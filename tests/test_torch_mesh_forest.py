"""The random forest on a mesh on ydf_tpu_torch, held against the JAX
package's mesh forest (the conftest's 8 virtual CPU devices) and the
port's single-device forest on the CPU: classification over 8 data
shards (n a multiple of 8, and n = 1001), out-of-bag evaluation, a 4x2
(data, feature) mesh on four columns (no pad column) and on three (one
pad column, the JAX package's candidate draw over the padded count), the
uplift forest, the multitasker passing `mesh` to its sub-learners, and
a dataset cache trained on a mesh. tests/test_torch_mesh.py holds the
helpers, the merged histograms and the GBT.

Tolerances, and why:
  * against the port's single device: trees by hash, predictions and
    out-of-bag metrics bitwise (the merge rounds the shards' f64 sums
    once; the bootstrap, the candidates and the out-of-bag votes stay on
    the first device over the real rows);
  * against the JAX package's mesh: predictions within 1e-5
    (tests/test_parallel.py:109), 1e-4 for uplift (:183);
  * a padded feature axis draws its candidates as the JAX package's
    mesh does, which is not the single device's draw: that forest is
    held against the JAX package's mesh alone.
"""

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax  # noqa: F401

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset import cache as pcache
from test_torch_mesh import (
    assert_same_trees,
    binary_data,
    cpu_mesh,
    jax_mesh_of,
    require_jax,
)
from test_torch_dataset_cache import frame, write_files
from test_torch_uplift import uplift_frame

torch.set_num_threads(1)
RF_ATOL = 1e-5
UPLIFT_ATOL = 1e-4


def four_columns(n=800, seed=9):
    """tests/test_parallel.py's feature-parallel frame: x1, x2, cat, x3."""
    d = binary_data(n, seed)
    d["x3"] = np.random.RandomState(10).normal(size=n)
    return d


@pytest.mark.parametrize("data,feature", [(8, 1), (4, 2)])
def test_rf_mesh_matches_jax_mesh_and_single_device(data, feature):
    """tests/test_parallel.py:93's forest (four columns: the feature axis
    needs no pad column), with out-of-bag evaluation."""
    require_jax()
    d = four_columns()
    kw = dict(label="y", num_trees=12, max_depth=6, random_seed=31,
              compute_oob_performances=True)
    jm = ydf.RandomForestLearner(mesh=jax_mesh_of(data, feature),
                                 **kw).train(d)
    single = ydf_tpu_torch.RandomForestLearner(device="cpu", **kw).train(d)
    pm = ydf_tpu_torch.RandomForestLearner(
        mesh=cpu_mesh(data, feature), **kw).train(d)
    np.testing.assert_allclose(pm.predict(d), jm.predict(d), atol=RF_ATOL)
    assert_same_trees(single, pm)
    assert np.array_equal(pm.predict(d), single.predict(d))
    assert pm.oob_evaluation == single.oob_evaluation
    a1 = jm.oob_evaluation["metrics"]["accuracy"]
    a2 = pm.oob_evaluation["metrics"]["accuracy"]
    assert abs(a1 - a2) < 0.02, (a1, a2)


def test_rf_uneven_rows_on_mesh():
    """n = 1001 over 8 shards (tests/test_multitasker.py:47): the padding
    rows sit in the last shard alone and never count; the out-of-bag
    evaluation sees the 1001 real rows."""
    require_jax()
    rng = np.random.RandomState(8)
    n = 1001
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    d = {"x1": x1, "x2": x2, "cls": (x1 + x2 > 0).astype(np.int64)}
    kw = dict(label="cls", num_trees=8, max_depth=4, random_seed=3)
    jm = ydf.RandomForestLearner(mesh=jax_mesh_of(), **kw).train(d)
    single = ydf_tpu_torch.RandomForestLearner(device="cpu", **kw).train(d)
    pm = ydf_tpu_torch.RandomForestLearner(mesh=cpu_mesh(), **kw).train(d)
    np.testing.assert_allclose(pm.predict(d), jm.predict(d), atol=1e-4)
    assert_same_trees(single, pm)
    assert pm.oob_evaluation == single.oob_evaluation


def test_rf_padded_feature_axis_matches_jax_mesh():
    """Three columns on a 4x2 mesh: one constant-zero pad column, which
    never splits; the candidates are drawn over four columns with the
    pad scored -1, as the JAX package's mesh draws them
    (tests/test_parallel.py:117's frame)."""
    require_jax()
    d = binary_data(n=600, seed=13)
    kw = dict(label="y", num_trees=8, max_depth=5)
    jm = ydf.RandomForestLearner(mesh=jax_mesh_of(4, 2), **kw).train(d)
    pm = ydf_tpu_torch.RandomForestLearner(mesh=cpu_mesh(4, 2),
                                           **kw).train(d)
    np.testing.assert_allclose(pm.predict(d), jm.predict(d), atol=RF_ATOL)
    jf, pf = jm.forest, pm.forest.to_numpy()
    for f in ("feature", "threshold_bin", "left", "right", "is_leaf"):
        assert np.array_equal(np.asarray(getattr(jf, f)), pf[f]), f
    splits = pf["feature"][~pf["is_leaf"]]
    assert splits.max() < 3, "a pad column split"


def test_uplift_forest_on_mesh():
    """The uplift forest over 8 shards of 1001 rows: the stats' padding
    rows hold treatment code 0's zeros and never count."""
    require_jax()
    train, test = uplift_frame(1001, seed=3)
    kw = dict(label="y", uplift_treatment="treat", num_trees=6,
              max_depth=6)
    jm = ydf.RandomForestLearner(task=JaxTask.CATEGORICAL_UPLIFT,
                                 mesh=jax_mesh_of(), **kw).train(train)
    single = ydf_tpu_torch.RandomForestLearner(
        task=Task.CATEGORICAL_UPLIFT, device="cpu", **kw).train(train)
    pm = ydf_tpu_torch.RandomForestLearner(
        task=Task.CATEGORICAL_UPLIFT, mesh=cpu_mesh(), **kw).train(train)
    np.testing.assert_allclose(pm.predict(test), jm.predict(test),
                               atol=UPLIFT_ATOL)
    assert_same_trees(single, pm)


@pytest.mark.parametrize("base", ["RANDOM_FOREST", "GRADIENT_BOOSTED_TREES"])
def test_multitasker_passes_the_mesh(base):
    """MultitaskerLearner(..., mesh=) trains every sub-model on the mesh:
    each equals its single-device sub-model tree by tree."""
    rng = np.random.RandomState(8)
    n = 1001
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    d = {"x1": x1, "x2": x2, "cls": (x1 + x2 > 0).astype(np.int64),
         "reg": (2 * x1 - x2 + rng.normal(scale=0.3, size=n)).astype(
             np.float32)}
    tasks = [{"label": "cls"},
             {"label": "reg", "task": Task.REGRESSION}]
    kw = dict(base_learner=base, num_trees=5, max_depth=4)
    single = ydf_tpu_torch.MultitaskerLearner(tasks, device="cpu",
                                              **kw).train(d)
    meshed = ydf_tpu_torch.MultitaskerLearner(tasks, mesh=cpu_mesh(3, 2),
                                              **kw).train(d)
    for label in ("cls", "reg"):
        assert_same_trees(single.models[label], meshed.models[label])


@pytest.mark.parametrize("cls,feature", [("RandomForestLearner", 1),
                                         ("GradientBoostedTreesLearner", 2)])
def test_cache_on_mesh(tmp_path, cls, feature):
    """A dataset cache (dataset/cache.py) trains on a mesh as on one
    device: the cache's bins are laid over the shards. The cache holds
    11 feature columns, so the forest runs on 4x1 (a 4x2 mesh pads a
    column and draws the JAX package's padded candidates); the GBT, whose
    mesh pads no column, on 4x2."""
    src = write_files(str(tmp_path), [frame(700, 5), frame(301, 6)])
    cache = pcache.create_dataset_cache(src, str(tmp_path / "c"),
                                        label="label", device="cpu",
                                        chunk_rows=256)
    learner = getattr(ydf_tpu_torch, cls)
    kw = dict(label="label", num_trees=5, max_depth=5)
    single = learner(device="cpu", **kw).train(cache)
    pm = learner(mesh=cpu_mesh(4, feature), **kw).train(cache)
    assert single.binner.num_features == 11
    assert_same_trees(single, pm)
