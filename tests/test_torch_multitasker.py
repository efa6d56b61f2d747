"""The multitasker on ydf_tpu_torch, held against the JAX package on the
CPU: MultitaskerLearner with two tasks (a binary label and a regression
target) over GBT, random forest and CART sub-learners, each sub-model
tree for tree and its predictions and evaluation; the multitasker
directory saved by either package and loaded by the other (load_model
recognises it); the exclusion of every task's label and special
columns from the features.

Tolerances: trees and predictions bitwise; metrics within 1e-12.

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import os
import tempfile

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
from test_torch_random_forest import (
    assert_same_forest,
    assert_same_metrics,
    make_frame,
    require_jax,
)

torch.set_num_threads(1)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def frame(n, seed):
    """make_frame's binary frame plus a regression target."""
    df = make_frame(n, seed)
    df["target"] = (2 * df["x2"] - df["x3"] * df["x4"]
                    + 0.3 * df["x5"]).astype(np.float32)
    return df


def tasks(T):
    return [{"label": "label"}, {"label": "target", "task": T.REGRESSION}]


BASES = {
    "GRADIENT_BOOSTED_TREES": dict(num_trees=3, max_depth=3),
    "RANDOM_FOREST": dict(num_trees=2, max_depth=4),
    "CART": dict(max_depth=4),
}


@pytest.fixture(scope="module", params=sorted(BASES))
def pair(request):
    require_jax()
    base = request.param
    df = frame(1200, 1)
    kw = dict(base_learner=base, **BASES[base])
    jm = ydf.MultitaskerLearner(tasks(JaxTask), **kw).train(df)
    pm = ydf_tpu_torch.MultitaskerLearner(tasks(Task), device="cpu",
                                          **kw).train(df)
    return base, df, jm, pm


def test_multitasker_trains_the_jax_sub_models(pair):
    """Each task's sub-model tree for tree, its predictions bitwise and
    its evaluation within 1e-12; no sub-model sees another task's
    label."""
    base, df, jm, pm = pair
    test = frame(700, 9)
    assert list(pm.models) == list(jm.models) == ["label", "target"]
    want, got = jm.predict(test), pm.predict(test)
    for label in jm.models:
        assert_same_forest(jm.models[label], pm.models[label])
        assert got[label].tobytes() == np.asarray(want[label]).tobytes()
        names = pm.models[label].binner.feature_names
        assert "label" not in names and "target" not in names
    jev, pev = jm.evaluate(test), pm.evaluate(test)
    for label in jm.models:
        assert_same_metrics(jev[label].metrics, pev[label].metrics)


def test_multitasker_directory_loads_both_ways(pair):
    """multitasker.txt and task_<label>/ written by either package load
    in the other as a MultitaskerModel with the same predictions."""
    base, df, jm, pm = pair
    test = frame(300, 11)
    with tempfile.TemporaryDirectory() as tmp:
        jm.save(os.path.join(tmp, "jax"))
        pm.save(os.path.join(tmp, "port"))
        with open(os.path.join(tmp, "port", "multitasker.txt")) as f:
            assert f.read().splitlines() == ["label", "target"]
        back_port = ydf_tpu_torch.load_model(os.path.join(tmp, "jax"),
                                             device="cpu")
        back_jax = ydf.load_model(os.path.join(tmp, "port"))
    assert isinstance(back_port, ydf_tpu_torch.MultitaskerModel)
    assert type(back_jax).__name__ == "MultitaskerModel"
    want = jm.predict(test)
    for label, got in back_port.predict(test).items():
        assert got.tobytes() == np.asarray(want[label]).tobytes()
    for label, got in back_jax.predict(test).items():
        assert np.asarray(got).tobytes() == np.asarray(want[label]).tobytes()


def test_multitasker_excludes_special_columns():
    """A task's weights column stays out of every sub-model's features,
    as in the JAX package; an empty task list raises."""
    require_jax()
    df = frame(600, 3)
    df["w"] = np.float32(1.0) + (df["x0"] > 0).astype(np.float32)
    spec = [{"label": "label", "weights": "w"},
            {"label": "target", "task": Task.REGRESSION}]
    pm = ydf_tpu_torch.MultitaskerLearner(
        spec, base_learner="CART", max_depth=3, device="cpu").train(df)
    jspec = [dict(spec[0]), dict(spec[1], task=JaxTask.REGRESSION)]
    jm = ydf.MultitaskerLearner(jspec, base_learner="CART",
                                max_depth=3).train(df)
    for label in ("label", "target"):
        assert "w" not in pm.models[label].binner.feature_names
        assert_same_forest(jm.models[label], pm.models[label])
    with pytest.raises(ValueError, match="non-empty"):
        ydf_tpu_torch.MultitaskerLearner([])


def test_train_multitasker_fixture_matches_chip_smoke_constants():
    """The committed train_multitasker fixture (the JAX directory too) is
    the configuration phase 15 drives, and it loads in the port."""
    import json

    from test_torch_default_train import load_chip_smoke

    smoke = load_chip_smoke()
    root = smoke.TRAIN_MULTITASKER
    with open(os.path.join(root, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["test_rows"]) == (smoke.MULTITASK_ROWS,
                                               smoke.MULTITASK_TEST_ROWS)
    model = ydf_tpu_torch.load_model(os.path.join(root, "model"),
                                     device="cpu")
    assert isinstance(model, ydf_tpu_torch.MultitaskerModel)
    assert list(model.models) == [t["label"] for t in cfg["tasks"]]
    exp = np.load(os.path.join(root, "expected.npz"))
    for label, m in model.models.items():
        assert m.forest.num_trees == cfg["models"][label]["num_trees"]
        assert exp[f"{label}/tree_sha256"].shape[0] == m.forest.num_trees


@pytest.mark.gpu
def test_multitasker_on_card_matches_cpu():
    """A two-task GBT multitasker trained on the card equals the CPU
    port's, tree for tree, and saves and loads on the card."""
    _need_card()
    df = frame(20_000, 1)
    test = frame(1000, 9)
    kw = dict(num_trees=5, max_depth=5)
    gm = ydf_tpu_torch.MultitaskerLearner(tasks(Task), device="cuda",
                                          **kw).train(df)
    cm = ydf_tpu_torch.MultitaskerLearner(tasks(Task), device="cpu",
                                          **kw).train(df)
    for label in gm.models:
        g = gm.models[label].forest.to_numpy()
        c = cm.models[label].forest.to_numpy()
        for f in ("feature", "threshold_bin", "left", "right", "is_leaf",
                  "num_nodes"):
            assert np.asarray(g[f]).tobytes() == np.asarray(c[f]).tobytes()
    with tempfile.TemporaryDirectory() as tmp:
        gm.save(os.path.join(tmp, "m"))
        back = ydf_tpu_torch.load_model(os.path.join(tmp, "m"))
    for label, p in back.predict(test).items():
        assert p.tobytes() == gm.predict(test)[label].tobytes()
