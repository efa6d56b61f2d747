"""Training on a mesh on ydf_tpu_torch (parallel/mesh.py,
parallel/shards.py), held against the JAX package's mesh on the CPU:
the mesh helpers against ydf_tpu/parallel/mesh.py; the shard sums of the
histogram kernels' wide mode, merged, against one device's plain
histogram; the GBT on a mesh against the JAX package's mesh GBT (the
conftest's 8 virtual CPU devices; the port's mesh is the CPU eight
times, or 4x2) and against the port's single-device GBT, for binomial,
(data, feature), ranking, survival, sparse-oblique and vector-sequence
runs and the options that come through the same seam.
tests/test_torch_mesh_forest.py holds the random forest, the
multitasker and a dataset cache on a mesh; tests/test_torch_mesh_
multiprocess.py two processes.

Tolerances, and why:
  * against the port's single device: trees by hash (every node array
    bitwise) and predictions bitwise. The merge adds the shards' f64
    sums and rounds once, and every sum that replays XLA's order runs
    over the full row order on the first device;
  * against the JAX package's mesh: predictions within the JAX package's
    own mesh tolerance, 1e-4 (tests/test_parallel.py:37; 1e-3 for
    survival, :206). GSPMD reorders the JAX package's sums on a mesh;
    the port's mesh does not;
  * merged histograms: torch.equal to one device's plain histogram.

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.parallel import mesh as jax_mesh
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.learners.generic import unported
from ydf_tpu_torch.ops import histogram as hist_ops
from ydf_tpu_torch.ops import histogram_kernels
from ydf_tpu_torch.ops.histogram_kernels import RouteTables
from ydf_tpu_torch.parallel import mesh as pmesh
from ydf_tpu_torch.parallel.shards import MeshRows

torch.set_num_threads(1)
GBT_ATOL = 1e-4
SURVIVAL_ATOL = 1e-3
FOREST_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
                 "right", "is_leaf", "leaf_value", "cover", "num_nodes",
                 "threshold")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def cpu_mesh(data=8, feature=1):
    return pmesh.make_mesh(["cpu"] * (data * feature),
                           feature_parallelism=feature)


def jax_mesh_of(data=8, feature=1):
    devs = jax.devices()[:data * feature]
    return jax_mesh.make_mesh(devs, feature_parallelism=feature)


def tree_hashes(model):
    """SHA-256 of each tree's node arrays (FOREST_FIELDS present)."""
    import hashlib

    f = model.forest.to_numpy()
    out = []
    for t in range(f["feature"].shape[0]):
        h = hashlib.sha256()
        for name in FOREST_FIELDS:
            if name in f:
                h.update(np.ascontiguousarray(f[name][t]).tobytes())
        out.append(h.hexdigest())
    return out


def assert_same_trees(single, meshed):
    a, b = tree_hashes(single), tree_hashes(meshed)
    assert len(a) == len(b)
    first = next((t for t in range(len(a)) if a[t] != b[t]), None)
    assert first is None, f"tree {first} differs from the single device's"


def binary_data(n=1000, seed=3):
    """tests/test_parallel.py's _data."""
    rng = np.random.RandomState(seed)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    cat = rng.choice(["u", "v", "w"], size=n)
    logit = x1 - 2 * x2 + (cat == "v") * 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    return {"x1": x1, "x2": x2, "cat": cat, "y": y}


# --------------------------------------------------------------------- #
# The helpers against ydf_tpu/parallel/mesh.py
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n,multiple", [(10, 4), (12, 4), (997, 8), (1, 3)])
def test_pad_rows_to_multiple_matches_jax(n, multiple):
    require_jax()
    rng = np.random.default_rng(n)
    arrs = [rng.normal(size=(n, 3)).astype(np.float32),
            rng.integers(0, 9, n).astype(np.int64)]
    got, pad = pmesh.pad_rows_to_multiple(arrs, multiple)
    want, jpad = jax_mesh.pad_rows_to_multiple(arrs, multiple)
    assert pad == jpad
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    tgot, tpad = pmesh.pad_rows_to_multiple(
        [torch.from_numpy(a) for a in arrs], multiple)
    assert tpad == pad
    for g, w in zip(tgot, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("devices,data,feature", [
    (8, None, 1), (8, None, 2), (8, 2, 4), (6, 3, 2), (1, None, 1)])
def test_make_mesh_shape_matches_jax(devices, data, feature):
    require_jax()
    got = pmesh.make_mesh(["cpu"] * devices, data, feature)
    want = jax_mesh.make_mesh(jax.devices()[:devices], data, feature)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert got.first_device == torch.device("cpu")


def test_make_mesh_errors():
    require_jax()
    with pytest.raises(ValueError) as jerr:
        jax_mesh.make_mesh(jax.devices()[:6], 4, 2)
    with pytest.raises(ValueError, match=str(jerr.value)):
        pmesh.make_mesh(["cpu"] * 6, 4, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.make_mesh(["cuda:0"] * 4)
    with pytest.raises(ValueError, match="backend"):
        pmesh.init_distributed("127.0.0.1:1", 2, 0)
    with pytest.raises(TypeError, match="Mesh"):
        ydf_tpu_torch.GradientBoostedTreesLearner(label="y", mesh=object())
    with pytest.raises(ValueError, match="first device"):
        ydf_tpu_torch.RandomForestLearner(label="y", mesh=cpu_mesh(),
                                          device="meta")


@pytest.mark.parametrize("feature", [1, 2])
def test_shard_batch_matches_jax_shards(feature):
    """Each device's block equals the JAX package's addressable shard on
    the device of the same mesh position."""
    require_jax()
    x = np.arange(64 * 6, dtype=np.float32).reshape(64, 6)
    mesh = cpu_mesh(8 // feature, feature)
    jm = jax_mesh_of(8 // feature, feature)
    for fn in (pmesh.shard_batch, pmesh.shard_batch_and_features):
        got = fn(mesh, x)
        want = getattr(jax_mesh, fn.__name__)(jm, x)
        by_dev = {s.device: np.asarray(s.data)
                  for s in want.addressable_shards}
        for i in range(8 // feature):
            for j in range(feature):
                w = by_dev[jm.devices[i, j]]
                assert np.array_equal(got[i][j].numpy(), w), (fn, i, j)
    with pytest.raises(ValueError, match="pad_rows_to_multiple"):
        pmesh.shard_batch(mesh, np.zeros((63, 2)))


def test_column_slices_and_shard_rows():
    assert pmesh.column_slices(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert pmesh.column_slices(4, 2) == [(0, 2), (2, 4)]
    m, spans = pmesh.shard_rows(cpu_mesh(8), 997)
    assert m == 125 and spans[0] == (0, 125) and spans[-1] == (875, 997)


# --------------------------------------------------------------------- #
# The merged shard sums against one device's plain histogram
# --------------------------------------------------------------------- #


def layer_inputs(n, F, S, B, seed):
    g = torch.Generator().manual_seed(seed)
    bins_t = torch.randint(0, B, (F, n), dtype=torch.uint8, generator=g)
    stats = torch.randn(n, S, generator=g) * torch.exp(
        torch.randn(n, 1, generator=g) * 3)
    return bins_t, stats


@pytest.mark.parametrize("quant", ["f32", "bf16x2", "int8"])
@pytest.mark.parametrize("data,feature", [(1, 1), (3, 1), (4, 1), (8, 1),
                                          (3, 2), (2, 3)])
def test_merged_root_histogram_equals_one_device(quant, data, feature):
    """The root layer's per-shard wide sums, merged in shard order and
    rounded once, torch.equal to the plain histogram of all the rows on
    one device (n = 1001: the shards are uneven)."""
    n, F, S, B, L = 1001, 5, 3, 16, 4
    bins_t, stats = layer_inputs(n, F, S, B, seed=data * 10 + feature)
    op, qscale, _ = hist_ops.prepare_stats_for_hist(stats, quant)
    slot = torch.randint(0, L + 1, (n,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    want = hist_ops.histogram(bins_t, slot, op, L, B, quant, qscale)
    shards = MeshRows(cpu_mesh(data, feature), bins_t).for_tree()
    shards.begin(op, L)
    for i in range(data):
        for j in range(feature):
            shards.state[i][j] = (shards.rows.rows(slot, i, j=j),
                                  shards.state[i][j][1])
            # The padding rows stay on the trash slot.
            real = shards.rows.spans[i][1] - shards.rows.spans[i][0]
            shards.state[i][j][0][real:] = L
    got = hist_ops.finish(shards.root(L, B), op, qscale)
    assert got.dtype == want.dtype and torch.equal(got, want)


def routed_tables(L, B, F, seed):
    """Random decision tables of a layer of L slots."""
    g = torch.Generator().manual_seed(seed)
    do_split = torch.rand(L + 1, generator=g) < 0.7
    do_split[L] = False
    rank = torch.cumsum(do_split.long(), 0) - 1
    Lh = max(int(do_split.sum()), 1)
    hmap = torch.randint(0, Lh + 1, (L + 1,), dtype=torch.int32,
                         generator=g)
    hmap[L] = Lh
    return RouteTables(
        do_split=do_split,
        route_f=torch.randint(0, F, (L + 1,), dtype=torch.int32,
                              generator=g),
        go_left=torch.rand((L + 1, B), generator=g) < 0.5,
        left_id=(10 + 2 * rank).to(torch.int32),
        right_id=(11 + 2 * rank).to(torch.int32),
        split_rank=rank.clamp(min=0).to(torch.int32), hmap=hmap,
        is_set=torch.zeros(L + 1, dtype=torch.bool),
        set_go_left=torch.zeros(1, dtype=torch.uint8)), Lh


@pytest.mark.parametrize("quant", ["f32", "bf16x2", "int8"])
@pytest.mark.parametrize("data,feature", [(3, 1), (8, 1), (3, 2), (2, 3)])
def test_merged_routed_histogram_equals_one_device(quant, data, feature):
    """A routed layer on the shards (under feature parallelism through
    the owners' row directions) merged: the histogram torch.equal to the
    plain fused layer of all the rows, every row's leaf the same."""
    n, F, S, B, L = 1001, 6, 3, 16, 8
    bins_t, stats = layer_inputs(n, F, S, B, seed=7 + data)
    op, qscale, _ = hist_ops.prepare_stats_for_hist(stats, quant)
    tables, Lh = routed_tables(L, B, F, seed=data + feature)
    slot = torch.randint(0, L, (n,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    leaf = torch.zeros(n, dtype=torch.int32)
    acc, _, want_leaf = histogram_kernels.histogram_routed_plain(
        bins_t, slot, leaf, tables, op, Lh, B)
    want = hist_ops.finish(acc, op, qscale)
    shards = MeshRows(cpu_mesh(data, feature), bins_t).for_tree()
    shards.begin(op, L)
    for i in range(data):
        real = shards.rows.spans[i][1] - shards.rows.spans[i][0]
        for j in range(feature):
            s = shards.rows.rows(slot, i, j=j)
            s[real:] = L
            shards.state[i][j] = (s, shards.state[i][j][1])
    got = hist_ops.finish(shards.routed(tables, Lh, B), op, qscale)
    assert torch.equal(got, want)
    assert torch.equal(shards.leaf_ids(), want_leaf)


def test_wide_mode_keeps_the_unrounded_sum():
    """The wide mode's f64 (int32 for int8) sum, rounded, is the normal
    output; it counts no launch on the CPU."""
    bins_t, stats = layer_inputs(500, 4, 3, 8, seed=3)
    slot = torch.zeros(500, dtype=torch.int32)
    before = dict(histogram_kernels.WIDE_LAUNCHES)
    for op in (stats, hist_ops.split_bf16x2(stats),
               hist_ops.quantize_int8(stats, hist_ops.int8_scale(stats))
               .to(torch.int8)):
        wide = histogram_kernels.histogram(bins_t, slot, op, 1, 8, wide=True)
        assert wide.dtype == histogram_kernels.wide_dtype(op)
        assert torch.equal(wide.to(histogram_kernels.acc_dtype(op)),
                           histogram_kernels.histogram(bins_t, slot, op, 1,
                                                       8))
    assert histogram_kernels.WIDE_LAUNCHES == before


# --------------------------------------------------------------------- #
# The GBT on a mesh
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("data,feature", [(8, 1), (4, 2)])
def test_gbt_mesh_matches_jax_mesh_and_single_device(data, feature):
    """tests/test_parallel.py's binomial runs: 8-way data parallel and
    4x2 (validation split and early stopping on)."""
    require_jax()
    d = binary_data()
    kw = dict(label="y", num_trees=10, max_depth=4, random_seed=7)
    jm = ydf.GradientBoostedTreesLearner(
        mesh=jax_mesh_of(data, feature), **kw).train(d)
    single = ydf_tpu_torch.GradientBoostedTreesLearner(
        device="cpu", **kw).train(d)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        mesh=cpu_mesh(data, feature), **kw).train(d)
    np.testing.assert_allclose(pm.predict(d), jm.predict(d), atol=GBT_ATOL)
    assert_same_trees(single, pm)
    assert np.array_equal(pm.predict(d), single.predict(d))
    assert pm.evaluate(d).accuracy > 0.75


def test_gbt_ranking_on_mesh():
    """LambdaMART with n = 997 rows (not a multiple of the 8 shards): the
    query groups are registered on the real rows, the padding lives in
    the shards alone."""
    require_jax()
    rng = np.random.RandomState(11)
    n = 997
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    group = rng.randint(0, 40, size=n).astype(str)
    rel = np.clip((x1 - x2 + rng.normal(scale=0.3, size=n)) > 0.5, 0, 4)
    d = {"x1": x1, "x2": x2, "GROUP": group,
         "LABEL": rel.astype(np.float32)}
    kw = dict(label="LABEL", ranking_group="GROUP", num_trees=5,
              max_depth=3, validation_ratio=0.0, early_stopping="NONE")
    jm = ydf.GradientBoostedTreesLearner(
        task=JaxTask.RANKING, mesh=jax_mesh_of(), **kw).train(d)
    single = ydf_tpu_torch.GradientBoostedTreesLearner(
        task=Task.RANKING, device="cpu", **kw).train(d)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        task=Task.RANKING, mesh=cpu_mesh(), **kw).train(d)
    assert pm.predict(d).shape == (n,)
    np.testing.assert_allclose(pm.predict(d), jm.predict(d), atol=GBT_ATOL)
    assert_same_trees(single, pm)


def test_gbt_survival_on_mesh():
    """The Cox loss on n = 997 rows over 8 shards."""
    require_jax()
    rng = np.random.RandomState(19)
    n = 997
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    hazard = np.exp(0.8 * x1 - 0.5 * x2)
    age = rng.exponential(1.0 / hazard) + 0.1
    censor = rng.exponential(2.0, size=n) + 0.1
    d = {"x1": x1, "x2": x2,
         "age": np.minimum(age, censor).astype(np.float32),
         "observed": age <= censor}
    kw = dict(label="age", label_event_observed="observed", num_trees=8,
              max_depth=3, validation_ratio=0.0, early_stopping="NONE",
              random_seed=19)
    jm = ydf.GradientBoostedTreesLearner(
        task=JaxTask.SURVIVAL_ANALYSIS, mesh=jax_mesh_of(), **kw).train(d)
    single = ydf_tpu_torch.GradientBoostedTreesLearner(
        task=Task.SURVIVAL_ANALYSIS, device="cpu", **kw).train(d)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        task=Task.SURVIVAL_ANALYSIS, mesh=cpu_mesh(), **kw).train(d)
    p = pm.predict(d)
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p, jm.predict(d), atol=SURVIVAL_ATOL)
    assert_same_trees(single, pm)


def test_gbt_sparse_oblique_on_mesh():
    """Sparse-oblique splits on a 4x2 mesh: every tree's projection
    columns are cut over the rows and the feature axis too."""
    require_jax()
    d = binary_data(n=1200, seed=5)
    kw = dict(label="y", num_trees=8, max_depth=4,
              split_axis="SPARSE_OBLIQUE")
    jm = ydf.GradientBoostedTreesLearner(
        mesh=jax_mesh_of(4, 2), **kw).train(d)
    single = ydf_tpu_torch.GradientBoostedTreesLearner(
        device="cpu", **kw).train(d)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        mesh=cpu_mesh(4, 2), **kw).train(d)
    assert pm.forest.oblique_weights is not None
    np.testing.assert_allclose(pm.predict(d), jm.predict(d), atol=GBT_ATOL)
    assert_same_trees(single, pm)
    assert pm.evaluate(d).accuracy > 0.75


def vs_data(n, seed, D=4):
    """tests/test_vector_sequence.py's closer task: does any vector of
    the sequence lie within distance 1 of a fixed center?"""
    rng = np.random.RandomState(seed)
    center = np.linspace(-0.8, 0.8, D).astype(np.float32)
    seqs = [rng.normal(size=(rng.randint(0, 7), D)).astype(np.float32)
            for _ in range(n)]
    y = np.array([int(len(s) > 0 and np.sum((s - center) ** 2, 1).min()
                      < 1.0) for s in seqs])
    return {"seq": seqs, "noise": rng.normal(size=n), "y": y}


@pytest.mark.parametrize("n", [1008, 1001])
def test_gbt_vector_sequence_on_mesh(n):
    """Vector sequences on 8 shards: the anchors are sampled over the
    real rows, every tree's anchor columns cut over the shards. At n =
    1008 (a multiple of 8) against the JAX package's mesh. At n = 1001
    the JAX package's mesh samples its anchors over its 1008 padded rows
    and leaves its own single device's trees from tree 0 on (ROADMAP
    Queue 3); the port's mesh keeps the single device's, which are the
    JAX package's single device's bitwise."""
    require_jax()
    d = vs_data(n, 19)
    kw = dict(label="y", num_trees=8, max_depth=4, validation_ratio=0.0,
              early_stopping="NONE")
    single = ydf_tpu_torch.GradientBoostedTreesLearner(
        device="cpu", **kw).train(d)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        mesh=cpu_mesh(), **kw).train(d)
    assert_same_trees(single, pm)
    if n % 8 == 0:
        jm = ydf.GradientBoostedTreesLearner(mesh=jax_mesh_of(),
                                             **kw).train(d)
        np.testing.assert_allclose(pm.predict(d), jm.predict(d),
                                   atol=GBT_ATOL)
    else:
        js = ydf.GradientBoostedTreesLearner(**kw).train(d)
        assert np.array_equal(pm.predict(d), js.predict(d))
    assert pm.evaluate(d).accuracy > 0.85


@pytest.mark.parametrize("extra", [
    dict(dart_dropout=0.2), dict(subsample=0.5),
    dict(sampling_method="GOSS"), dict(monotonic_constraints={"x1": 1}),
    dict(split_axis="MHLD_OBLIQUE"), dict(num_candidate_attributes=1),
    dict(max_depth=1), dict(l2_regularization=1.0), dict(multiclass=True)])
def test_gbt_options_on_mesh_equal_single_device(extra):
    """The options that reach the grower through the same seam (the
    loop's per-row state stays whole; only the trees' rows are sharded)
    grow the single device's trees on a 3x2 mesh."""
    extra = dict(extra)
    d = binary_data(n=900, seed=4)
    if extra.pop("multiclass", False):
        d["y"] = np.digitize(d["x1"] - d["x2"], [-0.5, 0.5])
    kw = {**dict(label="y", num_trees=5, max_depth=4, random_seed=7),
          **extra}
    single = ydf_tpu_torch.GradientBoostedTreesLearner(
        device="cpu", **kw).train(d)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        mesh=cpu_mesh(3, 2), **kw).train(d)
    assert_same_trees(single, pm)
    assert np.array_equal(pm.predict(d), single.predict(d))


def test_gbt_mesh_launches_every_shard():
    """Each tree launches the root histogram and each routed layer once
    a device (counted on the CPU through the wrappers' plain calls)."""
    calls = {"histogram": 0, "histogram_routed": 0}
    orig = (histogram_kernels.histogram, histogram_kernels.histogram_routed)

    def count(name, fn):
        def wrapped(*a, **k):
            assert k.get("wide"), f"{name} outside the wide mode"
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    d = binary_data(n=600)
    kw = dict(label="y", num_trees=3, max_depth=4, validation_ratio=0.0,
              early_stopping="NONE")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(histogram_kernels, "histogram",
                   count("histogram", orig[0]))
        mp.setattr(histogram_kernels, "histogram_routed",
                   count("histogram_routed", orig[1]))
        ydf_tpu_torch.GradientBoostedTreesLearner(
            mesh=cpu_mesh(2, 2), **kw).train(d)
    finally:
        mp.undo()
    assert calls == {"histogram": 3 * 4, "histogram_routed": 3 * 3 * 4}


def test_unported_on_a_mesh_raise(tmp_path):
    """Categorical-set features do not train on a mesh (ROADMAP item
    18); distributed_membership raises naming item 18, and mesh= with
    RPC workers raises the JAX package's "combined with RPC workers"
    error when it trains (the constructor takes both)."""
    rng = np.random.RandomState(0)
    n = 300
    d = {"x": rng.normal(size=n),
         "s": [list(rng.choice(["a", "b", "c"], rng.randint(0, 3)))
               for _ in range(n)],
         "y": rng.randint(0, 2, n)}
    types = {"s": ydf_tpu_torch.ColumnType.CATEGORICAL_SET}
    for cls in (ydf_tpu_torch.GradientBoostedTreesLearner,
                ydf_tpu_torch.RandomForestLearner):
        learner = cls(label="y", num_trees=2, mesh=cpu_mesh(2),
                      column_types=types)
        with pytest.raises(NotImplementedError, match="item 18"):
            learner.train(d)
    assert "item 18" in str(unported("categorical-set features on a mesh",
                                     18))
    with pytest.raises(NotImplementedError, match="item 18"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="y", mesh=cpu_mesh(2), distributed_membership=object())
    from ydf_tpu_torch.dataset.cache import create_dataset_cache

    cache = create_dataset_cache(
        {"x": d["x"], "z": rng.normal(size=n), "y": d["y"]},
        str(tmp_path / "c"), label="y", feature_shards=2, device="cpu")
    with pytest.raises(ValueError, match="combined with RPC workers"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="y", mesh=cpu_mesh(2), distributed_workers=["h:1"],
            validation_ratio=0.0).train(cache)


# --------------------------------------------------------------------- #
# On a card
# --------------------------------------------------------------------- #


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["f32", "bf16x2", "int8"])
def test_wide_kernels_on_card_match_plain(quant):
    """Both kernels' wide mode on the card against their plain versions:
    int32 sums exactly; f64 sums within 1e-12 of the cell mass (the sum
    of |terms|: the order of the f64 adds), but the root kernel's bf16
    halves, which it adds in f32 partials, within chip_smoke's HIST_RTOL
    (1e-5) of the mass; rounded, each equals the normal mode's output."""
    _need_card()
    n, F, S, B, L = 20_011, 6, 3, 32, 8
    bins_t, stats = layer_inputs(n, F, S, B, seed=5)
    op, _, _ = hist_ops.prepare_stats_for_hist(stats, quant)
    tables, Lh = routed_tables(L, B, F, seed=4)
    slot = torch.randint(0, L, (n,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    leaf = torch.zeros(n, dtype=torch.int32)
    mass_op = op if op.dtype == torch.int8 else op.abs()

    def close(got, want, mass, rtol):
        assert got.dtype == want.dtype
        if got.dtype == torch.int32:
            assert torch.equal(got, want)
        else:
            assert torch.all((got - want).abs() <= rtol * mass + 1e-12)

    cu = [a.cuda() for a in (bins_t, slot, op)]
    got = histogram_kernels.histogram(*cu, L, B, wide=True).cpu()
    close(got, histogram_kernels.histogram_plain(bins_t, slot, op, L, B,
                                                 wide=True),
          histogram_kernels.histogram_plain(bins_t, slot, mass_op, L, B,
                                            wide=True),
          1e-5 if op.dtype == torch.bfloat16 else 1e-12)
    assert torch.equal(got.to(histogram_kernels.acc_dtype(op)),
                       histogram_kernels.histogram(*cu, L, B).cpu())
    tab = RouteTables(*(t.cuda() for t in tables))
    g = histogram_kernels.histogram_routed(
        cu[0], cu[1], leaf.cuda(), tab, cu[2], Lh, B, wide=True)
    w = histogram_kernels.histogram_routed_plain(
        bins_t, slot, leaf, tables, op, Lh, B, wide=True)
    assert torch.equal(g[1].cpu(), w[1]) and torch.equal(g[2].cpu(), w[2])
    close(g[0].cpu(), w[0], histogram_kernels.histogram_routed_plain(
        bins_t, slot, leaf, tables, mass_op, Lh, B, wide=True)[0], 1e-12)
    assert torch.equal(g[0].cpu().to(histogram_kernels.acc_dtype(op)),
                       histogram_kernels.histogram_routed(
                           cu[0], cu[1], leaf.cuda(), tab, cu[2], Lh,
                           B)[0].cpu())


@pytest.mark.gpu
def test_gbt_on_card_mesh_equals_card_single_device():
    """Four shards on the card (one card four times, or four cards):
    the trees equal the card's single-device run by hash."""
    _need_card()
    d = binary_data(n=20_000, seed=8)
    kw = dict(label="y", num_trees=10, max_depth=6)
    single = ydf_tpu_torch.GradientBoostedTreesLearner(**kw).train(d)
    count = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(4)] if count >= 4
               else ["cuda:0"] * 4)
    for feature in (1, 2):
        pm = ydf_tpu_torch.GradientBoostedTreesLearner(
            mesh=pmesh.make_mesh(devices, feature_parallelism=feature),
            **kw).train(d)
        assert_same_trees(single, pm)
