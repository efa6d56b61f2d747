"""Sparse-oblique splits on ydf_tpu_torch, held against the JAX package on
the CPU: the shared projection sampler (all four weight types), the
projection in XLA's dot order, the projection columns and their
boundaries at the GBT's and the isolation forest's shapes, small oblique
GBT (binary with validation, 3 classes, with a vector-sequence feature
for the [num, obl, vs, cat] layout, each weight type, a loop of one
iteration), random forest, CART and isolation forest trainings, routing
with a missing-value replacement and NaN inputs, and saves loaded by the
other package; the options that still raise; the train_oblique fixture's
configuration against chip_smoke.py's constants.

The JAX side trains with its CPU defaults (the native histogram and
fused routing) and predicts through its Routed engine (force_engine):
its default CPU engine for an oblique GBT is the native C++ one, whose
projections are not the routed engine's. Tolerance: bitwise everywhere
(W, projections, boundaries, bins, every node array, leaf values,
predictions and scores); evaluation metrics within 1e-12 (host float64
on the same predictions).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import json
import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.ops.oblique import (
        sample_projection_coefficients as jax_sample,
    )
    from ydf_tpu.ops.routing import forest_leaves as jax_forest_leaves
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.ops import histogram_kernels, oblique
import ydf_tpu_torch.models.forest
from ydf_tpu_torch.ops.routing import oblique_tree_projections as \
    oblique_projections
from ydf_tpu_torch.ops.routing import route_tree_values
from ydf_tpu_torch.utils import prng
from test_torch_default_train import load_chip_smoke
from test_torch_default_train import make_frame as gbt_frame
from test_torch_random_forest import make_frame as rf_frame

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_OBLIQUE = os.path.join(REPO, "ydf_tpu_torch", "testdata",
                             "train_oblique")
FOREST_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
                 "right", "is_leaf", "leaf_value", "cover", "num_nodes",
                 "threshold", "oblique_weights", "oblique_na_repl",
                 "na_left")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def torch_key(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def assert_same_forest(jm, pm, fields=FOREST_FIELDS):
    jf = {f: np.asarray(getattr(jm.forest, f)) for f in jm.forest._fields}
    pf = pm.forest.to_numpy()
    for f in fields:
        a, b = np.ascontiguousarray(jf[f]), np.ascontiguousarray(pf[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


def jax_routed(jm, data):
    """The JAX model's predictions through its Routed engine."""
    jm.force_engine("Routed")
    return np.asarray(jm.predict(data))


# ---- the sampler and the projection ------------------------------------


@pytest.mark.parametrize("weight_type", oblique.WEIGHT_TYPES)
@pytest.mark.parametrize("P,Fn,density", [
    (28, 28, 2.0), (5, 1, 2.0), (10, 3, 2.0), (4, 4, 10.0), (64, 30, 3.0),
    (2, 7, 0.5),
])
def test_sampler_matches_jax(weight_type, P, Fn, density):
    """W [P, Fn] bitwise to the JAX sampler on three keys, Fn = 1, P > Fn
    and density >= Fn included (zeros are +0.0: jnp's wts * mask is a
    select)."""
    require_jax()
    for seed in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
        want = jax_sample(key, P, Fn, density=density,
                          weight_type=weight_type)
        got = oblique.sample_projection_coefficients(
            torch_key(key), P, Fn, density, weight_type)
        assert np.array_equal(bits(got), bits(want)), seed


def test_sampler_weight_ranges_and_batched_keys():
    """The POWER_OF_TWO and INTEGER ranges the GBT passes, and a batch of
    keys drawn at once (the learners draw every tree's W before the
    loop) equal to one key at a time."""
    require_jax()
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    for wt, rng in (("POWER_OF_TWO", (-1, 5)), ("INTEGER", (-2, 9))):
        got = oblique.sample_projection_coefficients(
            torch_key(keys), 9, 6, 2.0, wt, rng)
        for i in range(4):
            want = jax_sample(keys[i], 9, 6, weight_type=wt,
                              weight_range=rng)
            assert np.array_equal(bits(got[i]), bits(want)), (wt, i)
    with pytest.raises(ValueError, match="sparse_oblique_weights"):
        oblique.sample_projection_coefficients(torch_key(keys[0]), 2, 2,
                                               weight_type="GAUSSIAN")


@pytest.mark.parametrize("n,Fn,P", [
    (4096, 28, 28), (256, 28, 28), (3000, 8, 8), (1000, 6, 6),
    (1000, 4, 4), (1000, 2, 2), (1000, 3, 3), (1000, 5, 20),
    (1000, 7, 20), (1000, 9, 40), (1000, 17, 40), (1000, 12, 64),
    (1000, 31, 17), (1000, 40, 48),
])
def test_xla_dot_matches_jax(n, Fn, P):
    """z = x @ W.T with dense CONTINUOUS weights (every product rounds,
    every term counts) bitwise to XLA's CPU dot, at the learners' shapes
    (train_default's 28 numerical features, the isolation forest's 256
    rows) and at shapes that take each lane count and tail."""
    require_jax()
    rng = np.random.default_rng(n + Fn + P)
    x = rng.normal(size=(n, Fn)).astype(np.float32)
    W = rng.uniform(-1, 1, size=(P, Fn)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: a @ b.T)(x, W))
    got = oblique.xla_dot(torch.from_numpy(np.ascontiguousarray(x.T)),
                          torch.from_numpy(W))
    assert np.array_equal(bits(got.numpy().T), bits(want))


def jax_projection_step(x, W, B, uniform):
    """The learners' projection step as they compile it, inside a loop
    of two steps (the GBT's and the random forest's quantile bins,
    gbt.py:1283-1295; the isolation forest's uniform bins,
    isolation_forest.py:256-272)."""
    def step(c, t):
        x, W = c
        z = x @ (W * t).T
        if uniform:
            zmin, zmax = jnp.min(z, axis=0), jnp.max(z, axis=0)
            qs = jnp.arange(1, B, dtype=jnp.float32) / B
            bnd = zmin[:, None] + (
                jnp.maximum(zmax - zmin, 1e-12)[:, None] * qs[None, :])
        else:
            qs = jnp.linspace(1.0 / B, 1.0 - 1.0 / B, B - 1)
            bnd = jnp.quantile(z, qs, axis=0).T
        zb = jax.vmap(lambda b, zz: jnp.searchsorted(b, zz, side="right"))(
            bnd, z.T).astype(jnp.uint8)
        return c, (bnd, zb)

    return jax.jit(lambda x, W: jax.lax.scan(step, (x, W), jnp.ones(2))
                   )(x, W)[1]


@pytest.mark.parametrize("n,uniform", [(20_000, False), (256, True)])
def test_projection_columns_match_jax(n, uniform):
    """Boundaries f32 [P, B-1] and bins u8 [P, n] of 28 projections of
    28 features with NaN-free imputed values and ties (a column at its
    imputation value on 10% of the rows), bitwise: the GBT's quantile
    cuts at 20,000 rows, the isolation forest's uniform cuts at 256."""
    require_jax()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 28)).astype(np.float32)
    x[rng.random(n) < 0.1, 0] = np.float32(0.0123)
    key = jax.random.PRNGKey(11)
    W = jax_sample(key, 28, 28)
    bnd, zb = jax_projection_step(jnp.asarray(x), W, 256, uniform)
    xt = torch.from_numpy(np.ascontiguousarray(x.T))
    Wt = oblique.sample_projection_coefficients(torch_key(key), 28, 28)
    qs = None if uniform else prng.linspace_f32(1 / 256, 1 - 1 / 256, 255)
    cols, bounds = oblique.projection_columns(xt, Wt, qs=qs, num_bins=256)
    assert np.array_equal(bits(bounds), bits(bnd[0]))
    assert np.array_equal(cols.numpy(), np.asarray(zb[0]))


# ---- whole trainings ---------------------------------------------------


@pytest.fixture(scope="module")
def gbt_pair():
    """A binary oblique GBT with every default but 40 trees and a
    look-ahead of 10, on 4,000 rows of 8 numerical (NaNs in f5) and 3
    categorical columns, in both packages."""
    require_jax()
    data = gbt_frame(4000, 0)
    hp = dict(label="label", split_axis="SPARSE_OBLIQUE", num_trees=40,
              early_stopping_num_trees_look_ahead=10)
    jm = ydf.GradientBoostedTreesLearner(**hp).train(data)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                   **hp).train(data)
    return jm, pm, data


def test_oblique_gbt_matches_jax(gbt_pair):
    """Every tree, projection, threshold and leaf value bitwise, the same
    kept count, predictions bitwise to JAX's Routed engine."""
    jm, pm, data = gbt_pair
    jl, pl = jm.training_logs, pm.training_logs
    assert (pl["num_trees"], pl["num_trees_trained"]) == (
        jl["num_trees"], jl["num_trees_trained"])
    assert_same_forest(jm, pm)
    pf = pm.forest.to_numpy()
    F = pm.binner.num_features
    assert pf["oblique_weights"].shape[1:] == (8, 8)  # P = Fn = 8
    assert (pf["feature"][~pf["is_leaf"]] >= F).any()  # projections used
    fresh = gbt_frame(800, 6)
    assert pm.predict(fresh).tobytes() == jax_routed(jm, fresh).tobytes()
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(pl[key], jl[key], rtol=1e-5)


def test_oblique_gbt_evaluate_and_saves_load_both_ways(gbt_pair, tmp_path):
    """evaluate within 1e-12; the JAX save loaded by the port and the
    port's save loaded by JAX predict bitwise; the registry serves the
    oblique forest routed."""
    jm, pm, data = gbt_pair
    fresh = gbt_frame(800, 6)
    jev, pev = jm.evaluate(fresh), pm.evaluate(fresh)
    for k in jev.metrics:
        assert abs(jev.metrics[k] - pev.metrics[k]) <= 1e-12, k
    assert pm.list_compatible_engines() == ["Routed"]
    jm.save(str(tmp_path / "jax"))
    pm.save(str(tmp_path / "port"))
    back = ydf_tpu_torch.load_model(str(tmp_path / "jax"), device="cpu")
    assert back.predict(fresh).tobytes() == pm.predict(fresh).tobytes()
    jback = ydf.load_model(str(tmp_path / "port"))
    assert jax_routed(jback, fresh).tobytes() == \
        pm.predict(fresh).tobytes()
    assert_same_forest(jback, back)


@pytest.mark.parametrize("weight_type", ["CONTINUOUS", "INTEGER",
                                         "POWER_OF_TWO"])
def test_oblique_gbt_weight_types_match_jax(weight_type):
    """The other three weight types: W and trees bitwise (CONTINUOUS and
    INTEGER products round, so the dot's order and fused multiply-adds
    decide the bins)."""
    require_jax()
    data = gbt_frame(3000, 2)
    hp = dict(label="label", split_axis="SPARSE_OBLIQUE", num_trees=15,
              max_depth=4, sparse_oblique_weights=weight_type,
              sparse_oblique_projection_density_factor=4.0,
              early_stopping_num_trees_look_ahead=5)
    jm = ydf.GradientBoostedTreesLearner(**hp).train(data)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                   **hp).train(data)
    assert_same_forest(jm, pm)
    assert pm.predict(data).tobytes() == jax_routed(jm, data).tobytes()


def test_oblique_gbt_loop_of_one_and_regression():
    """One iteration (the JAX loop of one step rounds its quantiles the
    other way) of a regression GBT without validation; P capped by
    sparse_oblique_max_num_projections and raised by the exponent."""
    require_jax()
    data = rf_frame(2000, 3, "regression")
    for hp in (dict(num_trees=1), dict(
            num_trees=6, sparse_oblique_num_projections_exponent=1.5,
            sparse_oblique_max_num_projections=10)):
        kw = dict(label="label", split_axis="SPARSE_OBLIQUE",
                  validation_ratio=0.0, early_stopping="NONE", **hp)
        jm = ydf.GradientBoostedTreesLearner(
            task=ydf.Task.REGRESSION, **kw).train(data)
        pm = ydf_tpu_torch.GradientBoostedTreesLearner(
            task=ydf_tpu_torch.Task.REGRESSION, device="cpu",
            **kw).train(data)
        assert_same_forest(jm, pm)
        assert pm.predict(data).tobytes() == jax_routed(jm, data).tobytes()
    assert pm.forest.oblique_weights.shape[1] == 10


def test_oblique_multiclass_gbt_matches_jax():
    """Three classes: the K = 3 trees of an iteration share one W and its
    boundaries; trees and probabilities bitwise."""
    require_jax()
    data = rf_frame(3000, 4, "multiclass")
    hp = dict(label="label", split_axis="SPARSE_OBLIQUE", num_trees=12,
              max_depth=4, early_stopping_num_trees_look_ahead=4)
    jm = ydf.GradientBoostedTreesLearner(**hp).train(data)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                   **hp).train(data)
    assert_same_forest(jm, pm)
    W = pm.forest.oblique_weights
    assert torch.equal(W[0], W[1]) and torch.equal(W[0], W[2])
    assert pm.predict(data).tobytes() == jax_routed(jm, data).tobytes()


def test_oblique_gbt_with_vector_sequences_and_categoricals():
    """[num, obl, vs, cat] while growing, [real, obl, vs] in the forest:
    projections, anchors and trees bitwise, validation rows projected
    and scored through the same projections and anchors."""
    require_jax()
    smoke = load_chip_smoke()
    d = smoke.make_vs_data(2000, max_len=6, dim=4, noise=2, radius=2.4)
    rng = np.random.default_rng(0)
    d["c"] = np.array([f"k{v}" for v in np.where(
        d["label"] == 1, rng.integers(0, 4, 2000), rng.integers(0, 9, 2000))])
    hp = dict(label="label", num_trees=10, max_depth=4,
              split_axis="SPARSE_OBLIQUE",
              early_stopping_num_trees_look_ahead=5)
    jm = ydf.GradientBoostedTreesLearner(**hp).train(d)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                   **hp).train(d)
    assert_same_forest(jm, pm, FOREST_FIELDS + ("vs_anchor", "vs_feat",
                                                "vs_is_closer"))
    pf = pm.forest.to_numpy()
    F, P = pm.binner.num_features, pf["oblique_weights"].shape[1]
    split = pf["feature"][~pf["is_leaf"]]
    assert ((split >= F) & (split < F + P)).any()  # projections
    assert (split >= F + P).any()  # anchors
    assert pm.predict(d).tobytes() == jax_routed(jm, d).tobytes()


@pytest.mark.parametrize("learner,frame,kw", [
    ("RandomForestLearner", "binary", dict(num_trees=5)),
    ("RandomForestLearner", "regression",
     dict(num_trees=3, sparse_oblique_weights="CONTINUOUS")),
    ("CartLearner", "binary", {}),
    ("CartLearner", "multiclass", dict(sparse_oblique_weights="INTEGER")),
    ("IsolationForestLearner", "binary", dict(num_trees=20)),
    ("IsolationForestLearner", "binary",
     dict(num_trees=1, sparse_oblique_weights="POWER_OF_TWO")),
])
def test_oblique_forests_match_jax(learner, frame, kw):
    """Random forests, CART (one tree, pruned on its holdout) and
    isolation forests with sparse-oblique splits on 3,000 rows of 6
    numerical (NaNs in x1) and 2 categorical columns: every node array,
    projection and threshold, the out-of-bag or holdout evaluation, and
    predictions (scores) bitwise."""
    require_jax()
    df = rf_frame(3000, 1, frame)
    hp = dict(split_axis="SPARSE_OBLIQUE", **kw)
    if learner == "IsolationForestLearner":
        df = df.drop(columns=["label"])
    else:
        hp["label"] = "label"
        if frame == "regression":
            hp["task"] = ydf.Task.REGRESSION
    jm = getattr(ydf, learner)(**hp).train(df)
    if "task" in hp:
        hp["task"] = ydf_tpu_torch.Task.REGRESSION
    pm = getattr(ydf_tpu_torch, learner)(device="cpu", **hp).train(df)
    assert_same_forest(jm, pm)
    if learner != "IsolationForestLearner":
        je, pe = jm.self_evaluation(), pm.self_evaluation()
        assert je["num_examples"] == pe["num_examples"]
        for k in je["metrics"]:
            assert abs(je["metrics"][k] - pe["metrics"][k]) <= 1e-12, k
    if learner == "CartLearner":
        assert pm.extra_metadata == jm.extra_metadata
    assert pm.predict(df).tobytes() == jax_routed(jm, df).tobytes()


def test_routing_with_missing_value_replacement(gbt_pair, tmp_path):
    """Rows with NaNs routed natively (native_missing) through oblique
    nodes whose oblique_na_repl replaces some missing features (not NaN)
    and leaves others NaN (the projection is NaN and the node takes
    na_left, random here): the leaf of every row in every tree equals
    JAX's route_tree_values."""
    jm, _, _ = gbt_pair
    rng = np.random.default_rng(9)
    f = jm.forest
    repl = np.where(rng.random(f.oblique_weights.shape) < 0.5,
                    rng.normal(size=f.oblique_weights.shape), np.nan)
    na_left = rng.random(f.na_left.shape) < 0.5
    jm.forest = f._replace(oblique_na_repl=jnp.asarray(repl, jnp.float32),
                           na_left=jnp.asarray(na_left))
    try:
        jm.save(str(tmp_path / "m"))
    finally:
        jm.forest = f
    pm = ydf_tpu_torch.load_model(str(tmp_path / "m"), device="cpu")
    x = rng.normal(size=(600, 8)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.nan
    Fc = pm.binner.num_categorical
    xc = rng.integers(-1, 3, size=(600, Fc)).astype(np.int32)
    jf = ydf.load_model(str(tmp_path / "m")).forest
    want = np.asarray(jax_forest_leaves(
        jf, jnp.asarray(x), jnp.asarray(xc), 8, pm.max_depth))
    xt, xct = torch.from_numpy(x), torch.from_numpy(xc)
    for t in range(pm.forest.num_trees):
        got = route_tree_values(pm.forest, t, xt, xct, 8, pm.max_depth)
        assert np.array_equal(got.numpy(), want[:, t]), t


def probe_forest(w, thresholds):
    """A JAX Forest of one depth-1 tree a threshold: its root splits on
    the projection on w f32 [Fn] (feature Fn: no categorical column)."""
    from ydf_tpu.models.forest import Forest as JaxForest

    T, N, Fn = len(thresholds), 3, w.shape[0]
    feat = np.full((T, N), -1, np.int32)
    feat[:, 0] = Fn
    th = np.zeros((T, N), np.float32)
    th[:, 0] = thresholds
    left = np.zeros((T, N), np.int32)
    left[:, 0] = 1
    right = np.zeros((T, N), np.int32)
    right[:, 0] = 2
    leaf = np.ones((T, N), bool)
    leaf[:, 0] = False
    z = np.zeros((T, N), bool)
    return JaxForest(
        feature=feat, threshold=th, threshold_bin=np.zeros((T, N), np.int32),
        is_cat=z, is_set=z, cat_mask=np.zeros((T, N, 8), np.uint32),
        left=left, right=right, is_leaf=leaf, na_left=z,
        leaf_value=np.zeros((T, N, 1), np.float32),
        cover=np.ones((T, N), np.float32),
        oblique_weights=np.broadcast_to(w, (T, 1, Fn)).copy(),
        oblique_na_repl=np.full((T, 1, Fn), np.nan, np.float32),
        vs_anchor=np.zeros((T, 0, 0), np.float32),
        vs_feat=np.zeros((T, 0), np.int32),
        vs_is_closer=np.zeros((T, 0), bool),
        num_nodes=np.full((T,), N, np.int32))


@pytest.mark.parametrize("Fn", [6, 8, 21, 24, 28, 31])
def test_routing_projection_matches_jax_reduce(Fn):
    """Each tree's projections (ops/routing.py:oblique_tree_projections)
    equal the value XLA's reduce gives inside the JAX package's routing,
    with dense CONTINUOUS weights (every term counts): for 32 rows, two
    probe trees at the port's value v and at the next float above it
    send the row right, then left, only if JAX's value is v (one chain
    up to 21 features, 8 lanes from 24 to 31)."""
    require_jax()
    rng = np.random.default_rng(Fn)
    x = rng.normal(size=(2000, Fn)).astype(np.float32)
    w = rng.uniform(-1, 1, Fn).astype(np.float32)
    forest = ydf_tpu_torch.models.forest.Forest.from_numpy(
        probe_forest(w, np.zeros(1, np.float32))._asdict())
    v = oblique_projections(forest, 0, torch.from_numpy(x))[:32, 0].numpy()
    thr = np.stack([v, np.nextafter(v, np.float32(np.inf))], 1).reshape(-1)
    leaves = np.asarray(jax_forest_leaves(
        probe_forest(w, thr), jnp.asarray(x), jnp.zeros((2000, 0), jnp.int32),
        Fn, 1))
    rows = np.arange(32)
    assert np.array_equal(leaves[rows, 2 * rows], np.full(32, 2))
    assert np.array_equal(leaves[rows, 2 * rows + 1], np.full(32, 1))


# ---- the options that still raise; the fixture's configuration --------


def test_mhld_and_monotone_constraints_still_raise():
    """MHLD_OBLIQUE trains on the GBT (ported since ROADMAP item 28,
    tests/test_torch_mhld.py) and raises the JAX package's ValueError on
    a task other than classification and with monotone constraints; a
    monotone constraint with oblique splits (ported since item 14b)
    raises, as the JAX package's, only on an unknown or a non-numerical
    feature; the RF, CART and isolation forest reject MHLD as the JAX
    package does; unknown weight types raise."""
    kw = dict(label="label", device="cpu")
    rng = np.random.default_rng(0)
    data = {"f0": rng.normal(size=200).astype(np.float32),
            "c": np.array(["a", "b"] * 100),
            "label": rng.integers(0, 2, 200)}
    for extra, match in (
            (dict(task=ydf_tpu_torch.Task.REGRESSION),
             "only available for classification"),
            (dict(monotonic_constraints={"f0": 1}),
             "not supported with MHLD_OBLIQUE")):
        with pytest.raises(ValueError, match=match):
            ydf_tpu_torch.GradientBoostedTreesLearner(
                split_axis="MHLD_OBLIQUE", validation_ratio=0.0,
                num_trees=1, **extra, **kw).train(data)
    for bad, match in (({"nope": 1}, "Unknown monotonic"),
                       ({"c": 1}, "non-numerical")):
        with pytest.raises(ValueError, match=match):
            ydf_tpu_torch.GradientBoostedTreesLearner(
                split_axis="SPARSE_OBLIQUE", monotonic_constraints=bad,
                validation_ratio=0.0, num_trees=1, **kw).train(data)
    for cls in (ydf_tpu_torch.RandomForestLearner, ydf_tpu_torch.CartLearner):
        with pytest.raises(ValueError, match="split_axis"):
            cls(split_axis="MHLD_OBLIQUE", **kw)
    with pytest.raises(ValueError, match="split_axis"):
        ydf_tpu_torch.IsolationForestLearner(split_axis="MHLD_OBLIQUE",
                                             device="cpu")
    with pytest.raises(ValueError, match="sparse_oblique_weights"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            split_axis="SPARSE_OBLIQUE", sparse_oblique_weights="GAUSSIAN",
            **kw)


def test_train_oblique_fixture_matches_chip_smoke_constants():
    """The committed fixture is the configuration phase 12 drives."""
    smoke = load_chip_smoke()
    with open(os.path.join(TRAIN_OBLIQUE, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["jax_version"] == "0.9.0"
    assert cfg["gbt"]["rows"] == smoke.DEFAULT_ROWS
    assert cfg["gbt"]["test_rows"] == smoke.DEFAULT_TEST_ROWS
    assert cfg["gbt"]["learner"] == smoke.OBLIQUE_HP
    assert cfg["rf"]["rows"] == smoke.RF_ROWS
    assert cfg["rf"]["fixture_trees"] == smoke.OBLIQUE_RF_FIXTURE_TREES
    assert cfg["cart"]["rows"] == smoke.CART_ROWS
    assert cfg["iforest"]["rows"] == smoke.IF_ROWS
    for part in ("gbt", "rf", "cart", "iforest"):
        assert cfg[part]["num_projections"] == 28, part
    e = np.load(os.path.join(TRAIN_OBLIQUE, "expected.npz"))
    assert e["gbt/oblique_weights"].shape[0] == cfg["gbt"]["num_trees"]
    assert e["rf/tree_sha256"].shape[0] == cfg["rf"]["fixture_trees"]


def test_jax_saved_fixture_model_loads_and_predicts():
    """The JAX-saved full-width oblique GBT (train_oblique/gbt_model:
    28 projections a tree) on the CPU port: its predictions on the first
    1,024 test rows bitwise to the JAX Routed engine's, recorded by the
    fixture writer; the registry serves it routed."""
    with open(os.path.join(TRAIN_OBLIQUE, "config.json")) as f:
        cfg = json.load(f)
    e = np.load(os.path.join(TRAIN_OBLIQUE, "expected.npz"))
    head = {k.split("/", 1)[1]: e[k] for k in e.files
            if k.startswith("gbt_head/")}
    m = ydf_tpu_torch.load_model(os.path.join(TRAIN_OBLIQUE, "gbt_model"),
                                 device="cpu")
    assert m.list_compatible_engines() == ["Routed"]
    assert m.forest.num_trees == cfg["gbt"]["num_trees"]
    assert np.array_equal(m.forest.oblique_weights.numpy(),
                          e["gbt/oblique_weights"])
    assert m.predict(head).tobytes() == e["gbt/predictions"].tobytes()


# ---- on the card ----------------------------------------------------------


@pytest.mark.gpu
def test_oblique_trainings_on_card_match_cpu_port():
    """GBT, RF and isolation forest with sparse-oblique splits on the
    card and on the CPU: the same forests (node arrays, projections,
    thresholds) and predictions; the binning kernel launches once a tree
    for the projections."""
    _need_card()
    from ydf_tpu_torch.ops import binning

    data = gbt_frame(20_000, 3)
    cases = [
        (ydf_tpu_torch.GradientBoostedTreesLearner,
         dict(label="label", split_axis="SPARSE_OBLIQUE", num_trees=20,
              early_stopping_num_trees_look_ahead=5), data),
        (ydf_tpu_torch.RandomForestLearner,
         dict(label="label", split_axis="SPARSE_OBLIQUE", num_trees=5),
         data),
        (ydf_tpu_torch.IsolationForestLearner,
         dict(split_axis="SPARSE_OBLIQUE", num_trees=20),
         {k: v for k, v in data.items() if k != "label"}),
    ]
    for cls, hp, d in cases:
        binning.KERNEL_LAUNCHES = 0
        for k in histogram_kernels.LAUNCHES:
            histogram_kernels.LAUNCHES[k] = 0
        cm = cls(**hp).train(d)
        assert binning.KERNEL_LAUNCHES > cm.forest.num_trees // 3, cls
        assert histogram_kernels.LAUNCHES["histogram"] > 0, cls
        pm = cls(device="cpu", **hp).train(d)
        cf, pf = cm.forest.to_numpy(), pm.forest.to_numpy()
        for f in FOREST_FIELDS:
            assert cf[f].tobytes() == pf[f].tobytes(), (cls, f)
        assert cm.predict(d).tobytes() == pm.predict(d).tobytes(), cls
