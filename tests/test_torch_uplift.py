"""Uplift forests on ydf_tpu_torch, held against the JAX package on the
CPU: UpliftEuclideanRule (gain, leaf value, sort key, split_valid)
against jax.jit of the JAX rule and the grower against the JAX grower on
tie-heavy uplift stats; qini_curve and the uplift evaluation; small
CATEGORICAL_UPLIFT and NUMERICAL_UPLIFT random forests trained by both
packages (tests/test_torch_uplift_cart.py holds the uplift CART and its
AUUC pruning); saves loaded in either direction; the GBT's refusal of
the uplift tasks; the routed kernel's refusal of F == 0; the kernels'
launch shapes at the uplift width S = 5.

Tolerances: trees, leaf values and predictions bitwise (the stats are
treatment-arm counts and sums of f32 outcomes in f64, the gain replays
XLA's arithmetic: a fused left mass, see ops/split_rules.py); metrics
within 1e-12 (host float64 on the same predictions).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.metrics import metrics as jax_metrics
    from ydf_tpu.ops import grower as jax_grower
    from ydf_tpu.ops.split_rules import UpliftEuclideanRule as JaxRule
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.metrics import metrics
from ydf_tpu_torch.ops import grower, histogram_kernels
from ydf_tpu_torch.ops.split_rules import UpliftEuclideanRule
from test_torch_random_forest import (
    assert_same_forest,
    assert_same_metrics,
    require_jax,
)

torch.set_num_threads(1)
ROWS = 3000
TREES = 4
# Depth 16, the default: the deep layers are where a cancelling cut
# passes min_split_gain only through chosen_gain.
HP = dict(label="y", uplift_treatment="treat", num_trees=TREES)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def uplift_frame(n, seed=0, numerical=False):
    """chip_smoke.make_uplift_frame's recipe at n rows (+ 800 test)."""
    from test_torch_default_train import load_chip_smoke

    smoke = load_chip_smoke()
    return smoke.make_uplift_frame(n, 800, seed=seed, numerical=numerical)


def uplift_stats(shape, rng, counts=True):
    """[..., 5] uplift stats: arm weights (integers), outcome sums (0/1
    outcomes, or f32 values), the known weight."""
    wc = rng.integers(0, 30, shape).astype(np.float32)
    wt = rng.integers(0, 30, shape).astype(np.float32)
    if counts:
        yc = np.floor(wc * rng.uniform(size=shape)).astype(np.float32)
        yt = np.floor(wt * rng.uniform(size=shape)).astype(np.float32)
    else:
        yc = (wc * rng.normal(size=shape)).astype(np.float32)
        yt = (wt * rng.normal(size=shape)).astype(np.float32)
    return np.stack([wc, yc, wt, yt, wc + wt], -1)


@pytest.mark.parametrize("counts", [True, False])
def test_rule_matches_jax_jit(counts):
    """gain, leaf value, categorical sort key and split_valid bitwise
    against jax.jit of the JAX rule (integer outcome sums tie often)."""
    require_jax()
    rng = np.random.default_rng(int(counts))
    parent = uplift_stats((4,), rng, counts) * 8
    left = uplift_stats((4, 5, 32), rng, counts)
    right = parent[:, None, None, :] - left
    p = parent[:, None, None, :]
    jr, pr = JaxRule(), UpliftEuclideanRule()
    t = [torch.from_numpy(a) for a in (left, right, p)]
    want = np.asarray(jax.jit(lambda a, b, c: jr.gain(a, b, c, None, None))(
        left, right, p))
    got = pr.gain(*t).numpy()
    assert got.tobytes() == want.tobytes()
    for name in ("leaf_value", "cat_sort_key"):
        want = np.asarray(jax.jit(lambda a: getattr(jr, name)(a, None))(left))
        assert getattr(pr, name)(t[0]).numpy().tobytes() == want.tobytes()
    want = np.asarray(jax.jit(jr.split_valid)(left, right))
    assert np.array_equal(pr.split_valid(t[0], t[1]).numpy(), want)


TIES_KW = dict(max_depth=5, frontier=16, max_nodes=64, num_bins=32,
               num_numerical=6, min_examples=5)


def jax_grow(bins, stats, key):
    """The JAX grower on uplift stats (one compile for every seed)."""
    global _JAX_GROW
    if _JAX_GROW is None:
        _JAX_GROW = jax.jit(lambda b, s, k: jax_grower.grow_tree(
            b, s, k, rule=JaxRule(), **TIES_KW))
    return _JAX_GROW(bins, stats, key)


_JAX_GROW = None


@pytest.mark.parametrize("seed", range(4))
def test_grower_breaks_uplift_ties_as_jax(seed):
    """A tree grown on uplift stats with duplicated features and 0/1
    outcomes (exact gain ties within and across features) equals the
    JAX grower's node for node."""
    require_jax()
    rng = np.random.default_rng(seed)
    n = 1200
    base = rng.integers(0, 6, (n, 3)).astype(np.uint8)
    bins = np.concatenate([base, base[:, ::-1]], 1)  # features tie
    t = (rng.uniform(size=n) < 0.4).astype(np.float32)
    y = (rng.uniform(size=n) < 0.3 + 0.2 * (base[:, 0] > 2) * t).astype(
        np.float32)
    stats = np.stack([1 - t, (1 - t) * y, t, t * y, np.ones(n, np.float32)],
                     1)
    want = jax_grow(jnp.asarray(bins), jnp.asarray(stats),
                    jax.random.PRNGKey(0))
    got = grower.grow_tree(torch.from_numpy(np.ascontiguousarray(bins.T)),
                           torch.from_numpy(stats),
                           rule=UpliftEuclideanRule(), **TIES_KW)
    for f in ("feature", "threshold_bin", "left", "right", "is_leaf",
              "leaf_stats", "num_nodes"):
        a = np.asarray(getattr(want.tree, f))
        b = getattr(got.tree, f).numpy()
        assert a.tobytes() == b.tobytes(), f
    assert np.array_equal(np.asarray(want.leaf_id), got.leaf_id.numpy())


def test_chosen_gain_fuses_the_parent_mass():
    """Where every mass cancels (both children keep the parent's uplift,
    0.8), the gain the argmax sees is 0 and the chosen cut's gain, as the
    JAX grower compares it with min_split_gain, is 2^-23: a split the
    JAX forests make (tree 3 of test_uplift_forest_grows_the_jax_trees's
    categorical forest, at depth 12)."""
    p = torch.tensor([16.0, 0, 10, 8, 26])
    left = torch.tensor([6.0, 0, 5, 4, 11])
    rule = UpliftEuclideanRule()
    assert rule.gain(left, p - left, p) == 0.0
    assert rule.chosen_gain(left, p - left, p) == 2.0 ** -23


@pytest.mark.parametrize("weighted", [False, True])
def test_qini_curve_and_evaluation_match_jax(weighted):
    """qini_curve (areas and curve points) and evaluate_predictions for
    both uplift tasks within 1e-12 of the JAX package's, ties in the
    predictions included."""
    require_jax()
    rng = np.random.default_rng(3)
    n = 3000
    pred = np.round(rng.normal(size=n), 1)  # ties
    treat = (rng.uniform(size=n) < 0.45).astype(np.int64)
    outcome = (rng.uniform(size=n) < 0.3 + 0.1 * treat).astype(np.int64)
    w = rng.uniform(0.5, 2, n) if weighted else None
    want = jax_metrics.qini_curve(pred, outcome, treat, weights=w)
    got = metrics.qini_curve(pred, outcome, treat, weights=w)
    for k in ("qini", "auuc"):
        assert abs(got[k] - want[k]) <= 1e-12
    for k in ("curve_fraction", "curve_uplift"):
        assert np.abs(got[k] - want[k]).max() <= 1e-12
    values = rng.normal(size=n)
    for task, labels in (("CATEGORICAL_UPLIFT", outcome),
                         ("NUMERICAL_UPLIFT", values)):
        jev = jax_metrics.evaluate_predictions(
            JaxTask[task], labels, pred, weights=w, treatments=treat)
        pev = metrics.evaluate_predictions(
            Task[task], labels, pred, weights=w, treatments=treat)
        assert_same_metrics(jev.metrics, pev.metrics)
        assert str(pev) == str(jev)
    with pytest.raises(AssertionError, match="needs treatments"):
        metrics.evaluate_predictions(Task.CATEGORICAL_UPLIFT, outcome, pred)


def train_pair(task, **kw):
    require_jax()
    train, test = uplift_frame(ROWS, numerical=task == "NUMERICAL_UPLIFT")
    hp = dict(HP, **kw)
    jm = ydf.RandomForestLearner(task=JaxTask[task], **hp).train(train)
    pm = ydf_tpu_torch.RandomForestLearner(task=Task[task], device="cpu",
                                           **hp).train(train)
    return train, test, jm, pm


@pytest.fixture(scope="module", params=["CATEGORICAL_UPLIFT",
                                        "NUMERICAL_UPLIFT"])
def forests(request):
    return request.param, train_pair(request.param)


def test_uplift_forest_grows_the_jax_trees(forests):
    """The trees node for node, the predicted uplifts bitwise, evaluate
    (Qini, AUUC; unseen treatments left out) within 1e-12, the
    treatment column in extra_metadata, no out-of-bag evaluation."""
    task, (train, test, jm, pm) = forests
    assert_same_forest(jm, pm)
    want = np.asarray(jm.predict(test))
    assert pm.predict(test).tobytes() == want.tobytes()
    assert_same_metrics(jm.evaluate(test).metrics, pm.evaluate(test).metrics)
    assert pm.extra_metadata == jm.extra_metadata == {
        "uplift_treatment": "treat"}
    assert pm.self_evaluation() is None and jm.oob_evaluation is None
    assert "treat" not in pm.binner.feature_names


def test_uplift_saves_load_both_ways(forests):
    task, (train, test, jm, pm) = forests
    with tempfile.TemporaryDirectory() as tmp:
        pm.save(os.path.join(tmp, "port"))
        jm.save(os.path.join(tmp, "jax"))
        back_jax = ydf.load_model(os.path.join(tmp, "port"))
        back_port = ydf_tpu_torch.load_model(os.path.join(tmp, "jax"),
                                             device="cpu")
    want = np.asarray(jm.predict(test))
    assert back_port.predict(test).tobytes() == want.tobytes()
    assert np.asarray(back_jax.predict(test)).tobytes() == want.tobytes()
    assert back_port.extra_metadata == jm.extra_metadata
    assert_same_metrics(back_jax.evaluate(test).metrics,
                        back_port.evaluate(test).metrics)


@pytest.mark.parametrize("case", ["no_treatment", "three_outcomes"])
def test_uplift_errors_match_jax(case):
    """An uplift task without a treatment column (ValueError) and a
    CATEGORICAL_UPLIFT outcome of three classes (NotImplementedError)
    raise the JAX package's errors."""
    require_jax()
    train, _ = uplift_frame(400)
    hp = dict(HP, num_trees=1)
    if case == "no_treatment":
        hp["uplift_treatment"] = None
        error, match = ValueError, "Uplift tasks require uplift_treatment="
    else:
        train = dict(train, y=np.digitize(train["x1"], [-0.5, 0.5]))
        error, match = NotImplementedError, "Only binary outcomes"
    for mod, task in ((ydf, JaxTask), (ydf_tpu_torch, Task)):
        extra = {} if mod is ydf else {"device": "cpu"}
        with pytest.raises(error, match=match):
            mod.RandomForestLearner(task=task.CATEGORICAL_UPLIFT, **hp,
                                    **extra).train(train)


def test_missing_treatment_column_raises():
    """uplift_treatment names a column the data lacks: the port's _need
    says so (the JAX package's check of a dataset cache's columns; on
    in-memory data its dataspec lookup raises KeyError)."""
    train, _ = uplift_frame(300)
    del train["treat"]
    with pytest.raises(ValueError, match="needs column 'treat'"):
        ydf_tpu_torch.RandomForestLearner(
            task=Task.CATEGORICAL_UPLIFT, device="cpu",
            **dict(HP, num_trees=1)).train(train)


def test_gbt_refuses_the_uplift_tasks_as_jax():
    """The GBT has no default loss for an uplift task: the same
    ValueError as the JAX package's make_loss, at train time."""
    require_jax()
    train, _ = uplift_frame(400)
    for task in ("CATEGORICAL_UPLIFT", "NUMERICAL_UPLIFT"):
        msgs = []
        for mod, T in ((ydf, JaxTask), (ydf_tpu_torch, Task)):
            extra = {} if mod is ydf else {"device": "cpu"}
            with pytest.raises(ValueError, match="No default GBT loss") as e:
                mod.GradientBoostedTreesLearner(
                    label="y", task=T[task], num_trees=2,
                    **extra).train(train)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_routed_kernel_refuses_no_scalar_feature():
    """histogram_routed raises at F == 0 on either device instead of
    handing back unwritten slots (the grower routes set-only rows through
    route_plain)."""
    n, L, B = 64, 4, 32
    tables = histogram_kernels.RouteTables(
        do_split=torch.zeros(L + 1, dtype=torch.bool),
        route_f=torch.zeros(L + 1, dtype=torch.int32),
        go_left=torch.zeros((L + 1, B), dtype=torch.bool),
        left_id=torch.zeros(L + 1, dtype=torch.int32),
        right_id=torch.zeros(L + 1, dtype=torch.int32),
        split_rank=torch.zeros(L + 1, dtype=torch.int32),
        hmap=torch.arange(L + 1, dtype=torch.int32),
        is_set=torch.zeros(L + 1, dtype=torch.bool),
        set_go_left=torch.zeros(1, dtype=torch.uint8))
    args = (torch.zeros((0, n), dtype=torch.uint8),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32), tables,
            torch.ones((n, 5)), 2, B)
    with pytest.raises(ValueError, match="F == 0"):
        histogram_kernels.histogram_routed(*args)
    # route_plain takes the JAX chain's all-right branch.
    new_slot, new_leaf, _ = histogram_kernels.route_plain(*args[:4])
    assert torch.equal(new_slot, torch.full((n,), L, dtype=torch.int32))


@pytest.mark.parametrize("n", [20_000, 50_000, 90_000])
def test_launch_shapes_fit_at_five_stats(n):
    """The routed kernel's launch shape at the uplift width (S = 5, f64
    cells, L = 1024, F = 20) keeps the shared memory under
    ROUTED_SMEM_LIMIT at every hist-slot count of a depth-16 tree, and
    the root kernel's sub-histograms (F = 20, and the set prefix shape
    F = 1) fit its budget."""
    hk = histogram_kernels
    for Lh in [2 ** k for k in range(10)]:
        shape = hk.routed_launch_shape(n, 20, Lh, 256, 5, 1024, 8)
        assert shape.smem <= hk.ROUTED_SMEM_LIMIT, (Lh, shape)
        assert shape.Lb >= 1 and shape.G * shape.Fb >= 20, (Lh, shape)
        assert shape.slot_blocks * shape.Lb >= Lh, (Lh, shape)
    for F, L, B in ((20, 1, 256), (1, 1, 256), (1, 32, 64)):
        root = hk.root_launch_shape(n, F, L, B, 5, 8)
        assert root.Fb * root.Lb * B * hk.cell_stride(5) * 8 <= \
            hk.ROOT_SMEM_BUDGET, (F, L, root)
        assert root.G * root.Fb >= F and root.slot_blocks * root.Lb >= L


def test_train_uplift_fixture_matches_chip_smoke_constants():
    """The committed train_uplift fixture is the configuration phase 15
    drives, and chip_smoke.make_uplift_frame still writes its frames."""
    import json

    from test_torch_default_train import load_chip_smoke

    smoke = load_chip_smoke()
    root = smoke.TRAIN_UPLIFT
    with open(os.path.join(root, "config.json")) as f:
        cfg = json.load(f)
    rf, c, num = cfg["rf"], cfg["cart"], cfg["numerical"]
    assert (rf["rows"], rf["test_rows"], c["rows"], num["rows"],
            num["num_trees"]) == (smoke.UPLIFT_ROWS, smoke.UPLIFT_TEST_ROWS,
                                  smoke.UPLIFT_CART_ROWS,
                                  smoke.UPLIFT_NUM_ROWS,
                                  smoke.UPLIFT_NUM_TREES)
    assert cfg["generator"] == dict(features=smoke.UPLIFT_FEATURES,
                                    seed=smoke.UPLIFT_SEED)
    assert rf["learner"] == dict(label="y", uplift_treatment="treat")
    train, test = smoke.make_uplift_frame(rf["rows"], rf["test_rows"])
    assert smoke.frame_sha256(train) == rf["train_sha256"]
    assert smoke.frame_sha256(test) == rf["test_sha256"]
    exp = np.load(os.path.join(root, "expected.npz"))
    assert exp["rf/tree_sha256"].shape == (rf["fixture_trees"], 32)
    assert exp["numerical/tree_sha256"].shape == (num["num_trees"], 32)
    assert c["num_pruned_nodes"] > 0


@pytest.mark.gpu
def test_uplift_forest_on_card_matches_cpu():
    """A CATEGORICAL_UPLIFT forest of 3 trees trained on the card equals
    the CPU port's (the routed kernel at S = 5 with float outcome sums in
    f64 cells on the NUMERICAL_UPLIFT case)."""
    _need_card()
    for numerical in (False, True):
        train, test = uplift_frame(8000, numerical=numerical)
        task = Task.NUMERICAL_UPLIFT if numerical else \
            Task.CATEGORICAL_UPLIFT
        kw = dict(HP, num_trees=3, max_depth=10, task=task)
        before = histogram_kernels.LAUNCHES["histogram_routed"]
        gm = ydf_tpu_torch.RandomForestLearner(device="cuda", **kw).train(
            train)
        assert histogram_kernels.LAUNCHES["histogram_routed"] > before
        cm = ydf_tpu_torch.RandomForestLearner(device="cpu", **kw).train(
            train)
        g, c = gm.forest.to_numpy(), cm.forest.to_numpy()
        for f in ("feature", "threshold_bin", "left", "right", "is_leaf",
                  "leaf_value", "num_nodes"):
            assert np.asarray(g[f]).tobytes() == np.asarray(c[f]).tobytes(), f
        assert gm.predict(test).tobytes() == cm.predict(test).tobytes()
