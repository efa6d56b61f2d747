"""Honest trees on ydf_tpu_torch, held against the JAX package on the
CPU: the leaf re-estimation (random_forest.honest_leaf_stats) against
jax.ops.segment_sum, and honest random forests (classification and
regression, two estimation ratios) and an honest CART trained by both
packages: trees, leaf values, predictions, out-of-bag and evaluate
metrics.

Tolerances: trees, leaf values and predictions bitwise (the estimation
draw is jax.random.bernoulli's, the re-estimated sums add each leaf's
rows in row order as XLA's CPU scatter-add does); metrics within 1e-12.

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.learners import random_forest
from ydf_tpu_torch.ops import grower, segment_sum
from test_torch_random_forest import (
    assert_same_forest,
    assert_same_metrics,
    make_frame,
    require_jax,
)

torch.set_num_threads(1)
ROWS = 2000
TREES = 4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def leaf_case(n, N, S, seed):
    """A tree's leaf flags and stats, each row's leaf, estimation stats
    (zero on the rows that grew the tree)."""
    rng = np.random.default_rng(seed)
    is_leaf = rng.uniform(size=N) < 0.6
    leaves = np.flatnonzero(is_leaf[:N - 3])  # some leaves get no row
    leaf_id = rng.choice(leaves, n).astype(np.int32)
    est = rng.uniform(size=n) < 0.5
    stats = (rng.normal(size=(n, S)) * 3).astype(np.float32)
    stats[:, -1] = rng.integers(0, 4, n)
    stats *= est[:, None]
    grown = rng.normal(size=(N, S)).astype(np.float32)
    return is_leaf, leaf_id, stats, grown


@pytest.mark.parametrize("S", [3, 5])
def test_honest_leaf_stats_match_jax_segment_sum(S):
    """The re-estimated leaf stats bitwise to _rf_run_chunk's expression
    under jax.jit (segment_sum in row order, the grown stats kept where a
    leaf drew no estimation weight and on split nodes)."""
    require_jax()
    is_leaf, leaf_id, stats, grown = leaf_case(20_000, 301, S, S)

    @jax.jit
    def want_fn(stats, leaf_id, grown, is_leaf):
        seg = jax.ops.segment_sum(stats, leaf_id, num_segments=grown.shape[0])
        use = (is_leaf & (seg[..., -1] > 0))[:, None]
        return jnp.where(use, seg, grown)

    want = np.asarray(want_fn(stats, leaf_id, grown, is_leaf))
    tree = grower.TreeArrays(*([None] * 7), is_leaf=torch.from_numpy(is_leaf),
                             leaf_stats=torch.from_numpy(grown),
                             num_nodes=None)
    got = random_forest.honest_leaf_stats(
        tree, torch.from_numpy(leaf_id), torch.from_numpy(stats))
    assert got.numpy().tobytes() == want.tobytes()


def train_pair(task, rows=ROWS, cls="RandomForestLearner", **kw):
    require_jax()
    df = make_frame(rows, 4, task)
    hp = dict(label="label", honest=True, max_depth=6, **kw)
    if cls == "RandomForestLearner":
        hp.update(num_trees=TREES)
    jkw, pkw = {}, {}
    if task == "regression":
        jkw, pkw = dict(task=JaxTask.REGRESSION), dict(task=Task.REGRESSION)
    jm = getattr(ydf, cls)(**hp, **jkw).train(df)
    pm = getattr(ydf_tpu_torch, cls)(device="cpu", **hp, **pkw).train(df)
    return df, jm, pm


@pytest.mark.parametrize("task,ratio", [("binary", 0.5),
                                        ("regression", 0.5),
                                        ("binary", 0.3)])
def test_honest_forest_grows_the_jax_trees(task, ratio):
    """Honest forests node for node with their re-estimated leaf values,
    predictions bitwise, out-of-bag and evaluate metrics within 1e-12."""
    df, jm, pm = train_pair(task, honest_ratio_leaf_examples=ratio)
    assert_same_forest(jm, pm)
    test = make_frame(1000, 9, task)
    want = np.asarray(jm.predict(test))
    assert pm.predict(test).tobytes() == want.tobytes()
    assert_same_metrics(jm.evaluate(test).metrics, pm.evaluate(test).metrics)
    assert_same_metrics(jm.oob_evaluation["metrics"],
                        pm.self_evaluation()["metrics"])


def test_honest_cart_matches_jax():
    """CartLearner(honest=True): the JAX package grows the structure on
    the rows outside the estimation draw, re-estimates the leaves, then
    prunes on the holdout; so does the port, node for node."""
    df, jm, pm = train_pair("binary", rows=3000, cls="CartLearner")
    assert_same_forest(jm, pm)
    assert pm.extra_metadata == jm.extra_metadata


def test_honest_loop_makes_no_extra_host_read():
    """The estimation draw and the re-estimation run on the device: an
    honest forest reads the host as often as a plain one."""
    df = make_frame(800, 5)
    reads = []
    for honest in (False, True):
        before = random_forest.HOST_READS
        ydf_tpu_torch.RandomForestLearner(
            label="label", num_trees=3, max_depth=5, honest=honest,
            device="cpu").train(df)
        reads.append(random_forest.HOST_READS - before)
    assert reads[0] == reads[1]


def test_train_honest_fixture_matches_chip_smoke_constants():
    """The committed train_honest fixture is the configuration phase 15
    drives, on train_rf's frame."""
    import json
    import os

    from test_torch_default_train import load_chip_smoke

    smoke = load_chip_smoke()
    with open(os.path.join(smoke.TRAIN_HONEST, "config.json")) as f:
        cfg = json.load(f)
    rf, reg = cfg["rf"], cfg["regression"]
    assert (rf["rows"], rf["test_rows"], reg["rows"], reg["num_trees"]) == (
        smoke.RF_ROWS, smoke.RF_TEST_ROWS, smoke.HONEST_REG_ROWS,
        smoke.HONEST_REG_TREES)
    assert rf["learner"] == smoke.HONEST_HP
    train, test = smoke.make_frame(reg["rows"], reg["test_rows"])
    train["target"] = smoke.multitask_target(train)
    assert smoke.frame_sha256(train) == reg["train_sha256"]
    exp = np.load(os.path.join(smoke.TRAIN_HONEST, "expected.npz"))
    assert exp["rf/tree_sha256"].shape == (rf["fixture_trees"], 32)


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["binary", "regression"])
def test_honest_forest_on_card_matches_cpu(task):
    """An honest forest trained on the card equals the CPU port's (the
    re-estimated float sums through csrc/segment_sum.cu, one launch a
    tree)."""
    _need_card()
    df = make_frame(20_000, 4, task)
    test = make_frame(1000, 9, task)
    kw = dict(label="label", honest=True, num_trees=4, max_depth=12)
    if task == "regression":
        kw["task"] = Task.REGRESSION
    before = segment_sum.KERNEL_LAUNCHES
    gm = ydf_tpu_torch.RandomForestLearner(device="cuda", **kw).train(df)
    assert segment_sum.KERNEL_LAUNCHES == before + 4
    cm = ydf_tpu_torch.RandomForestLearner(device="cpu", **kw).train(df)
    g, c = gm.forest.to_numpy(), cm.forest.to_numpy()
    for f in ("feature", "threshold_bin", "left", "right", "is_leaf",
              "leaf_value", "num_nodes"):
        assert np.asarray(g[f]).tobytes() == np.asarray(c[f]).tobytes(), f
    assert gm.predict(test).tobytes() == cm.predict(test).tobytes()
