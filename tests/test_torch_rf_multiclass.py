"""The random forest's split rules and its 3-class forest on
ydf_tpu_torch, held bitwise against the JAX package on the CPU:
ClassificationRule (entropy and gini: gains, leaf values, categorical
sort keys, one sorted order per class) and RegressionRule on seeded
histograms, and RandomForestLearner with every default on a 3-class
label with categorical columns (C = 3 orders per categorical feature,
Sq = 4 stat columns).

The gains are held against the JAX rules compiled by XLA for the CPU
(jax.jit), whose arithmetic the port replays (the same operations, the
fused multiply-adds, XLA's log); an exact tie between two cuts then
breaks the same way in both packages. The forest's tolerances are those
of tests/test_torch_random_forest.py: trees, leaf values and
predictions bitwise, metrics 1e-12.
"""

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.ops import split_rules as jax_rules
except ImportError:
    jax = None

import ydf_tpu_torch
from ydf_tpu_torch.ops import split_rules

torch.set_num_threads(1)
FOREST_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
                 "right", "is_leaf", "leaf_value", "cover", "num_nodes",
                 "threshold")


def require_jax():
    if jax is None:
        pytest.skip("needs the JAX package, the reference")


def class_histograms(C, seed, shape=(8, 6, 32)):
    """(left [.., B, C+1] prefix counts, right, parent) of seeded integer
    class counts, as a layer of a forest sees them."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, shape + (C,)).astype(np.float32)
    left = np.cumsum(counts, axis=-2)
    left = np.concatenate([left, left.sum(-1, keepdims=True)], -1)
    parent = left[..., -1:, :].copy()
    parent[..., :C] += rng.integers(0, 5, parent[..., :C].shape)
    parent[..., -1] = parent[..., :C].sum(-1)
    return left, parent - left, parent


def bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("C", [2, 3, 5])
@pytest.mark.parametrize("criterion", ["entropy", "gini"])
def test_classification_rule_matches_jax(C, criterion):
    require_jax()
    left, right, parent = class_histograms(C, C)
    jr = jax_rules.ClassificationRule(num_classes=C, criterion=criterion)
    pr = split_rules.ClassificationRule(num_classes=C, criterion=criterion)
    want = jax.jit(lambda a, b, c: jr.gain(a, b, c, None, None))(
        left, right, parent)
    got = pr.gain(*(torch.from_numpy(a) for a in (left, right, parent)))
    assert np.array_equal(bits(got.numpy()), bits(np.asarray(want)))
    for a in (left, parent):
        assert np.array_equal(
            bits(pr.leaf_value(torch.from_numpy(a)).numpy()),
            bits(np.asarray(jax.jit(lambda s: jr.leaf_value(s, None))(a))))
    assert pr.num_stats == jr.num_stats == C + 1
    assert pr.num_outputs == jr.num_outputs == C
    assert pr.num_cat_orderings == jr.num_cat_orderings
    hist = left[..., 1:, :] - left[..., :-1, :]
    assert np.array_equal(
        bits(pr.cat_sort_key(torch.from_numpy(hist)).numpy()),
        bits(np.asarray(jax.jit(lambda h: jr.cat_sort_key(h, None))(hist))))
    assert np.array_equal(
        bits(pr.cat_sort_keys(torch.from_numpy(hist)).numpy()),
        bits(np.asarray(jax.jit(lambda h: jr.cat_sort_keys(h, None))(hist))))


def test_regression_rule_matches_jax():
    require_jax()
    rng = np.random.default_rng(3)
    y = rng.normal(size=(8, 6, 32, 5)).astype(np.float32)
    w = rng.integers(0, 4, y.shape).astype(np.float32)
    cells = np.stack([(y * w).sum(-1), (y * y * w).sum(-1), w.sum(-1)], -1)
    left = np.cumsum(cells, axis=-2).astype(np.float32)
    parent = left[..., -1:, :] + np.abs(cells[..., :1, :])
    jr, pr = jax_rules.RegressionRule(), split_rules.RegressionRule()
    want = jax.jit(lambda a, b, c: jr.gain(a, b, c, None, None))(
        left, parent - left, parent)
    got = pr.gain(*(torch.from_numpy(a) for a in (left, parent - left,
                                                 parent)))
    assert np.array_equal(bits(got.numpy()), bits(np.asarray(want)))
    assert np.array_equal(
        bits(pr.leaf_value(torch.from_numpy(left)).numpy()),
        bits(np.asarray(jax.jit(lambda s: jr.leaf_value(s, None))(left))))
    assert np.array_equal(
        bits(pr.cat_sort_key(torch.from_numpy(cells)).numpy()),
        bits(np.asarray(jax.jit(lambda h: jr.cat_sort_key(h, None))(cells))))


@pytest.fixture(scope="module")
def multiclass():
    require_jax()
    from test_torch_random_forest import make_frame

    df = make_frame(3000, 1, "multiclass")
    kw = dict(label="label", num_trees=10)
    jm = ydf.RandomForestLearner(**kw).train(df)
    pm = ydf_tpu_torch.RandomForestLearner(device="cpu", **kw).train(df)
    return df, jm, pm


def test_multiclass_forest_grows_the_jax_trees(multiclass):
    """3 classes, 2 categorical columns scanned in 3 orders each: every
    node array, leaf value (the class distributions) and the out-of-bag
    evaluation equal; probabilities [n, 3] bitwise."""
    from test_torch_random_forest import (
        assert_same_forest,
        assert_same_metrics,
        make_frame,
    )

    df, jm, pm = multiclass
    assert_same_forest(jm, pm)
    assert pm.forest.leaf_value.shape[-1] == 3
    f = pm.forest
    assert bool((f.is_cat & ~f.is_leaf).any())
    assert_same_metrics(jm.oob_evaluation["metrics"],
                        pm.self_evaluation()["metrics"])
    test = make_frame(1000, 8, "multiclass")
    want = np.asarray(jm.predict(test))
    got = pm.predict(test)
    assert got.shape == (1000, 3) and got.tobytes() == want.tobytes()
    assert_same_metrics(jm.evaluate(test).metrics,
                        pm.evaluate(test).metrics)
