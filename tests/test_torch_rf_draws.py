"""The random forest's random draws on ydf_tpu_torch, held bitwise against
the JAX package (jax 0.9.0) on the CPU: XLA's CPU log
(utils/xla_cpu.py:log_f32), the Poisson(1) bootstrap counts
(utils/prng.py:poisson1) and the per-node candidate features
(ops/grower.py:candidate_masks), ties at the k-th score included.

Every comparison is bitwise: the draws are integers or masks, and the
log feeds the Knuth loop's `log_prod > -1` test, where one ulp turns into
a different count and so a different tree.
"""

import json
import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX.
    import jax
    import jax.numpy as jnp

    from ydf_tpu.ops import grower as jax_grower
    from ydf_tpu.ops.split_rules import ClassificationRule as JaxRule
except ImportError:
    jax = None

from ydf_tpu_torch.learners import random_forest
from ydf_tpu_torch.ops import grower
from ydf_tpu_torch.ops.split_rules import ClassificationRule
from ydf_tpu_torch.utils import prng
from ydf_tpu_torch.utils.xla_cpu import log_f32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_RF = os.path.join(REPO, "ydf_tpu_torch", "testdata", "train_rf")


def require_jax():
    if jax is None:
        pytest.skip("needs the JAX package, the reference")


def rf_config():
    with open(os.path.join(TRAIN_RF, "config.json")) as f:
        return json.load(f)


def test_log_matches_xla_on_every_uniform_value_and_the_f32_range():
    """Every value jax.random.uniform draws (k / 2^23) and 3 million
    floats over the whole f32 range (subnormals, 0, negatives, inf and
    NaN among them): bitwise to jnp.log."""
    require_jax()
    grid = (np.arange(1 << 23, dtype=np.float64) * 2.0 ** -23).astype(
        np.float32)
    rng = np.random.default_rng(0)
    spread = np.concatenate([
        rng.random(1_000_000).astype(np.float32),
        (10.0 ** rng.uniform(-13, 3, 1_000_000)).astype(np.float32),
        rng.integers(0, 0x7F800000, 1_000_000).astype(np.int32).view(
            np.float32),
        np.array([0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, 1e-45],
                 np.float32),
    ])
    for x in (grid, spread):
        want = np.asarray(jax.jit(jnp.log)(x))
        got = log_f32(torch.from_numpy(x)).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_poisson_matches_jax_for_the_fixture_draws():
    """The train_rf fixture's draws, every one of its 300 trees at its
    50,000 rows: poisson1 with the fixture's Knuth steps equals
    jax.random.poisson(k_boot, 1.0, (n,)) under the learner's key chain
    (fold_in(PRNGKey(seed), t), split into 4), checked against JAX and
    against the fixture's SHA-256 of each tree's counts."""
    require_jax()
    import hashlib

    cfg = rf_config()
    exp = np.load(os.path.join(TRAIN_RF, "expected.npz"))
    T, n, seed = cfg["num_trees"], cfg["rows"], cfg["seed"]

    @jax.jit
    def draws(ts):
        def one(t):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            return jax.random.poisson(jax.random.split(key, 4)[0], 1.0, (n,))
        return jax.vmap(one)(ts)

    keys = random_forest.tree_keys(seed, T, "cpu")[:, 0]
    for t0 in range(0, T, 50):
        got, stopped = prng.poisson1(keys[t0:t0 + 50], n, cfg["knuth_steps"])
        assert bool(stopped)
        got = got.numpy()
        assert np.array_equal(got, np.asarray(draws(jnp.arange(t0, t0 + 50))))
        for t, row in enumerate(got, t0):
            assert hashlib.sha256(row.astype(np.int32).tobytes()).digest() \
                == exp["boot_sha256"][t].tobytes(), t


def test_poisson_reports_rows_that_did_not_stop():
    """Too few steps: `stopped` is False; enough: the counts no longer
    change with more steps."""
    keys = random_forest.tree_keys(7, 3, "cpu")[:, 0]
    _, stopped = prng.poisson1(keys, 1000, 2)
    assert not bool(stopped)
    a, ok_a = prng.poisson1(keys, 1000, 16)
    b, ok_b = prng.poisson1(keys, 1000, 24)
    assert bool(ok_a) and bool(ok_b) and torch.equal(a, b)


def test_bootstrap_counts_redraw_with_more_steps(monkeypatch):
    """A first draw that does not stop is drawn again with twice the
    steps: the counts equal a draw with ample steps."""
    keys = random_forest.tree_keys(11, 4, "cpu")[:, 0]
    monkeypatch.setattr(random_forest, "POISSON_STEPS", 1)
    got = random_forest.bootstrap_counts(keys, 500)
    want, _ = prng.poisson1(keys, 500, 32)
    assert torch.equal(got.to(torch.int32), want)


def test_candidate_masks_match_jax_layer_by_layer():
    """Tree 0's masks at every layer of the fixture's configuration, from
    the tree's grow key: bitwise to the JAX grower's expressions (and to
    the fixture's SHA-256, JAX's own run)."""
    require_jax()
    import hashlib

    cfg = rf_config()
    exp = np.load(os.path.join(TRAIN_RF, "expected.npz"))
    F, k, L = cfg["num_features"], cfg["candidate_features"], cfg["frontier"]
    k_grow = random_forest.tree_keys(cfg["seed"], 1, "cpu")[:, 1]
    jkey = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(
        cfg["seed"]), 0), 4)[1]
    for d, k_feat in enumerate(grower.layer_feature_keys(k_grow, 16)):
        Ld = min(2 ** d, L)
        got = grower.candidate_masks(k_feat, Ld, F, k)[0].numpy()
        jkey, _, jk = jax.random.split(jax.random.fold_in(jkey, d), 3)
        base = jax.random.uniform(jk, (Ld, F))
        want = np.asarray(base >= jax.lax.top_k(base, k)[0][:, -1][:, None])
        assert np.array_equal(got, want), d
        assert hashlib.sha256(got.tobytes()).digest() == \
            exp["mask_sha256"][d].tobytes(), d
        assert got.sum() == exp["mask_kept"][d]


@pytest.mark.parametrize("levels", [2, 4, 7])
def test_kept_by_score_keeps_ties_like_top_k_by_value(levels):
    """Scores quantized to a few levels, so that ties at the k-th score
    are common: the mask equals JAX's `scores >= top_k(scores, k)[0][:,
    -1]`, more than k features in the tied slots."""
    require_jax()
    rng = np.random.default_rng(levels)
    scores = (np.floor(rng.random((64, 12)) * levels) / levels).astype(
        np.float32)
    for k in (1, 3, 5, 12):
        want = np.asarray(scores >= jax.lax.top_k(
            jnp.asarray(scores), k)[0][:, -1][:, None])
        got = grower.kept_by_score(torch.from_numpy(scores), k).numpy()
        assert np.array_equal(got, want)
    assert (got.sum(-1) >= 12).all()


@pytest.mark.parametrize("num_classes,num_cat", [(2, 2), (3, 2)])
def test_layer_decide_with_tied_candidate_scores_matches_jax(
        monkeypatch, num_classes, num_cat):
    """The JAX grower's layer_decide with its uniform scores quantized to
    three levels (ties at the k-th score in most slots) against the
    port's candidate columns from the same scores: the same chosen cut,
    feature and split in every slot. The class counts are seeded
    integers, so every gain is exact input; multiclass categoricals
    expand to C order columns."""
    require_jax()
    rng = np.random.default_rng(num_classes)
    Ld, Fn, B, C = 16, 5, 16, num_classes
    F = Fn + num_cat
    O = C if C > 2 else 1
    Fa = Fn + num_cat * O
    # Each slot's class counts spread over the bins of every column.
    total = rng.integers(5, 40, (Ld, C))
    counts = np.stack([np.stack([
        rng.multinomial(total[l, c], np.full(B, 1 / B)) for c in range(C)],
        -1) for l in range(Ld) for _ in range(Fa)]).reshape(Ld, Fa, B, C)
    csum = np.cumsum(counts, axis=2).astype(np.float32)
    left = np.concatenate([csum, csum.sum(-1, keepdims=True)], -1)
    parent = left[:, 0, -1, :].copy()
    ranks = np.argsort(rng.random((Ld, num_cat * O, B)), -1)
    k_feat = prng.split(prng.prng_key(5))[1]
    quant = lambda u: np.floor(u * 3) / 3  # noqa: E731
    scores = quant(prng.uniform(k_feat, (Ld, F)).numpy()).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(scores))
    k = 3
    jdec = jax_grower.layer_decide(
        jnp.asarray(left), jnp.asarray(ranks.reshape(Ld, num_cat, O, B)),
        None, jnp.asarray(parent), jnp.ones(Ld, bool),
        jnp.arange(Ld, dtype=jnp.int32), jnp.int32(Ld), None,
        jnp.zeros(2, jnp.uint32), None, rule=JaxRule(num_classes=C),
        L=64, B=B, N=4 * Ld, Fn=Fn, Fc=num_cat, O=O, Fs=0, W=1,
        min_examples=1, min_split_gain=1e-9, candidate_features=k,
        num_valid_features=None, children_in_frontier=True)
    cmask = grower.column_mask(
        grower.kept_by_score(torch.from_numpy(scores), k), Fn, O)
    cols = grower.candidate_columns(cmask, int(cmask.sum(-1).max()))
    dec = grower.layer_decide(
        torch.from_numpy(left), torch.from_numpy(ranks), torch.from_numpy(
            parent), torch.ones(Ld, dtype=torch.bool),
        torch.arange(Ld), torch.tensor(Ld, dtype=torch.int32),
        rule=ClassificationRule(num_classes=C), L=64, B=B, N=4 * Ld,
        num_numerical=Fn, min_examples=1, min_split_gain=1e-9,
        children_in_frontier=True, columns=cols)
    # Ties at the k-th score let more features in.
    assert (grower.kept_by_score(torch.from_numpy(scores), k).sum(-1)
            > k).any()
    split = np.asarray(jdec.do_split)
    assert np.array_equal(dec.do_split.numpy(), split)
    for ours, theirs in ((dec.best_f, jdec.best_f), (dec.best_t, jdec.best_t),
                         (dec.best_f_scalar, jdec.best_f_scalar)):
        assert np.array_equal(ours.numpy()[split], np.asarray(theirs)[split])
    assert np.array_equal(dec.go_left_bins.numpy()[split],
                          np.asarray(jdec.go_left_bins)[split])
