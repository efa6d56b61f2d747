"""DART (dart_dropout > 0) on ydf_tpu_torch's GBT, held against the JAX
package on the CPU: the key chain's three-way split and the drop masks,
the dropped iterations' sum in XLA's dot order (dart_dot against
jax.jit of the learner's einsum), whole trainings with the validation
split and the look-ahead stop (kept count, every tree, the leaf values
with each iteration's final weight baked in), chunked or not, at one
output and three; and the train_dart fixture's configuration against
chip_smoke.py's constants.

Tolerance: bitwise (keys, masks, sums, node arrays, leaf values,
predictions); the reported binomial losses within rtol 1e-5 (torch's
log-sigmoid, as in every other GBT test); evaluation metrics within
1e-12.
"""

import json
import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.learners import gbt as port_gbt
from test_torch_default_train import load_chip_smoke
from test_torch_monotone import frame

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_DART = os.path.join(REPO, "ydf_tpu_torch", "testdata", "train_dart")
NODE_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
               "right", "is_leaf", "num_nodes", "threshold")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("with_oblique", [False, True])
def test_key_chain_and_drop_masks_match_jax(with_oblique):
    """key, k_sub, k_drop = split(fold_in(key, it), 3), then k_proj, and
    each iteration's bernoulli(k_drop, p, (T,)) & (arange(T) < it)."""
    require_jax()
    T, p = 40, 0.1
    keys = port_gbt.iteration_keys(5, T, 2, False, "cpu",
                                   with_oblique=with_oblique,
                                   with_dart=True)
    drops = port_gbt.dart_drops(keys.drop, p).numpy()
    key = jax.random.PRNGKey(5)
    for it in range(T):
        key, k_sub, k_drop = jax.random.split(jax.random.fold_in(key, it),
                                              3)
        if with_oblique:
            key, k_proj = jax.random.split(key)
            assert np.array_equal(keys.proj[it].numpy(), np.asarray(k_proj))
        assert np.array_equal(keys.sub[it].numpy(), np.asarray(k_sub))
        assert np.array_equal(keys.drop[it].numpy(), np.asarray(k_drop))
        want = np.asarray(jax.random.bernoulli(k_drop, p, (T,))
                          & (jnp.arange(T) < it))
        assert np.array_equal(drops[it], want), it
        tree = np.asarray(jax.random.fold_in(key, 1))
        assert np.array_equal(keys.tree[it, 1].numpy(), tree)
    assert drops.sum() > 20


@pytest.mark.parametrize("T,K,it", [(300, 1, 299), (300, 3, 120),
                                    (150, 1, 149), (20, 1, 19),
                                    (300, 1, 30)])
def test_dart_dot_matches_the_xla_einsum(T, K, it):
    """einsum("t,tnk->nk", drop * tree_scale, contrib) as jax.jit runs
    it, bitwise; the lanes' order matters (one chain differs)."""
    require_jax()
    rng = np.random.default_rng(T + K + it)
    n = 3000
    drop = (rng.uniform(size=T) < 0.4) & (np.arange(T) < it)
    scale = rng.uniform(0.2, 1.0, T).astype(np.float32)
    contrib = (rng.normal(size=(T, n, K)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda d, s, c: jnp.einsum("t,tnk->nk", d * s, c))(
            drop, scale, contrib))
    got = port_gbt.dart_dot(torch.from_numpy(drop) * torch.from_numpy(scale),
                            torch.from_numpy(contrib), it).numpy()
    assert np.array_equal(bits(got), bits(want))
    w = (drop * scale).astype(np.float32)
    chain = np.zeros((n, K), np.float32)
    for t in range(T):
        chain = (chain.astype(np.float64)
                 + np.float64(w[t]) * contrib[t]).astype(np.float32)
    if T >= 32 and it > 32:
        assert not np.array_equal(chain, want)


@pytest.mark.parametrize("chunk", [25, 7])
def test_dart_training_grows_the_jax_trees(monkeypatch, chunk):
    """The default GBT with dart_dropout=0.1 at 150 iterations (the
    validation split, the look-ahead stop in chunks of 25, the JAX
    package's): kept and trained counts, every node array, the baked
    leaf values, the losses and predictions bitwise. In chunks of 7 the
    stop is read at other iterations, so more or fewer iterations run:
    the kept trees' node arrays do not change, their leaf values do
    (each iteration's weight is the one left after the last trained
    iteration), as in the JAX package."""
    require_jax()
    data = frame(3000, seed=3)
    fresh = frame(600, seed=4)
    kw = dict(label="label", dart_dropout=0.1, num_trees=150)
    jm = ydf.GradientBoostedTreesLearner(**kw).train(data)
    monkeypatch.setattr(port_gbt, "MAX_CHUNK_TREES", chunk)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        device="cpu", **kw).train(data)
    jl, pl = jm.training_logs, pm.training_logs
    assert pl["num_trees"] == jl["num_trees"]
    assert jl["num_trees_trained"] < 150  # the look-ahead stop fired
    for key in ("train_loss", "valid_loss"):
        # The binomial reported loss is torch's (rtol 1e-5, as in
        # test_torch_default_train.py); the kept count above is exact.
        np.testing.assert_allclose(pl[key], jl[key], rtol=1e-5)
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    for field in NODE_FIELDS:
        assert np.array_equal(pf[field], jf[field]), field
    if chunk != 25:
        assert pl["num_trees_trained"] != jl["num_trees_trained"]
        return
    assert pl["num_trees_trained"] == jl["num_trees_trained"]
    assert np.array_equal(bits(pf["leaf_value"]), bits(jf["leaf_value"]))
    assert np.array_equal(bits(pm.predict(fresh)),
                          bits(np.asarray(jm.predict(fresh))))
    je, pe = jm.evaluate(fresh).metrics, pm.evaluate(fresh).metrics
    for k, v in je.items():
        assert abs(pe[k] - v) <= 1e-12, k


def test_dart_three_classes_grow_the_jax_trees():
    """K = 3 trees an iteration under DART, no validation split (every
    iteration kept, so the last weights are baked into all of them)."""
    require_jax()
    data = frame(2000, seed=6, classes=3)
    kw = dict(label="label", dart_dropout=0.2, num_trees=20,
              validation_ratio=0.0)
    jm = ydf.GradientBoostedTreesLearner(**kw).train(data)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        device="cpu", **kw).train(data)
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    assert pf["feature"].shape[0] == 60
    for field in NODE_FIELDS:
        assert np.array_equal(pf[field], jf[field]), field
    assert np.array_equal(bits(pf["leaf_value"]), bits(jf["leaf_value"]))


def test_dart_dropout_is_checked():
    with pytest.raises(ValueError, match="dart_dropout"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="label", dart_dropout=1.0, device="cpu")


def test_train_dart_fixture_matches_chip_smoke_constants():
    """The committed fixture is the configuration phase 13 drives."""
    smoke = load_chip_smoke()
    with open(os.path.join(TRAIN_DART, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["gbt"]["rows"] == smoke.DART_ROWS
    assert cfg["gbt"]["test_rows"] == smoke.DART_TEST_ROWS
    assert cfg["gbt"]["learner"] == smoke.DART_HP
    exp = np.load(os.path.join(TRAIN_DART, "expected.npz"))
    assert exp["gbt/tree_sha256"].shape == (cfg["gbt"]["num_trees"], 32)
