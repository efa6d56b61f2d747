"""GBT row sampling and candidate features of ydf_tpu_torch
(learners/gbt.py, utils/prng.py:bernoulli, ops/grower.py's candidate
draws) held against the JAX package on the CPU, and the sampling
configurations of the committed fixture train_gbt_options trained by
the CPU port.

Every comparison is bitwise: the Bernoulli draws over many keys, shapes
and rates; GOSS masks on gradients whose magnitudes tie at the top-k
threshold (a value comparison keeps every tied row); the key chain's
k_sub and per-class tree keys fold_in(key, k); each tree's candidate
masks at every layer; and the trees, kept counts and predictions of the
fixture's configurations (their reported binomial losses within rtol
1e-5, the tolerance of the port's binomial loss).
"""

import types

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX.
    import jax
    import jax.numpy as jnp
except ImportError:
    jax = None

import ydf_tpu_torch
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.ops import grower
from ydf_tpu_torch.utils import prng

from test_torch_gbt_losses import check_option

torch.set_num_threads(1)


def require_jax():
    if jax is None:
        pytest.skip("needs the JAX package, the reference")


@pytest.mark.parametrize("p", [0.8, 0.125, 0.5, 1.0, 0.0, 1e-8])
def test_bernoulli_matches_jax(p):
    require_jax()
    shapes = [(1,), (7,), (1000,), (3, 17)]
    for seed in range(0, 64, 3):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        pkey = prng.fold_in(prng.prng_key(seed), 11)
        for shape in shapes:
            want = np.asarray(jax.random.bernoulli(jkey, p, shape))
            got = prng.bernoulli(pkey, p, shape).numpy()
            assert got.dtype == np.bool_ and np.array_equal(got, want), (
                seed, shape)


def jax_goss_mask(key, g, alpha, beta):
    """The JAX package's GOSS branch of sample_mask (ydf_tpu/learners/
    gbt.py:1154-1164), jitted."""
    n = g.shape[0]

    @jax.jit
    def mask(key, g):
        gmag = jnp.sum(jnp.abs(g), axis=1)
        k_top = max(int(alpha * n), 1)
        thr = jax.lax.top_k(gmag, k_top)[0][-1]
        top = gmag >= thr
        rest_p = min(beta / max(1.0 - alpha, 1e-6), 1.0)
        keep = jax.random.bernoulli(key, rest_p, (n,))
        upw = (1.0 - alpha) / max(beta, 1e-9)
        return jnp.where(top, 1.0, jnp.where(keep, upw, 0.0))

    return np.asarray(mask(key, g))


def goss_gradients(kind, K, rng):
    """g [n, K] whose |g| sums tie at the top-k threshold. "grid": values
    on a 1/8 grid, so hundreds of rows tie and every sum is exact in any
    order. "duplicated": 286 distinct rows of values spread over five
    decades, each repeated 7 times in a shuffled order, so the threshold
    (400 or 600 rows, not multiples of 7) falls inside a group of ties,
    and the K-term sum rounds differently in another order."""
    if kind == "grid":
        return (rng.integers(-8, 9, (2000, K)) / 8.0).astype(np.float32)
    distinct = (rng.standard_normal((286, K))
                * 10.0 ** rng.uniform(-3, 2, (286, K))).astype(np.float32)
    return distinct[rng.permutation(np.repeat(np.arange(286), 7))]


@pytest.mark.parametrize("kind", ["grid", "duplicated"])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("alpha,beta", [(0.2, 0.1), (0.3, 0.5)])
def test_goss_mask_with_forced_ties(kind, K, alpha, beta):
    require_jax()
    rng = np.random.default_rng(K)
    g = goss_gradients(kind, K, rng)
    n = g.shape[0]
    if kind == "duplicated" and K == 3:
        # The data tells class order from another reduce order.
        a = np.abs(g)
        assert ((a[:, 0] + a[:, 1]) + a[:, 2] != a[:, 0] + (a[:, 1]
                                                          + a[:, 2])).any()
    sampling = port_gbt.Sampling("GOSS", 1.0, alpha, beta)
    for it in range(3):
        keys = port_gbt.iteration_keys(7, 3, K, False, "cpu")
        loop = types.SimpleNamespace(sampling=sampling, keys=keys)
        got = port_gbt._Loop.sample_mask(loop, it, torch.from_numpy(g))
        jkey = jnp.asarray(keys.sub[it].numpy().astype(np.uint32))
        want = jax_goss_mask(jkey, g, alpha, beta)
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32))
        kept = int((got.numpy() == 1.0).sum())
        assert kept > max(int(alpha * n), 1)  # the ties at the threshold


def jax_key_chain(seed, T, K, with_vs):
    """k_sub and the tree keys of the JAX boosting step (gbt.py:1416,
    :1446-1449 and :1507): key, k_sub = split(fold_in(key, it)); with VS
    features key, k_vs = split(key); tree k's key fold_in(key, k)."""
    key = jax.random.PRNGKey(seed)
    subs, trees = [], []
    for it in range(T):
        key, k_sub = jax.random.split(jax.random.fold_in(key, it))
        if with_vs:
            key, _ = jax.random.split(key)
        subs.append(np.asarray(k_sub))
        trees.append([np.asarray(jax.random.fold_in(key, k))
                      for k in range(K)])
    return np.stack(subs), np.array(trees)


@pytest.mark.parametrize("with_vs", [False, True])
def test_iteration_keys_and_candidate_masks(with_vs):
    require_jax()
    T, K, F, k, depth, L = 4, 3, 13, 5, 5, 8
    keys = port_gbt.iteration_keys(123456, T, K, with_vs, "cpu")
    subs, trees = jax_key_chain(123456, T, K, with_vs)
    assert np.array_equal(keys.sub.numpy(), subs.astype(np.int64))
    assert np.array_equal(keys.tree.numpy(), trees.astype(np.int64))
    cols = grower.layer_columns(
        keys.tree.reshape(-1, 2), max_depth=depth, frontier=L,
        num_features=F, num_numerical=F, orderings=1, k=k)
    for t, kk in enumerate(trees.reshape(-1, 2)):
        key = jnp.asarray(kk.astype(np.uint32))
        for d in range(depth):
            key, _, k_feat = jax.random.split(jax.random.fold_in(key, d), 3)
            base = jax.random.uniform(k_feat, (min(2 ** d, L), F))
            kth = jax.lax.top_k(base, k)[0][:, -1]
            want = np.asarray(base >= kth[:, None])
            idx, ok = cols[d]
            got = np.zeros_like(want)
            rows = np.arange(want.shape[0])[:, None]
            got[rows, idx[t].long().numpy()] |= ok[t].numpy()
            assert np.array_equal(got, want), (t, d)
            # Each slot's kept columns first, ascending: the first best
            # cut is JAX's.
            for slot_idx, slot_ok in zip(idx[t].numpy(), ok[t].numpy()):
                kept = slot_idx[slot_ok]
                assert (np.diff(kept) > 0).all()
                assert slot_ok[:len(kept)].all()


def test_candidate_masks_keep_ties():
    """A tie at the k-th score lets every tied feature in (the JAX
    grower compares with the k-th value, not top_k's indices)."""
    scores = torch.tensor([[0.5, 0.25, 0.25, 0.75, 0.25]])
    assert grower.kept_by_score(scores, 3).tolist() == [
        [True, True, True, True, True]]
    idx, ok = grower.candidate_columns(grower.kept_by_score(scores, 2), 5)
    assert idx.tolist() == [[0, 3, 1, 2, 4]]
    assert ok.tolist() == [[True, True, False, False, False]]


@pytest.mark.parametrize("name", ["subsample", "goss", "candidates"])
def test_sampling_configuration_matches_the_fixture(name):
    """The CPU port on train_gbt_options' sampling configurations (20,000
    rows, 30 trees, every other default): every tree by hash, the kept
    count and the predictions bitwise."""
    check_option(name)


# ---- on the card -------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [
    dict(sampling_method="GOSS"),
    dict(subsample=0.8, num_candidate_attributes_ratio=0.5),
])
def test_sampling_on_card_matches_cpu(extra):
    """GOSS, and subsample with candidate features on three classes: the
    card's trees and predictions equal the CPU port's bitwise, and the
    boosting loop makes no host read (sync debug mode "error")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    rng = np.random.default_rng(4)
    n = 4000
    x = rng.normal(size=(n, 6)).astype(np.float32)
    data = {f"f{i}": x[:, i] for i in range(6)}
    z = x[:, 0] - x[:, 1] + rng.logistic(size=n)
    data["label"] = np.digitize(z, (-0.8, 0.8))
    kw = dict(label="label", num_trees=6, **extra)
    card = ydf_tpu_torch.GradientBoostedTreesLearner(**kw).train(data)
    cpu = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                    **kw).train(data)
    cf, pf = card.forest.to_numpy(), cpu.forest.to_numpy()
    for f in cf:
        assert cf[f].tobytes() == pf[f].tobytes(), f
    assert card.predict(data).tobytes() == cpu.predict(data).tobytes()
