"""ydf_tpu_torch/utils/prng.py held bitwise against jax.random and the jnp
functions whose rounding the vector-sequence learner depends on (jax
0.9.0, threefry2x32, jax_threefry_partitionable=True).

Every comparison is bitwise: keys, random words, uniforms, randint and
choice results, the blocked cumulative sum, linspace and the quantiles.
Where XLA rounds a jnp function differently by context, the reference
is the context the JAX package's learner runs it in: linspace with
constant bounds inside a jitted program, and the quantiles feeding the
binning searchsorted in one program.
"""

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX.
    import jax
    import jax.numpy as jnp
except ImportError:
    jax = None

from ydf_tpu_torch.utils import prng


@pytest.fixture(autouse=True)
def _require_jax():
    if jax is None:
        pytest.skip("needs JAX, the reference")


def as_np(x):
    return np.asarray(x)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a = a.view(np.int32)
    if b.dtype == np.float32:
        b = b.view(np.int32)
    return a.shape == b.shape and np.array_equal(a, b)


def key_np(seed=123456):
    return jax.random.PRNGKey(seed)


def key_t(key):
    return torch.from_numpy(as_np(key).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 123456, 2**31 + 5, 2**32 - 1])
def test_prng_key(seed):
    assert same(prng.prng_key(seed).numpy(),
                as_np(jax.random.PRNGKey(seed)).astype(np.int64))


@pytest.mark.parametrize("data", [0, 1, 19, 2**31, 2**32 - 1])
def test_fold_in(data):
    k = key_np()
    assert same(prng.fold_in(key_t(k), data).numpy(),
                as_np(jax.random.fold_in(k, data)).astype(np.int64))


@pytest.mark.parametrize("num", [2, 3, 48])
def test_split(num):
    k = key_np()
    want = as_np(jax.random.split(k, num)).astype(np.int64)
    assert same(prng.split(key_t(k), num).numpy(), want)
    jitted = as_np(jax.jit(lambda kk: jax.random.split(kk, num))(k))
    assert same(prng.split(key_t(k), num).numpy(), jitted.astype(np.int64))


@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 4), (1001,)])
def test_bits_and_uniform(shape):
    k = key_np(7)
    assert same(prng.random_bits(key_t(k), shape).numpy(),
                as_np(jax.random.bits(k, shape)).astype(np.int64))
    want = as_np(jax.random.uniform(k, shape))
    assert same(prng.uniform(key_t(k), shape).numpy(), want)
    jitted = as_np(jax.jit(lambda kk: jax.random.uniform(kk, shape))(k))
    assert same(prng.uniform(key_t(k), shape).numpy(), jitted)


def test_batched_keys_match_vmap():
    """Leading key dims batch the draws as jax.vmap over keys does."""
    ks = jax.random.split(key_np(3), 48)
    want = as_np(jax.jit(jax.vmap(lambda kk: jax.random.uniform(kk)))(ks))
    assert same(prng.uniform(key_t(ks)).numpy(), want)
    pairs = as_np(jax.vmap(jax.random.split)(ks)).astype(np.int64)
    assert same(prng.split(key_t(ks)).numpy(), pairs)


@pytest.mark.parametrize("maxval", [1, 2, 3, 7, 16, 1000, 0, -3, 2**31 - 1])
def test_randint(maxval):
    k = key_np(11)
    want = as_np(jax.random.randint(k, (50,), 0, maxval))
    assert same(prng.randint(key_t(k), (50,), 0, maxval).numpy(), want)


def test_randint_device_maxval_under_jit_vmap():
    """The learner's form: randint(k, (), 0, max(len[idx], 1)) with a
    traced maxval, vmapped over keys."""
    ks = jax.random.split(key_np(5), 48)
    maxvals = np.arange(48, dtype=np.int32) % 17
    f = jax.jit(jax.vmap(lambda kk, m: jax.random.randint(
        kk, (), 0, jnp.maximum(m, 1))))
    got = prng.randint(key_t(ks), (), 0,
                       torch.clamp_min(torch.from_numpy(maxvals), 1))
    assert same(got.numpy(), as_np(f(ks, maxvals)))


def _probabilities(n, seed):
    """Uniform over a random 90% of the rows (zeros elsewhere), as the
    learner's row choice over non-empty sequences."""
    rng = np.random.default_rng(seed)
    ne = (rng.uniform(size=n) < 0.9).astype(np.float32)
    return ne / np.float32(max(ne.sum(), 1.0))


@pytest.mark.parametrize("n", [1, 16, 17, 256, 257, 4097, 200_000])
def test_cumsum_blocked_scan(n):
    for x in (_probabilities(n, n),
              np.random.default_rng(n).normal(size=n).astype(np.float32)):
        got = prng.cumsum_f32(torch.from_numpy(x)).numpy()
        assert same(got, as_np(jnp.cumsum(x)))
        assert same(got, as_np(jax.jit(jnp.cumsum)(x)))


@pytest.mark.parametrize("n", [1, 17, 1000, 200_000])
def test_choice_with_probabilities(n):
    ks = jax.random.split(key_np(n), 48)
    p = _probabilities(n, n + 1)
    if n == 1:
        p = np.ones(1, np.float32)
    want = as_np(jax.jit(jax.vmap(
        lambda kk: jax.random.choice(kk, n, p=jnp.asarray(p))))(ks))
    got = prng.choice(key_t(ks), n, torch.from_numpy(p))
    assert same(got.numpy(), want)
    eager = as_np(jax.random.choice(ks[0], n, p=jnp.asarray(p)))
    assert same(prng.choice(key_t(ks[0]), n, torch.from_numpy(p)).numpy(),
                eager)


@pytest.mark.parametrize("num_bins", [32, 64, 128, 256])
def test_linspace_as_the_learner_computes_it(num_bins):
    B = num_bins
    want = as_np(jax.jit(
        lambda: jnp.linspace(1.0 / B, 1.0 - 1.0 / B, B - 1))())
    assert same(prng.linspace_f32(1.0 / B, 1.0 - 1.0 / B, B - 1).numpy(),
                want)


@pytest.mark.parametrize("n,cols", [(17, 3), (3000, 32), (200_000, 32)])
def test_quantile_boundaries_and_bins(n, cols):
    """The learner's program (gbt.py:1326-1369): quantiles at the B-1
    linspace points, transposed, clamped at -1e29, and the scores binned
    by searchsorted(side="right") against them."""
    B = 256
    a = np.random.default_rng(n).normal(size=(n, cols)).astype(np.float32)
    a[: n // 10] = np.finfo(np.float32).min  # empty sequences' scores

    def program(s):
        qs = jnp.linspace(1.0 / B, 1.0 - 1.0 / B, B - 1)
        bnd = jnp.maximum(jnp.quantile(s, qs, axis=0).T, -1e29)
        cols_ = jax.vmap(lambda b, zz: jnp.searchsorted(b, zz, side="right")
                         )(bnd, s.T)
        return bnd, cols_.astype(jnp.uint8)

    want_bnd, want_cols = (as_np(x) for x in jax.jit(program)(a))
    qs = prng.linspace_f32(1.0 / B, 1.0 - 1.0 / B, B - 1)
    bnd = torch.clamp_min(
        prng.quantile_linear(torch.from_numpy(a), qs, dim=0).t(), -1e29)
    assert same(bnd.numpy(), want_bnd)
    got_cols = prng.searchsorted_scan(
        bnd.contiguous(), torch.from_numpy(a).t().contiguous(), right=True)
    assert np.array_equal(got_cols.numpy().astype(np.uint8), want_cols)


def test_searchsorted_scan_matches_jnp_on_unsorted_rows():
    """The scan binary search returns jnp's index even where rounding
    left the array out of order."""
    rng = np.random.default_rng(0)
    arr = np.sort(rng.normal(size=37)).astype(np.float32)
    arr[[5, 20]] = arr[[20, 5]]
    q = rng.normal(size=200).astype(np.float32)
    for right in (False, True):
        side = "right" if right else "left"
        want = as_np(jnp.searchsorted(arr, q, side=side))
        got = prng.searchsorted_scan(torch.from_numpy(arr),
                                     torch.from_numpy(q), right=right)
        assert np.array_equal(got.numpy(), want)
