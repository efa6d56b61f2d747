"""JAX's threefry random numbers, bit for bit, on torch tensors
(counterpart of the parts of jax.random the JAX package's learner uses:
PRNGKey, fold_in, split, random bits, uniform, randint and choice with
probabilities; jax 0.9.0, threefry2x32, jax_threefry_partitionable=True).

A key is an int64 tensor [..., 2] holding two 32-bit words; leading
dimensions batch keys, as jax.vmap over keys does. Every 32-bit word is
carried in an int64 masked to [0, 2^32): torch's uint32 lacks arithmetic
on CUDA. The functions run on the tensors' device; none of them reads a
device value on the host or copies a Python number to the device, so
they are safe under torch's sync debug mode "error".

Three replicas of jnp functions whose rounding the learner's draws and
bins depend on:
  * `cumsum_f32`: jnp.cumsum of a float32 vector on the CPU is not a
    sequential scan; XLA lowers it to a blocked scan, matched bitwise by
    a sequential prefix within blocks of 16, the block totals scanned the
    same way (recursively), then the exclusive block prefix added;
  * `searchsorted_scan`: jnp.searchsorted's default "scan" binary search
    (the same index as any search on a sorted vector, and the same index
    as jnp's on a vector that rounding left unsorted by an ulp);
  * `linspace_f32` and `quantile_linear`: jnp.linspace and jnp.quantile
    (method "linear") in float32.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
#: Block size of XLA's cumulative-sum rewrite on the CPU (see module
#: docstring); other sizes do not reproduce jnp.cumsum.
CUMSUM_BLOCK = 16

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2); every operand int64 in [0, 2^32), broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2^32: [0, seed]."""
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _words(key: torch.Tensor, extra_dims: int):
    """The key's two words, with `extra_dims` trailing unit dims."""
    shape = key.shape[:-1] + (1,) * extra_dims
    return key[..., 0].reshape(shape), key[..., 1].reshape(shape)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """iota_2x32_shape: the high and low words of a row-major 64-bit
    iota of `shape`."""
    size = math.prod(shape)
    iota = torch.arange(size, dtype=torch.int64, device=device).reshape(
        tuple(shape))
    return iota >> 32, iota & MASK32


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """jax.random.fold_in(key, data): the hash of the counter pair
    (0, data mod 2^32). `data` is a Python int or an integer tensor that
    broadcasts against the key's batch dims."""
    k1, k2 = key[..., 0], key[..., 1]
    if isinstance(data, torch.Tensor):
        lo = data.to(torch.int64) & MASK32
    else:
        lo = torch.full((), data & MASK32, dtype=torch.int64,
                        device=key.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    y1, y2 = torch.broadcast_tensors(y1, y2)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num) (the partitionable, fold-like split):
    keys [..., num, 2]."""
    k1, k2 = _words(key, 1)
    hi, lo = _counters((num,), key.device)
    y1, y2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()
                ) -> torch.Tensor:
    """32-bit random words [..., *shape] (int64 in [0, 2^32)), the
    partitionable layout: word i = xor of the hash of the 64-bit counter
    i."""
    shape = tuple(shape)
    k1, k2 = _words(key, len(shape))
    hi, lo = _counters(shape, key.device)
    y1, y2 = threefry2x32(k1, k2, hi, lo)
    return y1 ^ y2


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits as the mantissa of a float in
    [1, 2), minus 1 (jax.random.uniform with minval 0, maxval 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)


def uniform(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32."""
    return uniform_from_bits(random_bits(key, shape))


def randint_bits(key: torch.Tensor, shape: Sequence[int] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two words jax.random.randint draws: (higher, lower) from the
    two halves of split(key)."""
    ks = split(key)
    return random_bits(ks[..., 0, :], shape), random_bits(ks[..., 1, :],
                                                          shape)


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor,
                      minval: IntLike, maxval: IntLike) -> torch.Tensor:
    """jax.random.randint's int32 result from its two words: the offset
    (higher * 2^32 + lower) mod span, computed as jax does in uint32
    arithmetic; span = maxval - minval, or 1 when maxval <= minval.
    minval and maxval lie in int32."""
    lo, hi = (v.to(torch.int64) if isinstance(v, torch.Tensor)
              else torch.full_like(higher, v) for v in (minval, maxval))
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & MASK32)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK32) % span
    offset = (((higher % span) * mult) & MASK32) + (lower % span)
    offset = (offset & MASK32) % span
    return (lo + offset).to(torch.int32)


def randint(key: torch.Tensor, shape: Sequence[int], minval: IntLike,
            maxval: IntLike) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) in int32; maxval
    may be a device tensor."""
    higher, lower = randint_bits(key, shape)
    return randint_from_bits(higher, lower, minval, maxval)


def _sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last dim, each add rounded to
    float32 in order (torch.cumsum may accumulate in double)."""
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def cumsum_f32(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """jnp.cumsum of float32 `x` along `dim` as XLA computes it on the
    CPU: the recursive blocked scan of the module docstring (the
    anchors' row-choice probabilities; the grower's prefix sums over
    bins, where an ulp decides a near-tie split)."""
    return _cumsum_last(x.movedim(dim, -1)).movedim(-1, dim)


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    b = CUMSUM_BLOCK
    if n <= b:
        return _sequential_scan(x)
    pad = (-n) % b
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    blocks = _sequential_scan(x.reshape(x.shape[:-1] + (-1, b)))
    prefix = _cumsum_last(blocks[..., -1])
    excl = torch.cat([prefix.new_zeros(prefix.shape[:-1] + (1,)),
                      prefix[..., :-1]], dim=-1)
    return (blocks + excl[..., None]).reshape(x.shape)[..., :n]


def searchsorted_scan(sorted_arr: torch.Tensor, query: torch.Tensor,
                      right: bool = False) -> torch.Tensor:
    """jnp.searchsorted(sorted_arr, query, side) with its default "scan"
    method: ceil(log2(len + 1)) halvings of [0, len) (int64 result).
    `sorted_arr` is 1-D, or [R, m] with `query` [R, ...] searching row by
    row (jax.vmap over both). Neither holds NaN."""
    m = sorted_arr.shape[-1]
    dev = query.device
    low = torch.zeros(query.shape, dtype=torch.int64, device=dev)
    high = torch.full(query.shape, m, dtype=torch.int64, device=dev)
    levels = int(math.ceil(math.log2(m + 1)))
    if sorted_arr.dim() == 1:
        def at(idx):
            return sorted_arr[idx]
    else:
        rows = sorted_arr.shape[0]
        flat_q = query.reshape(rows, -1)

        def at(idx):
            return torch.gather(sorted_arr, 1, idx.reshape(flat_q.shape)
                                ).reshape(query.shape)
    for _ in range(levels):
        mid = (low + high) // 2
        a = at(mid.clamp(max=m - 1))
        go_left = query < a if right else query <= a
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high


def choice_from_uniform(p_cuml: torch.Tensor, u: torch.Tensor
                        ) -> torch.Tensor:
    """jax.random.choice(key, n, p=p) (replace=True) from its uniform
    draw u and jnp.cumsum(p): searchsorted(p_cuml, total * (1 - u)),
    int32."""
    r = p_cuml[-1] * (1.0 - u)
    return searchsorted_scan(p_cuml, r).to(torch.int32)


def choice(key: torch.Tensor, n: int, p: torch.Tensor,
           shape: Sequence[int] = ()) -> torch.Tensor:
    """jax.random.choice(key, n, shape, replace=True, p=p) for a float32
    p [n]: int32 indices [..., *shape]."""
    if p.shape != (n,):
        raise ValueError(f"p must have shape ({n},), got {tuple(p.shape)}")
    return choice_from_uniform(cumsum_f32(p), uniform(key, shape))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """a * b + c for float32 tensors, rounded once to float32: the
    product of two float32 values is exact in float64, the sum is
    rounded there and again to float32, which differs from a true fused
    multiply-add only on a double-rounding half-way case."""
    return (a.double() * b.double() + c.double()).float()


def linspace_f32(start: float, stop: float, num: int,
                 device="cpu") -> torch.Tensor:
    """jnp.linspace(start, stop, num) in float32 (endpoint included) as
    XLA computes it inside a jitted program whose start and stop are
    constants (the learner's qs): jnp writes start * (1 - step) + stop *
    step with step = iota / (num - 1); XLA's simplifier turns the
    division into a multiply by the float32 reciprocal c and folds stop
    * c into one constant, so out = start * (1 - iota * c) +
    iota * (stop * c), every operation rounded, then the exact stop.
    (Called eagerly, jnp.linspace rounds differently: XLA contracts the
    second product into a fused multiply-add.)"""
    f32 = torch.float32
    # torch.full, not torch.tensor: no copy from the host (the boosting
    # loop runs under sync debug mode "error").
    s = torch.full((), start, dtype=f32, device=device)
    e = torch.full((), stop, dtype=f32, device=device)
    if num == 1:
        return s.reshape(1)
    div = num - 1
    c = torch.ones((), dtype=f32, device=device) / float(div)
    it = torch.arange(div, dtype=f32, device=device)
    out = s * (1.0 - it * c) + it * (e * c)
    return torch.cat([out, e.reshape(1)])


def quantile_linear(a: torch.Tensor, q: torch.Tensor, dim: int = 0
                    ) -> torch.Tensor:
    """jnp.quantile(a, q, axis=dim) with method "linear" for float32 `a`
    without NaN and float32 q [Q], as XLA computes it on the CPU in the
    learner's program (the quantiles feed the binning searchsorted):
    [Q, ...rest] with h = q * (n - 1), low = floor(h), high = ceil(h),
    and fma(lo, 1 - (h - low), hi * (h - low)): XLA contracts the first
    product into the add. (The contraction follows the fusion: with no
    consumer but a transpose, XLA contracts the second product instead.)
    """
    a = torch.movedim(a, dim, 0)
    n = a.shape[0]
    srt = torch.sort(a, dim=0).values
    h = q * float(n - 1)
    low = torch.floor(h)
    high = torch.ceil(h)
    hw = h - low
    lw = 1.0 - hw
    low_i = low.clamp(0, n - 1).long()
    high_i = high.clamp(0, n - 1).long()
    extra = (1,) * (a.dim() - 1)
    lo_v = srt[low_i]
    hi_v = srt[high_i]
    lw = lw.reshape((-1,) + extra)
    hw = hw.reshape((-1,) + extra)
    return fma_f32(lo_v, lw, hi_v * hw)
