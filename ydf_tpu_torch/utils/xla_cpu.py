"""XLA's CPU arithmetic for f32 tensors, bit for bit (the JAX package's
programs as jax 0.9.0 compiles them for an x86 host).

The learners' splits and draws depend on a few functions whose last bit
XLA's CPU code decides differently from torch:
  * `exp_f32`: the Cephes expf polynomial with its multiply-adds fused
    (the binomial loss's sigmoid);
  * `log_f32`: XLA's logf, a degree-8 Cephes-style polynomial in three
    Horner parts with its multiply-adds fused, and subnormal inputs read
    as 0 (the binomial initial prediction, the Poisson bootstrap's Knuth
    loop, the entropy of a classification split);
  * `fma_f32`: the fused multiply-adds themselves.
Both functions flush subnormal results to 0, as XLA's CPU code runs.

The replicas are torch operations, so they run on either device: the
CUDA path keeps them (torch.log on a card is a third rounding). The
fused multiply-add is emulated in f64 (module `fma_f32`); `log_f32` is
bitwise to jnp.log on every one of the 2^23 values jax.random.uniform
draws and on 15 million floats spread over the whole f32 range
(tests/test_torch_random_forest.py).
"""

from __future__ import annotations

import numpy as np
import torch

_TINY = float(np.finfo(np.float32).tiny)


def f32(c: float) -> float:
    """A constant as the f32 value XLA compiles it to."""
    return float(np.float32(c))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32 (a, b, c f32 tensors or f32
    constants): the product is exact in f64, so only a double-rounding
    half-way case (about one in 2^29) differs from a hardware fused
    multiply-add."""
    if isinstance(b, torch.Tensor):
        b = b.double()
    if isinstance(c, torch.Tensor):
        c = c.double()
    return (a.double() * b + c).float()


def flush(y: torch.Tensor) -> torch.Tensor:
    """Subnormal results to 0 (flush to zero)."""
    return torch.where(y.abs() < _TINY, torch.zeros_like(y), y)


# exp: range reduction by ln 2 in two parts, then a degree-5 polynomial;
# inf past log(FLT_MAX) (bitwise below 88.37; above, where exp passes
# 2.4e38, a few ulps apart).
_EXP_HI = 89.0
_EXP_LO = -88.8
_LOG2E = 1.44269504088896341
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of f32 `x` as XLA computes it on the CPU, bit for bit."""
    x = x.clamp(f32(_EXP_LO), f32(_EXP_HI))
    fx = torch.floor(fma_f32(x, f32(_LOG2E), f32(0.5)))
    r = fma_f32(fx, -f32(_LN2_HI), x)
    r = fma_f32(fx, -f32(_LN2_LO), r)
    z = r * r
    y = torch.full_like(r, f32(_EXP_POLY[0]))
    for c in _EXP_POLY[1:]:
        y = fma_f32(y, r, f32(c))
    y = fma_f32(y, z, r) + 1.0
    # 2^fx in two exact factors: fx reaches 128 below log(FLT_MAX).
    n = fx.to(torch.int32)
    half = n >> 1
    y = (y * ((half + 127) << 23).view(torch.float32)
         * ((n - half + 127) << 23).view(torch.float32))
    return flush(y)


# log: the mantissa m in [0.5, 1), shifted to [sqrt(1/2), sqrt(2)) - 1
# (the exponent e counts the shift), a degree-8 polynomial in three
# Horner parts joined by x^3, e * ln 2 added in two parts.
_SQRT_HALF = 0.707106781186547524
_LOG_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
             -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
             2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_MANTISSA_BITS = -2139095041  # 0x807FFFFF: sign and mantissa
_HALF_EXPONENT = 0x3F000000   # the exponent of [0.5, 1)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """log of f32 `x` as XLA computes it on the CPU, bit for bit: -inf
    at 0 and at subnormal inputs (read as 0), the all-ones NaN below 0
    and at NaN, inf at inf.
    The steps and the multiply-adds XLA fuses, in its order:
      e = exponent + 1 - small, m = mantissa - 1 + (m if small)
      y = fma(fma(P0, m, P1), m, P2), y1, y2 likewise from P3.., P6..
      y = fma(fma(fma(y, x3, y1), x3, y2), x3, e * LN2_LO)
      log = fma(e, LN2_HI, fma(-0.5, x2, m) + y)."""
    xc = x.clamp_min(_TINY)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & _MANTISSA_BITS) | _HALF_EXPONENT).view(torch.float32)
    small = m < f32(_SQRT_HALF)
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    c = [f32(v) for v in _LOG_POLY]
    y = fma_f32(fma_f32(m, c[0], c[1]), m, c[2])
    y1 = fma_f32(fma_f32(m, c[3], c[4]), m, c[5])
    y2 = fma_f32(fma_f32(m, c[6], c[7]), m, c[8])
    y = fma_f32(fma_f32(y, x3, y1), x3, y2)
    y = fma_f32(y, x3, e * f32(_LN2_LO))
    out = fma_f32(e, f32(_LN2_HI), fma_f32(x2, -0.5, m) + y)
    out = torch.where(x < _TINY, float("-inf"), out)
    nan = torch.full_like(bits, -1).view(torch.float32)
    out = torch.where((x < 0) | torch.isnan(x), nan, out)
    return torch.where(x == float("inf"), float("inf"), out)
