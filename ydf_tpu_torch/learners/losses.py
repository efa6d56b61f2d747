"""GBT losses (counterpart of ydf_tpu/learners/losses.py): initial
predictions, per-row gradients/hessians and the reported loss, over raw
scores f32 [n]. Only the two losses of the training slice are ported;
make_loss raises NotImplementedError for the others.

Gradients and initial predictions round as the JAX package's do on the
CPU, bit for bit: the sigmoid through XLA's exp (exp_f32) and the sums
in XLA's order (ops/histogram.py:sum_rows_f32). An ulp of difference in
a gradient moves a histogram cell by an ulp now and then, which flips a
split whose gain ties another's, and every tree after it differs. The
reported losses use torch's own functions (within rtol 1e-5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.ops.histogram import sum_rows_f32

_EPS = 1e-12
# XLA's CPU exp (the Cephes expf polynomial, its multiply-adds fused):
# range reduction by ln 2 in two parts, then a degree-5 polynomial; no
# subnormal results (they flush to 0), inf past log(FLT_MAX) (bitwise
# below 88.37; above, where exp passes 2.4e38, a few ulps apart).
_EXP_HI = 89.0
_EXP_LO = -88.8
_LOG2E = 1.44269504088896341
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _f32(c: float) -> float:
    """A constant as the f32 value XLA compiles it to."""
    return float(np.float32(c))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32 (a, b, c f32): the product is exact
    in f64, so only a double-rounding half-way case (about one in 2^29)
    differs from a hardware fused multiply-add."""
    if isinstance(b, torch.Tensor):
        b = b.double()
    if isinstance(c, torch.Tensor):
        c = c.double()
    return (a.double() * b + c).float()


def _flush(y: torch.Tensor) -> torch.Tensor:
    """Subnormal results to 0, as XLA's CPU code runs (flush to zero)."""
    return torch.where(y.abs() < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(y), y)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of f32 `x` as XLA computes it on the CPU, bit for bit."""
    x = x.clamp(_f32(_EXP_LO), _f32(_EXP_HI))
    fx = torch.floor(_fma(x, _f32(_LOG2E), _f32(0.5)))
    r = _fma(fx, -_f32(_LN2_HI), x)
    r = _fma(fx, -_f32(_LN2_LO), r)
    z = r * r
    y = torch.full_like(r, _f32(_EXP_POLY[0]))
    for c in _EXP_POLY[1:]:
        y = _fma(y, r, _f32(c))
    y = _fma(y, z, r) + 1.0
    # 2^fx in two exact factors: fx reaches 128 below log(FLT_MAX).
    n = fx.to(torch.int32)
    half = n >> 1
    y = (y * ((half + 127) << 23).view(torch.float32)
         * ((n - half + 127) << 23).view(torch.float32))
    return _flush(y)


# XLA's CPU log (Eigen's Cephes logf, its multiply-adds fused): the
# mantissa shifted to [sqrt(1/2), sqrt(2)) - 1, a degree-8 polynomial in
# three Horner parts, the exponent's ln 2 added in two parts.
_SQRT_HALF = 0.707106781186547524
_LOG_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
             -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
             2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """log of positive f32 `x` as XLA computes it on the CPU (bitwise
    on all but about one value in 2,600 of a sample, which differ by an
    ulp; the learner takes one log, of the initial prediction)."""
    m, e = torch.frexp(x.clamp_min(torch.finfo(torch.float32).tiny))
    e = e.float()
    small = m < _f32(_SQRT_HALF)
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    c = [_f32(v) for v in _LOG_POLY]
    y = _fma(_fma(torch.full_like(m, c[0]), m, c[1]), m, c[2])
    y1 = _fma(_fma(torch.full_like(m, c[3]), m, c[4]), m, c[5])
    y2 = _fma(_fma(torch.full_like(m, c[6]), m, c[7]), m, c[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = _fma(e, _f32(_LN2_LO), y)
    m = _fma(x2, -0.5, m) + y
    return _fma(e, _f32(_LN2_HI), m)


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid as XLA computes it: 1 / (1 + exp(-x))."""
    return _flush(1.0 / (1.0 + exp_f32(-x)))


def _mean_f32(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum(weights * values) / (sum(weights) + EPS), the sums in XLA's
    order."""
    num = sum_rows_f32((weights * values)[:, None])[0]
    return num / (sum_rows_f32(weights[:, None])[0] + _EPS)


@dataclasses.dataclass(frozen=True)
class BinomialLogLikelihood:
    """Binary cross-entropy on logits; labels {0, 1}."""

    name = "BINOMIAL_LOG_LIKELIHOOD"
    num_dims = 1

    def initial_predictions(self, labels, weights):
        p = torch.clamp(_mean_f32(labels, weights), _EPS, 1.0 - _EPS)
        return log_f32(p / (1.0 - p))[None]

    def grad_hess(self, labels, preds):
        p = sigmoid_f32(preds)
        return p - labels, p * (1.0 - p)

    def loss(self, labels, preds, weights):
        # Binomial deviance: 2 x weighted logloss. softplus(x) is
        # logaddexp(x, 0), as jax.nn.softplus computes it.
        ll = torch.logaddexp(preds, torch.zeros_like(preds)) - labels * preds
        return 2.0 * torch.sum(weights * ll) / (torch.sum(weights) + _EPS)


@dataclasses.dataclass(frozen=True)
class MeanSquaredError:
    """Squared error; the reported loss is the RMSE."""

    name = "SQUARED_ERROR"
    num_dims = 1

    def initial_predictions(self, labels, weights):
        return _mean_f32(labels, weights)[None]

    def grad_hess(self, labels, preds):
        g = preds - labels
        return g, torch.ones_like(g)

    def loss(self, labels, preds, weights):
        se = torch.square(preds - labels)
        return torch.sqrt(torch.sum(weights * se)
                          / (torch.sum(weights) + _EPS))


def make_loss(name: str, task: Task, num_classes: int):
    if name in ("DEFAULT", "AUTO", None):
        if task == Task.CLASSIFICATION and num_classes == 2:
            name = BinomialLogLikelihood.name
        elif task == Task.REGRESSION:
            name = MeanSquaredError.name
        else:
            raise NotImplementedError(
                f"the default loss of {task.value} with {num_classes} "
                "classes is not ported yet (ROADMAP Queue 1 item 11)"
            )
    if name == BinomialLogLikelihood.name:
        return BinomialLogLikelihood()
    if name == MeanSquaredError.name:
        return MeanSquaredError()
    raise NotImplementedError(
        f"loss {name!r} is not ported yet (ROADMAP Queue 1 item 11)"
    )
