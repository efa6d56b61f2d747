"""GBT losses (counterpart of ydf_tpu/learners/losses.py): initial
predictions, per-row gradients/hessians and the reported loss.

A pointwise loss (num_dims 1: binomial, squared error, Poisson, mean
absolute error, binary focal, custom) takes raw scores f32 [n] and
returns gradients [n]; the multinomial loss (num_dims K, one tree per
class an iteration) takes [n, K] and returns [n, K]. The ranking losses
(learners/ranking_loss.py) and the Cox loss (learners/survival_loss.py)
are pointwise in shape but read the query groups or the survival
schedule the learner registers on them.

Gradients and initial predictions round as the JAX package's do on the
CPU, bit for bit: the sigmoid and softmax through XLA's exp and the
initial predictions through its log (utils/xla_cpu.py), the sums in
XLA's order (ops/histogram.py:sum_rows_f32; a softmax's K terms in
class order), MAE's weighted median through jnp.cumsum's blocked scan
(utils/prng.py). An ulp of difference in a gradient moves a histogram
cell by an ulp now and then, which flips a split whose gain ties
another's, and every tree after it differs. The binary focal loss takes
its derivatives by JAX autodiff there; the port evaluates the
derivative graph in the order of XLA's fused program for jax.grad
applied once and twice inside the boosting loop, with the multiply-adds
XLA contracts there. The
reported binomial and squared-error losses use torch's own functions
(within rtol 1e-5); the others replay XLA's sums.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import torch

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.ops.histogram import sum_rows_f32
from ydf_tpu_torch.utils import prng
from ydf_tpu_torch.utils.xla_cpu import exp_f32, flush, fma_f32, log_f32

_EPS = 1e-12


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid as XLA computes it: 1 / (1 + exp(-x))."""
    return flush(1.0 / (1.0 + exp_f32(-x)))


def _sum_f32(x: torch.Tensor) -> torch.Tensor:
    """jnp.sum of f32 [n] in XLA's order, as a 0-d tensor."""
    return sum_rows_f32(x[:, None])[0]


def _mean_f32(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum(weights * values) / (sum(weights) + EPS), the sums in XLA's
    order."""
    return _sum_f32(weights * values) / (_sum_f32(weights) + _EPS)


def sum_classes(x: torch.Tensor) -> torch.Tensor:
    """x [n, K] summed over its K columns in class order (XLA's reduce
    of a short row), [n, 1]."""
    s = x[:, 0]
    for k in range(1, x.shape[1]):
        s = s + x[:, k]
    return s[:, None]


def softmax_f32(preds: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax(preds, axis=1) as XLA computes it on the CPU: the
    row max subtracted, XLA's exp, the K terms summed in order, one
    division."""
    e = exp_f32(preds - preds.amax(dim=1, keepdim=True))
    return flush(e / sum_classes(e))


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

    def loss(self, labels, preds, weights, tag: str = "train"):
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

    def loss(self, labels, preds, weights, tag: str = "train"):
        se = torch.square(preds - labels)
        return torch.sqrt(torch.sum(weights * se)
                          / (torch.sum(weights) + _EPS))


@dataclasses.dataclass(frozen=True)
class MultinomialLogLikelihood:
    """Softmax cross-entropy; labels are class ids, one tree per class an
    iteration (preds [n, K])."""

    num_classes: int
    name = "MULTINOMIAL_LOG_LIKELIHOOD"

    @property
    def num_dims(self):
        return self.num_classes

    def initial_predictions(self, labels, weights):
        # Zeros, as the reference (loss_imp_multinomial.cc).
        return torch.zeros(self.num_classes, dtype=torch.float32,
                           device=labels.device)

    def grad_hess(self, labels, preds):
        p = softmax_f32(preds)
        y = torch.nn.functional.one_hot(labels.long(), self.num_classes)
        return p - y.to(p.dtype), p * (1.0 - p)

    def loss(self, labels, preds, weights, tag: str = "train"):
        # jax.nn.log_softmax: shifted - log(sum(exp(shifted))).
        shifted = preds - preds.amax(dim=1, keepdim=True)
        logp = shifted - log_f32(sum_classes(exp_f32(shifted)))
        nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
        return _sum_f32(weights * nll) / (_sum_f32(weights) + _EPS)


@dataclasses.dataclass(frozen=True)
class PoissonLoss:
    """Poisson deviance on log-rate scores; labels are counts >= 0."""

    name = "POISSON"
    num_dims = 1

    def initial_predictions(self, labels, weights):
        return log_f32(torch.clamp_min(_mean_f32(labels, weights),
                                       _EPS))[None]

    def grad_hess(self, labels, preds):
        mu = exp_f32(preds)
        return mu - labels, mu

    def loss(self, labels, preds, weights, tag: str = "train"):
        # 2 (mu - y log mu) + const: the reference's Poisson deviance.
        t = exp_f32(preds) - labels * preds
        return 2.0 * _sum_f32(weights * t) / (_sum_f32(weights) + _EPS)


@dataclasses.dataclass(frozen=True)
class MeanAverageError:
    """L1 regression: sign gradients, unit hessians, the weighted median
    as the initial prediction."""

    name = "MEAN_AVERAGE_ERROR"
    num_dims = 1

    def initial_predictions(self, labels, weights):
        # The smallest label whose cumulative weight (labels in a stable
        # ascending order, jnp.cumsum's rounding) reaches half the total:
        # searchsorted's left side.
        order = torch.argsort(labels, stable=True)
        cw = prng.cumsum_f32(weights[order])
        idx = prng.searchsorted_scan(cw, 0.5 * cw[-1:])
        return labels[order][idx.clamp_max(labels.shape[0] - 1)]

    def grad_hess(self, labels, preds):
        g = torch.sign(preds - labels)
        return g, torch.ones_like(g)

    def loss(self, labels, preds, weights, tag: str = "train"):
        ae = torch.abs(preds - labels)
        return _sum_f32(weights * ae) / (_sum_f32(weights) + _EPS)


@dataclasses.dataclass(frozen=True)
class BinaryFocalLoss:
    """Focal loss (Lin et al. 2017) on logits: -a_t (1 - p_t)^gamma
    log(max(p_t, EPS)). Its gradient and hessian are the JAX package's
    autodiff (jax.grad once and twice of the per-example loss) written
    out as XLA compiles them on the CPU at the default gamma 2: its
    simplifications of pow (x^2 = x x, x^1 = x, x^0 = 1), its operation
    order and its fused multiply-adds."""

    gamma: float = 2.0
    alpha: float = 0.5
    name = "BINARY_FOCAL_LOSS"
    num_dims = 1

    def _pow(self, x, e):
        if e == 2.0:
            return x * x
        if e == 1.0:
            return x
        if e == 0.0:
            return torch.ones_like(x)
        return torch.pow(x, e)

    def _parts(self, labels, preds):
        c = sigmoid_f32(preds)
        pos = labels > 0.5
        pt = torch.where(pos, c, 1.0 - c)
        o = -torch.where(pos, torch.full_like(c, self.alpha),
                         torch.full_like(c, 1.0 - self.alpha))
        p = 1.0 - pt
        u = torch.clamp_min(pt, _EPS)
        # d max(pt, EPS) / d pt: 1 above EPS, 1/2 at it, 0 below.
        dmax = (pt == u).to(c.dtype) / torch.where(
            u == _EPS, torch.full_like(c, 2.0), torch.ones_like(c))
        return c, pos, o, p, u, dmax

    @staticmethod
    def _pm(pos, x):
        """x where pos, -x elsewhere, as the autodiff's select, negate and
        add form it: (pos ? x : 0) + -(pos ? 0 : x), so -(+0) is +0."""
        return torch.where(pos, x, 0.0) - torch.where(pos, 0.0, x)

    def initial_predictions(self, labels, weights):
        p = torch.clamp(_mean_f32(labels, weights), _EPS, 1.0 - _EPS)
        return log_f32(p / (1.0 - p))[None]

    def grad_hess(self, labels, preds):
        gm = self.gamma
        c, pos, o, p, u, dmax = self._parts(labels, preds)
        e = c * (1.0 - c)
        q = self._pow(p, gm)                      # (1 - pt)^gamma
        two_p = gm * self._pow(p, gm - 1.0)       # d q / d p
        log_u = log_f32(u)
        bc = o * q
        bu = o * log_u
        # d loss / d pt, then through pt = +-c and c' = c (1 - c).
        dpt = (bc / u) * dmax - bu * two_p
        g = self._pm(pos, dpt) * e
        # The second derivative in the order of XLA's fused program
        # inside the boosting loop (the fusion that also forms the stats
        # rows), with the four multiply-adds it contracts there: read
        # from its optimized HLO, the contractions found by holding the
        # trees against the JAX learner's (tests). A standalone
        # jax.jit(grad_hess) leaves `dd` uncontracted.
        ch = self._pm(pos, e)                     # d pt / d s
        co = ch * dmax
        cp = co * (1.0 / (u * u))
        cn = o * (-ch * two_p)
        cw = fma_f32(-cp, bc, cn / u)
        cl = bu * -ch
        ba = (gm - 1.0) * self._pow(p, gm - 2.0)  # 1 at gamma 2
        dd = fma_f32(o * (co / u), two_p, (cl * gm) * ba)
        df = cw * dmax - dd
        ce = self._pm(pos, dpt)
        dm = fma_f32(ce, 1.0 - c, self._pm(pos, df))
        h = fma_f32(-c, ce, dm) * e
        # Newton steps need positive curvature; clamped as the reference.
        return g, torch.clamp_min(h, _EPS)

    def loss(self, labels, preds, weights, tag: str = "train"):
        c, pos, o, p, u, _ = self._parts(labels, preds)
        ex = (o * self._pow(p, self.gamma)) * log_f32(u)
        return _sum_f32(weights * ex) / (_sum_f32(weights) + _EPS)


@dataclasses.dataclass(frozen=True)
class CustomLoss:
    """A user-supplied loss (the JAX package's CustomLoss): three
    callables over torch tensors on the training device.

        CustomLoss(
            initial_predictions_fn=lambda y, w: torch.zeros(1),
            gradient_and_hessian_fn=lambda y, s: (g, h),  # s: [n] scores
            loss_fn=lambda y, s: scalar,       # or (y, s, w) for weighted
        )

    Single output (num_dims 1); the hessian is clamped at EPS. The
    callables must not read device values on the host: the boosting
    loop runs under sync debug mode "error" on a card."""

    initial_predictions_fn: Callable
    gradient_and_hessian_fn: Callable
    loss_fn: Callable
    name: str = "CUSTOM"

    num_dims = 1

    def initial_predictions(self, labels, weights):
        out = torch.as_tensor(self.initial_predictions_fn(labels, weights))
        return out.reshape(1).to(device=labels.device, dtype=torch.float32)

    def grad_hess(self, labels, preds):
        g, h = self.gradient_and_hessian_fn(labels, preds)
        return g.reshape(-1), torch.clamp_min(h.reshape(-1), _EPS)

    def loss(self, labels, preds, weights, tag: str = "train"):
        params = inspect.signature(self.loss_fn).parameters
        if len(params) >= 3:
            return torch.as_tensor(self.loss_fn(labels, preds, weights))
        return torch.as_tensor(self.loss_fn(labels, preds))

    def fingerprint(self) -> bytes:
        """Content hash for checkpoint-resume validation: the bytecode of
        each callable (a changed body changes it, an identical
        redefinition does not)."""
        out = []
        for fn in (self.initial_predictions_fn,
                   self.gradient_and_hessian_fn, self.loss_fn):
            code = getattr(fn, "__code__", None)
            out.append(code.co_code if code is not None
                       else repr(fn).encode())
        return b"|".join(out)


_POINTWISE = {cls.name: cls for cls in (
    BinomialLogLikelihood, MeanSquaredError, PoissonLoss, MeanAverageError,
    BinaryFocalLoss)}


def make_loss(name: str, task: Task, num_classes: int):
    """The loss object of a name (the JAX package's make_loss). DEFAULT
    (or AUTO) picks the task's default: binomial for two classes,
    multinomial for more, squared error for regression,
    LAMBDA_MART_NDCG for ranking, COX_PROPORTIONAL_HAZARD for survival
    analysis. XE_NDCG_MART and the other losses are taken by name."""
    from ydf_tpu_torch.learners.ranking_loss import LambdaMartNdcg, XeNdcg
    from ydf_tpu_torch.learners.survival_loss import (
        CoxProportionalHazardLoss)

    if name in ("DEFAULT", "AUTO", None):
        if task == Task.CLASSIFICATION:
            name = (BinomialLogLikelihood.name if num_classes == 2
                    else MultinomialLogLikelihood.name)
        elif task == Task.REGRESSION:
            name = MeanSquaredError.name
        elif task == Task.RANKING:
            name = LambdaMartNdcg.name
        elif task == Task.SURVIVAL_ANALYSIS:
            name = CoxProportionalHazardLoss.name
        else:
            raise ValueError(f"No default GBT loss for task {task}")
    if name == MultinomialLogLikelihood.name:
        return MultinomialLogLikelihood(num_classes=num_classes)
    if name in _POINTWISE:
        return _POINTWISE[name]()
    by_name = {cls.name: cls for cls in (
        LambdaMartNdcg, XeNdcg, CoxProportionalHazardLoss)}
    if name in by_name:
        return by_name[name]()
    raise ValueError(f"Unknown loss {name!r}")
