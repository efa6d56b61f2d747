"""GBT losses (counterpart of ydf_tpu/learners/losses.py): initial
predictions, per-row gradients/hessians and the reported loss, over raw
scores f32 [n]. Only the two losses of the training slice are ported;
make_loss raises NotImplementedError for the others.

Gradients and initial predictions round as the JAX package's do on the
CPU, bit for bit: the sigmoid through XLA's exp and the initial
prediction through its log (utils/xla_cpu.py), and the sums in XLA's
order (ops/histogram.py:sum_rows_f32). An ulp of difference in a
gradient moves a histogram cell by an ulp now and then, which flips a
split whose gain ties another's, and every tree after it differs. The
reported losses use torch's own functions (within rtol 1e-5).
"""

from __future__ import annotations

import dataclasses

import torch

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.ops.histogram import sum_rows_f32
from ydf_tpu_torch.utils.xla_cpu import exp_f32, flush, log_f32

_EPS = 1e-12


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid as XLA computes it: 1 / (1 + exp(-x))."""
    return flush(1.0 / (1.0 + exp_f32(-x)))


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
