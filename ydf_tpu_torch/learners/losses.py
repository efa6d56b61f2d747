"""GBT losses (counterpart of ydf_tpu/learners/losses.py): initial
predictions, per-row gradients/hessians and the reported loss, over raw
scores f32 [n]. Only the two losses of the training slice are ported;
make_loss raises NotImplementedError for the others.
"""

from __future__ import annotations

import dataclasses

import torch

from ydf_tpu_torch.config import Task

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class BinomialLogLikelihood:
    """Binary cross-entropy on logits; labels {0, 1}."""

    name = "BINOMIAL_LOG_LIKELIHOOD"
    num_dims = 1

    def initial_predictions(self, labels, weights):
        p = torch.sum(weights * labels) / (torch.sum(weights) + _EPS)
        p = torch.clamp(p, _EPS, 1.0 - _EPS)
        return torch.log(p / (1.0 - p))[None]

    def grad_hess(self, labels, preds):
        p = torch.sigmoid(preds)
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
        return (torch.sum(weights * labels)
                / (torch.sum(weights) + _EPS))[None]

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
