"""Cox proportional-hazard loss for survival analysis (counterpart of
ydf_tpu/learners/survival_loss.py): each example has a departure age
(the label), an event-observed flag and an optional entry age (left
truncation); predictions are log relative hazards.

The 2n updates (an arrival at each entry age, an event or a censoring at
each departure) are sorted once on the host by (time, type, example),
arrival < event < censoring, and registered before the boosting loop.
The sweep is then prefix sums on the device: the hazard before each
update is the exclusive prefix of +-w exp(pred), clamped at 0; S1 and
S2 are the prefix sums of w / hazard and w / hazard^2 over the events;
an example's dS = S[its removal] - S[its arrival], and

  grad_i = exp(pred_i) dS1_i - event_i
  hess_i = exp(pred_i) dS1_i - w_i exp(pred_i)^2 dS2_i   (floored at EPS)

per unit of the example's weight (the grower multiplies by it). The loss
is the weighted mean negative log partial likelihood over the events.

Rounding follows the JAX package's program on the CPU: XLA's exp and log
(utils/xla_cpu.py), jnp.cumsum's blocked scan (utils/prng.py:
cumsum_f32), the multiply-adds XLA contracts in the gradient and
hessian, its rewrite of exp(p)^2 as exp(2p), the loss's sum in XLA's
order (ops/histogram.py:sum_rows_f32).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ydf_tpu_torch.ops.histogram import sum_rows_f32
from ydf_tpu_torch.utils import prng
from ydf_tpu_torch.utils.xla_cpu import exp_f32, fma_f32, log_f32

_EPS = 1e-12


class CoxProportionalHazardLoss:
    """Survival loss with per-dataset update schedules:
    register_survival() must be called (by the GBT learner) for every
    prediction array length it will see ("train" / "valid"). Takes raw
    scores f32 [n] and returns gradients and hessians [n]."""

    name = "COX_PROPORTIONAL_HAZARD"
    num_dims = 1

    def __init__(self):
        self._structs: Dict[str, dict] = {}

    def register_survival(self, tag: str, departure: np.ndarray,
                          event: np.ndarray,
                          entry: Optional[np.ndarray] = None,
                          weights: Optional[np.ndarray] = None,
                          device="cpu") -> None:
        """The update schedule of the dataset named `tag`, on `device`.
        Raises ValueError when an entry age exceeds its departure age."""
        n = len(departure)
        departure = np.asarray(departure, np.float64)
        event = np.asarray(event).astype(bool)
        entry = (np.zeros((n,), np.float64) if entry is None
                 else np.asarray(entry, np.float64))
        w = (np.ones((n,), np.float64) if weights is None
             else np.asarray(weights, np.float64))
        if np.any(entry > departure):
            raise ValueError("entry age exceeds departure age")
        # ARRIVAL = 0 < EVENT = 1 < CENSORING = 2 (the reference's
        # Update::operator<, loss_imp_cox.h:67).
        times = np.concatenate([entry, departure])
        types = np.concatenate(
            [np.zeros((n,), np.int8), np.where(event, 1, 2).astype(np.int8)])
        idxs = np.concatenate([np.arange(n), np.arange(n)])
        order = np.lexsort((idxs, types, times))
        upd_type = types[order]
        pos = np.empty((2 * n,), np.int64)
        pos[order] = np.arange(2 * n)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self._structs[tag] = {
            "n": n,
            "upd_idx": dev(idxs[order].astype(np.int64)),
            "is_arrival": dev(upd_type == 0),
            "is_event": dev(upd_type == 1),
            "arrival_pos": dev(pos[:n]),
            "removal_pos": dev(pos[n:]),
            "event": dev(event.astype(np.float32)),
            "weights": dev(w.astype(np.float32)),
            # The loss's normalizer: n for uniform weights (the
            # reference's 1/n), the weights' sum otherwise.
            "norm": float(n if weights is None else w.sum()),
        }

    def _struct_for(self, tag: str, n: int) -> dict:
        if tag not in self._structs:
            raise ValueError(f"No survival structure registered for {tag!r}")
        s = self._structs[tag]
        if s["n"] != n:
            raise ValueError(
                f"Survival structure {tag!r} was registered for {s['n']} "
                f"examples, got {n}")
        return s

    def _sweep(self, s, preds):
        """(exp(pred) [n], hazard before each update [2n], S1 [2n],
        S2 [2n]): the reference sweep's running quantities."""
        exp_p = exp_f32(preds)
        w_exp = s["weights"] * exp_p
        gathered = w_exp[s["upd_idx"]]
        delta = torch.where(s["is_arrival"], gathered, -gathered)
        csum = prng.cumsum_f32(delta)
        hazard = torch.clamp_min(csum - delta, 0.0)
        w_upd = s["weights"][s["upd_idx"]]
        live = s["is_event"] & (hazard > 0)
        inv = torch.where(live, w_upd / (hazard + _EPS), 0.0)
        inv2 = torch.where(live, w_upd / torch.square(hazard + _EPS), 0.0)
        return exp_p, hazard, prng.cumsum_f32(inv), prng.cumsum_f32(inv2)

    def initial_predictions(self, labels, weights):
        # Zero log-hazard: the baseline hazard absorbs any constant.
        return torch.zeros(1, dtype=torch.float32, device=labels.device)

    def grad_hess(self, labels, preds):
        s = self._struct_for("train", preds.shape[0])
        exp_p, _, S1, S2 = self._sweep(s, preds)
        dS1 = S1[s["removal_pos"]] - S1[s["arrival_pos"]]
        dS2 = S2[s["removal_pos"]] - S2[s["arrival_pos"]]
        # XLA contracts both products into the subtractions and rewrites
        # square(exp(p)) as exp(p + p).
        g = fma_f32(exp_p, dS1, -s["event"])
        h = fma_f32(exp_p, dS1,
                    -((s["weights"] * exp_f32(preds + preds)) * dS2))
        return g, torch.clamp_min(h, _EPS)

    def loss(self, labels, preds, weights, tag: str = "train"):
        """Weighted mean negative log partial likelihood:
        (1 / norm) sum over events of w_i [log hazard(t_i) - pred_i]."""
        s = self._struct_for(tag, preds.shape[0])
        _, hazard, _, _ = self._sweep(s, preds)
        w_upd = s["weights"][s["upd_idx"]]
        terms = torch.where(
            s["is_event"] & (hazard > 0),
            w_upd * (log_f32(hazard + _EPS) - preds[s["upd_idx"]]), 0.0)
        # XLA multiplies by the f32 reciprocal of the f32 normalizer.
        inv_norm = float(np.float32(1.0) / np.float32(s["norm"]))
        return sum_rows_f32(terms[:, None])[0] * inv_norm
