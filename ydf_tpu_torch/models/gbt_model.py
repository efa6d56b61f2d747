"""GradientBoostedTreesModel.predict and plot_training_logs (counterpart
of ydf_tpu/models/gbt_model.py): raw scores + initial predictions, then
the link function. The link runs in numpy float32 with the JAX package's
expressions, so predictions are bit-identical to it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.models.forest import Forest
from ydf_tpu_torch.models.generic_model import GenericModel


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softmax(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


class GradientBoostedTreesModel(GenericModel):
    model_type = "GRADIENT_BOOSTED_TREES"

    def __init__(
        self,
        *,
        initial_predictions: np.ndarray,
        num_trees_per_iter: int,
        loss_name: str,
        training_logs: Optional[Dict[str, Any]] = None,
        apply_link_function: bool = True,
        **common,
    ):
        super().__init__(**common)
        self.initial_predictions = np.asarray(initial_predictions, np.float32)
        self.num_trees_per_iter = num_trees_per_iter
        self.loss_name = loss_name
        self.training_logs = training_logs or {}
        # False → predict() returns raw scores (margins).
        self.apply_link_function = apply_link_function
        self._dim_forests = None

    def predict(self, data) -> np.ndarray:
        K = self.num_trees_per_iter
        if K == 1:
            scores = self._raw_scores(data, combine="sum")[:, 0]
            scores = scores + self.initial_predictions[0]
            if not self.apply_link_function:
                return scores
            if self.task == Task.CLASSIFICATION:
                return _sigmoid(scores)  # P(classes[1])
            if self.loss_name == "POISSON":
                return np.exp(scores)  # log link
            return scores
        # Multi-dimensional output: each dimension's trees are served as
        # their own forest, on the rows encoded and copied once. The
        # sub-forests are kept, so repeated predicts reuse the same
        # tensors (the engine cache keys on identity).
        subs = self._dim_forests
        if subs is None or len(subs) != K:
            fo = self.forest.to_numpy()
            subs = self._dim_forests = [
                Forest.from_numpy(
                    {f: a[k::K] for f, a in fo.items()}
                ).to(self.device)
                for k in range(K)
            ]
        enc = self._encode(data)
        per_dim = []
        full = self.forest
        try:
            for k in range(K):
                self.forest = subs[k]
                s = self._scores(enc, combine="sum")[:, 0]
                per_dim.append(s + self.initial_predictions[k])
        finally:
            self.forest = full
        scores = np.stack(per_dim, axis=1)
        if self.task == Task.CLASSIFICATION and self.apply_link_function:
            return _softmax(scores)
        return scores

    def plot_training_logs(self) -> str:
        """Self-contained SVG of the per-iteration train and validation
        losses, the JAX package's string."""
        logs = self.training_logs
        tl = logs.get("train_loss") or []
        vl = logs.get("valid_loss") or []
        if not tl:
            return "<svg/>"
        W, H, pad = 640, 360, 40
        series = [("train", tl, "#1f77b4")]
        if vl:
            series.append(("validation", vl, "#d62728"))
        all_vals = [v for _, vs, _ in series for v in vs]
        lo, hi = min(all_vals), max(all_vals)
        span = (hi - lo) or 1.0
        n = max(len(tl), len(vl), 2)

        def pts(vs):
            return " ".join(
                f"{pad + (W - 2 * pad) * i / (n - 1):.1f},"
                f"{H - pad - (H - 2 * pad) * (v - lo) / span:.1f}"
                for i, v in enumerate(vs)
            )

        lines = "".join(
            f'<polyline fill="none" stroke="{c}" stroke-width="1.5" '
            f'points="{pts(vs)}"/>'
            f'<text x="{W - pad}" y="{20 + 16 * k}" text-anchor="end" '
            f'fill="{c}" font-size="12">{name}</text>'
            for k, (name, vs, c) in enumerate(series)
        )
        axes = (
            f'<line x1="{pad}" y1="{H - pad}" x2="{W - pad}" y2="{H - pad}" '
            'stroke="#888"/>'
            f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{H - pad}" '
            'stroke="#888"/>'
            f'<text x="{W // 2}" y="{H - 8}" text-anchor="middle" '
            'font-size="12">iterations</text>'
            f'<text x="{pad}" y="{pad - 8}" font-size="12">'
            f"loss ({self.loss_name})</text>"
        )
        return (
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" '
            f'height="{H}">{axes}{lines}</svg>'
        )

    def _metadata(self) -> Dict[str, Any]:
        return {
            "initial_predictions": self.initial_predictions.tolist(),
            "num_trees_per_iter": self.num_trees_per_iter,
            "loss_name": self.loss_name,
            "training_logs": self.training_logs,
            "apply_link_function": self.apply_link_function,
        }

    @classmethod
    def _from_saved(cls, common, specific):
        return cls(
            initial_predictions=np.array(
                specific["initial_predictions"], np.float32
            ),
            num_trees_per_iter=specific["num_trees_per_iter"],
            loss_name=specific["loss_name"],
            training_logs=specific.get("training_logs"),
            apply_link_function=specific.get("apply_link_function", True),
            **common,
        )
