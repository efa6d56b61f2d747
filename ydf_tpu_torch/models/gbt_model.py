"""GradientBoostedTreesModel.predict (counterpart of
ydf_tpu/models/gbt_model.py): raw scores + initial predictions, then the
link function. The link runs in numpy float32 with the JAX package's
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
        # their own forest. The sub-forests are kept, so repeated predicts
        # reuse the same tensors (the engine cache keys on identity).
        subs = self._dim_forests
        if subs is None or len(subs) != K:
            fo = self.forest.to_numpy()
            subs = self._dim_forests = [
                Forest.from_numpy(
                    {f: a[k::K] for f, a in fo.items()}
                ).to(self.device)
                for k in range(K)
            ]
        per_dim = []
        full = self.forest
        try:
            for k in range(K):
                self.forest = subs[k]
                s = self._raw_scores(data, combine="sum")[:, 0]
                per_dim.append(s + self.initial_predictions[k])
        finally:
            self.forest = full
        scores = np.stack(per_dim, axis=1)
        if self.task == Task.CLASSIFICATION and self.apply_link_function:
            return _softmax(scores)
        return scores

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
