"""RandomForestModel (counterpart of ydf_tpu/models/rf_model.py): the
mean of the trees' leaf values. A classification forest with
winner_take_all (the default) votes: each leaf's class distribution is
baked into the one-hot of its top class before the mean. The routed
engine serves it (the bank and QuickScorer kernels sum single-output
forests; serving/registry.py), and its mean multiplies by the f32
reciprocal of the tree count as XLA does, so the probabilities equal the
JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.models.forest import bake_winner_take_all
from ydf_tpu_torch.models.generic_model import GenericModel


class RandomForestModel(GenericModel):
    model_type = "RANDOM_FOREST"
    combine = "mean"

    def __init__(self, *, winner_take_all: bool = True, oob_evaluation=None,
                 oob_variable_importances=None, **common):
        super().__init__(**common)
        self.winner_take_all = winner_take_all
        self.oob_evaluation = oob_evaluation
        # Loaded from JAX saves as they are; the port computes none
        # (ROADMAP Queue 1 item 20).
        self.oob_variable_importances = oob_variable_importances
        self._votes = None  # (leaf values it was baked from, votes)

    def self_evaluation(self):
        """The out-of-bag evaluation of the training run (None when it
        was not computed)."""
        return self.oob_evaluation

    def predict(self, data) -> np.ndarray:
        """Classification: P(class 1) [n] for a binary label, else the
        class probabilities [n, C]; regression: the mean [n]."""
        if self.task == Task.CLASSIFICATION and self.winner_take_all:
            lv = self.forest.leaf_value
            if self._votes is None or self._votes[0] is not lv:
                self._votes = (lv, bake_winner_take_all(lv))
            orig = self.forest
            self.forest = orig._replace(leaf_value=self._votes[1])
            try:
                proba = self._raw_scores(data, combine="mean")
            finally:
                self.forest = orig
        else:
            proba = self._raw_scores(data, combine="mean")
        if self.task == Task.CLASSIFICATION:
            return proba[:, 1] if proba.shape[1] == 2 else proba
        return proba[:, 0]

    def _metadata(self) -> Dict[str, Any]:
        return {
            "winner_take_all": self.winner_take_all,
            "oob_evaluation": self.oob_evaluation,
            "oob_variable_importances": self.oob_variable_importances,
        }

    @classmethod
    def _from_saved(cls, common, specific):
        return cls(
            winner_take_all=specific.get("winner_take_all", True),
            oob_evaluation=specific.get("oob_evaluation"),
            oob_variable_importances=specific.get("oob_variable_importances"),
            **common,
        )
