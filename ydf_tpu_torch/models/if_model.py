"""IsolationForestModel (counterpart of ydf_tpu/models/if_model.py): the
anomaly score of a row from its mean isolation depth. Each leaf holds
its path length h = depth + c(rows in the leaf), computed when the tree
was grown; the score is

    score(x) = 2^(-mean_t h_t(x) / c(num_examples_per_tree))

with c(n) the average path length of an unsuccessful search in a binary
search tree of n keys. The mean is the routed engine's (the bank and
QuickScorer kernels sum single-output forests only; serving/registry.py)
and the score is computed in numpy as the JAX package's is, so the
scores equal its own bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ydf_tpu_torch.models.generic_model import GenericModel

EULER = 0.5772156649015329


def average_path_length(n) -> np.ndarray:
    """c(n) in float64: 2 H(n - 1) - 2 (n - 1) / n for n > 2 (H(i) =
    log(i) + Euler's constant), 1 for n = 2, 0 below."""
    n = np.asarray(n, dtype=np.float64)
    h = np.log(np.maximum(n - 1, 1)) + EULER
    c = 2.0 * h - 2.0 * (n - 1) / np.maximum(n, 1)
    return np.where(n > 2, c, np.where(n == 2, 1.0, 0.0))


class IsolationForestModel(GenericModel):
    model_type = "ISOLATION_FOREST"
    combine = "mean"

    def __init__(self, *, num_examples_per_tree: int, **common):
        super().__init__(**common)
        self.num_examples_per_tree = num_examples_per_tree

    def predict(self, data) -> np.ndarray:
        """Anomaly scores [n] in [0, 1] (f32, as the JAX package's);
        higher is more anomalous."""
        mean_path = self._raw_scores(data, combine="mean")[:, 0]
        denom = float(average_path_length(self.num_examples_per_tree))
        return np.power(2.0, -mean_path / max(denom, 1e-9))

    def _metadata(self) -> Dict[str, Any]:
        return {"num_examples_per_tree": self.num_examples_per_tree}

    @classmethod
    def _from_saved(cls, common, specific):
        return cls(num_examples_per_tree=specific["num_examples_per_tree"],
                   **common)
