"""Task types and the tree-shape configuration (counterpart of
ydf_tpu/config.py: Task, resolve_num_bins, resolve_max_frontier,
TreeConfig)."""

from __future__ import annotations

import dataclasses
import enum


class Task(enum.Enum):
    """Modeling task. Reference: ydf/model/abstract_model.proto:Task."""

    CLASSIFICATION = "CLASSIFICATION"
    REGRESSION = "REGRESSION"
    RANKING = "RANKING"
    CATEGORICAL_UPLIFT = "CATEGORICAL_UPLIFT"
    NUMERICAL_UPLIFT = "NUMERICAL_UPLIFT"
    ANOMALY_DETECTION = "ANOMALY_DETECTION"
    SURVIVAL_ANALYSIS = "SURVIVAL_ANALYSIS"


def resolve_num_bins(num_bins, n: int, min_cat_vocab: int = 0) -> int:
    """num_bins="auto" -> pow2ceil(n / 180) clipped to [64, 256] (floored
    at the largest categorical dictionary); an int is kept."""
    if num_bins != "auto":
        return int(num_bins)
    floor = 64
    while floor < 256 and floor < min_cat_vocab:
        floor *= 2
    if n >= 180 * 256:
        return 256
    b = floor
    while b < 256 and b * 180 < n:
        b *= 2
    return b


def resolve_max_frontier(max_frontier, n: int, min_examples: int) -> int:
    """max_frontier="auto" -> n / (2 min_examples) rounded up to a power
    of two, capped at 1024; an int is kept."""
    if max_frontier != "auto":
        return int(max_frontier)
    need = max(2, n // max(2 * min_examples, 1))
    p = 2
    while p < need and p < 1024:
        p *= 2
    return min(p, 1024)


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Static shape of one tree build: the layer loop's sizes follow from
    it, so every launch of a training run has a fixed shape."""

    max_depth: int = 6
    # Most nodes one layer may split; nodes beyond the cap become leaves.
    max_frontier: int = 1024
    num_bins: int = 256
    min_examples: int = 5

    @property
    def frontier(self) -> int:
        if self.max_depth < 0:
            return self.max_frontier
        return min(2 ** max(self.max_depth - 1, 0), self.max_frontier)

    @property
    def max_nodes(self) -> int:
        """Capacity of the node arrays of one tree."""
        depth = 32 if self.max_depth < 0 else self.max_depth
        total = 0
        for d in range(depth + 1):
            total += min(2**d, 2 * self.frontier)
            if 2**d >= 2 * self.frontier and d > 20:
                total += (depth - d) * 2 * self.frontier
                break
        return int(total)
