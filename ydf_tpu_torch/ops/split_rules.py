"""GBT split rule (counterpart of ydf_tpu/ops/split_rules.py:
HessianGainRule): stats = [g, h, w]; the hessian gain of a cut, the
Newton leaf value and the categorical sort key, with the JAX package's expressions and epsilon so the
f32 results round alike. stats[..., -1] is the weighted example count.
"""

from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class HessianGainRule:
    """GBT hessian gain. stats = [g, h, w]; leaf = -sum g / (sum h + l2)."""

    l2: float = 0.0
    num_outputs: int = 1

    num_stats = 3

    def _score(self, s: torch.Tensor) -> torch.Tensor:
        g, h = s[..., 0], s[..., 1]
        return torch.square(g) / (h + self.l2 + _EPS)

    def gain(self, left: torch.Tensor, right: torch.Tensor,
             parent: torch.Tensor) -> torch.Tensor:
        return 0.5 * (self._score(left) + self._score(right)
                      - self._score(parent))

    def leaf_value(self, stats: torch.Tensor) -> torch.Tensor:
        g, h = stats[..., 0], stats[..., 1]
        return (-g / (h + self.l2 + _EPS))[..., None]

    def cat_sort_key(self, hist: torch.Tensor) -> torch.Tensor:
        """Order of a categorical feature's bins (f32, [..., B] of
        hist [..., B, S]): the bins' Newton leaf values; the candidate
        left sets are the prefixes of that order."""
        g, h = hist[..., 0], hist[..., 1]
        return -g / (h + self.l2 + _EPS)
