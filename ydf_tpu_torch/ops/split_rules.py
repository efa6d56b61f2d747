"""Split rules (counterpart of ydf_tpu/ops/split_rules.py): the gain of
a cut, the leaf value and the categorical sort key of a task, with the
JAX package's expressions and epsilon so the f32 results round alike.
stats[..., -1] is always the weighted example count.

  * `HessianGainRule`: GBT, stats = [g, h, w];
  * `ClassificationRule`: RF classification (entropy, or gini),
    stats = [w 1[y=0], ..., w 1[y=C-1], w];
  * `RegressionRule`: RF regression (variance reduction),
    stats = [w y, w y^2, w];
  * `UpliftEuclideanRule`: uplift forests (Euclidean divergence),
    stats = [w_c, w y_c, w_t, w y_t, w], with a validity check of its
    own (`split_valid`: rows of each treatment arm on each side);
  * `RandomSplitRule`: the isolation forest's random splits (Gumbel-max
    over the cuts), stats = [w]. Its gain also reads the layer's key and
    a context (`takes_key`); the other rules' gains take the stats only.

A gain is computed as XLA's CPU code computes the JAX package's
expression inside its grower (the same operations, the multiply-adds
that LLVM fuses fused, its log): a split whose gain ties another to the
last bit then breaks the same way in both packages, which matters most
for the integer class counts of a random forest, where two cuts often
tie exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from ydf_tpu_torch.ops.histogram import sum_rows_f32
from ydf_tpu_torch.utils import prng
from ydf_tpu_torch.utils.xla_cpu import exp_f32, fma_f32, log_f32

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class HessianGainRule:
    """GBT hessian gain. stats = [g, h, w]; leaf = -sum g / (sum h + l2)."""

    l2: float = 0.0
    num_outputs: int = 1

    num_stats = 3
    num_cat_orderings = 1

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


@dataclasses.dataclass(frozen=True)
class ClassificationRule:
    """Information-gain (default) or Gini classification splits over
    class counts; the leaf value is the class distribution."""

    num_classes: int
    criterion: str = "entropy"  # or "gini"

    def __post_init__(self):
        if self.criterion not in ("entropy", "gini"):
            raise ValueError(f"unknown criterion {self.criterion!r}")

    @property
    def num_stats(self) -> int:
        return self.num_classes + 1

    @property
    def num_outputs(self) -> int:
        return self.num_classes

    @property
    def num_cat_orderings(self) -> int:
        """Sorted orders a categorical feature is scanned in: one per
        class for C > 2 ("one class against the others"), one for a
        binary label (its two per-class orders are each other's
        reverse)."""
        return self.num_classes if self.num_classes > 2 else 1

    def _probs(self, s: torch.Tensor) -> torch.Tensor:
        return s[..., :self.num_classes] / (s[..., -1:] + _EPS)

    def _sum_over_classes(self, s: torch.Tensor, entropy: bool
                          ) -> torch.Tensor:
        """sum_c p_c log(p_c + EPS) (entropy) or sum_c p_c^2 (gini) in
        XLA's reduction: the first term, then one fused multiply-add per
        further class."""
        p = self._probs(s)
        q = log_f32(p + _EPS) if entropy else p
        acc = p[..., 0] * q[..., 0]
        for c in range(1, self.num_classes):
            acc = fma_f32(p[..., c], q[..., c], acc)
        return acc

    def gain(self, left: torch.Tensor, right: torch.Tensor,
             parent: torch.Tensor) -> torch.Tensor:
        """mass(parent) - mass(left) - mass(right), mass = w * impurity,
        as XLA evaluates it. Entropy (impurity -S, S = sum p log p): XLA
        folds the negations into w_l S_l - w_p S_p + w_r S_r and fuses
        both multiply-adds. Gini (impurity 1 - Q, Q = sum p^2): m_p -
        w_l (1 - Q_l) - w_r (1 - Q_r), both subtractions fused."""
        wl, wr, wp = left[..., -1], right[..., -1], parent[..., -1]
        entropy = self.criterion == "entropy"
        sides = self._sum_over_classes(
            torch.stack(torch.broadcast_tensors(left, right)), entropy)
        sp = self._sum_over_classes(parent, entropy)
        if entropy:
            return fma_f32(wr, sides[1], fma_f32(wl, sides[0], -(wp * sp)))
        mass_p = wp * (1.0 - sp)
        return fma_f32(-wr, 1.0 - sides[1],
                       fma_f32(-wl, 1.0 - sides[0], mass_p))

    def leaf_value(self, stats: torch.Tensor) -> torch.Tensor:
        return self._probs(stats)

    def cat_sort_key(self, hist: torch.Tensor) -> torch.Tensor:
        """P(class 1 | category): the exact order for a binary label."""
        c = hist[..., min(1, self.num_classes - 1)]
        return c / (hist[..., -1] + _EPS)

    def cat_sort_keys(self, hist: torch.Tensor) -> torch.Tensor:
        """[..., B, S] -> [..., C, B]: ordering c sorts the categories by
        P(class c | category)."""
        return self._probs(hist).movedim(-1, -2)


@dataclasses.dataclass(frozen=True)
class RegressionRule:
    """Variance-reduction regression splits; the leaf value is the mean
    label."""

    num_stats = 3
    num_outputs = 1
    num_cat_orderings = 1

    @staticmethod
    def _sse(s: torch.Tensor) -> torch.Tensor:
        return s[..., 1] - torch.square(s[..., 0]) / (s[..., 2] + _EPS)

    def gain(self, left: torch.Tensor, right: torch.Tensor,
             parent: torch.Tensor) -> torch.Tensor:
        return self._sse(parent) - self._sse(left) - self._sse(right)

    def leaf_value(self, stats: torch.Tensor) -> torch.Tensor:
        return (stats[..., 0] / (stats[..., 2] + _EPS))[..., None]

    def cat_sort_key(self, hist: torch.Tensor) -> torch.Tensor:
        return hist[..., 0] / (hist[..., -1] + _EPS)


@dataclasses.dataclass(frozen=True)
class UpliftEuclideanRule:
    """Uplift splits by the squared Euclidean divergence between the
    treated and the control outcome rates (the reference's uplift.h,
    kEuclideanDistance). stats = [w_c, w y_c, w_t, w y_t, w]: the control
    and treated weights and weighted outcomes, then the weight of the
    rows with a known treatment. The leaf value is the estimated uplift
    p_t - p_c; a cut is valid only when each side holds at least
    `min_examples_per_treatment` of each arm (`split_valid`)."""

    num_stats = 5
    num_outputs = 1
    num_cat_orderings = 1
    min_examples_per_treatment: int = 5

    def split_valid(self, left: torch.Tensor, right: torch.Tensor
                    ) -> torch.Tensor:
        m = self.min_examples_per_treatment
        return ((left[..., 0] >= m) & (left[..., 2] >= m)
                & (right[..., 0] >= m) & (right[..., 2] >= m))

    @staticmethod
    def _uplift(s: torch.Tensor) -> torch.Tensor:
        pc = s[..., 1] / (s[..., 0] + _EPS)
        pt = s[..., 3] / (s[..., 2] + _EPS)
        return pt - pc

    def _sides(self, left, right, parent):
        """(fma(w_l, d_l^2, w_r d_r^2), w_p, d_p^2), d = p_t - p_c: the
        children's masses as LLVM fuses them in XLA's CPU code."""
        sq = [torch.square(self._uplift(s)) for s in (left, right, parent)]
        return (fma_f32(left[..., 4], sq[0], right[..., 4] * sq[1]),
                parent[..., 4], sq[2])

    def gain(self, left: torch.Tensor, right: torch.Tensor,
             parent: torch.Tensor) -> torch.Tensor:
        """mass(left) + mass(right) - mass(parent), mass = w (p_t -
        p_c)^2, as XLA's CPU code evaluates it inside the grower (read
        from the object code of its split-search fusion): the children's
        masses fused (_sides), then the parent's subtracted."""
        sides, wp, sqp = self._sides(left, right, parent)
        return sides - wp * sqp

    def chosen_gain(self, left: torch.Tensor, right: torch.Tensor,
                    parent: torch.Tensor) -> torch.Tensor:
        """The gain of each slot's chosen cut as the grower compares it
        with min_split_gain and ranks it on a frontier overflow: XLA
        computes it again in the fusions that read the chosen index, and
        there LLVM fuses the parent's mass too, fma(-w_p, d_p^2, sides)
        (read from their object code). The argmax over the cuts sees
        `gain`; where the masses cancel the two differ by an ulp, enough
        to pass min_split_gain."""
        sides, wp, sqp = self._sides(left, right, parent)
        return fma_f32(-wp, sqp, sides)

    def leaf_value(self, stats: torch.Tensor) -> torch.Tensor:
        return self._uplift(stats)[..., None]

    def cat_sort_key(self, hist: torch.Tensor) -> torch.Tensor:
        return self._uplift(hist)


@dataclasses.dataclass(frozen=True)
class RandomSplitRule:
    """Isolation-forest random splits by the Gumbel-max trick. The
    context is log_gap f32 [F, B], the log of the value-space width of
    each cut's bin gap (-inf where a feature has no such cut); the gain
    of a cut whose children both hold rows is log_gap - logsumexp(the
    slot's valid log_gaps of that feature) + gumbel(key), -inf
    elsewhere, so the best cut of a slot is a uniform feature and a cut
    drawn in proportion to its gap. The leaf value is the row count; a
    categorical feature's bins are ordered by their counts."""

    num_stats = 1
    num_outputs = 1
    num_cat_orderings = 1
    #: The grower passes the layer's gain key and its rule context.
    takes_key = True

    def gain(self, left: torch.Tensor, right: torch.Tensor,
             parent: torch.Tensor, key: torch.Tensor,
             log_gap: torch.Tensor) -> torch.Tensor:
        """[Ld, F, B] from the left and right stats [Ld, F, B, 1], as
        XLA computes the JAX package's rule: the isfinite guard keeps a
        feature with no valid cut at -inf (no -inf - -inf NaN)."""
        valid = (left[..., -1] > 0) & (right[..., -1] > 0)
        w = torch.where(valid, log_gap, float("-inf"))
        norm = logsumexp_f32(w)
        g = prng.gumbel(key, w.shape)
        return torch.where(valid & torch.isfinite(w), w - norm + g,
                           float("-inf"))

    def leaf_value(self, stats: torch.Tensor) -> torch.Tensor:
        return stats[..., 0:1]

    def cat_sort_key(self, hist: torch.Tensor) -> torch.Tensor:
        return hist[..., -1]


def logsumexp_f32(w: torch.Tensor) -> torch.Tensor:
    """jax.scipy.special.logsumexp(w, axis=-1, keepdims=True) of f32 `w`
    as XLA computes it on the CPU: the max m (0 where it is not finite),
    exp(w - m) with XLA's exp, the sum over the last axis in XLA's
    reduce order (sum_rows_f32: windows of 32, then their partials), and
    XLA's log of its magnitude plus m."""
    m = w.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = exp_f32(w - m)
    total = sum_rows_f32(e.reshape(-1, e.shape[-1]).t())
    return log_f32(total.abs()).reshape(m.shape) + m
