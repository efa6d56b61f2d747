"""Ranking losses (counterpart of ydf_tpu/learners/ranking_loss.py):
LambdaMART with NDCG (LambdaMartNdcg) and the cross-entropy NDCG
surrogate (XeNdcg), on query groups padded into a dense [num_groups, G]
row matrix (build_group_rows; padding points at a trash row n).

For an ordered pair (i more relevant than j) of one group, LambdaMART
takes rho = sigmoid(s_j - s_i) and |dZ| = |gain_i - gain_j| * |disc_i -
disc_j| / maxDCG (gain 2^rel - 1, disc 1 / log2(rank + 2) below the
truncation, 0 after), and adds -rho |dZ| to i's gradient, rho |dZ| to
j's and rho (1 - rho) |dZ| to both hessians. The [G, G] pair tensors
are formed for chunks of groups, each f32 pair tensor at most
GROUP_CHUNK_BYTES (one chunk at train_ranking's 1,800 groups of 200; the
JAX package scans chunks of 2^26 bytes; groups are independent, so the
chunks change no value). The reported loss is -NDCG@truncation.

Every value rounds as the JAX package's program does on the CPU (jax
0.9.0, read from its optimized HLO): exp2(y) is XLA's exp of y * f32(ln
2), log2(x) XLA's log times f32(1 / ln 2) (utils/xla_cpu.py), the
sigmoid 1 / (exp(-x) + 1), each reduction over G or over the groups in
XLA's order (ops/histogram.py:sum_rows_f32: windows of 32, padded half
before and half after; group_total and discounted_sum for the shorter
sums XLA fuses with their producers), the argsorts stable under XLA's total order of
floats (-0.0 before +0.0), and the scatter back onto zeros adds each
real row's value once. No value is read on the host: the row matrices
are registered before the boosting loop.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from ydf_tpu_torch.learners.losses import sigmoid_f32
from ydf_tpu_torch.ops.histogram import sum_rows_f32
from ydf_tpu_torch.utils.xla_cpu import exp_f32, f32, flush, fma_f32, log_f32

_EPS = 1e-12
#: Largest f32 [groups, G, G] pair tensor of one chunk of groups.
GROUP_CHUNK_BYTES = 1 << 30
_LN2 = f32(0.6931471805599453)
_INV_LN2 = f32(1.4426950408889634)


def build_group_rows(group_values: np.ndarray, max_group_size: int = 2048
                     ) -> Tuple[np.ndarray, int]:
    """The group column -> dense row-index matrix int64 [num_groups, G],
    padded with -1 (the JAX package's build_group_rows): groups in the
    order of their sorted distinct values, each group's rows in dataset
    order, G the largest group capped at max_group_size. Longer groups
    keep their first rows and warn: dropped rows get no gradient and
    leave NDCG."""
    _, codes = np.unique(np.asarray(group_values), return_inverse=True)
    codes = codes.reshape(-1)
    order = np.argsort(codes, kind="stable")
    boundaries = np.flatnonzero(np.diff(codes[order])) + 1
    groups = np.split(order, boundaries)
    largest = max(len(g) for g in groups)
    G = min(largest, max_group_size)
    if largest > max_group_size:
        n_trunc = sum(1 for g in groups if len(g) > max_group_size)
        warnings.warn(
            f"{n_trunc} query group(s) exceed max_group_size="
            f"{max_group_size} (largest: {largest}); excess documents are "
            "dropped from training and NDCG. Raise ranking_max_group_size "
            "to keep them.",
            stacklevel=3,
        )
    rows = np.full((len(groups), G), -1, np.int64)
    for gi, g in enumerate(groups):
        g = g[:G]
        rows[gi, :len(g)] = g
    return rows, G


def xla_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.sum(x, axis=dim) of f32 `x` in XLA's CPU order
    (sum_rows_f32 along `dim`)."""
    moved = x.movedim(dim, 0)
    out = sum_rows_f32(moved.reshape(moved.shape[0], -1))
    return out.reshape(moved.shape[1:])


def group_total(x: torch.Tensor, vectorized: bool) -> torch.Tensor:
    """jnp.sum of f32 [k] to a scalar where XLA fuses it with the
    per-group values (the losses' sum over groups, inside the JAX
    learner's boosting loop): above 32 terms its windows (xla_sum). At
    most 32 terms and `vectorized` (groups longer than 32 rows), the
    loop XLA's CPU backend vectorizes, found by capturing the JAX
    learner's in-loop validation losses at k = 4-32 groups (G = 64): a
    lane accumulator of L lanes over the first k // L * L terms, its
    lanes added by halves, then the rest in order, with L = 4 at k = 4
    and at k = 20-23, 8 at k = 8 and at the other k >= 16, and no lanes
    (in order) at the other k. (A standalone jax.jit of the loss takes
    4 lanes at k = 28-31.) Otherwise in order (seen at G = 28, k = 30;
    not identified elsewhere, ROADMAP Queue 3)."""
    k = x.shape[0]
    if k > 32:
        return xla_sum(x, 0)
    lanes = {4: 4, 8: 8}.get(k, 0) if vectorized else 0
    if k >= 16 and vectorized:
        lanes = 4 if 20 <= k <= 23 else 8
    main = k // lanes * lanes if lanes else 0
    total = x.new_zeros(())
    if main:
        acc = x.new_zeros(lanes)
        for a in range(0, main, lanes):
            acc = acc + x[a:a + lanes]
        while acc.shape[0] > 1:
            h = acc.shape[0] // 2
            acc = acc[:h] + acc[h:]
        total = acc[0]
    for i in range(main, k):
        total = total + x[i]
    return total


def discounted_sum(gains: torch.Tensor, disc: torch.Tensor
                   ) -> torch.Tensor:
    """sum over the last dim of gains [groups, G] * disc [G] as XLA
    computes it: windows of the products above 12 terms (xla_sum); at
    most 12 the multiply fused into the reduce, one multiply-add a term
    in order (identified at G <= 12; at G = 13-32 the order is not
    identified, ROADMAP Queue 3)."""
    if gains.shape[1] > 12:
        return xla_sum(gains * disc, 1)
    acc = gains.new_zeros(gains.shape[0])
    for i in range(gains.shape[1]):
        acc = fma_f32(gains[:, i], disc[i], acc)
    return acc


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of f32 `x` that sort as XLA's comparator orders floats
    (IEEE total order: -0.0 before +0.0, NaNs at the ends)."""
    bits = x.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def argsort_f32(x: torch.Tensor) -> torch.Tensor:
    """jnp.argsort(x, axis=-1): stable, ascending in XLA's total order."""
    return torch.sort(total_order_key(x), dim=-1, stable=True).indices


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """argsort of a permutation along the last dim (its inverse)."""
    ar = torch.arange(order.shape[-1], device=order.device)
    return torch.empty_like(order).scatter_(
        -1, order, ar.expand_as(order).contiguous())


def exp2_gains(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """where(m, exp2(y) - 1, 0): jnp.exp2 as XLA computes it, the exp of
    y * f32(ln 2) (integer relevances give exact integers)."""
    return torch.where(m, exp_f32(y * _LN2) - 1.0, 0.0)


def position_discounts(G: int, truncation: int, device) -> torch.Tensor:
    """f32 [G]: 1 / log2(position + 2) below `truncation`, 0 after, with
    XLA's log (jnp.log2 = log(x) * f32(1 / ln 2))."""
    pos = torch.arange(G, dtype=torch.float32, device=device)
    disc = 1.0 / (log_f32(pos + 2.0) * _INV_LN2)
    return torch.where(pos < truncation, disc, 0.0)


class LambdaMartNdcg:
    """Group-structured loss: register_groups() must be called (by the
    GBT learner) for every prediction array length it will see. Takes
    raw scores f32 [n] and returns gradients and hessians [n]."""

    name = "LAMBDA_MART_NDCG"
    num_dims = 1

    def __init__(self, ndcg_truncation: int = 5):
        self.ndcg_truncation = ndcg_truncation
        self._structs: Dict[str, Tuple[torch.Tensor, int]] = {}

    def register_groups(self, tag: str, n: int, rows: np.ndarray,
                        device="cpu") -> None:
        """rows: [num_groups, G] indices into the length-n example arrays
        of the dataset named `tag` ("train" / "valid"), padding -1 (sent
        to the trash row n)."""
        rows = np.where(rows < 0, n, rows).astype(np.int64)
        self._structs[tag] = (torch.from_numpy(rows).to(device), n)

    def rows_for(self, tag: str, n: int) -> torch.Tensor:
        """The registered row matrix int64 [num_groups, G] of `tag`."""
        if tag not in self._structs:
            raise ValueError(f"No group structure registered for {tag!r}")
        rows, reg_n = self._structs[tag]
        if reg_n != n:
            raise ValueError(
                f"Group structure {tag!r} was registered for {reg_n} "
                f"examples, got {n}")
        return rows

    def _gather_groups(self, tag, labels, preds):
        """(rows, s, y, m) [num_groups, G]: scores and relevances of each
        group's rows (the trash row scores 0, relevance -1) and the
        validity mask."""
        n = preds.shape[0]
        rows = self.rows_for(tag, n)
        s_pad = torch.cat([preds, preds.new_zeros(1)])
        y_pad = torch.cat([labels.float(), labels.new_full((1,), -1.0)])
        return rows, s_pad[rows], y_pad[rows], rows < n

    def initial_predictions(self, labels, weights):
        return torch.zeros(1, dtype=torch.float32, device=labels.device)

    def lambdas(self, s, y, m):
        """Gradients and hessians [num_groups, G] of every group's rows
        (the JAX package's _per_group_lambdas, batched)."""
        G = s.shape[1]
        gains = exp2_gains(y, m)
        order = argsort_f32(-torch.where(m, s, float("-inf")))
        pos_disc = position_discounts(G, self.ndcg_truncation, s.device)
        disc = pos_disc[inverse_permutation(order)]
        ideal = torch.sort(gains, dim=1, descending=True).values
        maxdcg = discounted_sum(ideal, pos_disc)
        inv_maxdcg = torch.where(maxdcg > 0, 1.0 / (maxdcg + _EPS), 0.0)
        better = ((y[:, :, None] > y[:, None, :]) & m[:, :, None]
                  & m[:, None, :])
        rho = sigmoid_f32(s[:, None, :] - s[:, :, None])
        delta = ((gains[:, :, None] - gains[:, None, :]).abs()
                 * (disc[:, :, None] - disc[:, None, :]).abs()
                 * inv_maxdcg[:, None, None])
        lam = torch.where(better, flush(rho * delta), 0.0)
        hl = torch.where(better, flush((rho * (1.0 - rho)) * delta), 0.0)
        g = -xla_sum(lam, 2) + xla_sum(lam, 1)
        h = xla_sum(hl, 2) + xla_sum(hl, 1)
        return g, h

    def _scatter(self, rows, vals, n):
        """vals [num_groups, G] added onto zeros at their rows, [n]."""
        out = torch.zeros(n + 1, dtype=torch.float32, device=vals.device)
        return out.index_add_(0, rows.reshape(-1), vals.reshape(-1))[:n]

    def grad_hess(self, labels, preds):
        n = preds.shape[0]
        rows, s, y, m = self._gather_groups("train", labels, preds)
        G = s.shape[1]
        chunk = max(1, GROUP_CHUNK_BYTES // (G * G * 4))
        parts = [self.lambdas(s[a:a + chunk], y[a:a + chunk], m[a:a + chunk])
                 for a in range(0, s.shape[0], chunk)]
        g = torch.cat([p[0] for p in parts])
        h = torch.cat([p[1] for p in parts])
        return (self._scatter(rows, torch.where(m, g, 0.0), n),
                self._scatter(rows, torch.where(m, h, 0.0), n))

    def loss(self, labels, preds, weights, tag: str = "train"):
        """-NDCG@truncation averaged over the groups with a relevant
        row."""
        _, s, y, m = self._gather_groups(tag, labels, preds)
        pos_disc = position_discounts(s.shape[1], self.ndcg_truncation,
                                      s.device)
        gains = exp2_gains(y, m)
        order = argsort_f32(-torch.where(m, s, float("-inf")))
        dcg = discounted_sum(torch.gather(gains, 1, order), pos_disc)
        ideal = torch.sort(gains, dim=1, descending=True).values
        idcg = discounted_sum(ideal, pos_disc)
        ok = idcg > 0
        ndcg = torch.where(ok, dcg / (idcg + _EPS), 0.0)
        return (-group_total(ndcg, s.shape[1] > 32)
                / (ok.sum().float() + _EPS))


def masked_softmax(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over each group's valid rows (padding at -inf)
    as XLA computes it: the row max subtracted, XLA's exp, the sum in
    XLA's order, one division; 0 on padding."""
    sm = torch.where(m, s, float("-inf"))
    e = exp_f32(sm - sm.amax(dim=1, keepdim=True))
    e = torch.where(m, e, 0.0)
    return torch.where(m, flush(e / xla_sum(e, 1)[:, None]), 0.0)


class XeNdcg(LambdaMartNdcg):
    """Cross-entropy NDCG surrogate (Bruch et al. 2020; the JAX
    package's XeNdcg, Loss XE_NDCG_MART): each group's softmax over its
    scores is pulled toward its normalized gains; groups without a
    relevant row contribute nothing. Hessians are floored at 1e-6."""

    name = "XE_NDCG_MART"

    def _terms(self, s, y, m):
        """(p, t, valid): softmax scores and gain targets [num_groups,
        G] (0 on padding) and whether the group has a relevant row."""
        p = masked_softmax(s, m)
        gains = exp2_gains(y, m)
        denom = xla_sum(gains, 1)
        valid = denom > 0
        t = torch.where(valid[:, None], gains / (denom[:, None] + _EPS), 0.0)
        return p, t, valid

    def grad_hess(self, labels, preds):
        n = preds.shape[0]
        rows, s, y, m = self._gather_groups("train", labels, preds)
        p, t, valid = self._terms(s, y, m)
        g = torch.where(valid[:, None], p - t, 0.0)
        h = torch.where(valid[:, None], p * (1.0 - p), 0.0)
        return (self._scatter(rows, g, n),
                torch.clamp_min(self._scatter(rows, h, n), 1e-6))

    def loss(self, labels, preds, weights, tag: str = "train"):
        _, s, y, m = self._gather_groups(tag, labels, preds)
        p, t, valid = self._terms(s, y, m)
        ce = -xla_sum(t * log_f32(p + _EPS), 1)
        ce = torch.where(valid, ce, 0.0)
        return (group_total(ce, s.shape[1] > 32)
                / (valid.sum().float() + _EPS))
