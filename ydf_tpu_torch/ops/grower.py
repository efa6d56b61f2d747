"""Layer-synchronous decision-tree grower, numerical and categorical
features (counterpart of ydf_tpu/ops/grower.py: sibling_reconstruct,
scalar_candidates, layer_decide, sibling_next_state and the grow_tree
layer loop).

Per layer: histogram -> prefix sums over bins -> hessian gains -> best cut
per frontier slot -> child allocation -> routing. Every shape is static
(layer d holds Ld = min(2^d, L) candidate slots; the frontier has L slots
plus the trash slot L; node arrays have N slots plus the trash row N), so
a tree is a fixed sequence of launches and the loop never reads a device
value on the host.

The loop has the JAX package's fused structure (its default on a CPU):
  * the root layer: one histogram (csrc/histogram.cu);
  * every deeper layer: one fused route + histogram
    (csrc/histogram_routed.cu) that applies the previous layer's
    decision tables to each row and accumulates this layer's histogram
    of the SMALLER child of every split (sibling subtraction: the larger
    child's histogram is parent - small child);
  * the last layer: one standalone route of the rows to their leaves.

Feature order in the bins: [numericals..., categoricals...]. A
numerical cut t sends bins <= t left; a categorical feature's bins are
sorted by the rule's key (empty bins last, a stable sort, as
jnp.argsort), and cut t sends the t + 1 first bins of that order left,
so the routing table of a categorical split is any per-bin mask. A rule
may scan O orders per categorical feature (`num_cat_orderings`: one per
class for multiclass classification); each order is a candidate column,
so the candidate columns are [Fn numericals, Fc x O categorical
orders]. Ties pick the first best cut, as jnp.argmax does.

Categorical-set features (packed multi-hot rows, `set_bits` [n, Fs, W]
as i32 bit patterns) are candidates of their own, after the scalar
columns: Fs columns that sort a slot's items ascending by the rule's
key, then Fs that sort them descending (items absent from the slot
last in both). Per layer: the per-(slot, feature, item) stats (the JAX
package's einsum "nfv,nl,ns->lfvs", summed in XLA's CPU dot order:
blocks of dot_block_rows rows in row order, the blocks' sums in block
order; set_item_stats, its run sums through csrc/segment_sum.cu), each
item's rank in both orders (stable argsorts), each row's least rank
over its items, and one prefix
histogram a set feature and order over the rows whose least rank lies
in the first Tc = min(Vs, B) cuts (ops/histogram.py, csrc/histogram.cu
at Ld slots and Tc bins). Cut t selects the items ranked <= t; a row
holding one of them goes RIGHT, so the left stats are parent - prefix.
The node stores the selected items as its mask (32 * W bits, W the
wider of B / 32 and the sets' words) and the feature id F + f; each
row's direction (least rank > t: left) goes into the routed kernel's
`is_set` / `set_go_left` tables.

With set features alone (no scalar column, `bins_t` [0, n]; the JAX
package's F == 0 branches) the candidates are the set columns only: no
histogram of scalar columns is built, there is no sibling subtraction,
and the rows are routed every layer by route_plain (its bin gather
skipped: every scalar decision goes right, the set tables decide).

A rule may add its own validity (`split_valid(left, right)`: uplift's
rows of each treatment arm) and the gain the grower compares with
min_split_gain at each slot's chosen cut (`chosen_gain`; the argmax
reads `gain`): XLA computes the two in different fusions, so their
roundings can differ (ops/split_rules.py).

Monotone constraints (the JAX package's `monotone` / `monotone_dirs`):
`mono_dirs` f32 holds a direction (+1, -1, 0) for the leading candidate
columns; a cut on a column with direction d is valid only when d *
(leaf_value(right) - leaf_value(left)) >= 0. The leaves are clamped
after training (learners/gbt.py:clamp_monotone_leaves).

Per-node candidate features (a random forest's attribute sampling,
the JAX package's layer_decide): every layer d draws key, k_gain, k_feat
= split(fold_in(key, d), 3) from the tree's key, scores u =
uniform(k_feat, [Ld, F]) and keeps, in each slot, the features whose
score is at least the k-th largest (the value, so that a tie at the
boundary lets every tied feature in). The scores depend on the seed
alone, so a learner draws them for every tree before its loop
(`layer_columns`, one host read of each layer's widest set) and hands
the grower each layer's candidate columns (`candidate_columns`: the kept
columns in ascending order, padded to the most any slot keeps); the
gains are computed on those columns only. A rule that `takes_key` (the
isolation forest's random splits) gets the same layer's k_gain and a
rule context with the stats, and draws its noise on the device in the
loop.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ydf_tpu_torch.ops.histogram import (
    finish, histogram, prepare_stats_for_hist)
from ydf_tpu_torch.ops.histogram_kernels import RouteTables, route_plain
from ydf_tpu_torch.ops import segment_sum
from ydf_tpu_torch.ops.routing import route_histogram_fused
from ydf_tpu_torch.utils import prng


def dot_block_rows(items: int) -> int:
    """Rows of one block of XLA's CPU dot over the rows in the set
    candidates' per-item sums (set_item_stats), for `items` = Fs * Vs
    columns (jax 0.9.0, read by probing the einsum): 512 from 64 items
    on (64 to 1024 probed, at 1 to 32 slots), 1024 at 32 items (probed
    at 1, 2 and 8 slots; at 32 slots the order is another, ROADMAP
    Queue 3)."""
    return 512 if items >= 64 else 1024

#: When a list, layer_decide appends each layer's two best gains per slot
#: (f32 [Ld, 2]): a diagnostic of near ties; None (the default) records
#: nothing.
GAIN_TRACE: Optional[list] = None


class TreeArrays(NamedTuple):
    """One tree's node arrays, capacity N (field meanings as in the JAX
    package's ops/grower.py:TreeArrays)."""

    feature: torch.Tensor        # i32 [N], -1 on leaves
    threshold_bin: torch.Tensor  # i32 [N]: bin <= t goes left
    is_cat: torch.Tensor         # bool [N]
    is_set: torch.Tensor         # bool [N]
    cat_mask: torch.Tensor       # i32 [N, W] bits (u32 in numpy)
    left: torch.Tensor           # i32 [N]
    right: torch.Tensor          # i32 [N]
    is_leaf: torch.Tensor        # bool [N]
    leaf_stats: torch.Tensor     # f32 [N, S]
    num_nodes: torch.Tensor      # i32 []


class GrowResult(NamedTuple):
    tree: TreeArrays
    leaf_id: torch.Tensor  # i32 [n]: leaf node of every row


class LayerDecision(NamedTuple):
    do_split: torch.Tensor      # bool [Ld]
    is_cat_split: torch.Tensor  # bool [Ld]
    best_f_scalar: torch.Tensor  # i64 [Ld] the chosen column's feature
    split_rank: torch.Tensor    # i64 [Ld] rank among this layer's splits
    wid: torch.Tensor           # i64 [Ld] node write index (N = trash)
    left_id: torch.Tensor       # i64 [Ld] child ids (N = none)
    right_id: torch.Tensor
    best_t: torch.Tensor        # i64 [Ld] chosen cut
    best_f: torch.Tensor        # i64 [Ld] chosen candidate column
    go_left_bins: torch.Tensor  # bool [Ld, B]
    left_stats: torch.Tensor    # f32 [Ld, S]
    right_stats: torch.Tensor
    num_nodes: torch.Tensor     # i32 [] updated node count
    is_set_split: Optional[torch.Tensor] = None  # bool [Ld] (set features)
    fset: Optional[torch.Tensor] = None      # i64 [Ld] chosen set feature
    set_dir: Optional[torch.Tensor] = None   # bool [Ld]: descending order
    store_mask: Optional[torch.Tensor] = None  # bool [Ld, 32 W] node mask


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool [..., B] -> i32 [..., B/32] bit patterns (u32 words)."""
    B = mask.shape[-1]
    w = (B + 31) // 32
    if 32 * w != B:
        pad = torch.zeros(mask.shape[:-1] + (32 * w - B,), dtype=mask.dtype,
                          device=mask.device)
        mask = torch.cat([mask, pad], dim=-1)
    bits = mask.reshape(mask.shape[:-1] + (w, 32)).long()
    shifts = torch.arange(32, device=mask.device)
    words = torch.sum(bits << shifts, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def sibling_reconstruct(hist_small: torch.Tensor, parent_hist: torch.Tensor,
                        small_is_left: torch.Tensor, Ld: int) -> torch.Tensor:
    """[Lh, F, B, S] smaller-child histograms + the carried parents ->
    the full [Ld, F, B, S] layer (larger sibling = parent - child; split
    s's children sit at slots 2s, 2s+1)."""
    Lh = hist_small.shape[0]
    hist_big = parent_hist - hist_small
    sil = small_is_left[:, None, None, None, None]
    hist = torch.where(
        sil,
        torch.stack([hist_small, hist_big], dim=1),
        torch.stack([hist_big, hist_small], dim=1),
    ).reshape((2 * Lh,) + hist_small.shape[1:])
    if 2 * Lh < Ld:  # odd frontier cap: the top slots are never used
        pad = hist.new_zeros((Ld - 2 * Lh,) + hist.shape[1:])
        hist = torch.cat([hist, pad], dim=0)
    return hist


def scalar_candidates(hist: torch.Tensor, *, num_numerical: int, rule
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Left stats of every cut, [Ld, Fn + Fc * O, B, S]: prefix sums
    over the bins of a numerical feature, over the sorted bins of each of
    a categorical feature's O orders (O = rule.num_cat_orderings); and
    each categorical bin's rank in each order, i64 [Ld, Fc * O, B] (None
    without categorical features). Prefixes and the sort key are f32
    with the JAX package's rounding (jnp.cumsum's blocked scan,
    prng.cumsum_f32; a sequential scan, torch.cumsum or f64 sums round
    otherwise), so a near tie breaks the same way in both packages."""
    Fn = num_numerical
    if Fn == hist.shape[1]:
        return prng.cumsum_f32(hist, 2), None
    Ld, F, B, S = hist.shape
    O = rule.num_cat_orderings
    hist_cat = hist[:, Fn:]  # [Ld, Fc, B, S]
    if O > 1:
        key = rule.cat_sort_keys(hist_cat)              # [Ld, Fc, O, B]
    else:
        key = rule.cat_sort_key(hist_cat)[:, :, None]   # [Ld, Fc, 1, B]
    # Empty bins sort last, so unseen categories route right.
    key = torch.where((hist_cat[..., -1] > 0)[:, :, None], key,
                      float("inf"))
    # Stable, as jnp.argsort: ties keep the bins' order.
    order = torch.argsort(key, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    sorted_hist = torch.gather(
        hist_cat[:, :, None].expand(-1, -1, O, -1, -1), 3,
        order[..., None].expand(-1, -1, -1, -1, S))  # [Ld, Fc, O, B, S]
    # One scan for both blocks: the scan is per (slot, column, stat).
    return prng.cumsum_f32(torch.cat(
        [hist[:, :Fn], sorted_hist.reshape(Ld, -1, B, S)], dim=1), 2), \
        ranks.reshape(Ld, -1, B)


def layer_feature_keys(key: torch.Tensor, max_depth: int
                       ) -> List[torch.Tensor]:
    """k_feat of every layer (keys [..., 2]) from the trees' grow keys
    [..., 2]: key, k_gain, k_feat = split(fold_in(key, d), 3)."""
    out = []
    for depth in range(max_depth):
        ks = prng.split(prng.fold_in(key, depth), 3)
        key = ks[..., 0, :]
        out.append(ks[..., 2, :])
    return out


def candidate_masks(k_feat: torch.Tensor, Ld: int, F: int,
                    k: int, pad_columns: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """bool [..., Ld, F]: the features each slot of a layer may split on,
    from the layer's keys [..., 2] (kept_by_score of uniform scores).
    `pad_columns` (start, stop): constant-zero columns a mesh's feature
    axis padded in, scored -1 so that they take no sampling slot (the
    JAX package's num_valid_features)."""
    scores = prng.uniform(k_feat, (Ld, F))
    if pad_columns is not None:
        col = torch.arange(F, device=scores.device)
        pad = (col >= pad_columns[0]) & (col < pad_columns[1])
        scores = torch.where(pad, -1.0, scores)
    return kept_by_score(scores, k)


def kept_by_score(scores: torch.Tensor, k: int) -> torch.Tensor:
    """bool [..., F]: a score at least the k-th largest of its row
    (jax.lax.top_k's k-th value, compared by value: every feature tied
    with it is kept)."""
    kth = torch.topk(scores, k, dim=-1).values[..., -1:]
    return scores >= kth


def column_mask(mask: torch.Tensor, num_numerical: int,
                orderings: int, num_set: int = 0) -> torch.Tensor:
    """Feature mask [..., F + Fs] -> candidate-column mask [..., Fn + Fc *
    O + 2 Fs]: a categorical feature's O order columns share its score,
    and a set feature's two direction columns share its."""
    Fn = num_numerical
    F = mask.shape[-1] - num_set
    return torch.cat([mask[..., :Fn],
                      mask[..., Fn:F].repeat_interleave(orderings, dim=-1),
                      mask[..., F:], mask[..., F:]], dim=-1)


def candidate_columns(cmask: torch.Tensor, width: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Column mask [..., C] -> (the kept columns in ascending order, i64
    [..., width], padded with unkept ones; bool [..., width]: kept).
    `width` is at least the most columns any slot keeps."""
    idx = torch.argsort((~cmask).to(torch.uint8), dim=-1,
                        stable=True)[..., :width]
    return idx, torch.gather(cmask, -1, idx)


def layer_columns(tree_keys: torch.Tensor, *, max_depth: int,
                  frontier: int, num_features: int, num_numerical: int,
                  orderings: int, k: int, num_set: int = 0,
                  num_valid: Optional[int] = None) -> List[tuple]:
    """Per layer, every tree's candidate columns from the trees' grow
    keys [T, 2] (candidate_columns of column_mask of candidate_masks:
    i32 [T, Ld, W], bool [T, Ld, W]), W the most columns a slot of that
    layer keeps in any tree: one host read of the widths, for all
    layers. `num_features` counts the scalar features; the scores cover
    them and the `num_set` set features after them. Scalar columns from
    `num_valid` on are a mesh's padding (candidate_masks)."""
    masks, widths = [], []
    pad = (None if num_valid is None or num_valid >= num_features
           else (num_valid, num_features))
    for d, k_feat in enumerate(layer_feature_keys(tree_keys, max_depth)):
        cm = column_mask(candidate_masks(k_feat, min(2 ** d, frontier),
                                         num_features + num_set, k, pad),
                         num_numerical, orderings, num_set)
        masks.append(cm)
        widths.append(cm.sum(-1).amax())
    widths = torch.stack(widths).tolist()
    out = []
    for cm, W in zip(masks, widths):
        idx, ok = candidate_columns(cm, max(int(W), 1))
        out.append((idx.to(torch.int32), ok))
    return out


def layer_decide(left_all, ranks, parent, active, nid, num_nodes, *, rule,
                 L: int, B: int, N: int, num_numerical: int,
                 min_examples: int, min_split_gain: float,
                 children_in_frontier: bool,
                 columns: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 gain_args: tuple = (), num_set: int = 0,
                 set_ranks: Optional[Sequence[torch.Tensor]] = None,
                 mask_words: int = 0,
                 mono_dirs: Optional[torch.Tensor] = None) -> LayerDecision:
    """One layer's split search: gains -> validity -> best cut per slot
    -> frontier-overflow cap -> child allocation -> chosen stats and the
    per-bin routing masks (a prefix of bin ids for a numerical split,
    the bins ranked <= the cut for a categorical one; `ranks` from
    scalar_candidates). `columns` (candidate_columns: i64 [Ld, K] and
    its kept mask) restricts each slot to those columns; they are in
    ascending order, so the first best cut is the JAX package's.
    `gain_args` follow the stats into rule.gain (a rule that
    `takes_key`: the layer's gain key and the rule context). The last
    2 * num_set columns are set candidates (ascending, then descending;
    `set_ranks` the items' ranks in both orders, [Ld, Fs, Vs] each):
    a set split stores the items ranked <= its cut as a mask of
    32 * mask_words bits. `mono_dirs` f32 [<= columns] are the leading
    columns' monotone directions (module docstring)."""
    Ld, Fa = left_all.shape[0], left_all.shape[1]
    dev = left_all.device
    O = rule.num_cat_orderings
    Fn = num_numerical
    Fcand = Fa - 2 * num_set
    F = Fn + (Fcand - Fn) // O  # scalar features
    if columns is None:
        cand = left_all
    else:
        col_idx, col_ok = columns
        cand = torch.gather(left_all, 1, col_idx[:, :, None, None].expand(
            -1, -1, B, left_all.shape[3]))
    K = cand.shape[1]
    right_all = parent[:, None, None, :] - cand
    gain = rule.gain(cand, right_all, parent[:, None, None, :], *gain_args)
    valid = (
        (cand[..., -1] >= min_examples)
        & (right_all[..., -1] >= min_examples)
        & active[:, None, None]
    )
    if hasattr(rule, "split_valid"):
        # A rule's own validity (uplift: rows of each treatment arm).
        valid &= rule.split_valid(cand, right_all)
    if columns is not None:
        valid &= col_ok[:, :, None]
    if mono_dirs is not None:
        dirs = torch.zeros(Fa, dtype=torch.float32, device=dev)
        dirs[:mono_dirs.shape[0]] = mono_dirs.float()
        d = (dirs[None, :] if columns is None
             else dirs[col_idx])[:, :, None]  # [1 or Ld, K, 1]
        leaf_l = rule.leaf_value(cand)[..., 0]
        leaf_r = rule.leaf_value(right_all)[..., 0]
        valid &= (d == 0) | (d * (leaf_r - leaf_l) >= 0)
    gain = torch.where(valid, gain, float("-inf"))

    flat = gain.reshape(Ld, K * B)
    best_idx = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best_idx[:, None])[:, 0]
    best_f = best_idx // B
    best_t = best_idx % B
    if columns is not None:
        best_f = torch.gather(col_idx, 1, best_f[:, None])[:, 0]
    if GAIN_TRACE is not None:
        GAIN_TRACE.append(torch.topk(flat, min(2, flat.shape[1]),
                                     dim=1).values)

    chosen = torch.gather(
        left_all, 1,
        best_f[:, None, None, None].expand(Ld, 1, B, left_all.shape[3]),
    )[:, 0]  # [Ld, B, S]
    left_stats = torch.gather(
        chosen, 1, best_t[:, None, None].expand(Ld, 1, chosen.shape[2])
    )[:, 0]
    right_stats = parent - left_stats
    if hasattr(rule, "chosen_gain"):
        # The chosen cut's gain as the JAX grower compares it (the rule's
        # docstring); -inf stays -inf (no valid cut).
        best_gain = torch.where(
            torch.isfinite(best_gain),
            rule.chosen_gain(left_stats, right_stats, parent), best_gain)

    do_split = active & torch.isfinite(best_gain) & (
        best_gain > min_split_gain)
    if children_in_frontier and 2 * Ld > L:
        # Frontier overflow: keep the top L/2 splits by gain.
        key = torch.where(do_split, -best_gain, float("inf"))
        order = torch.argsort(key, stable=True)
        rank_by_gain = torch.argsort(order, stable=True)
        do_split &= rank_by_gain < (L // 2)

    # Node-capacity guard: children that would not fit in N become leaves.
    rank0 = torch.cumsum(do_split.long(), 0) - 1
    do_split &= num_nodes + 2 * (rank0 + 1) <= N
    split_rank = torch.cumsum(do_split.long(), 0) - 1
    wid = torch.where(do_split, nid.long(), N)
    left_id = torch.where(do_split, num_nodes + 2 * split_rank, N)
    right_id = torch.where(do_split, left_id + 1, N)

    cut_ids = torch.arange(B, device=dev)
    go_left_bins = cut_ids[None, :] <= best_t[:, None]
    is_set_split = best_f >= Fcand
    is_cat_split = (best_f >= Fn) & ~is_set_split
    # The order columns collapse back onto their categorical feature.
    best_f_scalar = torch.where(is_cat_split, Fn + (best_f - Fn) // O,
                                best_f)
    if ranks is not None:
        chosen_rank = torch.gather(
            ranks, 1,
            (best_f - Fn).clamp(0, ranks.shape[1] - 1)[
                :, None, None].expand(Ld, 1, B))[:, 0]  # [Ld, B]
        go_left_bins = torch.where(is_cat_split[:, None],
                                   chosen_rank <= best_t[:, None],
                                   go_left_bins)
    set_fields = {}
    if num_set:
        set_dir = (best_f - Fcand) >= num_set
        fset = torch.where(set_dir, best_f - Fcand - num_set,
                           best_f - Fcand)
        Vs = set_ranks[0].shape[-1]
        fclip = fset.clamp(0, num_set - 1)[:, None, None].expand(Ld, 1, Vs)
        chosen_srank = torch.where(
            set_dir[:, None], torch.gather(set_ranks[1], 1, fclip)[:, 0],
            torch.gather(set_ranks[0], 1, fclip)[:, 0])  # [Ld, Vs]
        Wb = 32 * mask_words
        sel = _pad_last(chosen_srank <= best_t[:, None], Wb)
        store = torch.where(is_set_split[:, None], sel,
                            _pad_last(go_left_bins, Wb))
        # A set split's stored id is the scalar count plus its feature.
        best_f_scalar = torch.where(is_set_split, F + fset, best_f_scalar)
        set_fields = dict(is_set_split=is_set_split, fset=fset,
                          set_dir=set_dir, store_mask=store)
    num_nodes_new = (num_nodes + 2 * do_split.sum()).to(torch.int32)
    return LayerDecision(
        do_split=do_split, is_cat_split=is_cat_split,
        best_f_scalar=best_f_scalar,
        split_rank=split_rank, wid=wid, left_id=left_id,
        right_id=right_id, best_t=best_t, best_f=best_f,
        go_left_bins=go_left_bins, left_stats=left_stats,
        right_stats=right_stats, num_nodes=num_nodes_new, **set_fields,
    )


def _pad_last(a: torch.Tensor, size: int) -> torch.Tensor:
    """bool [..., k] padded with False up to [..., size]."""
    if a.shape[-1] >= size:
        return a
    return torch.cat([a, a.new_zeros(a.shape[:-1] + (size - a.shape[-1],))],
                     dim=-1)


def sibling_next_state(hist, do_split, split_rank, left_stats, right_stats,
                       *, Ld: int, L: int):
    """Sibling-subtraction state of the NEXT layer: (parent histograms by
    split rank [Lh, F, B, S], smaller child is left [Lh], Lh, hmap
    [L+1] mapping each next-layer slot to its hist slot, Lh = trash)."""
    dev = hist.device
    Lh = min(Ld, L // 2)
    ridx = torch.where(do_split, split_rank, Lh)
    parent_next = hist.new_zeros((Lh + 1,) + hist.shape[1:])
    parent_next[ridx] = hist
    small_left = left_stats[:, -1] <= right_stats[:, -1]
    small_is_left = torch.zeros(Lh + 1, dtype=torch.bool, device=dev)
    small_is_left[ridx] = small_left
    tgt_l = torch.where(do_split, 2 * split_rank, L)
    tgt_r = torch.where(do_split, 2 * split_rank + 1, L)
    hmap = torch.full((L + 1,), Lh, dtype=torch.int64, device=dev)
    hmap[tgt_l] = torch.where(do_split & small_left, split_rank, Lh)
    hmap[tgt_r] = torch.where(do_split & ~small_left, split_rank, Lh)
    hmap[L:].fill_(Lh)
    return parent_next[:Lh], small_is_left[:Lh], Lh, hmap.to(torch.int32)


class SetMembers(NamedTuple):
    """The set features' memberships for set_item_stats: one entry per
    (row, set feature, item) a row holds, in (row block, item, row)
    order; `item` is f * Vs + v."""

    bits: torch.Tensor   # i32 [n, Fs, Ws] packed rows (u32 bit patterns)
    row: torch.Tensor    # i64 [E]
    item: torch.Tensor   # i64 [E]
    block: torch.Tensor  # i64 [E] row // dot_block_rows(Fs * Vs)

    @property
    def num_set(self) -> int:
        return self.bits.shape[1]

    @property
    def vocab(self) -> int:
        return 32 * self.bits.shape[2]


def set_members(set_bits: torch.Tensor) -> SetMembers:
    """SetMembers of packed set rows i32 [n, Fs, Ws] (one host read, the
    entry count; a learner makes them once, before its tree loop)."""
    n, Fs, Ws = set_bits.shape
    dev = set_bits.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    multi = ((set_bits[..., None] >> shifts) & 1).bool().reshape(n, -1)
    row, item = torch.nonzero(multi, as_tuple=True)  # row-major order
    block = row // dot_block_rows(multi.shape[1])
    # Stable: rows stay ascending within one (block, item).
    order = torch.sort(block * multi.shape[1] + item, stable=True).indices
    return SetMembers(set_bits, row[order], item[order], block[order])


def set_item_stats(members: SetMembers, slot: torch.Tensor,
                   stats: torch.Tensor, Ld: int) -> torch.Tensor:
    """Per-(slot, set feature, item) stats f32 [Ld, Fs, Vs, S]: the JAX
    package's einsum("nfv,nl,ns->lfvs", multi-hot, one-hot slots,
    stats), which XLA's CPU runs as one dot over the rows, summed in
    blocks of dot_block_rows rows: each block's terms added in row order
    from 0, then the blocks' sums in block order, one f32 rounding an
    add. Terms of rows without the item or off the layer's slots are
    zeros and change no sum, so only the memberships are added: the
    (block, slot, item) runs of rows, then each (slot, item)'s run of
    blocks (ops/segment_sum.py, csrc/segment_sum.cu on a card)."""
    S = stats.shape[1]
    FV = members.num_set * members.vocab
    dev = stats.device
    slot_e = slot[members.row].long().clamp(max=Ld)  # Ld: off the layer
    key = (members.block * FV + members.item) * (Ld + 1) + slot_e
    # Stable: each (block, slot, item) run keeps its rows ascending.
    key, perm = torch.sort(key, stable=True)
    slot_p = slot_e[perm]
    live = slot_p < Ld
    vals = torch.where(live[:, None], stats[members.row[perm]], 0.0)
    head = segment_sum.run_heads(key) & live
    acc = segment_sum.segment_sums(key, vals)
    # The block sums of each (slot, item), in block order (the sort is
    # stable and the entries are in block order); the other entries get
    # keys past Ld * FV of their own, runs of one.
    trash = Ld * FV
    cell = torch.where(head, slot_p * FV + members.item[perm],
                       trash + torch.arange(key.shape[0], device=dev))
    cell, perm2 = torch.sort(cell, stable=True)
    total = segment_sum.segment_sums(cell, acc[perm2])
    out = torch.zeros((trash + 1, S), dtype=torch.float32, device=dev)
    keep = segment_sum.run_heads(cell) & (cell < trash)
    out[torch.where(keep, cell, trash)] = total
    return out[:-1].reshape(Ld, members.num_set, members.vocab, S)


def set_candidates(members: SetMembers, slot: torch.Tensor,
                   stats: torch.Tensor, parent: torch.Tensor, *, rule,
                   Ld: int, L: int, B: int):
    """The set features' candidate columns of one layer (the JAX
    package's grower, the categorical-set block): (left stats f32 [Ld,
    2 Fs, B, S], ascending columns then descending; the items' ranks in
    both orders, i64 [Ld, Fs, Vs] each; each row's least rank over its
    items in both orders, i64 [n, Fs] each). Absent items sort last in
    both orders; the prefix histograms run over the rows whose least
    rank is below Tc = min(Vs, B), cut t's left stats are parent minus
    the prefix up to t, and cuts t >= Tc have count -1 (never valid)."""
    Fs, Vs = members.num_set, members.vocab
    Tc = min(Vs, B)
    n = slot.shape[0]
    dev = stats.device
    per_item = set_item_stats(members, slot, stats, Ld)
    skey = rule.cat_sort_key(per_item)  # [Ld, Fs, Vs]
    present = per_item[..., -1] > 0
    f_e = members.item // Vs
    v_e = members.item % Vs
    slot_e = slot[members.row].long()
    ranks_dirs, rank_min_dirs, blocks = [], [], []
    for dkey in (torch.where(present, skey, float("inf")),
                 torch.where(present, -skey, float("inf"))):
        sranks = torch.argsort(torch.argsort(dkey, dim=-1, stable=True),
                               dim=-1, stable=True)
        ranks_pad = torch.cat([sranks, sranks.new_full(
            (L + 1 - Ld, Fs, Vs), Vs)])
        rm = torch.full((n * Fs,), Vs, dtype=torch.long, device=dev)
        rm.scatter_reduce_(0, members.row * Fs + f_e,
                           ranks_pad[slot_e, f_e, v_e], reduce="amin")
        rm = rm.reshape(n, Fs)
        hists = []
        for f in range(Fs):
            in_cut = (rm[:, f] < Tc).float()
            bins_t = torch.clamp(rm[:, f], max=Tc - 1).to(torch.uint8)
            hists.append(histogram(bins_t[None, :], slot,
                                   stats * in_cut[:, None], num_slots=Ld,
                                   num_bins=Tc, quant="f32")[:, 0])
        prefix = prng.cumsum_f32(torch.stack(hists, 1), 2)  # [Ld, Fs, Tc, S]
        left = parent[:, None, None, :] - prefix
        if Tc < B:
            left = torch.cat([left, left.new_full(
                (Ld, Fs, B - Tc, left.shape[3]), -1.0)], dim=2)
        ranks_dirs.append(sranks)
        rank_min_dirs.append(rm)
        blocks.append(left)
    return torch.cat(blocks, dim=1), ranks_dirs, rank_min_dirs


def set_go_left(dec: LayerDecision, rank_min_dirs, slot: torch.Tensor,
                L: int) -> torch.Tensor:
    """u8 [n]: each row's direction at its slot's set split (1 = left:
    its least rank in the split's order lies beyond the cut), for the
    routed kernel's set table."""
    s = slot.long()
    fset = _pad(dec.fset, L + 1, 0)[s]
    desc = _pad(dec.set_dir, L + 1, False)[s]
    t = _pad(dec.best_t, L + 1, 0)[s]
    Fs = rank_min_dirs[0].shape[1]
    f = fset.clamp(0, Fs - 1)[:, None]
    rm = torch.where(desc, torch.gather(rank_min_dirs[1], 1, f)[:, 0],
                     torch.gather(rank_min_dirs[0], 1, f)[:, 0])
    return (rm > t).to(torch.uint8)


def _pad(a: torch.Tensor, size: int, fill) -> torch.Tensor:
    """a [Ld, ...] padded with `fill` up to [size, ...]."""
    extra = a.new_full((size - a.shape[0],) + tuple(a.shape[1:]), fill)
    return torch.cat([a, extra], dim=0)


def grow_tree(
    bins_t: torch.Tensor,   # u8 [F, n] feature-major bins
    stats: torch.Tensor,    # f32 [n, S] weighted per-row stats
    *,
    rule,
    max_depth: int,
    frontier: int,
    max_nodes: int,
    num_bins: int = 256,
    num_numerical: Optional[int] = None,
    min_examples: int = 5,
    min_split_gain: float = 1e-9,
    hist_quant: str = "f32",
    columns: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    key: Optional[torch.Tensor] = None,
    rule_ctx=None,
    set_members: Optional[SetMembers] = None,
    mono_dirs: Optional[torch.Tensor] = None,
    shards=None,
) -> GrowResult:
    """Grows one tree (module docstring). Rows [0, num_numerical) of
    `bins_t` are numerical features, the rest categorical (default: all
    numerical). `hist_quant` is the stats operand's precision, as in
    ops/histogram.py. `columns` holds each layer's candidate columns
    (candidate_columns at Ld = min(2^d, frontier)); None lets every
    column compete at every node. A rule that `takes_key` gets each
    layer's k_gain, drawn from the tree's `key` [2] as the JAX
    package's grower draws it (key, k_gain, k_feat = split(fold_in(key,
    d), 3)), and `rule_ctx`. `set_members` (set_members of the rows'
    packed set features) adds the set candidates; `mono_dirs` (f32, on
    the stats' device) the leading candidate columns' monotone
    directions (module docstring).

    On a mesh, `shards` (parallel/shards.py:TreeShards, the tree's rows
    laid over the devices) replaces `bins_t`: `stats` stays whole on the
    mesh's first device, every layer's kernels run on every shard and
    the split search once on the merged histogram, so the tree is the
    single device's. Distributed training's manager
    (parallel/dist_gbt.py) is the same seam over RPC workers: begin(op,
    L, qscale), root, routed, route_last and leaf_ids."""
    if shards is not None:
        if set_members is not None:
            raise ValueError("set features do not train on a mesh")
        F, n = shards.F, stats.shape[0]
    else:
        F, n = bins_t.shape
    if F == 0 and set_members is None:
        raise ValueError("grow_tree needs a scalar or a set feature")
    Fn = F if num_numerical is None else num_numerical
    S = stats.shape[1]
    L, B, N = frontier, num_bins, max_nodes
    Fs = 0 if set_members is None else set_members.num_set
    Vs = 0 if set_members is None else set_members.vocab
    W = (max(B, Vs) + 31) // 32
    dev = stats.device
    i32 = torch.int32
    # Writes of Python numbers into device tensors go through fill_ /
    # index_fill_: an item assignment would copy the number from the host
    # and synchronize.
    feature = torch.full((N + 1,), -1, dtype=i32, device=dev)
    threshold_bin = torch.zeros(N + 1, dtype=i32, device=dev)
    is_cat = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    is_set = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    cat_mask = torch.zeros((N + 1, W), dtype=i32, device=dev)
    left = torch.zeros(N + 1, dtype=i32, device=dev)
    right = torch.zeros(N + 1, dtype=i32, device=dev)
    is_leaf = torch.ones(N + 1, dtype=torch.bool, device=dev)
    leaf_stats = torch.zeros((N + 1, S), dtype=torch.float32, device=dev)

    # int8: ONE scale per tree, so parent - child cancels exactly on the
    # quantized grid (the JAX package's per-tree-scale design note).
    hist_stats, qscale, total = prepare_stats_for_hist(stats, hist_quant)
    leaf_stats[0] = total
    if Fs:
        # The set candidates sum the same per-row values as the
        # histograms (the dequantized grid under int8, the folded halves
        # under bf16x2).
        if hist_quant == "int8":
            stats_set = hist_stats.float() * qscale
        elif hist_quant == "bf16x2":
            stats_set = hist_stats[:, :S].float() + hist_stats[:, S:].float()
        else:
            stats_set = stats

    frontier_id = torch.full((L + 1,), N, dtype=torch.int64, device=dev)
    frontier_id[:1].fill_(0)
    node_stats = torch.zeros((L + 1, S), dtype=torch.float32, device=dev)
    node_stats[0] = total
    if shards is None:
        slot = torch.zeros(n, dtype=i32, device=dev)
        leaf_id = torch.zeros(n, dtype=i32, device=dev)
    else:
        shards.begin(hist_stats, L, qscale)
    num_nodes = torch.ones((), dtype=i32, device=dev)
    sub_state = None  # (parent hist, small_is_left, Lh) under subtraction
    tables: Optional[RouteTables] = None  # previous layer's decisions
    no_set = torch.zeros(1, dtype=torch.uint8, device=dev)

    takes_key = getattr(rule, "takes_key", False)
    if takes_key and key is None:
        raise ValueError(f"{type(rule).__name__} needs the tree's key")
    for depth in range(max_depth):
        gain_args = ()
        if takes_key:
            ks = prng.split(prng.fold_in(key, depth), 3)
            key = ks[0]
            gain_args = (ks[1], rule_ctx)
        children_in_frontier = depth + 1 < max_depth
        Ld = min(2**depth, L)
        parent = node_stats[:Ld]
        active = frontier_id[:Ld] < N

        if F == 0:
            # Set features alone: no histogram; the previous layer's
            # decisions are applied to the rows by the plain chain.
            if tables is not None:
                slot, leaf_id = route_plain(bins_t, slot, leaf_id,
                                            tables)[:2]
            hist = None
        elif tables is None:
            if shards is None:
                hist = histogram(bins_t, slot, hist_stats, num_slots=Ld,
                                 num_bins=B, quant=hist_quant,
                                 quant_scale=qscale)
            else:
                hist = finish(shards.root(Ld, B), hist_stats, qscale)
        else:
            # Under subtraction the smaller children's Lh hist slots; for
            # a frontier of one slot, no subtraction and the identity hmap.
            Lh = Ld if sub_state is None else sub_state[2]
            if shards is None:
                hist, slot, leaf_id = route_histogram_fused(
                    bins_t, slot, leaf_id, tables, hist_stats, num_slots=Lh,
                    num_bins=B, quant_scale=qscale,
                )
            else:
                hist = finish(shards.routed(tables, Lh, B), hist_stats,
                              qscale)
            if sub_state is not None:
                parent_hist, small_is_left, _ = sub_state
                hist = sibling_reconstruct(hist, parent_hist,
                                           small_is_left, Ld)
        if F == 0:
            left_all = stats.new_zeros((Ld, 0, B, S))
            ranks = None
        else:
            left_all, ranks = scalar_candidates(hist, num_numerical=Fn,
                                                rule=rule)
        set_ranks = rank_min = None
        if Fs:
            left_set, set_ranks, rank_min = set_candidates(
                set_members, slot, stats_set, parent, rule=rule, Ld=Ld,
                L=L, B=B)
            left_all = torch.cat([left_all, left_set], dim=1)

        dec = layer_decide(
            left_all, ranks, parent, active, frontier_id[:Ld], num_nodes,
            rule=rule, L=L, B=B, N=N, num_numerical=Fn,
            min_examples=min_examples,
            min_split_gain=min_split_gain,
            children_in_frontier=children_in_frontier,
            columns=None if columns is None else columns[depth],
            gain_args=gain_args, num_set=Fs, set_ranks=set_ranks,
            mask_words=W, mono_dirs=mono_dirs,
        )
        do_split, split_rank = dec.do_split, dec.split_rank
        feature[dec.wid] = dec.best_f_scalar.to(i32)
        threshold_bin[dec.wid] = dec.best_t.to(i32)
        is_cat[dec.wid] = dec.is_cat_split
        if Fs:
            is_set[dec.wid] = dec.is_set_split
            cat_mask[dec.wid] = pack_mask(dec.store_mask)
        else:
            cat_mask[dec.wid] = pack_mask(dec.go_left_bins)
        left[dec.wid] = dec.left_id.to(i32)
        right[dec.wid] = dec.right_id.to(i32)
        is_leaf.index_fill_(0, dec.wid, False)
        leaf_stats[dec.left_id] = dec.left_stats
        leaf_stats[dec.right_id] = dec.right_stats
        num_nodes = dec.num_nodes

        hmap = None
        if children_in_frontier and L // 2 >= 1 and F > 0:
            parent_next, small_is_left_next, Lh_next, hmap = (
                sibling_next_state(hist, do_split, split_rank,
                                   dec.left_stats, dec.right_stats,
                                   Ld=Ld, L=L)
            )
            sub_state = (parent_next, small_is_left_next, Lh_next)
        else:
            sub_state = None
        if hmap is None:
            hmap = torch.arange(L + 1, dtype=i32, device=dev)
        if Fs:
            # A set split's row directions, from this layer's slots.
            set_tables = dict(
                is_set=_pad(dec.is_set_split, L + 1, False),
                set_go_left=set_go_left(dec, rank_min, slot, L))
        else:
            set_tables = dict(
                is_set=torch.zeros(L + 1, dtype=torch.bool, device=dev),
                set_go_left=no_set)
        tables = RouteTables(
            do_split=_pad(do_split, L + 1, False),
            route_f=_pad(dec.best_f_scalar.clamp(0, max(F - 1, 0)).to(i32),
                         L + 1, 0),
            go_left=_pad(dec.go_left_bins, L + 1, False),
            left_id=_pad(dec.left_id.to(i32), L + 1, N),
            right_id=_pad(dec.right_id.to(i32), L + 1, N),
            split_rank=_pad(split_rank.to(i32), L + 1, 0),
            hmap=hmap, **set_tables,
        )

        if children_in_frontier:
            # The next layer's fused kernel applies `tables` to the rows.
            tgt_l = torch.where(do_split, 2 * split_rank, L)
            tgt_r = torch.where(do_split, 2 * split_rank + 1, L)
            frontier_id = torch.full((L + 1,), N, dtype=torch.int64,
                                     device=dev)
            frontier_id[tgt_l] = dec.left_id
            frontier_id[tgt_r] = dec.right_id
            frontier_id[L:].fill_(N)
            node_stats = torch.zeros((L + 1, S), dtype=torch.float32,
                                     device=dev)
            node_stats[tgt_l] = dec.left_stats
            node_stats[tgt_r] = dec.right_stats
            node_stats[L:].fill_(0.0)
        else:
            # The last layer's standalone route (the JAX package's XLA
            # chain, grower.py:982-1000; no TPU kernel).
            if shards is None:
                leaf_id = route_plain(bins_t, slot, leaf_id, tables)[1]
            else:
                shards.route_last(tables, B)
                leaf_id = shards.leaf_ids()

    tree = TreeArrays(
        feature=feature[:N], threshold_bin=threshold_bin[:N],
        is_cat=is_cat[:N], is_set=is_set[:N],
        cat_mask=cat_mask[:N], left=left[:N], right=right[:N],
        is_leaf=is_leaf[:N], leaf_stats=leaf_stats[:N], num_nodes=num_nodes,
    )
    return GrowResult(tree=tree, leaf_id=leaf_id)
