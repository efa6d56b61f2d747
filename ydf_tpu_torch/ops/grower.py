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
so the routing table of a categorical split is any per-bin mask. One
ordering per categorical feature (the binomial and squared-error
losses). All features are candidates at every node, no monotone
constraints. Ties pick the first best cut, as jnp.argmax does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ydf_tpu_torch.ops.histogram import histogram, prepare_stats_for_hist
from ydf_tpu_torch.ops.histogram_kernels import RouteTables, route_plain
from ydf_tpu_torch.ops.routing import route_histogram_fused
from ydf_tpu_torch.utils import prng


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
    split_rank: torch.Tensor    # i64 [Ld] rank among this layer's splits
    wid: torch.Tensor           # i64 [Ld] node write index (N = trash)
    left_id: torch.Tensor       # i64 [Ld] child ids (N = none)
    right_id: torch.Tensor
    best_t: torch.Tensor        # i64 [Ld] chosen cut
    best_f: torch.Tensor        # i64 [Ld] chosen feature
    go_left_bins: torch.Tensor  # bool [Ld, B]
    left_stats: torch.Tensor    # f32 [Ld, S]
    right_stats: torch.Tensor
    num_nodes: torch.Tensor     # i32 [] updated node count


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
    """Left stats of every cut, [Ld, F, B, S]: prefix sums over the bins
    of a numerical feature, over the sorted bins of a categorical one;
    and each categorical bin's rank in its order, i64 [Ld, Fc, B] (None
    without categorical features). Prefixes and the sort key are f32
    with the JAX package's rounding (jnp.cumsum's blocked scan,
    prng.cumsum_f32; a sequential scan, torch.cumsum or f64 sums round
    otherwise), so a near tie breaks the same way in both packages."""
    Fn = num_numerical
    if Fn == hist.shape[1]:
        return prng.cumsum_f32(hist, 2), None
    hist_cat = hist[:, Fn:]  # [Ld, Fc, B, S]
    # Empty bins sort last, so unseen categories route right.
    key = torch.where(hist_cat[..., -1] > 0, rule.cat_sort_key(hist_cat),
                      float("inf"))
    # Stable, as jnp.argsort: ties keep the bins' order.
    order = torch.argsort(key, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    sorted_hist = torch.gather(
        hist_cat, 2, order[..., None].expand(hist_cat.shape))
    # One scan for both blocks: the scan is per (slot, feature, stat).
    return prng.cumsum_f32(torch.cat([hist[:, :Fn], sorted_hist], dim=1),
                           2), ranks


def layer_decide(left_all, ranks, parent, active, nid, num_nodes, *, rule,
                 L: int, B: int, N: int, num_numerical: int,
                 min_examples: int, min_split_gain: float,
                 children_in_frontier: bool) -> LayerDecision:
    """One layer's split search: gains -> validity -> best cut per slot
    -> frontier-overflow cap -> child allocation -> chosen stats and the
    per-bin routing masks (a prefix of bin ids for a numerical split,
    the bins ranked <= the cut for a categorical one; `ranks` from
    scalar_candidates)."""
    Ld, F = left_all.shape[0], left_all.shape[1]
    dev = left_all.device
    right_all = parent[:, None, None, :] - left_all
    gain = rule.gain(left_all, right_all, parent[:, None, None, :])
    valid = (
        (left_all[..., -1] >= min_examples)
        & (right_all[..., -1] >= min_examples)
        & active[:, None, None]
    )
    gain = torch.where(valid, gain, float("-inf"))

    flat = gain.reshape(Ld, F * B)
    best_idx = torch.argmax(flat, dim=1)
    best_gain = torch.gather(flat, 1, best_idx[:, None])[:, 0]
    best_f = best_idx // B
    best_t = best_idx % B

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

    chosen = torch.gather(
        left_all, 1,
        best_f[:, None, None, None].expand(Ld, 1, B, left_all.shape[3]),
    )[:, 0]  # [Ld, B, S]
    left_stats = torch.gather(
        chosen, 1, best_t[:, None, None].expand(Ld, 1, chosen.shape[2])
    )[:, 0]
    right_stats = parent - left_stats
    cut_ids = torch.arange(B, device=dev)
    go_left_bins = cut_ids[None, :] <= best_t[:, None]
    is_cat_split = best_f >= num_numerical
    if ranks is not None:
        Fc = ranks.shape[1]
        chosen_rank = torch.gather(
            ranks, 1,
            (best_f - num_numerical).clamp(0, Fc - 1)[:, None, None].expand(
                Ld, 1, B))[:, 0]  # [Ld, B]
        go_left_bins = torch.where(is_cat_split[:, None],
                                   chosen_rank <= best_t[:, None],
                                   go_left_bins)
    num_nodes_new = (num_nodes + 2 * do_split.sum()).to(torch.int32)
    return LayerDecision(
        do_split=do_split, is_cat_split=is_cat_split,
        split_rank=split_rank, wid=wid, left_id=left_id,
        right_id=right_id, best_t=best_t, best_f=best_f,
        go_left_bins=go_left_bins, left_stats=left_stats,
        right_stats=right_stats, num_nodes=num_nodes_new,
    )


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
) -> GrowResult:
    """Grows one tree (module docstring). Rows [0, num_numerical) of
    `bins_t` are numerical features, the rest categorical (default: all
    numerical). `hist_quant` is the stats operand's precision, as in
    ops/histogram.py."""
    F, n = bins_t.shape
    Fn = F if num_numerical is None else num_numerical
    S = stats.shape[1]
    L, B, N = frontier, num_bins, max_nodes
    W = (B + 31) // 32
    dev = stats.device
    i32 = torch.int32
    # Writes of Python numbers into device tensors go through fill_ /
    # index_fill_: an item assignment would copy the number from the host
    # and synchronize.
    feature = torch.full((N + 1,), -1, dtype=i32, device=dev)
    threshold_bin = torch.zeros(N + 1, dtype=i32, device=dev)
    is_cat = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    cat_mask = torch.zeros((N + 1, W), dtype=i32, device=dev)
    left = torch.zeros(N + 1, dtype=i32, device=dev)
    right = torch.zeros(N + 1, dtype=i32, device=dev)
    is_leaf = torch.ones(N + 1, dtype=torch.bool, device=dev)
    leaf_stats = torch.zeros((N + 1, S), dtype=torch.float32, device=dev)

    # int8: ONE scale per tree, so parent - child cancels exactly on the
    # quantized grid (the JAX package's per-tree-scale design note).
    hist_stats, qscale, total = prepare_stats_for_hist(stats, hist_quant)
    leaf_stats[0] = total

    frontier_id = torch.full((L + 1,), N, dtype=torch.int64, device=dev)
    frontier_id[:1].fill_(0)
    node_stats = torch.zeros((L + 1, S), dtype=torch.float32, device=dev)
    node_stats[0] = total
    slot = torch.zeros(n, dtype=i32, device=dev)
    leaf_id = torch.zeros(n, dtype=i32, device=dev)
    num_nodes = torch.ones((), dtype=i32, device=dev)
    sub_state = None  # (parent hist, small_is_left, Lh) under subtraction
    tables: Optional[RouteTables] = None  # previous layer's decisions
    no_set = torch.zeros(1, dtype=torch.uint8, device=dev)

    for depth in range(max_depth):
        children_in_frontier = depth + 1 < max_depth
        Ld = min(2**depth, L)
        parent = node_stats[:Ld]
        active = frontier_id[:Ld] < N

        if tables is None:
            hist = histogram(bins_t, slot, hist_stats, num_slots=Ld,
                             num_bins=B, quant=hist_quant,
                             quant_scale=qscale)
        elif sub_state is not None:
            parent_hist, small_is_left, Lh = sub_state
            hist_small, slot, leaf_id = route_histogram_fused(
                bins_t, slot, leaf_id, tables, hist_stats, num_slots=Lh,
                num_bins=B, quant_scale=qscale,
            )
            hist = sibling_reconstruct(hist_small, parent_hist,
                                       small_is_left, Ld)
        else:
            # Frontier of one slot: no subtraction, identity hmap.
            hist, slot, leaf_id = route_histogram_fused(
                bins_t, slot, leaf_id, tables, hist_stats, num_slots=Ld,
                num_bins=B, quant_scale=qscale,
            )
        left_all, ranks = scalar_candidates(hist, num_numerical=Fn,
                                            rule=rule)

        dec = layer_decide(
            left_all, ranks, parent, active, frontier_id[:Ld], num_nodes,
            rule=rule, L=L, B=B, N=N, num_numerical=Fn,
            min_examples=min_examples,
            min_split_gain=min_split_gain,
            children_in_frontier=children_in_frontier,
        )
        do_split, split_rank = dec.do_split, dec.split_rank
        feature[dec.wid] = dec.best_f.to(i32)
        threshold_bin[dec.wid] = dec.best_t.to(i32)
        is_cat[dec.wid] = dec.is_cat_split
        cat_mask[dec.wid] = pack_mask(dec.go_left_bins)
        left[dec.wid] = dec.left_id.to(i32)
        right[dec.wid] = dec.right_id.to(i32)
        is_leaf.index_fill_(0, dec.wid, False)
        leaf_stats[dec.left_id] = dec.left_stats
        leaf_stats[dec.right_id] = dec.right_stats
        num_nodes = dec.num_nodes

        hmap = None
        if children_in_frontier and L // 2 >= 1:
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
        tables = RouteTables(
            do_split=_pad(do_split, L + 1, False),
            route_f=_pad(dec.best_f.to(i32), L + 1, 0),
            go_left=_pad(dec.go_left_bins, L + 1, False),
            left_id=_pad(dec.left_id.to(i32), L + 1, N),
            right_id=_pad(dec.right_id.to(i32), L + 1, N),
            split_rank=_pad(split_rank.to(i32), L + 1, 0),
            hmap=hmap,
            is_set=torch.zeros(L + 1, dtype=torch.bool, device=dev),
            set_go_left=no_set,
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
            leaf_id = route_plain(bins_t, slot, leaf_id, tables)[1]

    tree = TreeArrays(
        feature=feature[:N], threshold_bin=threshold_bin[:N],
        is_cat=is_cat[:N],
        is_set=torch.zeros(N, dtype=torch.bool, device=dev),
        cat_mask=cat_mask[:N], left=left[:N], right=right[:N],
        is_leaf=is_leaf[:N], leaf_stats=leaf_stats[:N], num_nodes=num_nodes,
    )
    return GrowResult(tree=tree, leaf_id=leaf_id)
