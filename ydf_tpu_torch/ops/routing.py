"""Tree routing (counterpart of ydf_tpu/ops/routing.py).

Training: `route_histogram_fused`, the fused routing + histogram step of
every layer below the root, through csrc/histogram_routed.cu; and
`route_tree_bins`, a grown tree's leaf for every row of a bin matrix
(the validation rows of early stopping), plain PyTorch as the JAX
package's is XLA.

Serving: value-mode routing in plain PyTorch (route_tree_values /
forest_predict_values), each row's leaf in every tree (forest_leaves)
and the leaves' Breiman proximity (leaf_proximity), plain PyTorch as the
JAX package's are XLA.

This is the generic serving engine (rank 0 in serving/registry.py) and
the oracle the kernels are tested against. It walks `max_depth` steps per
tree; each step reads the current node's condition and steps to a child;
leaves self-loop. Trees are accumulated in order, one f32 add each, the
order of the JAX package's `lax.scan`, so the sums are bit-identical.

Numerical, categorical, sparse-oblique and vector-sequence nodes: a
tree's projections and anchors are computed once per tree, before its
depth loop reads them. A projection is the JAX package's
sum(x_eff * w) over the numerical features (x_eff: x, a missing value
replaced by the tree's oblique_na_repl where that is not NaN, 0 where
w is 0) in the order XLA gives that reduce in the JAX package's routing
(not the order of the learners' dot, ops/oblique.py): fused
multiply-adds in increasing feature order, in one chain up to 21
features; from 24 to 31 features (train_default's 28), the first 24 in
8 lanes (feature k on lane k mod 8), the lanes summed by halves (lane i
+ lane i + 4, then i + 2, then i + 1), the rest chained on after. A NaN
projection takes the node's na_left. Anchors are scored by ops/vector_sequence.py
(csrc/vector_sequence.cu on a card). A categorical-set node holds its
selected items as its mask; a row whose packed set (x_set, u32 words as
i32 [n, Fs, W]) intersects it goes RIGHT (set_intersects); a missing set
takes na_left only where `set_missing` flags it (models that route
missing values natively), else it routes as the empty set.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ydf_tpu_torch.models.forest import Forest
from ydf_tpu_torch.ops import histogram_kernels
from ydf_tpu_torch.ops.histogram import finish
from ydf_tpu_torch.ops.histogram_kernels import RouteTables
from ydf_tpu_torch.ops.vector_sequence import vs_scores
from ydf_tpu_torch.utils.xla_cpu import fma_f32


def set_intersects(cat_mask: torch.Tensor, x_set: torch.Tensor,
                   fs: torch.Tensor) -> torch.Tensor:
    """bool [n]: does each row's packed set of feature fs [n] (clamped
    into [0, Fs)) share an item with its node's mask cat_mask [n, Wn]
    (the JAX package's _set_intersects: the first min(W, Wn) words)?"""
    Fs = x_set.shape[1]
    Wm = min(x_set.shape[2], cat_mask.shape[-1])
    f = fs.clamp(0, Fs - 1).long()
    words = torch.gather(
        x_set, 1, f[:, None, None].expand(-1, 1, x_set.shape[2]))[:, 0, :Wm]
    return ((words & cat_mask[:, :Wm]) != 0).any(dim=1)


def mask_bit_filled(words: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """bool [n]: bit `bit` of the packed rows words [n, W] (int32 bit
    patterns). A word index past W reads as all ones, as the JAX
    oracle's take_along_axis fill does (unpack_mask_bit)."""
    W = words.shape[1]
    w = bit >> 5
    inside = w < W
    if W == 0:
        return torch.ones_like(inside)
    word = torch.gather(words, 1, w.clamp(0, W - 1).long()[:, None])[:, 0]
    return torch.where(inside, ((word >> (bit & 31)) & 1) == 1, True)


def reduce_lanes(num_features: int) -> int:
    """Lanes of XLA's CPU reduce sum(x_eff * w) over `num_features` in
    the JAX package's routing (jax 0.9.0): one chain up to 21 features,
    8 lanes from 24 to 31 (module docstring). Other widths are not
    identified and take one chain (ROADMAP Queue 3)."""
    return 8 if 24 <= num_features <= 31 else 1


def oblique_tree_projections(forest: Forest, t: int,
                             x_num: torch.Tensor) -> torch.Tensor:
    """Projections f32 [n, P] of the rows x_num f32 [n, Fn] on tree t's
    oblique weights (counterpart of the projection in the JAX package's
    route_tree_values; module docstring)."""
    w = forest.oblique_weights[t]   # [P, Fn]
    repl = forest.oblique_na_repl[t]
    n, Fn = x_num.shape[0], w.shape[1]

    def term(k):
        """(x_eff, w) of feature k, [n, P] and [1, P]."""
        x = x_num[:, k, None]
        r = repl[None, :, k]
        x_eff = torch.where(torch.isnan(x) & ~torch.isnan(r), r, x)
        w_k = w[None, :, k]
        return torch.where(w_k != 0, x_eff, 0.0), w_k

    lanes = reduce_lanes(Fn)
    main = Fn - Fn % lanes
    acc = [torch.zeros((n, w.shape[0]), dtype=torch.float32,
                       device=x_num.device) for _ in range(lanes)]
    for k in range(main):
        acc[k % lanes] = fma_f32(*term(k), acc[k % lanes])
    # The lanes' horizontal sum: halves added lane by lane.
    while len(acc) > 1:
        h = len(acc) // 2
        acc = [acc[i] + acc[i + h] for i in range(h)]
    total = acc[0]
    for k in range(main, Fn):
        total = fma_f32(*term(k), total)
    return total


def vs_tree_projections(forest: Forest, t: int,
                        x_vs_vals: List[torch.Tensor],
                        x_vs_len: List[torch.Tensor]) -> torch.Tensor:
    """Scores [n, Pv] of tree t's anchors (counterpart of the JAX
    package's _vs_tree_projections): every VS feature is scored against
    all of the tree's anchors, one kernel launch per feature, and each
    anchor reads its own feature's column. x_vs_vals holds one f32
    [n, L, D] tensor per VS feature, x_vs_len one i32 [n]."""
    anchors = forest.vs_anchor[t].contiguous()
    closer = forest.vs_is_closer[t].contiguous()
    per_feat = torch.stack(
        [vs_scores(v, ln, anchors, closer)
         for v, ln in zip(x_vs_vals, x_vs_len)], dim=1)  # [n, Fv, Pv]
    Fv = per_feat.shape[1]
    fsel = forest.vs_feat[t].long().clamp(0, Fv - 1)
    return torch.gather(
        per_feat, 1, fsel[None, None, :].expand(per_feat.shape[0], 1, -1)
    )[:, 0, :]


def route_tree_values(
    forest: Forest,
    t: int,
    x_num: torch.Tensor,  # f32 [n, Fn] (missing imputed, or NaN)
    x_cat: torch.Tensor,  # i32 [n, Fc] vocabulary indices (-1 = missing)
    num_numerical: int,
    max_depth: int,
    vs_proj: Optional[torch.Tensor] = None,     # f32 [n, Pv] tree t's
    vs_missing: Optional[torch.Tensor] = None,  # bool [n, Fv]
    obl_proj: Optional[torch.Tensor] = None,    # f32 [n, P] tree t's
    x_set: Optional[torch.Tensor] = None,       # i32 [n, Fs, W] packed sets
    set_missing: Optional[torch.Tensor] = None,  # bool [n, Fs]
) -> torch.Tensor:
    """Leaf node id (int64 [n]) of every example in tree `t`. Feature
    index space: [0, Fn) numerical, [Fn, Fn+Fc) categorical,
    [Fn+Fc, F_total) categorical sets (`x_set`, module docstring),
    [F_total, F_total+P) oblique projections, whose values are
    `obl_proj` (oblique_tree_projections; computed here when the tree
    has projections and none is given), [F_total+P, F_total+P+Pv)
    vector-sequence anchors, whose values are `vs_proj`
    (vs_tree_projections). A VS score is never NaN (an empty sequence
    scores -FLT_MAX), so a VS node takes its na_left direction only where
    `vs_missing` flags the cell (models that route missing values
    natively); without it missing cells route as empty ones."""
    n = x_num.shape[0] if x_num.numel() else x_cat.shape[0]
    Fn, Fc = x_num.shape[1], x_cat.shape[1]
    Fs = 0 if x_set is None else x_set.shape[1]
    num_scalar = Fn + Fc
    F_total = num_scalar + Fs
    P = forest.oblique_weights.shape[1]
    if P > 0 and obl_proj is None:
        obl_proj = oblique_tree_projections(forest, t, x_num)
    feature = forest.feature[t].long()
    threshold = forest.threshold[t]
    is_cat = forest.is_cat[t]
    is_set = forest.is_set[t]
    is_leaf = forest.is_leaf[t]
    na_left = forest.na_left[t]
    left = forest.left[t].long()
    right = forest.right[t].long()
    cat_mask = forest.cat_mask[t]  # [N, W]
    node = torch.zeros(n, dtype=torch.long, device=x_num.device)
    for _ in range(max(max_depth, 0)):
        f = feature[node].clamp(min=0)
        if Fn > 0:
            v = torch.gather(x_num, 1, f.clamp(0, Fn - 1)[:, None])[:, 0]
        else:
            v = torch.zeros(n, dtype=torch.float32, device=node.device)
        if Fc > 0:
            fc = (f - num_numerical).clamp(0, Fc - 1)  # int64
            c = torch.gather(x_cat, 1, fc[:, None])[:, 0]
        else:
            c = torch.zeros(n, dtype=torch.int32, device=node.device)
        if P > 0:
            is_obl = (f >= F_total) & (f < F_total + P)
            p = (f - F_total).clamp(0, P - 1)
            v = torch.where(is_obl,
                            torch.gather(obl_proj, 1, p[:, None])[:, 0], v)
        if vs_proj is not None:
            is_vs = f >= F_total + P
            q = (f - F_total - P).clamp(0, vs_proj.shape[1] - 1)
            v = torch.where(is_vs,
                            torch.gather(vs_proj, 1, q[:, None])[:, 0], v)
        node_cat = is_cat[node]
        go_left = torch.where(
            node_cat,
            mask_bit_filled(cat_mask[node], c.clamp(min=0)),
            v < threshold[node],
        )
        # Missing values (NaN numerical / negative categorical code) take
        # the node's stored direction.
        missing = torch.where(node_cat, c < 0, torch.isnan(v))
        if Fs:
            node_set = is_set[node]
            go_left = torch.where(
                node_set,
                ~set_intersects(cat_mask[node], x_set, f - num_scalar),
                go_left)
            sm = torch.zeros_like(missing)
            if set_missing is not None:
                sm = torch.gather(set_missing, 1, (f - num_scalar).clamp(
                    0, Fs - 1)[:, None])[:, 0]
            missing = torch.where(node_set, sm, missing)
        if vs_proj is not None:
            vm = torch.zeros_like(missing)
            if vs_missing is not None:
                fv = forest.vs_feat[t].long()[q].clamp(
                    0, vs_missing.shape[1] - 1)
                vm = torch.gather(vs_missing, 1, fv[:, None])[:, 0]
            missing = torch.where(is_vs, vm, missing)
        go_left = torch.where(missing, na_left[node], go_left)
        nxt = torch.where(go_left, left[node], right[node])
        node = torch.where(is_leaf[node], node, nxt)
    return node


def route_tree_bins(tree, bins_t: torch.Tensor, max_depth: int,
                    x_set: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Leaf node id (int64 [n]) of every row of the feature-major bins
    u8 [F, n] in one grown tree (ops/grower.py:TreeArrays; counterpart of
    ydf_tpu/ops/routing.py:route_tree_bins, impl="xla"): `max_depth`
    steps, each reading the node's feature bin; a categorical node sends
    bin b left when bit b of its mask is set, a numerical one when
    b <= threshold_bin; a set node (feature F + f) sends a row whose
    packed set x_set[:, f] (i32 [n, Fs, W]) misses its mask left; leaves
    self-loop. No host sync: every step is a gather on the tree's
    device."""
    F, n = bins_t.shape
    flat = bins_t.reshape(-1)
    rows = torch.arange(n, device=bins_t.device)
    feature = tree.feature.long()
    left, right = tree.left.long(), tree.right.long()
    node = torch.zeros(n, dtype=torch.long, device=bins_t.device)
    for _ in range(max(max_depth, 0)):
        f = feature[node].clamp(0, max(F - 1, 0))
        b = flat[f * n + rows].long() if F else torch.zeros_like(node)
        go_left = torch.where(
            tree.is_cat[node],
            mask_bit_filled(tree.cat_mask[node], b),
            b <= tree.threshold_bin[node],
        )
        if x_set is not None:
            go_left = torch.where(
                tree.is_set[node],
                ~set_intersects(tree.cat_mask[node], x_set,
                                feature[node] - F),
                go_left)
        nxt = torch.where(go_left, left[node], right[node])
        node = torch.where(tree.is_leaf[node], node, nxt)
    return node


def route_histogram_fused(
    bins_t: torch.Tensor,  # u8 [F, n]
    slot: torch.Tensor,    # i32 [n] previous-layer slot; L = trash
    leaf_id: torch.Tensor,  # i32 [n]
    tables: RouteTables,
    stats: torch.Tensor,   # f32 [n, S] / bf16 [n, 2S] / int8 [n, S]
    *,
    num_slots: int,
    num_bins: int,
    quant_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused previous-layer routing + this-layer histogram (counterpart
    of ydf_tpu/ops/routing.py:route_histogram_fused): one pass over rows
    applies the previous layer's padded [L+1] decision tables and
    accumulates this layer's histogram from each row's hist slot
    hmap[new_slot]. Returns (hist f32 [num_slots, F, B, S], new_slot,
    new_leaf). stats.dtype selects the precision as in
    ops/histogram.py; int8 stats need `quant_scale`."""
    if stats.dtype == torch.int8 and quant_scale is None:
        raise ValueError("int8 fused histogram requires quant_scale")
    acc, new_slot, new_leaf = histogram_kernels.histogram_routed(
        bins_t, slot, leaf_id, tables, stats, num_slots, num_bins
    )
    return finish(acc, stats, quant_scale), new_slot, new_leaf


def forest_predict_values(
    forest: Forest,
    x_num: torch.Tensor,
    x_cat: torch.Tensor,
    num_numerical: int,
    max_depth: int,
    combine: str = "sum",
    x_vs_vals: Optional[torch.Tensor] = None,   # f32 [n, Fv, L, D]
    x_vs_len: Optional[torch.Tensor] = None,    # i32 [n, Fv]
    vs_missing: Optional[torch.Tensor] = None,  # bool [n, Fv]
    x_set: Optional[torch.Tensor] = None,       # i32 [n, Fs, W]
    set_missing: Optional[torch.Tensor] = None,  # bool [n, Fs]
) -> torch.Tensor:
    """Σ (or mean) over trees of routed leaf values: f32 [n, V]. A forest
    with vector-sequence anchors needs the padded sequences
    (Binner.transform_vs on the forest's device), one with set features
    their packed rows."""
    if combine not in ("sum", "mean"):
        raise ValueError(f"combine must be 'sum' or 'mean', got {combine!r}")
    T = forest.num_trees
    n = x_num.shape[0] if x_num.numel() else x_cat.shape[0]
    acc = torch.zeros(
        (n, forest.leaf_value.shape[-1]), dtype=torch.float32,
        device=x_num.device,
    )
    for t, leaves in _tree_leaves(
            forest, x_num, x_cat, num_numerical, max_depth, x_vs_vals,
            x_vs_len, vs_missing, x_set, set_missing):
        acc = acc + forest.leaf_value[t][leaves]
    if combine == "mean":
        # XLA rewrites the oracle's `acc / T` as a multiply by the f32
        # reciprocal; the same rounding here keeps the means bitwise equal.
        return acc * (torch.ones((), dtype=torch.float32) / T).to(acc.device)
    return acc


def _tree_leaves(forest: Forest, x_num, x_cat, num_numerical: int,
                 max_depth: int, x_vs_vals=None, x_vs_len=None,
                 vs_missing=None, x_set=None, set_missing=None):
    """Yields (t, leaf ids int64 [n]) of every tree in order, each tree's
    anchors scored in one batch before its depth loop."""
    has_vs = forest.vs_anchor.numel() > 0
    if has_vs and x_vs_vals is None:
        raise ValueError("this forest has vector-sequence conditions; pass "
                         "x_vs_vals and x_vs_len")
    if has_vs:
        vals = [x_vs_vals[:, j].contiguous()
                for j in range(x_vs_vals.shape[1])]
        lens = [x_vs_len[:, j].contiguous() for j in range(x_vs_len.shape[1])]
    for t in range(forest.num_trees):
        proj = vs_tree_projections(forest, t, vals, lens) if has_vs else None
        yield t, route_tree_values(
            forest, t, x_num, x_cat, num_numerical, max_depth,
            vs_proj=proj, vs_missing=vs_missing, x_set=x_set,
            set_missing=set_missing,
        )


def forest_leaves(
    forest: Forest,
    x_num: torch.Tensor,
    x_cat: torch.Tensor,
    num_numerical: int,
    max_depth: int,
    x_vs_vals: Optional[torch.Tensor] = None,
    x_vs_len: Optional[torch.Tensor] = None,
    vs_missing: Optional[torch.Tensor] = None,
    x_set: Optional[torch.Tensor] = None,
    set_missing: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Leaf node id of every example in every tree: int32 [n, T] on the
    inputs' device (the JAX package's forest_leaves; the reference's
    PredictLeaves). The [T, n] ids are stacked on the device and
    transposed there, so a caller copies them to the host once."""
    n = x_num.shape[0] if x_num.numel() else x_cat.shape[0]
    out = torch.empty((forest.num_trees, n), dtype=torch.int32,
                      device=x_num.device)
    for t, leaves in _tree_leaves(
            forest, x_num, x_cat, num_numerical, max_depth, x_vs_vals,
            x_vs_len, vs_missing, x_set, set_missing):
        out[t] = leaves
    return out.t().contiguous()


#: Compared cells (rows of leaves1 x rows of leaves2 x trees) of one
#: chunk of leaf_proximity: 2^26, the JAX package's cap.
PROXIMITY_CELLS = 1 << 26


def leaf_proximity(leaves1: torch.Tensor, leaves2: torch.Tensor,
                   chunk: int = 1024) -> torch.Tensor:
    """Breiman proximity, the fraction of trees that route a pair to the
    same leaf: f32 [n1, n2] (the JAX package's leaf_proximity; reference
    random_forest.h:211-217). The rows of leaves1 go in chunks of at
    most `chunk` rows and PROXIMITY_CELLS compared cells, so the
    [chunk, n2, T] comparison stays bounded at any n2 and T."""
    n2, T = leaves2.shape
    step = min(chunk, max(1, PROXIMITY_CELLS // max(n2 * T, 1)))
    # XLA takes the mean as the (exact) count times the f32 reciprocal
    # of T; so does this, for the same bits.
    inv_t = (torch.ones((), dtype=torch.float32) / max(T, 1)).to(
        leaves1.device)
    out = torch.empty((leaves1.shape[0], n2), dtype=torch.float32,
                      device=leaves1.device)
    for r0 in range(0, leaves1.shape[0], step):
        same = leaves1[r0:r0 + step, None, :] == leaves2[None, :, :]
        out[r0:r0 + step] = same.sum(dim=2, dtype=torch.int32).to(
            torch.float32) * inv_t
    return out
