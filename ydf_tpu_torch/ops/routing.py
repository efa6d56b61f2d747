"""Value-mode tree routing in plain PyTorch (counterpart of
ydf_tpu/ops/routing.py:route_tree_values / forest_predict_values).

This is the generic serving engine (rank 0 in serving/registry.py) and
the oracle the kernels are tested against. It walks `max_depth` steps per
tree; each step reads the current node's condition and steps to a child;
leaves self-loop. Trees are accumulated in order, one f32 add each, the
order of the JAX package's `lax.scan`, so the sums are bit-identical.

Numerical and categorical nodes only: categorical-set, oblique and
vector-sequence nodes raise NotImplementedError (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import torch

from ydf_tpu_torch.models.forest import Forest


def _check_supported(forest: Forest) -> None:
    internal = ~forest.is_leaf
    if bool((forest.is_set & internal).any()):
        raise NotImplementedError(
            "categorical-set routing is not ported yet "
            "(ROADMAP Queue 1 item 9)"
        )
    if forest.oblique_weights.numel() > 0:
        raise NotImplementedError(
            "oblique routing is not ported yet (ROADMAP Queue 1 item 9)"
        )
    if forest.vs_anchor.numel() > 0:
        raise NotImplementedError(
            "vector-sequence routing is not ported yet "
            "(ROADMAP Queue 1 item 9)"
        )


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


def route_tree_values(
    forest: Forest,
    t: int,
    x_num: torch.Tensor,  # f32 [n, Fn] (missing imputed, or NaN)
    x_cat: torch.Tensor,  # i32 [n, Fc] vocabulary indices (-1 = missing)
    num_numerical: int,
    max_depth: int,
) -> torch.Tensor:
    """Leaf node id (int64 [n]) of every example in tree `t`. Feature
    index space: [0, Fn) numerical, [Fn, Fn+Fc) categorical."""
    n = x_num.shape[0] if x_num.numel() else x_cat.shape[0]
    Fn, Fc = x_num.shape[1], x_cat.shape[1]
    feature = forest.feature[t].long()
    threshold = forest.threshold[t]
    is_cat = forest.is_cat[t]
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
        node_cat = is_cat[node]
        go_left = torch.where(
            node_cat,
            mask_bit_filled(cat_mask[node], c.clamp(min=0)),
            v < threshold[node],
        )
        # Missing values (NaN numerical / negative categorical code) take
        # the node's stored direction.
        missing = torch.where(node_cat, c < 0, torch.isnan(v))
        go_left = torch.where(missing, na_left[node], go_left)
        nxt = torch.where(go_left, left[node], right[node])
        node = torch.where(is_leaf[node], node, nxt)
    return node


def forest_predict_values(
    forest: Forest,
    x_num: torch.Tensor,
    x_cat: torch.Tensor,
    num_numerical: int,
    max_depth: int,
    combine: str = "sum",
) -> torch.Tensor:
    """Σ (or mean) over trees of routed leaf values: f32 [n, V]."""
    _check_supported(forest)
    if combine not in ("sum", "mean"):
        raise ValueError(f"combine must be 'sum' or 'mean', got {combine!r}")
    T = forest.num_trees
    n = x_num.shape[0] if x_num.numel() else x_cat.shape[0]
    acc = torch.zeros(
        (n, forest.leaf_value.shape[-1]), dtype=torch.float32,
        device=x_num.device,
    )
    for t in range(T):
        leaves = route_tree_values(
            forest, t, x_num, x_cat, num_numerical, max_depth
        )
        acc = acc + forest.leaf_value[t][leaves]
    if combine == "mean":
        # XLA rewrites the oracle's `acc / T` as a multiply by the f32
        # reciprocal; the same rounding here keeps the means bitwise equal.
        return acc * (torch.ones((), dtype=torch.float32) / T).to(acc.device)
    return acc
