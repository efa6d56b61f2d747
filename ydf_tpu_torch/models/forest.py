"""Forest: a trained ensemble as stacked per-tree node tensors
(counterpart of ydf_tpu/models/forest.py:Forest).

Every tree lives in fixed-capacity node arrays stacked on a leading tree
axis. Field names, shapes and meanings are the JAX package's, so a saved
`forest.npz` loads field for field. `cat_mask` is uint32 on disk; torch
keeps it as int32 holding the same bit patterns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Forest(NamedTuple):
    feature: torch.Tensor        # [T, N] i32, -1 on leaves
    threshold: torch.Tensor      # [T, N] f32: v < threshold → left
    threshold_bin: torch.Tensor  # [T, N] i32: bin <= t → left
    is_cat: torch.Tensor         # [T, N] bool
    is_set: torch.Tensor         # [T, N] bool: categorical-set node
    cat_mask: torch.Tensor       # [T, N, W] i32 bits (u32 on disk)
    left: torch.Tensor           # [T, N] i32
    right: torch.Tensor          # [T, N] i32
    is_leaf: torch.Tensor        # [T, N] bool
    na_left: torch.Tensor        # [T, N] bool: direction of missing values
    leaf_value: torch.Tensor     # [T, N, V] f32
    cover: torch.Tensor          # [T, N] f32
    oblique_weights: torch.Tensor  # [T, P, Fn] f32 (P = 0: none)
    oblique_na_repl: torch.Tensor  # [T, P, Fn] f32
    vs_anchor: torch.Tensor      # [T, Pv, D] f32 (Pv = 0: none)
    vs_feat: torch.Tensor        # [T, Pv] i32
    vs_is_closer: torch.Tensor   # [T, Pv] bool
    num_nodes: torch.Tensor      # [T] i32

    @property
    def num_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def to(self, device) -> "Forest":
        return Forest(*(t.to(device) for t in self))

    def to_numpy(self) -> dict:
        out = {f: getattr(self, f).cpu().numpy() for f in self._fields}
        out["cat_mask"] = out["cat_mask"].view(np.uint32)
        return out

    @staticmethod
    def from_numpy(d: dict) -> "Forest":
        """numpy arrays in the JAX package's layout → CPU Forest. Fields
        missing from older saves are back-filled as the JAX package
        does."""
        d = dict(d)
        shape = np.shape(d["feature"])
        T = shape[0]
        if "na_left" not in d:
            d["na_left"] = np.zeros(shape, bool)
        if "is_set" not in d:
            d["is_set"] = np.zeros(shape, bool)
        if "cover" not in d:
            d["cover"] = np.ones(shape, np.float32)
        if "oblique_weights" not in d:
            d["oblique_weights"] = np.zeros((T, 0, 0), np.float32)
        if "oblique_na_repl" not in d:
            d["oblique_na_repl"] = np.full(
                np.shape(d["oblique_weights"]), np.nan, np.float32
            )
        if "vs_anchor" not in d:
            d["vs_anchor"] = np.zeros((T, 0, 0), np.float32)
            d["vs_feat"] = np.zeros((T, 0), np.int32)
            d["vs_is_closer"] = np.zeros((T, 0), bool)
        d["cat_mask"] = np.asarray(d["cat_mask"], np.uint32).view(np.int32)

        def tensor(a):
            # 64-bit arrays narrow to 32 bits, as jnp.asarray does.
            a = np.asarray(a)
            if a.dtype == np.int64:
                a = a.astype(np.int32)
            elif a.dtype == np.float64:
                a = a.astype(np.float32)
            return torch.from_numpy(np.array(a, copy=True, order="C"))

        return Forest(**{f: tensor(d[f]) for f in Forest._fields})


def forest_from_stacked_trees(stacked, leaf_value: torch.Tensor,
                              boundaries: np.ndarray) -> Forest:
    """Stacked tree arrays (ops/grower.py:TreeArrays with a leading tree
    axis) + leaf values [T, N, V] -> Forest, on the trees' device
    (counterpart of ydf_tpu/models/forest.py:forest_from_stacked_trees
    for numerical trees). Value thresholds are
    boundaries[feature, threshold_bin]: "bin <= t" is
    "v < boundaries[t]"; cover is the weighted example count."""
    feature = stacked.feature
    tbin = stacked.threshold_bin
    dev = feature.device
    T, N = feature.shape
    bnd = torch.from_numpy(np.ascontiguousarray(boundaries, np.float32)).to(
        dev)
    if bnd.shape[0] == 0:
        threshold = torch.zeros((T, N), dtype=torch.float32, device=dev)
    else:
        f_safe = feature.long().clamp(0, bnd.shape[0] - 1)
        t_safe = tbin.long().clamp(0, bnd.shape[1] - 1)
        threshold = bnd[f_safe, t_safe]
    empty = torch.zeros((T, 0, 0), dtype=torch.float32, device=dev)
    return Forest(
        feature=feature, threshold=threshold, threshold_bin=tbin,
        is_cat=stacked.is_cat, is_set=stacked.is_set,
        cat_mask=stacked.cat_mask, left=stacked.left, right=stacked.right,
        is_leaf=stacked.is_leaf,
        na_left=torch.zeros((T, N), dtype=torch.bool, device=dev),
        leaf_value=leaf_value, cover=stacked.leaf_stats[..., -1],
        oblique_weights=empty, oblique_na_repl=empty, vs_anchor=empty,
        vs_feat=torch.zeros((T, 0), dtype=torch.int32, device=dev),
        vs_is_closer=torch.zeros((T, 0), dtype=torch.bool, device=dev),
        num_nodes=stacked.num_nodes,
    )
