"""Structure variable importances, from the trees themselves
(counterpart of ydf_tpu/analysis/importance.py:structure_importances;
reference structure_analysis.cc): NUM_NODES (the splits on each
feature) and INV_MEAN_MIN_DEPTH. Host numpy over the forest's arrays,
with the JAX package's expressions, so the rankings are its own.
Permutation importance is not ported (ROADMAP Queue 1 item 20).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def structure_importances(model) -> Dict[str, List[Dict]]:
    """NUM_NODES and INV_MEAN_MIN_DEPTH: {kind: [{feature, importance}]},
    best first, features of importance 0 left out."""
    f = model.forest.to_numpy()
    feature = f["feature"]  # [T, N]
    is_leaf = f["is_leaf"]
    left = f["left"]
    right = f["right"]
    names = model.input_feature_names()
    F = len(names)

    split_mask = (~is_leaf) & (feature >= 0)
    counts = np.bincount(feature[split_mask].ravel(), minlength=F)[:F]

    # Depth at which a depth-first walk (the JAX package's stack order)
    # first meets each feature, per tree.
    T, N = feature.shape
    min_depth_sum = np.zeros(F)
    min_depth_cnt = np.zeros(F)
    for t in range(T):
        depth = np.full(N, -1, np.int64)
        depth[0] = 0
        order = [0]
        seen_depth: Dict[int, int] = {}
        while order:
            nid = order.pop()
            if is_leaf[t, nid]:
                continue
            ft = int(feature[t, nid])
            if 0 <= ft < F and ft not in seen_depth:
                seen_depth[ft] = int(depth[nid])
            for ch in (int(left[t, nid]), int(right[t, nid])):
                if 0 < ch < N and depth[ch] < 0:
                    depth[ch] = depth[nid] + 1
                    order.append(ch)
        for ft, d in seen_depth.items():
            min_depth_sum[ft] += d
            min_depth_cnt[ft] += 1

    inv_mean_min_depth = np.where(
        min_depth_cnt > 0,
        1.0 / (1.0 + min_depth_sum / np.maximum(min_depth_cnt, 1)), 0.0)

    def ranked(vals):
        order = np.argsort(-vals)
        return [{"feature": names[i], "importance": float(vals[i])}
                for i in order if vals[i] > 0]

    return {
        "NUM_NODES": ranked(counts.astype(np.float64)),
        "INV_MEAN_MIN_DEPTH": ranked(inv_mean_min_depth),
    }
