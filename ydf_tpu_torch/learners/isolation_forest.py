"""Isolation Forest learner (counterpart of
ydf_tpu/learners/isolation_forest.py: IsolationForestLearner, _train_if
and the per-tree step of _if_run).

    import ydf_tpu_torch as ydf
    model = ydf.IsolationForestLearner().train(data)   # no label needed
    model.predict(rows)          # anomaly scores in [0, 1], on the card

The JAX package's defaults: 300 trees, each grown on 256 rows drawn
without replacement (`subsample_count`, or `subsample_ratio` of the
rows), to depth ceil(log2(256)) = 8 (max_depth=-2), frontier
2^(depth - 1), at most min(TreeConfig.max_nodes, 4 x 256 + 3) nodes.

Tree t draws from key = fold_in(PRNGKey(seed), t): k_samp, k_grow, k_obl
= split(key, 3). Its rows are the top 256 of uniform(k_samp, (n,))
(jax.lax.top_k's set: prng.top_k), its stats are ones [256, 1], and the
grower splits each node at a random cut (ops/split_rules.py:
RandomSplitRule: Gumbel noise from each layer's k_gain over log_gap, the
log of each cut's bin gap in value space, computed on the host from the
binner's boundaries in f64 as the JAX package does). A node's value is
its path length, depth + c(rows in it) (models/if_model.py), in f32 with
XLA's log.

Sparse-oblique splits (split_axis="SPARSE_OBLIQUE", _if_run's projection
step) replace the axis-aligned numerical splits: their log_gap is -inf,
and tree t draws P = min(max(ceil(Fn ** exponent), 2),
max_num_projections) sparse projections of the Fn imputed numerical
features from k_obl (ops/oblique.py, drawn for every tree before the
loop), projects its subsample's rows in XLA's dot order, spaces B - 1
uniform cuts over each projection's range on the subsample, bins the
projections through the binning kernel and grows on [numericals,
projections, categoricals] with log_gap 0 on every projection cut. The
forest keeps the projections after the real features.

The loop reads nothing back (on a card it runs under
torch.cuda.set_sync_debug_mode("error")); the draws of a tree are made in
its step, on the device, so no tree's noise waits in memory.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ydf_tpu_torch.config import Task, TreeConfig
from ydf_tpu_torch.dataset.dataset import InputData
from ydf_tpu_torch.dataset.dataspec import ColumnType
from ydf_tpu_torch.learners.generic import GenericLearner
from ydf_tpu_torch.learners import random_forest
from ydf_tpu_torch.models.if_model import EULER, IsolationForestModel
from ydf_tpu_torch.ops import grower, oblique
from ydf_tpu_torch.ops.split_rules import RandomSplitRule
from ydf_tpu_torch.utils import prng
from ydf_tpu_torch.utils.xla_cpu import f32, log_f32


class IsolationForestLearner(GenericLearner):
    """The JAX package's IsolationForestLearner: random axis-aligned or
    sparse-oblique splits on numerical, boolean and categorical
    features."""

    # The reference trains on numerical and categorical splits only.
    _feature_types = (ColumnType.NUMERICAL, ColumnType.CATEGORICAL,
                      ColumnType.BOOLEAN, ColumnType.DISCRETIZED_NUMERICAL)

    def __init__(
        self,
        label: Optional[str] = None,
        task: Task = Task.ANOMALY_DETECTION,
        num_trees: int = 300,
        subsample_count: int = 256,
        subsample_ratio: float = -1.0,
        max_depth: int = -2,
        split_axis: str = "AXIS_ALIGNED",
        sparse_oblique_projection_density_factor: float = 2.0,
        sparse_oblique_weights: str = "BINARY",
        sparse_oblique_num_projections_exponent: float = 1.0,
        sparse_oblique_max_num_projections: int = 64,
        features: Optional[Sequence[str]] = None,
        random_seed: int = 123456,
        device=None,
        **kwargs,
    ):
        if split_axis not in ("AXIS_ALIGNED", "SPARSE_OBLIQUE"):
            raise ValueError(f"Unknown split_axis {split_axis!r}")
        oblique.check_weight_type(sparse_oblique_weights)
        super().__init__(label=label, task=task, features=features,
                         random_seed=random_seed, device=device, **kwargs)
        self.num_trees = num_trees
        self.subsample_count = subsample_count
        self.subsample_ratio = subsample_ratio
        self.max_depth = max_depth
        self.split_axis = split_axis
        self.sparse_oblique_projection_density_factor = (
            sparse_oblique_projection_density_factor)
        self.sparse_oblique_weights = sparse_oblique_weights
        self.sparse_oblique_num_projections_exponent = (
            sparse_oblique_num_projections_exponent)
        self.sparse_oblique_max_num_projections = (
            sparse_oblique_max_num_projections)

    def train(self, data: InputData, valid: Optional[InputData] = None
              ) -> IsolationForestModel:
        """Trains on `data`; `valid` is ignored, as in the JAX package."""
        t0 = time.perf_counter()
        prep = self._prepare(data)
        binner = prep["binner"]
        bins_t = prep["bins_t"]
        n = bins_t.shape[1]
        if self.subsample_ratio > 0:
            sub = max(int(self.subsample_ratio * n), 2)
        else:
            sub = self.subsample_count
        sub = min(sub, n)
        depth = (int(np.ceil(np.log2(max(sub, 2))))
                 if self.max_depth == -2 else self.max_depth)
        tree_cfg = TreeConfig(max_depth=depth,
                              max_frontier=max(2 ** max(depth - 1, 0), 1),
                              num_bins=binner.num_bins, min_examples=1)
        log_gap = if_log_gap(binner)
        obl = random_forest.oblique_inputs(self, prep)
        if obl is not None:
            # Oblique splits replace the axis-aligned numerical ones.
            log_gap[:binner.num_numerical] = -np.inf
        log_gap = torch.from_numpy(log_gap).to(self.device)
        t1 = time.perf_counter()
        out = train_if(bins_t, log_gap, num_trees=self.num_trees, sub=sub,
                       tree_cfg=tree_cfg,
                       max_nodes=min(tree_cfg.max_nodes, 4 * sub + 3),
                       num_numerical=binner.num_numerical,
                       seed=self.random_seed, obl=obl)
        t2 = time.perf_counter()
        forest = random_forest.oblique_forest(out, binner)
        model = IsolationForestModel(
            task=self.task, label=self.label, classes=None,
            dataspec=prep["dataset"].dataspec, binner=binner, forest=forest,
            max_depth=depth, num_examples_per_tree=sub,
        )
        self.last_timings.update(out.timings)
        self.last_timings.update({"train_if_s": t2 - t1,
                                  "finalize_s": time.perf_counter() - t2,
                                  "train_s": time.perf_counter() - t0})
        return model


def if_log_gap(binner) -> np.ndarray:
    """f32 [F, B]: the log of the value-space width of each numerical
    cut's bin gap (the first gap extends below the first boundary by the
    boundaries' span over their count, gaps floored at 1e-12), computed
    in f64; 0 on a categorical feature's first max(bins - 1, 1) cuts;
    -inf elsewhere (the JAX package's train, on the host)."""
    F, B = binner.num_features, binner.num_bins
    log_gap = np.full((F, B), -np.inf, np.float32)
    for f in range(binner.num_numerical):
        nb = int(binner.feature_num_bins[f]) - 1  # boundaries
        if nb <= 0:
            continue
        b = binner.boundaries[f, :nb].astype(np.float64)
        gaps = np.diff(b, prepend=b[0] - (b[-1] - b[0] + 1e-6) / max(nb, 1))
        log_gap[f, :nb] = np.log(np.maximum(gaps, 1e-12))
    for f in range(binner.num_numerical, F):
        nb = int(binner.feature_num_bins[f])
        log_gap[f, :max(nb - 1, 1)] = 0.0
    return log_gap


def avg_path_length_f32(count: torch.Tensor) -> torch.Tensor:
    """c(count) in f32 as XLA computes the JAX package's
    _avg_path_length_jnp: nf = max(count, 1), 2 (log(max(nf - 1, 1)) +
    Euler) - 2 (nf - 1) / nf above 2 rows, 1 at 2, 0 below (2 h is
    exact, so a fused multiply-add there rounds alike)."""
    nf = count.clamp_min(1.0)
    h = log_f32((nf - 1.0).clamp_min(1.0)) + f32(EULER)
    c = 2.0 * h - 2.0 * (nf - 1.0) / nf
    return torch.where(count > 2, c, torch.where(
        count == 2, torch.ones_like(c), torch.zeros_like(c)))


def node_depths(tree: grower.TreeArrays, max_nodes: int,
                depth: int) -> torch.Tensor:
    """i32 [N]: each node's depth, from `depth` scatter passes of the
    split nodes' depth + 1 onto their children (parents precede their
    children in the BFS ids; unused nodes stay 0)."""
    nd = torch.zeros(max_nodes + 1, dtype=torch.int32,
                     device=tree.left.device)
    internal = ~tree.is_leaf
    trash = torch.full_like(tree.left, max_nodes)
    tl = torch.where(internal, tree.left, trash).long()
    tr = torch.where(internal, tree.right, trash).long()
    for _ in range(depth):
        d1 = nd[:max_nodes] + 1
        nd = nd.index_put((tl,), d1).index_put((tr,), d1)
    return nd[:max_nodes]


class IFResult(NamedTuple):
    """train_if's outputs, on the training device but `timings`."""

    trees: grower.TreeArrays      # stacked [T, ...]
    leaf_values: torch.Tensor     # f32 [T, N, 1]: path lengths
    timings: Dict[str, float]
    obl_out: Optional[tuple] = None  # (projections [T, P, Fn], boundaries
                                     # [T, P, B-1]) or None


def tree_keys(seed: int, num_trees: int, device) -> torch.Tensor:
    """[T, 3, 2]: k_samp, k_grow and k_obl of every tree,
    split(fold_in(PRNGKey(seed), t), 3). A split's i-th key hashes the
    counter i alone, so they are the first three keys of the random
    forest's split in 4 (random_forest.tree_keys)."""
    return random_forest.tree_keys(seed, num_trees, device)[:, :3]


def train_if(bins_t: torch.Tensor, log_gap: torch.Tensor, *, num_trees: int,
             sub: int, tree_cfg: TreeConfig, max_nodes: int,
             num_numerical: int, seed: int, obl=None) -> IFResult:
    """Grows `num_trees` isolation trees on the device of `bins_t` (u8
    [F, n]; rows [0, num_numerical) numerical, the rest categorical) with
    the rule context log_gap f32 [F, B] (module docstring), with
    sparse-oblique splits when `obl` (ops/oblique.py:ObliqueInputs) is
    given. On a card the tree loop runs under torch's sync debug mode
    "error"."""
    if num_trees < 1:
        raise ValueError(f"num_trees must be >= 1, got {num_trees}")
    F, n = bins_t.shape
    dev = bins_t.device
    cfg = tree_cfg
    rule = RandomSplitRule()
    t0 = time.perf_counter()
    keys = tree_keys(seed, num_trees, dev)
    stats = torch.ones((sub, 1), dtype=torch.float32, device=dev)
    Fn = num_numerical
    P = 0 if obl is None else obl.num_projections
    obl_w = None
    if P:
        obl_w = obl.weights(keys[:, 2])
        log_gap = torch.cat([
            log_gap[:Fn], log_gap.new_zeros((P, log_gap.shape[1])),
            log_gap[Fn:]])
    on_card = dev.type == "cuda"
    if on_card:
        prev_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    trees, leaf_values, obl_bounds = [], [], []
    try:
        for t in range(num_trees):
            idx = prng.top_k(prng.uniform(keys[t, 0], (n,)), sub)
            grow_bins = torch.index_select(bins_t, 1, idx)
            if P:
                cols, bounds = oblique.projection_columns(
                    torch.index_select(obl.x_t, 1, idx), obl_w[t],
                    num_bins=cfg.num_bins)
                grow_bins = torch.cat([grow_bins[:Fn], cols,
                                       grow_bins[Fn:]])
                obl_bounds.append(bounds)
            res = grower.grow_tree(
                grow_bins, stats, rule=rule,
                max_depth=cfg.max_depth, frontier=cfg.frontier,
                max_nodes=max_nodes, num_bins=cfg.num_bins,
                num_numerical=Fn + P, min_examples=1,
                min_split_gain=float("-inf"), key=keys[t, 1],
                rule_ctx=log_gap,
            )
            tree = res.tree
            depth = node_depths(tree, max_nodes, cfg.max_depth)
            lv = depth.to(torch.float32) + avg_path_length_f32(
                tree.leaf_stats[:, 0])
            trees.append(tree)
            leaf_values.append(lv[:, None])
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(prev_mode)
    stacked = grower.TreeArrays(*(torch.stack(f) for f in zip(*trees)))
    if on_card:
        torch.cuda.synchronize(dev)
    return IFResult(trees=stacked, leaf_values=torch.stack(leaf_values),
                    timings={"loop_s": time.perf_counter() - t0},
                    obl_out=(obl_w, torch.stack(obl_bounds)) if P else None)
