"""Gradient boosted trees learner (counterpart of ydf_tpu/learners/gbt.py:
GradientBoostedTreesLearner and the boosting step of _make_boost_fn).

    import ydf_tpu_torch as ydf
    model = ydf.GradientBoostedTreesLearner(
        label="label", num_trees=20, max_depth=6, validation_ratio=0.0,
        early_stopping="NONE").train(data)     # on the card by default
    model.predict(rows)

One boosting iteration, K = 1 (binary classification or regression):
gradients and hessians of the loss at the current predictions, the
[g*w, h*w, w] stats rows, one tree grown by ops/grower.py, leaf values
-sum g / (sum h + l2) scaled by the shrinkage for the model, and the
prediction update. The whole loop stays on the device: the trees, leaf
values and losses are collected as device tensors and read back once
after the last tree.

Prediction update: preds + raw * shrinkage as ONE rounding (a fused
multiply-add), what the JAX package computes on an x86 host whose XLA
contracts the multiply into the add (ydf_tpu/ops/routing_native.py:
update_uses_fma). The product of two f32 values is exact in f64, so the
port forms it there, adds in f64 and rounds to f32; that differs from a
true fused multiply-add only when the f64 sum rounds onto an f32
half-way point (double rounding), one row in about 2^29. The model
stores round(raw * shrinkage), as the reference does.

What this slice does not port raises NotImplementedError naming the
ROADMAP item; nothing falls back to a default the JAX package would not
take.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ydf_tpu_torch.config import Task, TreeConfig, resolve_max_frontier
from ydf_tpu_torch.dataset.dataset import InputData
from ydf_tpu_torch.dataset.dataspec import ColumnType
from ydf_tpu_torch.learners.generic import GenericLearner
from ydf_tpu_torch.learners.losses import make_loss
from ydf_tpu_torch.models.forest import forest_from_stacked_trees
from ydf_tpu_torch.models.gbt_model import GradientBoostedTreesModel
from ydf_tpu_torch.ops import grower
from ydf_tpu_torch.ops.split_rules import HessianGainRule


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})"
    )


def fma_update(preds: torch.Tensor, raw: torch.Tensor,
               scale: float) -> torch.Tensor:
    """preds + raw * scale rounded once to f32 (module docstring)."""
    s = float(np.float32(scale))
    return (preds.double() + raw.double() * s).float()


class GradientBoostedTreesLearner(GenericLearner):
    """The JAX package's learner surface for the training slice: binary
    classification (binomial loss) and regression (squared error) on
    numerical and boolean features, no validation split."""

    def __init__(
        self,
        label: str,
        task: Task = Task.CLASSIFICATION,
        num_trees: int = 300,
        shrinkage: float = 0.1,
        max_depth: int = 6,
        min_examples: int = 5,
        subsample: float = 1.0,
        validation_ratio: float = 0.1,
        early_stopping: str = "LOSS_INCREASE",
        l2_regularization: float = 0.0,
        num_candidate_attributes: int = -1,
        num_candidate_attributes_ratio: float = -1.0,
        loss: str = "DEFAULT",
        max_frontier="auto",
        sampling_method: str = "RANDOM",
        apply_link_function: bool = True,
        dart_dropout: float = 0.0,
        split_axis: str = "AXIS_ALIGNED",
        monotonic_constraints: Optional[dict] = None,
        features: Optional[Sequence[str]] = None,
        weights: Optional[str] = None,
        num_bins="auto",
        max_vocab_count: int = 2000,
        min_vocab_frequency: int = 5,
        column_types: Optional[Dict[str, ColumnType]] = None,
        random_seed: int = 123456,
        device=None,
    ):
        if task not in (Task.CLASSIFICATION, Task.REGRESSION):
            raise _unported(f"task {task.value}", 15)
        if validation_ratio > 0 and early_stopping != "NONE":
            raise _unported(
                "the validation split and early stopping (pass "
                "validation_ratio=0.0 or early_stopping='NONE')", 13)
        if dart_dropout > 0.0:
            raise _unported("DART (dart_dropout > 0)", 13)
        if sampling_method != "RANDOM":
            raise _unported(f"sampling_method={sampling_method!r}", 12)
        if subsample < 1.0:
            raise _unported("subsample < 1", 12)
        if num_candidate_attributes > 0 or num_candidate_attributes_ratio > 0:
            raise _unported("candidate-feature sampling", 12)
        if split_axis != "AXIS_ALIGNED":
            raise _unported(f"split_axis={split_axis!r}", 14)
        if monotonic_constraints:
            raise _unported("monotonic constraints", 14)
        super().__init__(
            label=label, task=task, features=features, weights=weights,
            max_vocab_count=max_vocab_count,
            min_vocab_frequency=min_vocab_frequency, num_bins=num_bins,
            random_seed=random_seed, column_types=column_types,
            device=device,
        )
        self.num_trees = num_trees
        self.shrinkage = shrinkage
        self.max_depth = max_depth
        self.min_examples = min_examples
        self.validation_ratio = validation_ratio
        self.early_stopping = early_stopping
        self.l2_regularization = l2_regularization
        self.loss = loss
        self.max_frontier = max_frontier
        self.apply_link_function = apply_link_function

    def train(self, data: InputData) -> GradientBoostedTreesModel:
        t0 = time.perf_counter()
        prep = self._prepare(data)
        binner = prep["binner"]
        dev = self.device
        num_classes = len(prep.get("classes", [])) or 1
        loss_obj = make_loss(self.loss, self.task, num_classes)
        n = prep["bins"].shape[0]
        tree_cfg = TreeConfig(
            max_depth=self.max_depth,
            max_frontier=resolve_max_frontier(self.max_frontier, n,
                                              self.min_examples),
            num_bins=binner.num_bins,
            min_examples=self.min_examples,
        )
        rule = HessianGainRule(l2=self.l2_regularization)
        # One feature-major copy of the bins for every tree and layer.
        bins_t = prep["bins"].t().contiguous()
        labels = torch.from_numpy(prep["labels"].astype(np.float32)).to(dev)
        weights = torch.from_numpy(prep["sample_weights"]).to(dev)

        t1 = time.perf_counter()
        trees, leaf_values, losses, init_pred = boost(
            bins_t, labels, weights, loss_obj=loss_obj, rule=rule,
            tree_cfg=tree_cfg, num_trees=self.num_trees,
            shrinkage=self.shrinkage,
        )
        forest = forest_from_stacked_trees(trees, leaf_values,
                                           binner.boundaries)
        train_losses = losses.cpu().numpy()
        t2 = time.perf_counter()
        self.last_timings["boost_s"] = t2 - t1
        model = GradientBoostedTreesModel(
            task=self.task, label=self.label,
            classes=prep.get("classes"),
            dataspec=prep["dataset"].dataspec, binner=binner, forest=forest,
            max_depth=self.max_depth,
            initial_predictions=init_pred.cpu().numpy(),
            num_trees_per_iter=1, loss_name=loss_obj.name,
            apply_link_function=self.apply_link_function,
            training_logs={
                "train_loss": train_losses.tolist(),
                "valid_loss": None,
                "num_trees": int(len(train_losses)),
                "num_trees_trained": int(len(train_losses)),
            },
        )
        self.last_timings["train_s"] = time.perf_counter() - t0
        return model


def boost(bins_t: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
          *, loss_obj, rule, tree_cfg: TreeConfig, num_trees: int,
          shrinkage: float, hist_quant: str = "f32"):
    """The boosting loop on the device of `bins_t` (u8 [F, n]): returns
    (stacked TreeArrays [T, ...], leaf values f32 [T, N, 1], train loss
    f32 [T], initial prediction f32 [1]), all on that device. On a card
    the loop runs under torch's sync debug mode "error": no host sync
    happens inside it."""
    if num_trees < 1:
        raise ValueError(f"num_trees must be >= 1, got {num_trees}")
    on_card = bins_t.device.type == "cuda"
    if on_card:
        # The loop must never wait on the card: any synchronizing call
        # inside it raises instead of silently serializing the trees.
        prev_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        return _boost(bins_t, labels, weights, loss_obj=loss_obj, rule=rule,
                      tree_cfg=tree_cfg, num_trees=num_trees,
                      shrinkage=shrinkage, hist_quant=hist_quant)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(prev_mode)


def _boost(bins_t, labels, weights, *, loss_obj, rule, tree_cfg, num_trees,
           shrinkage, hist_quant):
    n = bins_t.shape[1]
    init_pred = loss_obj.initial_predictions(labels, weights)
    preds = init_pred.expand(n).contiguous()
    trees, leaf_values, losses = [], [], []
    for _ in range(num_trees):
        g, h = loss_obj.grad_hess(labels, preds)
        # w_eff = w * 1: sampling at subsample 1.0 keeps every row.
        stats = torch.stack([g * weights, h * weights, weights], dim=1)
        res = grower.grow_tree(
            bins_t, stats, rule=rule, max_depth=tree_cfg.max_depth,
            frontier=tree_cfg.frontier, max_nodes=tree_cfg.max_nodes,
            num_bins=tree_cfg.num_bins, min_examples=tree_cfg.min_examples,
            hist_quant=hist_quant,
        )
        lv_raw = rule.leaf_value(res.tree.leaf_stats)  # [N, 1]
        preds = fma_update(preds, lv_raw[res.leaf_id.long(), 0], shrinkage)
        trees.append(res.tree)
        leaf_values.append(lv_raw * shrinkage)
        losses.append(loss_obj.loss(labels, preds, weights))
    stacked = grower.TreeArrays(*(torch.stack(field)
                                  for field in zip(*trees)))
    return stacked, torch.stack(leaf_values), torch.stack(losses), init_pred
