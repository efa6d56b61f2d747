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

NUMERICAL_VECTOR_SEQUENCE features (the JAX package's per-tree anchor
candidates, gbt.py:1312-1383): every tree draws, for each VS feature,
num_anchors closer-than anchors (vectors drawn from the data) and as many
projected-more-than anchors (differences of two drawn vectors), scores
every example against them (ops/vector_sequence.py, csrc/
vector_sequence.cu on a card), and bins the scores at their quantiles
into candidate columns inserted after the numerical features. The draws
follow the JAX package's key chain bit for bit (utils/prng.py):
PRNGKey(seed); per iteration key, k_sub = split(fold_in(key, it)) and
key, k_vs = split(key); per feature split(fold_in(k_vs, fv), A); per
anchor k1, k2 = split(k), a row choice(k1, n, p) uniform over non-empty
sequences and a vector randint(k2, 0, max(len, 1)). The random words
depend on the seed alone, so they are drawn for every tree at once
before the loop (one copy to the device); the data-dependent steps (the
row and vector from those words, the scores, quantiles and bins) run on
the device inside it.

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
from typing import Dict, List, NamedTuple, Optional, Sequence

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
from ydf_tpu_torch.ops.vector_sequence import vs_scores
from ydf_tpu_torch.utils import prng


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
    """The JAX package's learner surface for the training slices: binary
    classification (binomial loss) and regression (squared error) on
    numerical, boolean and numerical-vector-sequence features, no
    validation split."""

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
        numerical_vector_sequence_num_anchors: int = 16,
        numerical_vector_sequence_enable_closer_than: bool = True,
        numerical_vector_sequence_enable_projected_more_than: bool = True,
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
        # Anchors per kind per (tree, VS feature) (reference
        # decision_tree.proto numerical_vector_sequence, :433-442).
        self.numerical_vector_sequence_num_anchors = (
            numerical_vector_sequence_num_anchors)
        self.numerical_vector_sequence_enable_closer_than = (
            numerical_vector_sequence_enable_closer_than)
        self.numerical_vector_sequence_enable_projected_more_than = (
            numerical_vector_sequence_enable_projected_more_than)

    def _vs_anchor_counts(self):
        """(closer-than, projected-more-than) anchors per VS feature."""
        k = self.numerical_vector_sequence_num_anchors
        return (k if self.numerical_vector_sequence_enable_closer_than
                else 0,
                k if self.numerical_vector_sequence_enable_projected_more_than
                else 0)

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
        Ac, Ap = self._vs_anchor_counts()
        vs = None
        if prep["vs"] is not None and Ac + Ap > 0:
            vs = vs_inputs(prep["vs"], Ac, Ap, dev)

        t1 = time.perf_counter()
        trees, leaf_values, losses, init_pred, vs_out = boost(
            bins_t, labels, weights, loss_obj=loss_obj, rule=rule,
            tree_cfg=tree_cfg, num_trees=self.num_trees,
            shrinkage=self.shrinkage, seed=self.random_seed, vs=vs,
        )
        kwargs = {}
        if vs is not None:
            kwargs = forest_vs_kwargs(vs, *vs_out)
        forest = forest_from_stacked_trees(trees, leaf_values,
                                           binner.boundaries, **kwargs)
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


class VSInputs(NamedTuple):
    """The vector-sequence features on the training device."""

    values: List[torch.Tensor]   # per VS feature f32 [n, L, D]
    lengths: List[torch.Tensor]  # per VS feature i32 [n]
    p_cuml: List[torch.Tensor]   # per VS feature f32 [n]: cumsum of the
                                 # row-choice probabilities
    num_closer: int              # Ac anchors per feature
    num_projected: int           # Ap anchors per feature

    @property
    def anchors_per_feature(self) -> int:
        return self.num_closer + self.num_projected

    @property
    def is_closer(self) -> torch.Tensor:
        """bool [Ac + Ap]: one feature's anchor kinds."""
        A = self.anchors_per_feature
        return torch.arange(A, device=self.values[0].device) < self.num_closer


def vs_inputs(vs, num_closer: int, num_projected: int, device) -> VSInputs:
    """Binner.transform_vs's (values [n, Fv, L, D], lengths [n, Fv], _)
    on `device`, one contiguous tensor per feature, and each feature's
    cumulative row-choice probabilities: uniform over the non-empty
    sequences (the reference's rejection loop, vector_sequence.cc:
    255-276), or over all rows when every sequence is empty."""
    values, lengths, _ = vs
    n = values.shape[0]
    vals, lens, cums = [], [], []
    for fv in range(values.shape[1]):
        v = torch.from_numpy(np.ascontiguousarray(values[:, fv])).to(device)
        ln = torch.from_numpy(np.ascontiguousarray(lengths[:, fv])).to(device)
        ne = (ln > 0).float()
        tot = ne.sum()
        p = torch.where(tot > 0, ne / torch.clamp_min(tot, 1.0), 1.0 / n)
        vals.append(v)
        lens.append(ln)
        cums.append(prng.cumsum_f32(p))
    return VSInputs(vals, lens, cums, num_closer, num_projected)


def vs_draws(seed: int, num_trees: int, num_vs: int, num_draws: int,
             device) -> Dict[str, torch.Tensor]:
    """The random words of every tree's anchor draws, [T, Fv, A3] each
    with A3 = num_draws = Ac + 2 Ap vector draws per feature: the key
    chain of the module docstring, run on the CPU (a few hundred tiny
    operations per tree) and copied to `device` once. "u" is choice's
    uniform (f32), "hi" and "lo" randint's two words."""
    key = prng.prng_key(seed)
    k_vs = []
    for it in range(num_trees):
        key = prng.split(prng.fold_in(key, it))[0]  # (key, k_sub)
        key, k = prng.split(key)                    # (key, k_vs)
        k_vs.append(k)
    kf = prng.fold_in(torch.stack(k_vs)[:, None, :],
                      torch.arange(num_vs)[None, :])      # [T, Fv, 2]
    pair = prng.split(prng.split(kf, num_draws))        # [T, Fv, A3, 2, 2]
    hi, lo = prng.randint_bits(pair[..., 1, :])
    return {"u": prng.uniform(pair[..., 0, :]).to(device),
            "hi": hi.to(device), "lo": lo.to(device)}


def make_vs_projections(vs: VSInputs, draws: Dict[str, torch.Tensor],
                        qs: torch.Tensor):
    """One tree's anchor candidates (counterpart of the JAX package's
    make_vs_projections): anchors f32 [Pv, D], bin boundaries f32
    [Pv, B-1] and candidate bins u8 [Pv, n] feature-major, Pv = Fv * A.
    `draws` holds this tree's words [Fv, A3]; qs the B-1 quantiles."""
    Ac, Ap = vs.num_closer, vs.num_projected
    closer = vs.is_closer
    anchors, bounds, cols = [], [], []
    for fv, (vals, lens) in enumerate(zip(vs.values, vs.lengths)):
        idx = prng.choice_from_uniform(vs.p_cuml[fv], draws["u"][fv]).long()
        li = prng.randint_from_bits(draws["hi"][fv], draws["lo"][fv], 0,
                                    torch.clamp_min(lens[idx], 1)).long()
        drawn = vals[idx, li]  # [A3, D]
        parts = [drawn[:Ac]]
        if Ap:
            parts.append(drawn[Ac:Ac + Ap] - drawn[Ac + Ap:])
        anchors_f = torch.cat(parts).contiguous()
        scores = vs_scores(vals, lens, anchors_f, closer)  # [n, A]
        bnd = torch.clamp_min(
            prng.quantile_linear(scores, qs, dim=0).t(), -1e29)
        # Empty sequences (-FLT_MAX) stay strictly below every threshold.
        cols.append(prng.searchsorted_scan(
            bnd.contiguous(), scores.t().contiguous(), right=True
        ).to(torch.uint8))
        anchors.append(anchors_f)
        bounds.append(bnd)
    return torch.cat(anchors), torch.cat(bounds), torch.cat(cols)


def forest_vs_kwargs(vs: VSInputs, anchors: torch.Tensor,
                     bounds: torch.Tensor) -> Dict[str, torch.Tensor]:
    """forest_from_stacked_trees' VS block from the per-tree anchors
    [T, Pv, D] and boundaries [T, Pv, B-1]: each anchor's feature and
    kind, the layout of make_vs_projections."""
    T, Pv = anchors.shape[:2]
    A = vs.anchors_per_feature
    dev = anchors.device
    feat = torch.arange(Pv // A, dtype=torch.int32, device=dev)
    return {
        "vs_anchors": anchors, "vs_boundaries": bounds,
        "vs_feat": feat.repeat_interleave(A)[None].expand(T, Pv),
        "vs_is_closer": vs.is_closer.repeat(Pv // A)[None].expand(T, Pv),
    }


def boost(bins_t: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
          *, loss_obj, rule, tree_cfg: TreeConfig, num_trees: int,
          shrinkage: float, seed: int = 123456,
          vs: Optional[VSInputs] = None, hist_quant: str = "f32"):
    """The boosting loop on the device of `bins_t` (u8 [F, n]): returns
    (stacked TreeArrays [T, ...], leaf values f32 [T, N, 1], train loss
    f32 [T], initial prediction f32 [1], VS block), all on that device;
    the VS block is (anchors [T, Pv, D], boundaries [T, Pv, B-1]), or
    None without `vs`. On a card the loop runs under torch's sync debug
    mode "error": no host sync happens inside it."""
    if num_trees < 1:
        raise ValueError(f"num_trees must be >= 1, got {num_trees}")
    draws = None
    if vs is not None:
        draws = vs_draws(seed, num_trees, len(vs.values),
                         vs.num_closer + 2 * vs.num_projected,
                         bins_t.device)
    on_card = bins_t.device.type == "cuda"
    if on_card:
        # The loop must never wait on the card: any synchronizing call
        # inside it raises instead of silently serializing the trees.
        prev_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        return _boost(bins_t, labels, weights, loss_obj=loss_obj, rule=rule,
                      tree_cfg=tree_cfg, num_trees=num_trees,
                      shrinkage=shrinkage, hist_quant=hist_quant, vs=vs,
                      draws=draws)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(prev_mode)


def _boost(bins_t, labels, weights, *, loss_obj, rule, tree_cfg, num_trees,
           shrinkage, hist_quant, vs, draws):
    n = bins_t.shape[1]
    B = tree_cfg.num_bins
    init_pred = loss_obj.initial_predictions(labels, weights)
    preds = init_pred.expand(n).contiguous()
    trees, leaf_values, losses, vs_anchors, vs_bounds = [], [], [], [], []
    if vs is not None:
        qs = prng.linspace_f32(1.0 / B, 1.0 - 1.0 / B, B - 1,
                               device=bins_t.device)
    for it in range(num_trees):
        g, h = loss_obj.grad_hess(labels, preds)
        # w_eff = w * 1: sampling at subsample 1.0 keeps every row.
        stats = torch.stack([g * weights, h * weights, weights], dim=1)
        grow_bins = bins_t
        if vs is not None:
            # The anchor columns go after the numerical features: [num,
            # vs] (no categorical features in this slice).
            anchors, bounds, cols = make_vs_projections(
                vs, {k: v[it] for k, v in draws.items()}, qs)
            grow_bins = torch.cat([bins_t, cols])
            vs_anchors.append(anchors)
            vs_bounds.append(bounds)
        res = grower.grow_tree(
            grow_bins, stats, rule=rule, max_depth=tree_cfg.max_depth,
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
    vs_out = None
    if vs is not None:
        vs_out = (torch.stack(vs_anchors), torch.stack(vs_bounds))
    return (stacked, torch.stack(leaf_values), torch.stack(losses),
            init_pred, vs_out)
