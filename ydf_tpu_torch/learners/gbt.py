"""Gradient boosted trees learner (counterpart of ydf_tpu/learners/gbt.py:
GradientBoostedTreesLearner and the boosting step of _make_boost_fn).

    import ydf_tpu_torch as ydf
    model = ydf.GradientBoostedTreesLearner(label="label").train(data)
    model.predict(rows)                          # on the card by default
    model.evaluate(test)

One boosting iteration: gradients and hessians of the loss at the current
predictions (f32 [n, K]; K = 1 for a pointwise loss, the number of
classes for the multinomial one), the row sample of the iteration, then
K trees, one per class column, each grown by ops/grower.py from that
column's [g*w, h*w, w] stats rows, with leaf values -sum g / (sum h +
l2) scaled by the shrinkage for the model, and the prediction update.
Trees are stored iteration-major (tree it * K + k), the order
models/gbt_model.py serves with a[k::K]. The loop stays on the device:
the trees, leaf values and losses are collected as device tensors and
read back after the last iteration.

Random draws follow the JAX package's key chain bit for bit
(utils/prng.py): PRNGKey(seed); per iteration key, k_sub =
split(fold_in(key, it)), then (with sparse-oblique splits) key, k_proj =
split(key), then (with vector-sequence features) key, k_vs =
split(key); class k's tree key is fold_in(key, k). The row sample
(gbt.py:sample_mask) draws from k_sub: subsample < 1 keeps a row with
bernoulli(k_sub, subsample); GOSS keeps the rows whose sum over the K
columns of |g| is at least the goss_alpha * n-th largest (a value
comparison, so ties keep more rows), and of the rest each with
bernoulli(k_sub, goss_beta / (1 - goss_alpha)), up-weighted by
(1 - goss_alpha) / goss_beta. One sample serves the iteration's K trees;
the loss is reported on every row. The sample words are drawn on the
device inside the loop, from keys computed before it. Candidate features
(num_candidate_attributes(_ratio)) come from each tree's key through the
grower's per-layer draws (ops/grower.py:layer_columns); they depend on
the seed alone, so every tree's columns are drawn before the loop, with
one host read of each layer's widest set there.

Validation and early stopping (the JAX package's defaults,
validation_ratio=0.1 and early_stopping="LOSS_INCREASE"): the rows are
split by np.random.RandomState(random_seed).permutation, the first
min(max(int(n * ratio), 1), n - 1) rows validating (gbt.py:396-430);
the binner is fitted on every row first, and the split gathers columns
of the one device bin matrix. Every tree routes the validation rows
(ops/routing.py:route_tree_bins), updates their predictions as the
training ones and records the iteration's loss. With look-ahead
stopping the loop runs in chunks of min(look_ahead, 25) iterations and
reads the chunk's validation losses back once after it, the loop's only
host read: it stops once the best loss lies `look_ahead` iterations back
(_early_stop_hit), and the model keeps argmin + 1 iterations, (argmin +
1) * K trees. Trees never depend on the chunking: a chunk only decides
where the loop stops.

NUMERICAL_VECTOR_SEQUENCE features (the JAX package's per-iteration
anchor candidates, gbt.py:1312-1383): every iteration draws, for each VS
feature, num_anchors closer-than anchors (vectors drawn from the data)
and as many projected-more-than anchors (differences of two drawn
vectors), scores every example against them (ops/vector_sequence.py,
csrc/vector_sequence.cu on a card), and bins the scores at their
quantiles into candidate columns inserted after the numerical features
(before the categorical ones, the JAX package's layout); the K trees of
the iteration share them. Per feature split(fold_in(k_vs, fv), A); per
anchor k1, k2 = split(k), a row choice(k1, n, p) uniform over non-empty
sequences and a vector randint(k2, 0, max(len, 1)). The random words
depend on the seed alone, so they are drawn for every iteration at once
before the loop (one copy to the device); the data-dependent steps (the
row and vector from those words, the scores, quantiles and bins) run on
the device inside it.

Sparse-oblique splits (split_axis="SPARSE_OBLIQUE", the JAX package's
make_projections, gbt.py:1255-1310): every iteration draws P =
min(max(ceil(Fn ** exponent), 2), max_num_projections) sparse
projections of the Fn imputed numerical features from k_proj
(ops/oblique.py; they depend on the seed alone, so every iteration's are
drawn before the loop), projects the rows (kept feature-major on the
device) in XLA's dot order, bins each projection at its quantiles
through the binning kernel and inserts the P columns after the
numerical features; the K trees of the iteration share them, and the
validation rows are projected and binned under the same cuts. The
candidate columns are then [numericals, projections, anchors,
categoricals]; the forest keeps both blocks after the real features,
projections first (models/forest.py).

Prediction update. K = 1: preds + raw * shrinkage as ONE rounding (a
fused multiply-add), what the JAX package computes on an x86 host whose
XLA contracts the multiply into the add (ydf_tpu/ops/routing_native.py:
update_uses_fma). The product of two f32 values is exact in f64, so the
port forms it there, adds in f64 and rounds to f32; that differs from a
true fused multiply-add only when the f64 sum rounds onto an f32
half-way point (double rounding), one row in about 2^29. K > 1: the JAX
package routes with XLA and adds the stored round(raw * shrinkage) to
every class column (jax 0.9.0 contracts none of them: read from the
machine code of its boosting programs at K = 3 and 5, with and without
validation, chunked or not; the fixture train_multiclass records it).
The model stores round(raw * shrinkage), as the reference does.

CATEGORICAL_SET features (packed multi-hot rows on the device, i32
[n, Fs, W]; the validation split gathers their rows too) are candidates
of every tree (ops/grower.py's set candidates); the validation rows
route through set nodes (ops/routing.py:route_tree_bins with x_set).

Monotone constraints (monotonic_constraints={feature: +1 / -1}, on
numerical features only): the grower rejects a cut whose leaf values
move against a feature's direction (per tree over [numericals,
projections, anchors] when there are projection or anchor columns: a
projection touching a constrained feature counts as +1, its
coefficients sign-forced by the sampler); the boosting loop uses the
unclamped leaf values, and the leaves are clamped once after training
on the host (clamp_monotone_leaves).

Ranking (task=RANKING, ranking_group=): the losses of
learners/ranking_loss.py (LambdaMART-NDCG by default, XE_NDCG_MART by
name) read each query group's rows, registered before the loop for the
training and validation rows; the validation split takes whole groups
(split_validation_groups) and the look-ahead stop watches -NDCG.
Selective gradient boosting (sampling_method="SELGB", ranking only)
keeps, per group, every relevant row (label > 0) and the
ceil(ratio * #negatives) negatives the current predictions score
highest, ranked by a stable sort. Survival analysis
(task=SURVIVAL_ANALYSIS, label_event_observed=, optionally
label_entry_age=) trains the Cox loss (learners/survival_loss.py) on
departure ages; its schedules are registered the same way. The model's
extra_metadata names the group, truncation and event columns, which
evaluate() reads.

DART (dart_dropout > 0): the key chain splits three ways, key, k_sub,
k_drop = split(fold_in(key, it), 3); iteration it drops each earlier
iteration with probability dart_dropout (the masks depend on the seed
alone and are drawn before the loop), takes their weighted
contributions out of the predictions (dart_dot, XLA's dot order) for
its gradients, then enters at weight 1 / (nd + 1) while the nd dropped
ones shrink by nd / (nd + 1); each iteration's contributions stay on
the device ([T, n] plus [T, nv] f32). The final weights are baked into
the stored leaf values, so they depend on how many iterations ran.

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
from ydf_tpu_torch.learners.generic import GenericLearner, unported
from ydf_tpu_torch.learners.losses import CustomLoss, make_loss, sum_classes
from ydf_tpu_torch.learners.ranking_loss import (
    LambdaMartNdcg, argsort_f32, build_group_rows, inverse_permutation)
from ydf_tpu_torch.learners.survival_loss import CoxProportionalHazardLoss
from ydf_tpu_torch.models.forest import forest_from_stacked_trees
from ydf_tpu_torch.models.gbt_model import GradientBoostedTreesModel
from ydf_tpu_torch.ops import grower, oblique
from ydf_tpu_torch.ops.routing import route_tree_bins
from ydf_tpu_torch.ops.split_rules import HessianGainRule
from ydf_tpu_torch.ops.vector_sequence import vs_scores
from ydf_tpu_torch.utils import cuda_build, prng
from ydf_tpu_torch.utils.xla_cpu import f32, fma_f32


#: Reads of device values on the host by boost() in this process: the
#: validation losses once per chunk of the look-ahead stop, and the
#: candidate columns' widths once before the loop when candidate
#: features are sampled; the loop makes no other.
HOST_READS = 0
#: Most iterations a chunk of the look-ahead stop runs (the JAX
#: package's in-memory early-stop loop, gbt.py:1918-1920).
MAX_CHUNK_TREES = 25


def bool_column(values: np.ndarray) -> np.ndarray:
    """The event-observed flags of a raw column (the JAX package's
    _bool_column): booleans, numbers, or the strings 1/true/t/yes/y and
    0/false/f/no/n in any case. A missing (NaN) or unknown value raises
    ValueError rather than count as an event."""
    v = np.asarray(values)
    if v.dtype.kind in ("O", "U", "S"):
        low = np.char.lower(v.astype(str))
        truthy = np.isin(low, ("1", "true", "t", "yes", "y"))
        falsy = np.isin(low, ("0", "false", "f", "no", "n"))
        if not (truthy | falsy).all():
            bad = v[~(truthy | falsy)][:3]
            raise ValueError(
                "event-observed column contains missing or unrecognized "
                f"values (e.g. {bad.tolist()!r}); expected true/false "
                "indicators")
        return truthy
    if v.dtype.kind == "f" and np.isnan(v).any():
        raise ValueError(
            "event-observed column contains missing values (NaN)")
    return v.astype(bool)


def fma_update(preds: torch.Tensor, raw: torch.Tensor,
               scale: float) -> torch.Tensor:
    """preds + raw * scale rounded once to f32 (module docstring)."""
    s = float(np.float32(scale))
    return (preds.double() + raw.double() * s).float()


def monotone_directions(constraints: Optional[dict], binner
                        ) -> Optional[tuple]:
    """The grower's per-feature monotone directions (the JAX package's
    `monotone` tuple over binner.feature_names: sign(d) on constrained
    numerical features, 0 elsewhere), or None without constraints. An
    unknown or non-numerical feature raises ValueError."""
    if not constraints:
        return None
    dirs = [0] * binner.num_features
    for name, d in constraints.items():
        if name not in binner.feature_names:
            raise ValueError(f"Unknown monotonic feature {name!r}")
        idx = binner.feature_names.index(name)
        if idx >= binner.num_numerical:
            raise ValueError(
                f"Monotonic constraint on non-numerical {name!r}")
        dirs[idx] = int(np.sign(d))
    return tuple(dirs)


def clamp_monotone_leaves(forest, binner, constraints: dict):
    """The JAX package's _clamp_monotone_leaves, once after training on
    the host (numpy): bounds propagate down each tree (reference
    ApplyConstraintOnNode, training.h:160-168): at a split on a feature
    of direction d the midpoint of the two children's values, clipped
    to the node's bounds, bounds the left child above (d > 0) or below
    (d < 0) and the right child on the other side; a projection touching
    a constrained feature counts as increasing. Leaf values are clipped
    to their bounds. Returns the forest on its device."""
    f = forest.to_numpy()
    nfeat = binner.num_features
    dirs = np.zeros((nfeat,), np.int8)
    for name, d in constraints.items():
        dirs[binner.feature_names.index(name)] = np.sign(d)
    ow = f["oblique_weights"]
    P = ow.shape[1]
    lv = f["leaf_value"].copy()  # [T, N, 1]
    for t in range(lv.shape[0]):
        if P > 0:
            touch = np.abs(ow[t][:, : len(dirs)]) @ np.abs(
                dirs[: ow.shape[2]].astype(np.float32))
            proj_dirs = (touch > 0).astype(np.int8)
        stack = [(0, -np.inf, np.inf)]
        while stack:
            nid, lo, hi = stack.pop()
            if f["is_leaf"][t, nid]:
                lv[t, nid, 0] = np.clip(lv[t, nid, 0], lo, hi)
                continue
            left, right = int(f["left"][t, nid]), int(f["right"][t, nid])
            feat = int(f["feature"][t, nid])
            if 0 <= feat < nfeat:
                d = dirs[feat]
            elif P > 0 and nfeat <= feat < nfeat + P:
                d = proj_dirs[feat - nfeat]
            else:
                d = 0
            if d == 0:
                stack.append((left, lo, hi))
                stack.append((right, lo, hi))
            else:
                mid = 0.5 * (lv[t, left, 0] + lv[t, right, 0])
                mid = float(np.clip(mid, lo, hi))
                if d > 0:
                    stack.append((left, lo, mid))
                    stack.append((right, mid, hi))
                else:
                    stack.append((left, mid, hi))
                    stack.append((right, lo, mid))
    return forest._replace(
        leaf_value=torch.from_numpy(lv).to(forest.device))


def dart_dot(weights: torch.Tensor, contrib: torch.Tensor,
             upto: int) -> torch.Tensor:
    """einsum("t,tnk->nk", weights [T], contrib [T, n, K]) in the order
    XLA's CPU gives it in the JAX package's DART loop (jax 0.9.0, read by
    probing the einsum): fused multiply-adds over t in 4 x 8 lanes (t =
    32 i + 8 j + l on accumulator j, lane l) up to the last whole 32,
    the accumulators added in order and their 8 lanes by halves; then
    the rest in 4 lanes (the first holding the sum so far), added by
    halves; then one chain. Below 32 terms, one chain. Terms from t =
    `upto` on have weight 0 and change no sum, so they are skipped.
    Identified at T = 10-30, 150 and 300 (the default); at T = 50, 64
    and 100 XLA's order differs (ROADMAP Queue 3)."""
    T = weights.shape[0]
    out_shape = contrib.shape[1:]
    main = T // 32 * 32
    res = torch.zeros(out_shape, dtype=torch.float32,
                      device=contrib.device)
    if main:
        acc = torch.zeros((4, 8) + out_shape, dtype=torch.float32,
                          device=contrib.device)
        for a in range(0, min(main, upto), 32):
            w = weights[a:a + 32].reshape((4, 8) + (1,) * len(out_shape))
            acc = fma_f32(w, contrib[a:a + 32].reshape(acc.shape), acc)
        v = acc[0] + acc[1]
        v = v + acc[2]
        v = v + acc[3]
        while v.shape[0] > 1:
            h = v.shape[0] // 2
            v = v[:h] + v[h:]
        res = v[0]
        ep = (T - main) // 4 * 4
        if ep and upto > main:
            lanes = torch.zeros((4,) + out_shape, dtype=torch.float32,
                                device=contrib.device)
            lanes[0] = res
            for a in range(main, min(main + ep, upto), 4):
                w = weights[a:a + 4].reshape((4,) + (1,) * len(out_shape))
                lanes = fma_f32(w, contrib[a:a + 4], lanes)
            res = (lanes[0] + lanes[2]) + (lanes[1] + lanes[3])
        start = main + ep
    else:
        start = 0
    for t in range(start, min(T, upto)):
        res = fma_f32(weights[t], contrib[t], res)
    return res


def split_validation(n: int, ratio: float, seed: int):
    """(train rows, validation rows) int64 numpy, the JAX package's
    split of n rows: RandomState(seed).permutation(n), the first
    min(max(int(n * ratio), 1), n - 1) validating; no validation rows
    when that is 0 (n = 1)."""
    perm = np.random.RandomState(seed).permutation(n)
    nv = min(max(int(n * ratio), 1), n - 1)
    if nv <= 0:
        return np.arange(n), np.zeros((0,), np.int64)
    return perm[nv:], perm[:nv]


def split_validation_groups(groups: np.ndarray, ratio: float, seed: int):
    """(train rows, validation rows) of a ranking task, whole query
    groups (the JAX package's split): RandomState(seed).permutation of
    the sorted distinct groups, the first min(max(int(#groups * ratio),
    1), #groups - 1) validating; no validation rows with one group."""
    uniq = np.unique(groups)
    nvg = min(max(int(len(uniq) * ratio), 1), len(uniq) - 1)
    gperm = np.random.RandomState(seed).permutation(len(uniq))
    va_mask = np.isin(groups, uniq[gperm[:nvg]])
    return np.flatnonzero(~va_mask), np.flatnonzero(va_mask)


def early_stop_hit(valid_losses: np.ndarray, lookahead: int) -> bool:
    """Look-ahead early stopping (the JAX package's _early_stop_hit,
    reference early_stopping.h:29-66): the loss of the trees trained so
    far has not improved for `lookahead` trees."""
    if lookahead <= 0 or len(valid_losses) == 0:
        return False
    return len(valid_losses) - (int(np.argmin(valid_losses)) + 1) \
        >= lookahead


class GradientBoostedTreesLearner(GenericLearner):
    """The JAX package's learner surface for the training slices:
    classification (binomial loss for two classes, multinomial for more),
    regression (squared error), ranking (LambdaMART-NDCG) and survival
    analysis (Cox) by default, the Poisson, mean absolute error, binary
    focal, XE-NDCG and custom losses, on numerical, boolean,
    categorical, categorical-set and numerical-vector-sequence features,
    with its validation split, look-ahead early stopping, row sampling
    (subsample, GOSS, SELGB), candidate features, monotone constraints
    and DART. `train(data, valid=None)`: an explicit validation set
    replaces the split. `loss` is a loss name or a
    learners/losses.py:CustomLoss. A task with no default loss (the
    uplift tasks, anomaly detection) raises the JAX package's ValueError
    when it trains; MHLD splits raise NotImplementedError."""

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
        early_stopping_num_trees_look_ahead: int = 30,
        l2_regularization: float = 0.0,
        num_candidate_attributes: int = -1,
        num_candidate_attributes_ratio: float = -1.0,
        loss="DEFAULT",
        ranking_group: Optional[str] = None,
        ndcg_truncation: int = 5,
        ranking_max_group_size: int = 2048,
        label_event_observed: Optional[str] = None,
        label_entry_age: Optional[str] = None,
        max_frontier="auto",
        sampling_method: str = "RANDOM",
        goss_alpha: float = 0.2,
        goss_beta: float = 0.1,
        selective_gradient_boosting_ratio: float = 0.01,
        apply_link_function: bool = True,
        dart_dropout: float = 0.0,
        split_axis: str = "AXIS_ALIGNED",
        sparse_oblique_num_projections_exponent: float = 1.0,
        sparse_oblique_projection_density_factor: float = 2.0,
        sparse_oblique_weights: str = "BINARY",
        sparse_oblique_weights_power_of_two_min_exponent: int = -3,
        sparse_oblique_weights_power_of_two_max_exponent: int = 3,
        sparse_oblique_weights_integer_minimum: int = -5,
        sparse_oblique_weights_integer_maximum: int = 5,
        sparse_oblique_max_num_projections: int = 64,
        mhld_oblique_max_num_attributes: int = 4,
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
        discretize_numerical_columns: bool = False,
        num_discretized_numerical_bins: int = 255,
        random_seed: int = 123456,
        device=None,
    ):
        if not 0.0 <= dart_dropout < 1.0:
            raise ValueError(
                f"dart_dropout must be in [0, 1), got {dart_dropout}")
        if sampling_method not in ("RANDOM", "GOSS", "SELGB"):
            raise ValueError(
                f"Unknown sampling_method {sampling_method!r}; expected "
                "RANDOM, GOSS or SELGB")
        if sampling_method == "SELGB" and task != Task.RANKING:
            # Selective gradient boosting ranks query groups (reference
            # gradient_boosted_trees.cc:3053-3056).
            raise ValueError("sampling_method=SELGB requires task=RANKING")
        if split_axis not in ("AXIS_ALIGNED", "SPARSE_OBLIQUE",
                              "MHLD_OBLIQUE"):
            raise ValueError(f"Unknown split_axis {split_axis!r}")
        if split_axis == "MHLD_OBLIQUE":
            raise unported("split_axis='MHLD_OBLIQUE'", 28)
        oblique.check_weight_type(sparse_oblique_weights)
        super().__init__(
            label=label, task=task, features=features, weights=weights,
            max_vocab_count=max_vocab_count,
            min_vocab_frequency=min_vocab_frequency, num_bins=num_bins,
            random_seed=random_seed, column_types=column_types,
            discretize_numerical_columns=discretize_numerical_columns,
            num_discretized_numerical_bins=num_discretized_numerical_bins,
            device=device,
        )
        self.num_trees = num_trees
        self.shrinkage = shrinkage
        self.max_depth = max_depth
        self.min_examples = min_examples
        self.subsample = subsample
        self.validation_ratio = validation_ratio
        self.early_stopping = early_stopping
        self.early_stopping_num_trees_look_ahead = (
            early_stopping_num_trees_look_ahead)
        self.l2_regularization = l2_regularization
        self.num_candidate_attributes = num_candidate_attributes
        self.num_candidate_attributes_ratio = num_candidate_attributes_ratio
        self.loss = loss
        self.ranking_group = ranking_group
        self.ndcg_truncation = ndcg_truncation
        # Cap on the rows of a query group in the dense [groups, G]
        # layout; longer groups are cut with a warning.
        self.ranking_max_group_size = ranking_max_group_size
        # The departure age is the label (reference train config
        # label_event_observed / label_entry_age).
        self.label_event_observed = label_event_observed
        self.label_entry_age = label_entry_age
        self.selective_gradient_boosting_ratio = (
            selective_gradient_boosting_ratio)
        self.max_frontier = max_frontier
        self.sampling_method = sampling_method
        self.goss_alpha = goss_alpha
        self.goss_beta = goss_beta
        self.apply_link_function = apply_link_function
        self.dart_dropout = dart_dropout
        self.monotonic_constraints = dict(monotonic_constraints or {})
        self.split_axis = split_axis
        self.sparse_oblique_num_projections_exponent = (
            sparse_oblique_num_projections_exponent)
        self.sparse_oblique_projection_density_factor = (
            sparse_oblique_projection_density_factor)
        self.sparse_oblique_weights = sparse_oblique_weights
        self.sparse_oblique_weights_power_of_two_min_exponent = (
            sparse_oblique_weights_power_of_two_min_exponent)
        self.sparse_oblique_weights_power_of_two_max_exponent = (
            sparse_oblique_weights_power_of_two_max_exponent)
        self.sparse_oblique_weights_integer_minimum = (
            sparse_oblique_weights_integer_minimum)
        self.sparse_oblique_weights_integer_maximum = (
            sparse_oblique_weights_integer_maximum)
        self.sparse_oblique_max_num_projections = (
            sparse_oblique_max_num_projections)
        self.mhld_oblique_max_num_attributes = mhld_oblique_max_num_attributes
        # Anchors per kind per (iteration, VS feature) (reference
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

    def _oblique_weight_range(self):
        """(min, max) of the POWER_OF_TWO exponents or INTEGER values,
        None for the other weight types (gbt.py:835-848)."""
        if self.sparse_oblique_weights == "POWER_OF_TWO":
            return (self.sparse_oblique_weights_power_of_two_min_exponent,
                    self.sparse_oblique_weights_power_of_two_max_exponent)
        if self.sparse_oblique_weights == "INTEGER":
            return (self.sparse_oblique_weights_integer_minimum,
                    self.sparse_oblique_weights_integer_maximum)
        return None

    def _candidate_features(self, num_features: int) -> int:
        """Candidate features a node, -1 for all (gbt.py:614-619)."""
        if self.num_candidate_attributes_ratio > 0:
            return max(int(np.ceil(self.num_candidate_attributes_ratio
                                   * num_features)), 1)
        if self.num_candidate_attributes > 0:
            return min(self.num_candidate_attributes, num_features)
        return -1

    def _loss_object(self, num_classes: int):
        if isinstance(self.loss, CustomLoss):
            return self.loss
        return make_loss(self.loss, self.task, num_classes)

    def _task_columns(self, ds) -> Dict[str, Optional[np.ndarray]]:
        """The task's per-row columns of a dataset, raw (numpy; None when
        the task has none): the ranking groups, the survival events and
        entry ages."""
        out = {"groups": None, "event": None, "entry": None}
        if self.task == Task.RANKING:
            if self.ranking_group is None:
                raise ValueError("Task.RANKING requires ranking_group=")
            out["groups"] = np.asarray(ds.data[self.ranking_group])
        if self.task == Task.SURVIVAL_ANALYSIS:
            if self.label_event_observed is None:
                raise ValueError(
                    "Task.SURVIVAL_ANALYSIS requires label_event_observed=")
            out["event"] = bool_column(ds.data[self.label_event_observed])
            if self.label_entry_age is not None:
                out["entry"] = np.asarray(ds.data[self.label_entry_age],
                                          np.float64)
        return out

    def _register(self, loss_obj, tr: dict, labels, weights,
                  va: Optional[dict], valid_labels, valid_weights) -> None:
        """Registers the training rows' (and with `va` the validation
        rows') query groups or survival schedules on the loss (the JAX
        package's train, gbt.py:528-611), on the learner's device."""
        if isinstance(loss_obj, LambdaMartNdcg):
            if self.task != Task.RANKING:
                raise ValueError(
                    f"{loss_obj.name} requires task=Task.RANKING")
            loss_obj.ndcg_truncation = self.ndcg_truncation
            for tag, cols, y in (("train", tr, labels),
                                 ("valid", va, valid_labels)):
                if cols is not None:
                    rows, _ = build_group_rows(
                        cols["groups"],
                        max_group_size=self.ranking_max_group_size)
                    loss_obj.register_groups(tag, len(y), rows, self.device)
        if isinstance(loss_obj, CoxProportionalHazardLoss):
            if self.task != Task.SURVIVAL_ANALYSIS:
                raise ValueError(
                    "COX_PROPORTIONAL_HAZARD requires "
                    "task=Task.SURVIVAL_ANALYSIS")
            for tag, cols, y, w in (("train", tr, labels, weights),
                                    ("valid", va, valid_labels,
                                     valid_weights)):
                if cols is not None:
                    loss_obj.register_survival(
                        tag, y, cols["event"], cols["entry"],
                        weights=w if self.weights is not None else None,
                        device=self.device)

    def _model_metadata(self) -> dict:
        """The columns evaluate() reads, saved with the model (the JAX
        package's _model_metadata)."""
        md = {}
        if self.ranking_group:
            md["ranking_group"] = self.ranking_group
            md["ndcg_truncation"] = self.ndcg_truncation
        if self.label_event_observed:
            md["label_event_observed"] = self.label_event_observed
            if self.label_entry_age:
                md["label_entry_age"] = self.label_entry_age
        return md

    def train(self, data: InputData, valid: Optional[InputData] = None
              ) -> GradientBoostedTreesModel:
        t0 = time.perf_counter()
        prep = self._prepare(data, valid=valid)
        binner = prep["binner"]
        dev = self.device
        num_classes = len(prep.get("classes", [])) or 1
        loss_obj = self._loss_object(num_classes)
        K = loss_obj.num_dims
        bins_t = prep["bins_t"]  # one copy for every tree and layer
        labels, weights, vs_all = (prep["labels"], prep["sample_weights"],
                                   prep["vs"])
        sets = prep["set_bits"]  # i32 [n, Fs, W] on the device, or None
        x_raw = None  # imputed numerical features [n, Fn] (oblique)
        P = 0
        if self.split_axis == "SPARSE_OBLIQUE" and binner.num_numerical:
            P = oblique.num_projections(
                binner.num_numerical,
                self.sparse_oblique_num_projections_exponent,
                self.sparse_oblique_max_num_projections)
            x_raw = self.raw_numerical(prep)
        monotone = monotone_directions(self.monotonic_constraints, binner)
        task_tr = self._task_columns(prep["dataset"])
        task_va = None
        va = None  # (bins_t, labels, weights, vs, x_raw, sets) of the
                   # validation rows
        if valid is not None:
            va = (prep["valid_bins_t"], prep["valid_labels"],
                  prep["valid_sample_weights"], prep["valid_vs"],
                  None if x_raw is None else
                  self.raw_numerical(prep, "valid_"),
                  prep["valid_set_bits"])
            task_va = self._task_columns(prep["valid_dataset"])
        elif self.validation_ratio > 0 and self.early_stopping != "NONE":
            if task_tr["groups"] is not None:
                # Ranking validates on whole query groups.
                tr_idx, va_idx = split_validation_groups(
                    task_tr["groups"], self.validation_ratio,
                    self.random_seed)
            else:
                tr_idx, va_idx = split_validation(
                    bins_t.shape[1], self.validation_ratio,
                    self.random_seed)
            if len(va_idx):
                task_va = {k: None if v is None else v[va_idx]
                           for k, v in task_tr.items()}
                task_tr = {k: None if v is None else v[tr_idx]
                           for k, v in task_tr.items()}

                def rows(idx):
                    on_dev = torch.from_numpy(idx).to(dev)
                    return (bins_t.index_select(1, on_dev),
                            labels[idx], weights[idx],
                            None if vs_all is None else
                            tuple(a[idx] for a in vs_all),
                            None if x_raw is None else x_raw[idx],
                            None if sets is None else
                            sets.index_select(0, on_dev))

                va = rows(va_idx)
                bins_t, labels, weights, vs_all, x_raw, sets = rows(tr_idx)
        n = bins_t.shape[1]
        tree_cfg = TreeConfig(
            max_depth=self.max_depth,
            max_frontier=resolve_max_frontier(self.max_frontier, n,
                                              self.min_examples),
            num_bins=binner.num_bins,
            min_examples=self.min_examples,
        )
        rule = HessianGainRule(l2=self.l2_regularization)

        def on_device(y, w):
            return (torch.from_numpy(y.astype(np.float32)).to(dev),
                    torch.from_numpy(w).to(dev))

        def feature_major(x):
            return torch.from_numpy(np.ascontiguousarray(x.T)).to(dev)

        Ac, Ap = self._vs_anchor_counts()
        vs = valid_set = obl = None
        if vs_all is not None and Ac + Ap > 0:
            vs = vs_inputs(vs_all, Ac, Ap, dev)
        if x_raw is not None:
            mono_vec = None
            if monotone is not None and any(monotone[:binner.num_numerical]):
                # Sign-forced coefficients on the constrained features.
                mono_vec = torch.tensor(monotone[:binner.num_numerical],
                                        dtype=torch.float32, device=dev)
            obl = oblique.ObliqueInputs(
                x_t=feature_major(x_raw), num_projections=P,
                density=self.sparse_oblique_projection_density_factor,
                weight_type=self.sparse_oblique_weights,
                weight_range=self._oblique_weight_range(),
                monotone_vec=mono_vec)
        if va is not None and va[0].shape[1] > 0:
            valid_set = ValidSet(
                va[0], *on_device(va[1], va[2]),
                None if vs is None else vs_inputs(va[3], Ac, Ap, dev),
                None if obl is None else feature_major(va[4]), va[5])
        self._register(loss_obj, task_tr, labels, weights,
                       task_va if valid_set is not None else None,
                       None if va is None else va[1],
                       None if va is None else va[2])
        selgb_rows = None
        if self.sampling_method == "SELGB":
            # SELGB ranks each query group the ranking loss registered.
            if not isinstance(loss_obj, LambdaMartNdcg):
                raise ValueError(
                    "sampling_method=SELGB needs a ranking loss "
                    f"(LAMBDA_MART_NDCG or XE_NDCG_MART), not {loss_obj.name}")
            selgb_rows = loss_obj.rows_for("train", n)
        lookahead = (self.early_stopping_num_trees_look_ahead
                     if self.early_stopping == "LOSS_INCREASE" else 0)

        t1 = time.perf_counter()
        out = boost(
            bins_t, *on_device(labels, weights), loss_obj=loss_obj,
            rule=rule, tree_cfg=tree_cfg, num_trees=self.num_trees,
            shrinkage=self.shrinkage, seed=self.random_seed, vs=vs,
            obl=obl, num_numerical=binner.num_numerical, valid=valid_set,
            lookahead=lookahead,
            sampling=Sampling(self.sampling_method, self.subsample,
                              self.goss_alpha, self.goss_beta,
                              self.selective_gradient_boosting_ratio,
                              selgb_rows),
            candidate_features=self._candidate_features(
                binner.num_features),
            set_bits=sets, monotone=monotone,
            dart_dropout=self.dart_dropout,
        )
        train_losses = out.train_loss.cpu().numpy()
        valid_losses = (None if out.valid_loss is None
                        else out.valid_loss.cpu().numpy())
        if valid_losses is not None and self.early_stopping != "NONE":
            num_iters = int(np.argmin(valid_losses)) + 1
        else:
            num_iters = len(train_losses)
        T = num_iters * K
        trees = grower.TreeArrays(*(f[:T] for f in out.trees))
        kwargs = {}

        def per_tree(a):
            # One projection or anchor set an iteration, shared by its K
            # trees.
            return a[:num_iters].repeat_interleave(K, dim=0)

        if obl is not None or vs is not None:
            blocks = (P + (0 if vs is None else out.vs_out[0].shape[1]))
            trees = trees._replace(feature=oblique.feature_ids(
                trees.feature, binner.num_numerical, binner.num_features,
                blocks))
        if obl is not None:
            kwargs["oblique_weights"], kwargs["oblique_boundaries"] = (
                per_tree(a) for a in out.obl_out)
        if vs is not None:
            kwargs.update(forest_vs_kwargs(vs, *(
                per_tree(a) for a in out.vs_out)))
        forest = forest_from_stacked_trees(
            trees, out.leaf_values[:T], binner.boundaries, **kwargs)
        if self.monotonic_constraints:
            forest = clamp_monotone_leaves(
                forest, binner, self.monotonic_constraints)
        t2 = time.perf_counter()
        self.last_timings["boost_s"] = t2 - t1
        model = GradientBoostedTreesModel(
            task=self.task, label=self.label,
            classes=prep.get("classes"),
            dataspec=prep["dataset"].dataspec, binner=binner, forest=forest,
            max_depth=self.max_depth,
            initial_predictions=out.init_pred.cpu().numpy(),
            num_trees_per_iter=K, loss_name=loss_obj.name,
            apply_link_function=self.apply_link_function,
            extra_metadata=self._model_metadata(),
            training_logs={
                "train_loss": train_losses[:num_iters].tolist(),
                "valid_loss": None if valid_losses is None
                else valid_losses[:num_iters].tolist(),
                "num_trees": num_iters,
                "num_trees_trained": int(len(train_losses)),
                "iterations": iteration_records(
                    train_losses, valid_losses, out.chunk_walls),
            },
        )
        self.last_timings["train_s"] = time.perf_counter() - t0
        return model


def iteration_records(train_losses, valid_losses, chunk_walls):
    """training_logs["iterations"] as the JAX package writes it
    (_iteration_records): one record a trained iteration, 1-based, its
    losses and seconds, each chunk's host wall spread evenly over its
    trees."""
    secs = np.zeros((len(train_losses),), np.float64)
    for start, count, seconds in chunk_walls:
        secs[start:start + count] = seconds / count
    return [
        {"iteration": i + 1, "train_loss": float(train_losses[i]),
         "valid_loss": (None if valid_losses is None
                        else float(valid_losses[i])),
         "seconds": float(secs[i])}
        for i in range(len(train_losses))
    ]


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


class IterationKeys(NamedTuple):
    """The key chain's draws of every iteration (module docstring), on
    the training device."""

    sub: torch.Tensor            # [T, 2] k_sub: the row sample
    vs: Optional[torch.Tensor]   # [T, 2] k_vs, or None without VS features
    tree: torch.Tensor           # [T, K, 2] fold_in(key, k): tree k's key
    proj: Optional[torch.Tensor] = None  # [T, 2] k_proj, or None without
                                         # oblique splits
    drop: Optional[torch.Tensor] = None  # [T, 2] k_drop, or None
                                         # without DART


def iteration_keys(seed: int, num_iters: int, num_classes: int,
                   with_vs: bool, device,
                   with_oblique: bool = False,
                   with_dart: bool = False) -> IterationKeys:
    """The JAX package's key chain for `num_iters` iterations, run on the
    CPU (a few tiny hashes an iteration) and copied to `device` once:
    key, k_sub = split(fold_in(key, it)) (with DART key, k_sub, k_drop =
    split(fold_in(key, it), 3)); key, k_proj = split(key) with oblique
    splits; key, k_vs = split(key) with VS features; tree keys
    fold_in(key, k)."""
    key = prng.prng_key(seed)
    subs, projs, vss, keys, drops = [], [], [], [], []
    for it in range(num_iters):
        if with_dart:
            ks = prng.split(prng.fold_in(key, it), 3)
            key, k_sub = ks[0], ks[1]
            drops.append(ks[2])
        else:
            key, k_sub = prng.split(prng.fold_in(key, it))
        subs.append(k_sub)
        if with_oblique:
            key, k_proj = prng.split(key)
            projs.append(k_proj)
        if with_vs:
            key, k_vs = prng.split(key)
            vss.append(k_vs)
        keys.append(key)
    tree = prng.fold_in(torch.stack(keys)[:, None, :],
                        torch.arange(num_classes)[None, :])
    return IterationKeys(
        torch.stack(subs).to(device),
        torch.stack(vss).to(device) if with_vs else None, tree.to(device),
        torch.stack(projs).to(device) if with_oblique else None,
        torch.stack(drops).to(device) if with_dart else None)


def dart_drops(k_drop: torch.Tensor, dropout: float) -> torch.Tensor:
    """bool [T, T]: row `it` marks the earlier iterations that iteration
    `it` drops, bernoulli(k_drop, dropout, (T,)) & (arange(T) < it),
    from every iteration's k_drop [T, 2]."""
    T = k_drop.shape[0]
    t = torch.arange(T, device=k_drop.device)
    return prng.bernoulli(k_drop, dropout, (T,)) & (t[None, :] < t[:, None])


def vs_draws(seed: int, num_iters: int, num_vs: int, num_draws: int,
             device) -> Dict[str, torch.Tensor]:
    """The random words of every iteration's anchor draws, [T, Fv, A3]
    each with A3 = num_draws = Ac + 2 Ap vector draws per feature, from
    the key chain's k_vs (iteration_keys)."""
    keys = iteration_keys(seed, num_iters, 1, True, device)
    return vs_words(keys.vs, num_vs, num_draws)


def vs_words(k_vs: torch.Tensor, num_vs: int,
             num_draws: int) -> Dict[str, torch.Tensor]:
    """vs_draws from the iterations' k_vs (keys [T, 2]): per feature
    split(fold_in(k_vs, fv), A3), per draw k1, k2 = split(k); "u" is
    choice's uniform (f32) from k1, "hi" and "lo" randint's two words
    from k2."""
    kf = prng.fold_in(k_vs[:, None, :],
                      torch.arange(num_vs, device=k_vs.device)[None, :])
    pair = prng.split(prng.split(kf, num_draws))        # [T, Fv, A3, 2, 2]
    hi, lo = prng.randint_bits(pair[..., 1, :])
    return {"u": prng.uniform(pair[..., 0, :]), "hi": hi, "lo": lo}


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
            prng.quantile_linear(scores, qs, dim=0).t(), -1e29).contiguous()
        cols.append(_vs_bins(bnd, scores))
        anchors.append(anchors_f)
        bounds.append(bnd)
    return torch.cat(anchors), torch.cat(bounds), torch.cat(cols)


def _vs_bins(bounds: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Scores f32 [n, A] binned under their anchors' boundaries [A, B-1]:
    u8 [A, n]. Empty sequences (-FLT_MAX) stay strictly below every
    threshold."""
    return prng.searchsorted_scan(bounds, scores.t().contiguous(),
                                  right=True).to(torch.uint8)


def vs_valid_columns(valid: VSInputs, anchors: torch.Tensor,
                     bounds: torch.Tensor) -> torch.Tensor:
    """The validation rows' candidate bins u8 [Pv, nv] under one tree's
    anchors [Pv, D] and boundaries [Pv, B-1] (make_vs_projections), as
    the JAX package bins its validation rows."""
    A = valid.anchors_per_feature
    closer = valid.is_closer
    return torch.cat([
        _vs_bins(bounds[fv * A:(fv + 1) * A],
                 vs_scores(vals, lens, anchors[fv * A:(fv + 1) * A]
                           .contiguous(), closer))
        for fv, (vals, lens) in enumerate(zip(valid.values, valid.lengths))
    ])


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


class ValidSet(NamedTuple):
    """The validation rows on the training device."""

    bins_t: torch.Tensor        # u8 [F, nv] feature-major
    labels: torch.Tensor        # f32 [nv]
    weights: torch.Tensor       # f32 [nv]
    vs: Optional[VSInputs]      # their vector sequences, or None
    x_t: Optional[torch.Tensor] = None  # f32 [Fn, nv] imputed numerical
                                        # features (oblique splits)
    sets: Optional[torch.Tensor] = None  # i32 [nv, Fs, W] packed sets


class Sampling(NamedTuple):
    """The row sample of an iteration (gbt.py:sample_mask)."""

    method: str = "RANDOM"      # "RANDOM" (subsample), "GOSS" or "SELGB"
    subsample: float = 1.0
    goss_alpha: float = 0.2
    goss_beta: float = 0.1
    selgb_ratio: float = 0.01
    # SELGB's query groups: int64 [groups, G] training rows, padding n.
    group_rows: Optional[torch.Tensor] = None

    @property
    def draws(self) -> bool:
        return self.method == "GOSS" or (self.method == "RANDOM"
                                         and self.subsample < 1.0)


class BoostResult(NamedTuple):
    """boost()'s outputs, on the training device but `chunk_walls`; T
    iterations of K trees."""

    trees: grower.TreeArrays    # stacked [T * K, ...], iteration-major
    leaf_values: torch.Tensor   # f32 [T * K, N, 1]
    train_loss: torch.Tensor    # f32 [T]
    init_pred: torch.Tensor     # f32 [K]
    vs_out: Optional[tuple]     # (anchors [T, Pv, D], boundaries
                                # [T, Pv, B-1]) or None
    valid_loss: Optional[torch.Tensor]  # f32 [T], None without `valid`
    chunk_walls: List[tuple]    # (first iteration, iterations, seconds)
    obl_out: Optional[tuple] = None  # (projections [T, P, Fn], boundaries
                                     # [T, P, B-1]) or None


def boost(bins_t: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
          *, loss_obj, rule, tree_cfg: TreeConfig, num_trees: int,
          shrinkage: float, seed: int = 123456,
          vs: Optional[VSInputs] = None,
          obl: Optional[oblique.ObliqueInputs] = None, hist_quant: str = "f32",
          num_numerical: Optional[int] = None,
          valid: Optional[ValidSet] = None,
          lookahead: int = 0, sampling: Sampling = Sampling(),
          candidate_features: int = -1,
          set_bits: Optional[torch.Tensor] = None,
          monotone: Optional[tuple] = None,
          dart_dropout: float = 0.0) -> BoostResult:
    """The boosting loop on the device of `bins_t` (u8 [F, n]; rows
    [0, num_numerical) numerical, the rest categorical; default all
    numerical), T <= num_trees iterations of loss_obj.num_dims trees,
    with sparse-oblique splits when `obl` is given, categorical-set
    candidates when `set_bits` (i32 [n, Fs, W]) is, monotone directions
    per feature (`monotone`, monotone_directions) and DART when
    dart_dropout > 0 (module docstring).
    With `valid`, every tree scores the validation rows; with lookahead >
    0 as well (and num_trees > lookahead, as the JAX package), the loop
    runs in chunks of min(lookahead, MAX_CHUNK_TREES) iterations, reads
    each chunk's validation losses back once (HOST_READS) and stops once
    early_stop_hit. On a card each chunk runs under torch's sync debug
    mode "error": no other host sync happens inside the loop."""
    global HOST_READS
    if num_trees < 1:
        raise ValueError(f"num_trees must be >= 1, got {num_trees}")
    K = loss_obj.num_dims
    dev = bins_t.device
    F = bins_t.shape[0]
    Fs = 0 if set_bits is None else set_bits.shape[1]
    Pv = 0 if vs is None else len(vs.values) * vs.anchors_per_feature
    P = 0 if obl is None else obl.num_projections
    sampled = 0 < candidate_features < F + P + Pv + Fs
    dart = dart_dropout > 0.0
    keys = draws = columns = obl_w = drops = members = None
    if sampling.draws or sampled or vs is not None or P or dart:
        keys = iteration_keys(seed, num_trees, K, vs is not None, dev,
                              with_oblique=P > 0, with_dart=dart)
    if vs is not None:
        draws = vs_words(keys.vs, len(vs.values),
                         vs.num_closer + 2 * vs.num_projected)
    if P:
        obl_w = obl.weights(keys.proj)
    if dart:
        drops = dart_drops(keys.drop, dart_dropout)
    if sampled:
        Fn = F if num_numerical is None else num_numerical
        columns = grower.layer_columns(
            keys.tree.reshape(-1, 2), max_depth=tree_cfg.max_depth,
            frontier=tree_cfg.frontier, num_features=F + P + Pv,
            num_numerical=Fn + P + Pv, orderings=rule.num_cat_orderings,
            k=candidate_features, num_set=Fs)
        HOST_READS += 1
    if Fs:
        members = grower.set_members(set_bits)
        HOST_READS += 1
    stopping = valid is not None and 0 < lookahead < num_trees
    clen = min(lookahead, MAX_CHUNK_TREES) if stopping else num_trees
    loop = _Loop(bins_t, labels, weights, loss_obj=loss_obj, rule=rule,
                 tree_cfg=tree_cfg, shrinkage=shrinkage,
                 hist_quant=hist_quant, vs=vs, draws=draws,
                 obl=obl, obl_w=obl_w, loop_of_one=clen == 1,
                 num_numerical=num_numerical, valid=valid,
                 sampling=sampling, keys=keys, columns=columns,
                 members=members, monotone=monotone, drops=drops,
                 num_trees=num_trees)
    on_card = dev.type == "cuda"
    walls = []
    while loop.iterations < num_trees:
        start = loop.iterations
        count = min(clen, num_trees - start)
        t0 = time.perf_counter()
        if on_card:
            # The loop must never wait on the card: any synchronizing
            # call inside it raises instead of silently serializing the
            # trees.
            prev_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for it in range(start, start + count):
                loop.step(it)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(prev_mode)
        if stopping:
            # The chunk's one host read.
            seen = torch.stack(loop.valid_losses).cpu().numpy()
            HOST_READS += 1
        walls.append((start, count, time.perf_counter() - t0))
        if stopping and early_stop_hit(seen, lookahead):
            break
    return loop.result(walls)


def selgb_mask(rows: torch.Tensor, labels: torch.Tensor,
               preds: torch.Tensor, ratio: float) -> torch.Tensor:
    """Selective gradient boosting's row mask f32 [n] (the JAX package's
    SELGB sample_mask; reference SampleTrainingExamplesWithSelGB): per
    query group (rows int64 [groups, G], padding n), every relevant row
    (label > 0) and the ceil(ratio * #negatives) negatives of highest
    score, ranked by a stable sort of the negated scores (ties keep the
    earlier row); rows in no group get 0."""
    n = preds.shape[0]
    pad = rows >= n
    safe = rows.clamp_max(n - 1)
    pos = (labels[safe] > 0) & ~pad
    neg = ~pos & ~pad
    neg_score = torch.where(neg, preds[safe], float("-inf"))
    rank = inverse_permutation(argsort_f32(-neg_score))
    n_neg = neg.sum(dim=1, keepdim=True).float()
    keep = pos | (neg & (rank < torch.ceil(f32(ratio) * n_neg)))
    mask = torch.zeros(n + 1, dtype=torch.float32, device=preds.device)
    mask[rows.reshape(-1)] = keep.reshape(-1).float()
    return mask[:n]


class _Loop:
    """The boosting loop's state: predictions (training and validation,
    [n] for K = 1, [n, K] otherwise) and the per-tree outputs, as device
    tensors; with DART, every iteration's contributions (its stored leaf
    values at each row, [T, n] or [T, n, K], and the same for the
    validation rows) and weights."""

    def __init__(self, bins_t, labels, weights, *, loss_obj, rule,
                 tree_cfg, shrinkage, hist_quant, vs, draws, obl, obl_w,
                 loop_of_one, num_numerical, valid, sampling, keys,
                 columns, members=None, monotone=None, drops=None,
                 num_trees=0):
        self.bins_t, self.labels, self.weights = bins_t, labels, weights
        self.loss_obj, self.rule, self.cfg = loss_obj, rule, tree_cfg
        self.shrinkage, self.hist_quant = shrinkage, hist_quant
        self.vs, self.draws, self.valid = vs, draws, valid
        # The JAX package runs the iterations in loops of `clen` steps; a
        # loop of one rounds the projections' quantiles differently.
        self.obl, self.obl_w, self.loop_of_one = obl, obl_w, loop_of_one
        self.sampling, self.keys, self.columns = sampling, keys, columns
        self.members, self.drops = members, drops
        self.K = loss_obj.num_dims
        self.Fn = bins_t.shape[0] if num_numerical is None else num_numerical
        dev = bins_t.device
        # Monotone directions: over the features when the candidate
        # columns are the binned ones, else (projection or anchor blocks
        # after the numericals) made per tree from the numericals'.
        self.mono = self.mono_num = None
        if monotone is not None and any(monotone):
            self.mono = torch.tensor(monotone, dtype=torch.float32,
                                     device=dev)
            self.mono_num = self.mono[:self.Fn]
        self.init_pred = loss_obj.initial_predictions(labels, weights)
        self.preds = self._broadcast(bins_t.shape[1])
        if valid is not None:
            self.vpreds = self._broadcast(valid.bins_t.shape[1])
        if drops is not None:
            self.contrib = torch.zeros((num_trees,) + self.preds.shape,
                                       dtype=torch.float32, device=dev)
            self.tree_scale = torch.zeros(num_trees, dtype=torch.float32,
                                          device=dev)
            if valid is not None:
                self.vcontrib = torch.zeros(
                    (num_trees,) + self.vpreds.shape, dtype=torch.float32,
                    device=dev)
        self.iterations = 0
        self.trees, self.leaf_values, self.losses = [], [], []
        self.valid_losses, self.vs_anchors, self.vs_bounds = [], [], []
        self.obl_bounds = []
        B = tree_cfg.num_bins
        if vs is not None or obl is not None:
            self.qs = prng.linspace_f32(1.0 / B, 1.0 - 1.0 / B, B - 1,
                                        device=bins_t.device)

    def _broadcast(self, rows: int) -> torch.Tensor:
        """The initial predictions on `rows` rows: [rows] or [rows, K]."""
        if self.K == 1:
            return self.init_pred.expand(rows).contiguous()
        return self.init_pred[None, :].expand(rows, self.K).contiguous()

    def _grad_hess(self, preds: torch.Tensor):
        """g, h f32 [n, K] at `preds`."""
        g, h = self.loss_obj.grad_hess(self.labels, preds)
        if self.K == 1:
            return g[:, None], h[:, None]
        return g, h

    def sample_mask(self, it: int, g: torch.Tensor,
                    preds: Optional[torch.Tensor] = None
                    ) -> Optional[torch.Tensor]:
        """The iteration's per-row weight multiplier f32 [n] (gbt.py:
        sample_mask) at the gradients `g` and (SELGB) the predictions
        `preds`, or None when every row counts once."""
        smp = self.sampling
        n = g.shape[0]
        if smp.method == "SELGB":
            return selgb_mask(smp.group_rows, self.labels, preds,
                              smp.selgb_ratio)
        key = self.keys.sub[it] if smp.draws else None
        if smp.method == "GOSS":
            alpha, beta = smp.goss_alpha, smp.goss_beta
            gmag = sum_classes(g.abs())[:, 0]
            thr = torch.topk(gmag, max(int(alpha * n), 1)).values[-1]
            rest = min(beta / max(1.0 - alpha, 1e-6), 1.0)
            keep = prng.bernoulli(key, rest, (n,))
            upw = (1.0 - alpha) / max(beta, 1e-9)
            return torch.where(gmag >= thr, 1.0,
                               torch.where(keep, upw, 0.0))
        if smp.subsample < 1.0:
            return prng.bernoulli(key, smp.subsample, (n,)).float()
        return None

    def step(self, it: int) -> None:
        """Iteration `it`: (DART: the dropped iterations' sum taken out of
        the predictions) gradients, the row sample, the K trees (grow,
        leaf values), prediction updates, losses."""
        cfg, loss_obj, valid, K = self.cfg, self.loss_obj, self.valid, self.K
        dart = self.drops is not None
        preds_used = self.preds
        if dart:
            drop = self.drops[it]
            nd = drop.float().sum()
            dropped = dart_dot(drop * self.tree_scale, self.contrib, it)
            preds_used = self.preds - dropped
        g, h = self._grad_hess(preds_used)
        m = self.sample_mask(it, g, preds_used)
        w = self.weights
        w_eff = w if m is None else w * m
        grow_bins = self.bins_t
        grow_va = None if valid is None else valid.bins_t
        Fn = self.Fn
        mono = self.mono
        if self.obl is not None:
            # The projection columns go after the numerical features,
            # the JAX package's [num, obl, vs, cat].
            cols, bounds = oblique.projection_columns(
                self.obl.x_t, self.obl_w[it], qs=self.qs,
                loop_of_one=self.loop_of_one)
            grow_bins = torch.cat([grow_bins[:Fn], cols, grow_bins[Fn:]])
            if valid is not None:
                cols_va, _ = oblique.projection_columns(
                    valid.x_t, self.obl_w[it], bounds=bounds)
                grow_va = torch.cat([grow_va[:Fn], cols_va, grow_va[Fn:]])
            Fn += cols.shape[0]
            self.obl_bounds.append(bounds)
            if mono is not None:
                # A projection touching a constrained feature increases
                # with it (its coefficients are sign-forced).
                touch = (self.obl_w[it].abs()
                         * self.mono_num.abs()).sum(dim=1) > 0
                mono = torch.cat([self.mono_num, touch.float()])
        if self.vs is not None:
            # The anchor columns go between the numerical and the
            # categorical features, the JAX package's [num, vs, cat].
            anchors, bounds, cols = make_vs_projections(
                self.vs, {k: v[it] for k, v in self.draws.items()},
                self.qs)
            grow_bins = torch.cat([grow_bins[:Fn], cols, grow_bins[Fn:]])
            if valid is not None:
                cols_va = vs_valid_columns(valid.vs, anchors, bounds)
                grow_va = torch.cat([grow_va[:Fn], cols_va, grow_va[Fn:]])
            if mono is not None:
                if self.obl is None:
                    mono = self.mono_num
                mono = torch.cat([mono, mono.new_zeros(cols.shape[0])])
            Fn += cols.shape[0]
            self.vs_anchors.append(anchors)
            self.vs_bounds.append(bounds)
        contrib, vcontrib = [], []
        for k in range(K):
            t = it * K + k
            stats = torch.stack([g[:, k] * w_eff, h[:, k] * w_eff, w_eff],
                                dim=1)
            res = grower.grow_tree(
                grow_bins, stats, rule=self.rule, max_depth=cfg.max_depth,
                frontier=cfg.frontier, max_nodes=cfg.max_nodes,
                num_bins=cfg.num_bins, num_numerical=Fn,
                min_examples=cfg.min_examples, hist_quant=self.hist_quant,
                columns=None if self.columns is None else [
                    (idx[t].long(), ok[t]) for idx, ok in self.columns],
                set_members=self.members, mono_dirs=mono,
            )
            lv_raw = self.rule.leaf_value(res.tree.leaf_stats)  # [N, 1]
            lv = lv_raw * self.shrinkage
            leaf = res.leaf_id.long()
            if K == 1 and not dart:
                self.preds = fma_update(self.preds, lv_raw[leaf, 0],
                                        self.shrinkage)
            else:
                contrib.append(lv[leaf, 0])
            self.trees.append(res.tree)
            self.leaf_values.append(lv)
            if valid is not None:
                timer = cuda_build.launch_timer("valid_route")
                vleaf = route_tree_bins(res.tree, grow_va, cfg.max_depth,
                                        x_set=valid.sets)
                if K == 1 and not dart:
                    self.vpreds = fma_update(self.vpreds, lv_raw[vleaf, 0],
                                             self.shrinkage)
                else:
                    vcontrib.append(lv[vleaf, 0])
                cuda_build.launch_done(timer)
        if dart:
            self._dart_update(it, drop, nd, dropped, preds_used, contrib,
                              vcontrib)
        elif K > 1:
            # preds + new_contrib: the stored values added (module
            # docstring).
            self.preds = self.preds + torch.stack(contrib, dim=1)
        self.losses.append(loss_obj.loss(self.labels, self.preds, w,
                                         tag="train"))
        if valid is not None:
            timer = cuda_build.launch_timer("valid_route")
            if K > 1 and not dart:
                self.vpreds = self.vpreds + torch.stack(vcontrib, dim=1)
            self.valid_losses.append(
                loss_obj.loss(valid.labels, self.vpreds, valid.weights,
                              tag="valid"))
            cuda_build.launch_done(timer)
        self.iterations += 1

    def _dart_update(self, it, drop, nd, dropped, preds_used, contrib,
                     vcontrib) -> None:
        """DART's step (the JAX package's boost_step): the new iteration
        enters at weight 1 / (nd + 1), the dropped ones shrink by nd /
        (nd + 1); preds = preds_used + dropped * nd * factor + new *
        factor with both products fused into the adds, as XLA's CPU
        compiles it; the validation rows the same way."""
        stack = (lambda c: c[0]) if self.K == 1 else (
            lambda c: torch.stack(c, dim=1))
        new = stack(contrib)
        factor = 1.0 / (nd + 1.0)
        scale_old = self.tree_scale
        self.tree_scale = torch.where(drop, scale_old * nd * factor,
                                      scale_old)
        self.tree_scale[it:it + 1] = factor
        self.contrib[it] = new
        self.preds = fma_f32(new, factor,
                             fma_f32(dropped * nd, factor, preds_used))
        if self.valid is not None:
            vnew = stack(vcontrib)
            vdropped = dart_dot(drop * scale_old, self.vcontrib, it)
            self.vcontrib[it] = vnew
            self.vpreds = fma_f32(vnew, factor, fma_f32(
                vdropped * nd, factor, self.vpreds - vdropped))

    def result(self, walls) -> BoostResult:
        stacked = grower.TreeArrays(*(torch.stack(field)
                                      for field in zip(*self.trees)))
        leaf_values = torch.stack(self.leaf_values)
        if self.drops is not None:
            # Each iteration's final weight baked into its leaf values.
            T = len(self.losses)
            leaf_values = leaf_values * self.tree_scale[:T].repeat_interleave(
                self.K)[:, None, None]
        vs_out = obl_out = None
        if self.vs is not None:
            vs_out = (torch.stack(self.vs_anchors),
                      torch.stack(self.vs_bounds))
        if self.obl is not None:
            T = len(self.obl_bounds)
            obl_out = (self.obl_w[:T], torch.stack(self.obl_bounds))
        return BoostResult(
            trees=stacked, leaf_values=leaf_values,
            train_loss=torch.stack(self.losses), init_pred=self.init_pred,
            vs_out=vs_out,
            valid_loss=(torch.stack(self.valid_losses)
                        if self.valid is not None else None),
            chunk_walls=walls, obl_out=obl_out,
        )
