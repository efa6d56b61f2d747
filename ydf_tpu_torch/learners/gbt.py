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
reads the chunk's validation losses back once after it (the loop's only
host read but MHLD's, below): it stops once the best loss lies
`look_ahead` iterations back (_early_stop_hit), and the model keeps
argmin + 1 iterations, (argmin + 1) * K trees. Trees never depend on
the chunking: a chunk only decides where the loop stops.

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

MHLD-oblique splits (split_axis="MHLD_OBLIQUE", classification only, no
monotone constraints; the JAX package's make_mhld_W, gbt.py:1196-1253):
the projections come from linear discriminant analysis of the
iteration's weighted rows (ops/mhld.py) instead of random draws, and
then go through projection_columns as sparse-oblique ones. When the row
weights are the same every iteration (no row sampling: the default),
the scatter matrices are summed once on the device and read back once
before the loop, and each chunk's W is solved on the host at the
chunk's start, outside the sync debug region (_Loop.solve_chunk): the
loop reads nothing more and solves only the iterations it runs.
Otherwise (subsample < 1, GOSS) each iteration sums
its scatter matrices on the device and reads them back with one counted
host read (HOST_READS); that read, the solves on the host and the copy
of W to the device are the one place the loop leaves torch's sync debug
mode "error" (_Loop._mhld_weights).

Checkpoints (working_dir; the JAX package's gbt.py:1995-2190): the loop
runs in chunks of resume_training_snapshot_interval_trees iterations
(the trees never depend on the chunking), and after each chunk writes
the chunk's outputs durably (chunk_<start>.npz), then a snapshot
(utils/snapshot.py) of the port's own state: the training and
validation predictions, DART's contributions and weights, the
validation losses and the chunk list, fingerprinted by the
configuration and the data. resume_training=True continues from the
newest snapshot, its finished chunks re-read (the look-ahead stop sees
their losses); a snapshot of other data or hyperparameters, or one the
JAX package wrote, is refused. SIGTERM or SIGINT during such a loop
sets a flag that the loop reads after the next snapshot, then raises
TrainingPreempted (exit_code 75); a second signal kills the default way
(_PreemptionGuard). maximum_training_duration (seconds from train()'s
entry) stops the loop at the first chunk boundary past it (chunks of
min(look-ahead, 25), or 25), keeping the finished trees.

Telemetry (utils/telemetry.py; a flag test a site when off): the train,
train.chunk, train.tree and train.layer spans, ydf_train_iterations_total,
ydf_train_chunk_latency_ns and the loss gauges a chunk (one host read of
the last losses), the memory ledger's snapshot in training_logs
["memory"], a flush at the end; the failpoint sites gbt.chunk (after a
snapshot) and telemetry.oom (a chunk boundary), and the flight
recorder's dump on a crash or a preemption.

Distributed training (distributed_workers=, parallel/dist_gbt.py) runs
this loop on the manager with the grower's seam pointed at the RPC
workers holding a feature-sharded cache's bins; the manager's _prepare
leaves the bins on the disk. The histogram operand's mode comes from
YDF_TPU_HIST_QUANT (f32 by default). What the port lacks (elastic
membership, row-parallel distributed training) raises
NotImplementedError naming the ROADMAP item; nothing falls back to a
default the JAX package would not take.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import signal
import threading
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
from ydf_tpu_torch.ops import grower, mhld, oblique
from ydf_tpu_torch.ops.histogram import resolve_hist_quant
from ydf_tpu_torch.ops.routing import route_tree_bins
from ydf_tpu_torch.ops.split_rules import HessianGainRule
from ydf_tpu_torch.ops.vector_sequence import vs_scores
from ydf_tpu_torch.parallel.mesh import learner_device
from ydf_tpu_torch.parallel.shards import MeshRows
from ydf_tpu_torch.utils import cuda_build, failpoints, log, prng, telemetry
from ydf_tpu_torch.utils.profiling import StageTimer, maybe_trace
from ydf_tpu_torch.utils.snapshot import Snapshots, _durable_replace
from ydf_tpu_torch.utils.xla_cpu import f32, fma_f32


#: Reads of device values on the host by boost() in this process: the
#: validation losses once per chunk of the look-ahead stop, the
#: candidate columns' widths once before the loop when candidate
#: features are sampled, MHLD's scatter matrices (once before the loop,
#: or once a tree when the row weights change), a checkpoint's copies
#: once a chunk, the last losses once a chunk when telemetry or debug
#: logging is on; the loop makes no other.
HOST_READS = 0
#: Most iterations a chunk of the look-ahead stop runs (the JAX
#: package's in-memory early-stop loop, gbt.py:1918-1920).
MAX_CHUNK_TREES = 25
#: The `format` of the port's snapshot metadata: a snapshot without it
#: (the JAX package's) is refused.
SNAPSHOT_FORMAT = "ydf_tpu_torch.gbt/1"
#: The hyperparameters that change no tree: left out of the snapshot
#: fingerprint, so a resume may change them.
RESUME_FREE = ("working_dir", "resume_training",
               "resume_training_snapshot_interval_trees",
               "maximum_training_duration", "device")


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
    when it trains. MHLD-oblique splits, checkpoints, preemption,
    deadlines and telemetry as the module docstring says. `mesh=`
    (ydf_tpu_torch.make_mesh) grows the trees with the rows, and
    optionally the columns, sharded over the mesh's devices (not with
    categorical-set features). `distributed_workers=["host:port", ...]`
    trains feature-parallel over RPC workers from a DatasetCache built
    with feature_shards=N (parallel/dist_gbt.py; the default loss of a
    regression or binary task, RANDOM sampling, axis-aligned splits, no
    validation split); `distributed_membership` raises
    NotImplementedError."""

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
        working_dir: Optional[str] = None,
        resume_training: bool = False,
        resume_training_snapshot_interval_trees: int = 50,
        maximum_training_duration: float = -1.0,
        features: Optional[Sequence[str]] = None,
        weights: Optional[str] = None,
        num_bins="auto",
        max_vocab_count: int = 2000,
        min_vocab_frequency: int = 5,
        column_types: Optional[Dict[str, ColumnType]] = None,
        discretize_numerical_columns: bool = False,
        num_discretized_numerical_bins: int = 255,
        random_seed: int = 123456,
        mesh=None,
        distributed_workers: Optional[Sequence[str]] = None,
        distributed_membership=None,
        device=None,
    ):
        # A mesh trains on its first device (parallel/mesh.py).
        device = learner_device(mesh, device)
        if distributed_membership is not None:
            raise unported("distributed_membership (elastic distributed "
                           "training)", 18)
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
        # Checkpoints (module docstring): with a working_dir the loop
        # snapshots every `resume_training_snapshot_interval_trees`
        # iterations and resume_training=True continues from the newest.
        self.working_dir = working_dir
        self.resume_training = resume_training
        self.resume_training_snapshot_interval_trees = (
            resume_training_snapshot_interval_trees)
        # Seconds for the whole train() call, the clock started at its
        # entry; <= 0 for none.
        self.maximum_training_duration = maximum_training_duration
        self.mesh = mesh
        self.distributed_workers = distributed_workers
        self.distributed_membership = distributed_membership
        # Test hooks (the JAX package's): abort after N snapshots, or
        # take a SIGTERM during chunk N (the real signal's path but its
        # delivery).
        self._abort_after_chunks = None
        self._preempt_after_chunks = None
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

    def _fingerprint(self, labels: np.ndarray, weights: np.ndarray,
                     binner, n: int, nv: int, hist_quant: str) -> str:
        """SHA-1 of the hyperparameters that decide the trees (with the
        histogram operand's mode when it is not the default f32, so that
        older f32 snapshots still resume) and of the data (labels,
        weights, the binner's boundaries, the row counts): a snapshot of
        another run is refused."""
        fp = hashlib.sha1()
        if hist_quant != "f32":
            fp.update(hist_quant.encode())
        hp = {k: (v if isinstance(v, (str, int, float, bool, type(None),
                                      tuple, list, dict))
                  else type(v).__name__)
              for k, v in self.hyperparameters().items()
              if k not in RESUME_FREE}
        fp.update(repr(sorted(hp.items())).encode())
        fp.update(np.asarray([n, nv], np.int64).tobytes())
        for a in (labels, weights, binner.boundaries):
            fp.update(np.ascontiguousarray(a).tobytes())
        return fp.hexdigest()

    def _check_mhld(self) -> None:
        """The JAX package's MHLD restrictions (gbt.py:697-709)."""
        if self.task != Task.CLASSIFICATION:
            # The reference restriction (oblique.cc:689-692): LDA needs
            # class labels.
            raise ValueError(
                "MHLD_OBLIQUE is only available for classification; "
                "use SPARSE_OBLIQUE for other tasks")
        if self.monotonic_constraints:
            raise ValueError(
                "monotonic constraints are not supported with "
                "MHLD_OBLIQUE (LDA coefficients cannot be sign-forced)")

    def _train_distributed(self, prep, loss_obj, hist_quant: str,
                           has_valid: bool):
        """Feature-parallel training over the RPC workers of
        `distributed_workers` (the JAX package's _train_gbt_distributed,
        gbt.py:2211-2340; parallel/dist_gbt.py): the configuration is
        checked down to the supported core with the JAX package's
        messages, then the manager runs. Returns (BoostResult, the
        training_logs["distributed"] record)."""
        from ydf_tpu_torch.parallel.dist_gbt import DistGBTManager
        from ydf_tpu_torch.parallel.worker_service import WorkerPool

        cache = prep["cache"]
        W = len(self.distributed_workers)
        if getattr(cache, "row_shards", 0) > 0:
            raise unported("row-parallel distributed training", 18)
        if cache.feature_shards < 1:
            raise ValueError(
                f"dataset cache {cache.path!r} has no shards; recreate it "
                "with create_dataset_cache(..., "
                f"feature_shards={W}) or row_shards={W}")
        unsupported = []
        if has_valid or (self.validation_ratio > 0
                         and self.early_stopping != "NONE"):
            unsupported.append(
                "a validation split (set early_stopping='NONE' or "
                "validation_ratio=0.0 — feature-parallel training has no "
                "validation routing; a row-sharded cache "
                "(create_dataset_cache(..., row_shards=N)) supports "
                "distributed early stopping)")
        if loss_obj.num_dims != 1:
            unsupported.append(
                f"multi-output losses (loss {loss_obj.name} has "
                f"{loss_obj.num_dims} dims)")
        if self.sampling_method != "RANDOM":
            unsupported.append(f"sampling_method={self.sampling_method!r}")
        if self.dart_dropout > 0.0:
            unsupported.append("dart_dropout > 0")
        if self.split_axis != "AXIS_ALIGNED":
            unsupported.append(f"split_axis={self.split_axis!r}")
        if prep.get("vs") is not None or prep.get("set_bits") is not None:
            unsupported.append("set / vector-sequence features")
        if self.monotonic_constraints:
            unsupported.append("monotonic constraints")
        if self.mesh is not None:
            unsupported.append("mesh= (GSPMD) combined with RPC workers")
        if (self.maximum_training_duration
                and self.maximum_training_duration > 0):
            unsupported.append("maximum_training_duration")
        if unsupported:
            raise ValueError("distributed_workers= does not support: "
                             + "; ".join(unsupported))
        binner = prep["binner"]
        n = cache.num_rows
        pool = WorkerPool(list(self.distributed_workers))
        mgr = DistGBTManager(
            pool, cache, labels=prep["labels"],
            weights=prep["sample_weights"], loss_obj=loss_obj,
            rule=HessianGainRule(l2=self.l2_regularization),
            tree_cfg=TreeConfig(
                max_depth=self.max_depth,
                max_frontier=resolve_max_frontier(self.max_frontier, n,
                                                  self.min_examples),
                num_bins=binner.num_bins, min_examples=self.min_examples),
            num_trees=self.num_trees, shrinkage=self.shrinkage,
            subsample=self.subsample,
            candidate_features=self._candidate_features(
                binner.num_features),
            num_numerical=binner.num_numerical, seed=self.random_seed,
            hist_quant=hist_quant, device=self.device,
            working_dir=self.working_dir, resume=self.resume_training,
            snapshot_interval=self.resume_training_snapshot_interval_trees,
            preempt_after_snapshots=self._preempt_after_chunks)
        try:
            return mgr.train()
        finally:
            # The pool's persistent connections are the run's.
            pool.close()

    def train(self, data: InputData, valid: Optional[InputData] = None
              ) -> GradientBoostedTreesModel:
        t0 = time.perf_counter()
        t_train0_ns = time.perf_counter_ns()
        # The deadline's clock starts at train() entry: ingest and binning
        # count against maximum_training_duration.
        deadline = (time.monotonic() + self.maximum_training_duration
                    if self.maximum_training_duration
                    and self.maximum_training_duration > 0 else None)
        timer = StageTimer()
        if self.split_axis == "MHLD_OBLIQUE":
            self._check_mhld()
        if self.distributed_workers:
            from ydf_tpu_torch.dataset.cache import DatasetCache

            if not isinstance(data, DatasetCache):
                raise ValueError(
                    "distributed_workers= requires training from a sharded "
                    "DatasetCache: create_dataset_cache(..., "
                    "feature_shards=N) or create_dataset_cache(..., "
                    "row_shards=N), then train(cache)")
        with timer.stage("ingest_bin"):
            # Distributed training leaves the bins to the workers: the
            # manager never holds the bin matrix.
            prep = self._prepare(data, valid=valid,
                                 bins=not self.distributed_workers)
        binner = prep["binner"]
        dev = self.device
        num_classes = len(prep.get("classes", [])) or 1
        loss_obj = self._loss_object(num_classes)
        K = loss_obj.num_dims
        hist_quant = resolve_hist_quant()
        if self.distributed_workers:
            with timer.stage("device_loop"), _flight_guard():
                t1 = time.perf_counter()
                out, dist_logs = self._train_distributed(
                    prep, loss_obj, hist_quant, valid is not None)
            model = self._model_from(out, prep, loss_obj, timer, t0, t1,
                                     t_train0_ns, len(prep["labels"]))
            model.training_logs["distributed"] = dist_logs
            return model
        bins_t = prep["bins_t"]  # one copy for every tree and layer
        labels, weights, vs_all = (prep["labels"], prep["sample_weights"],
                                   prep["vs"])
        sets = prep["set_bits"]  # i32 [n, Fs, W] on the device, or None
        x_raw = None  # imputed numerical features [n, Fn] (oblique)
        P = 0
        if self.split_axis in ("SPARSE_OBLIQUE", "MHLD_OBLIQUE") and (
                binner.num_numerical):
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
        y_dev, w_dev = on_device(labels, weights)
        if vs_all is not None and Ac + Ap > 0:
            vs = vs_inputs(vs_all, Ac, Ap, dev)
        if x_raw is not None and self.split_axis == "MHLD_OBLIQUE":
            obl = mhld.MHLDInputs.make(
                x_raw, y_dev, num_classes, P,
                self.mhld_oblique_max_num_attributes)
        elif x_raw is not None:
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

        checkpoint = None
        if self.working_dir:
            checkpoint = Checkpoint(
                self.working_dir,
                self.resume_training_snapshot_interval_trees,
                self.resume_training,
                self._fingerprint(labels, weights, binner, n,
                                  0 if va is None else len(va[1]),
                                  hist_quant),
                self._abort_after_chunks, self._preempt_after_chunks)
        t1 = time.perf_counter()
        with timer.stage("device_loop"), maybe_trace("gbt_train"):
            out = boost(
                bins_t, y_dev, w_dev, loss_obj=loss_obj,
                rule=rule, tree_cfg=tree_cfg, num_trees=self.num_trees,
                shrinkage=self.shrinkage, seed=self.random_seed, vs=vs,
                obl=obl, num_numerical=binner.num_numerical,
                valid=valid_set, lookahead=lookahead,
                sampling=Sampling(self.sampling_method, self.subsample,
                                  self.goss_alpha, self.goss_beta,
                                  self.selective_gradient_boosting_ratio,
                                  selgb_rows),
                candidate_features=self._candidate_features(
                    binner.num_features),
                set_bits=sets, monotone=monotone,
                dart_dropout=self.dart_dropout, checkpoint=checkpoint,
                deadline=deadline, mesh=self.mesh, hist_quant=hist_quant,
            )
        return self._model_from(out, prep, loss_obj, timer, t0, t1,
                                t_train0_ns, n, P=P, obl=obl, vs=vs)

    def _model_from(self, out, prep, loss_obj, timer, t0, t1, t_train0_ns,
                    n, P=0, obl=None, vs=None) -> GradientBoostedTreesModel:
        """The model of a boosting loop's result (BoostResult): the kept
        iterations (argmin of the validation losses with early
        stopping), the per-tree projection and anchor columns, the
        monotone clamp, the training logs, the stage timings and the
        telemetry spans."""
        binner = prep["binner"]
        K = loss_obj.num_dims
        t_fin = time.perf_counter()
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
        timer.seconds["finalize"] = time.perf_counter() - t_fin
        model.training_profile = timer.finish()
        if telemetry.ENABLED:
            trained = int(len(train_losses))
            emit_train_spans(out.chunk_walls, trained, self.max_depth)
            telemetry.emit_span(
                "train", t_train0_ns, time.perf_counter_ns() - t_train0_ns,
                {"rows": int(n), "num_trees": trained,
                 "learner": "GRADIENT_BOOSTED_TREES"})
            # The memory ledger's end-of-train snapshot beside the
            # per-iteration records.
            model.training_logs["memory"] = telemetry.ledger().snapshot()
            telemetry.flush()
        self.last_timings["train_s"] = time.perf_counter() - t0
        return model


def iteration_records(train_losses, valid_losses, chunk_walls):
    """training_logs["iterations"] as the JAX package writes it
    (_iteration_records): one record a trained iteration, 1-based, its
    losses and seconds, each chunk's host wall spread evenly over its
    trees."""
    secs = np.zeros((len(train_losses),), np.float64)
    for start, count, _, dur_ns in chunk_walls:
        secs[start:start + count] = dur_ns / 1e9 / count
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
    chunk_walls: List[tuple]    # (first iteration, iterations, host
                                # perf_counter_ns at its start, ns)
    obl_out: Optional[tuple] = None  # (projections [T, P, Fn], boundaries
                                     # [T, P, B-1]) or None


class Checkpoint(NamedTuple):
    """boost()'s snapshots (the learner's working_dir; module
    docstring)."""

    directory: str
    interval: int = 50              # iterations a chunk
    resume: bool = False
    fingerprint: str = ""           # of the configuration and the data
    abort_after_chunks: Optional[int] = None    # test hooks
    preempt_after_chunks: Optional[int] = None


class TrainingPreempted(RuntimeError):
    """SIGTERM or SIGINT arrived during checkpointed training (the JAX
    package's TrainingPreempted). The boosting loop finished the chunk in
    flight, saved its snapshot durably and stopped: train again with
    resume_training=True to continue where it stopped, with the trees of
    an uninterrupted run."""

    #: EX_TEMPFAIL: a transient condition; reschedule the job.
    exit_code = 75


class _TrainingAborted(RuntimeError):
    """Raised by the test-only abort hook (the reference injects failures
    the same way: MaybeSimulateFailure, worker.cc:415-452)."""


class _PreemptionGuard:
    """SIGTERM and SIGINT handlers around the checkpointed boosting loop
    (the JAX package's _PreemptionGuard; main thread only, where Python
    delivers signals). The handler only sets a flag: the loop checks it
    at each chunk boundary, right after the snapshot save, so the last
    snapshot of a preemption is the one just made durable. A second
    signal restores the previous handlers and delivers itself again."""

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.triggered = False
        self.signal_name: Optional[str] = None
        self._old = {}

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in self._SIGNALS:
                try:
                    self._old[sig] = signal.signal(sig, self._handle)
                except (ValueError, OSError):
                    pass  # an embedding that refuses: keep its handlers
        return self

    def __exit__(self, *exc):
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old if old is not None
                              else signal.SIG_DFL)
            except (ValueError, OSError, TypeError):
                pass
        self._old.clear()
        return False

    def trigger(self, signum: int) -> None:
        """Flags a preemption (the real handler and the
        _preempt_after_chunks test hook share this path)."""
        self.signal_name = signal.Signals(signum).name
        self.triggered = True

    def _handle(self, signum, frame):
        if self.triggered:
            # Second signal: restore the previous disposition and deliver
            # it again.
            old = self._old.pop(signum, signal.SIG_DFL)
            try:
                signal.signal(signum, old if old is not None
                              else signal.SIG_DFL)
            except (ValueError, OSError, TypeError):
                signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.trigger(signum)


def _oom_failpoint():
    """The `telemetry.oom` failpoint: an injected fault at a chunk
    boundary becomes a real MemoryError (the flight recorder's "oom"
    dump). One module-constant check when failpoints are unarmed."""
    try:
        failpoints.hit("telemetry.oom")
    except failpoints.FailpointError as e:
        raise MemoryError(f"injected OOM: {e}") from None


@contextlib.contextmanager
def _flight_guard():
    """An exception that escapes the boosting loop flushes buffered
    telemetry and writes the flight recorder's dump
    (`flight_<pid>.jsonl`, reason "oom" for a MemoryError, else
    "train_exception") before propagating; TrainingPreempted writes its
    own. A no-op when telemetry is off."""
    try:
        yield
    except TrainingPreempted:
        raise
    except BaseException as e:
        if telemetry.ENABLED:
            kind = "oom" if isinstance(e, MemoryError) else "exception"
            telemetry.flight_record(kind,
                                    error=f"{type(e).__name__}: {e}")
            telemetry.flush()
            telemetry.flight_dump("oom" if kind == "oom"
                                  else "train_exception")
        raise


def emit_train_spans(chunk_walls, trained: int, max_depth: int) -> None:
    """The boosting timeline's spans (the JAX package's
    _emit_train_spans): one measured `train.chunk` span a chunk, divided
    evenly into `train.tree` and `train.layer` spans flagged
    `attributed` (the host does not see a tree start and end on the
    device)."""
    if not telemetry.ENABLED:
        return
    for s, c, t0, dur in chunk_walls or []:
        n = max(min(s + c, trained) - s, 0)
        telemetry.emit_span("train.chunk", t0, dur,
                            {"start_iter": s, "iterations": c})
        if n == 0 or dur <= 0:
            continue
        tree_dur = dur // c
        layer_dur = max(tree_dur // max(max_depth, 1), 1)
        for j in range(n):
            tt0 = t0 + j * tree_dur
            telemetry.emit_span("train.tree", tt0, tree_dur,
                                {"iteration": s + j + 1, "attributed": True})
            for d in range(max_depth):
                telemetry.emit_span("train.layer", tt0 + d * layer_dur,
                                    layer_dur,
                                    {"depth": d, "attributed": True})


@contextlib.contextmanager
def _sync_allowed(on_card: bool):
    """Leaves the loop's sync debug mode "error" for the block (a
    counted host read, a copy to the card)."""
    if not on_card:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def chunk_length(lookahead: int, stopping: bool, num_trees: int,
                 checkpoint: Optional[Checkpoint], deadline) -> int:
    """Iterations a chunk of boost()'s loop (the JAX package's loops):
    the snapshot interval with a working_dir; min(lookahead, 25) with the
    look-ahead stop, or 25 for a deadline alone; else the whole loop."""
    if checkpoint is not None:
        return max(1, checkpoint.interval)
    if stopping or deadline is not None:
        return max(1, min(lookahead or MAX_CHUNK_TREES, MAX_CHUNK_TREES))
    return num_trees


def boost(bins_t: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
          *, loss_obj, rule, tree_cfg: TreeConfig, num_trees: int,
          shrinkage: float, seed: int = 123456,
          vs: Optional[VSInputs] = None, obl=None, hist_quant: str = "f32",
          num_numerical: Optional[int] = None,
          valid: Optional[ValidSet] = None,
          lookahead: int = 0, sampling: Sampling = Sampling(),
          candidate_features: int = -1,
          set_bits: Optional[torch.Tensor] = None,
          monotone: Optional[tuple] = None,
          dart_dropout: float = 0.0,
          checkpoint: Optional[Checkpoint] = None,
          deadline: Optional[float] = None, mesh=None) -> BoostResult:
    """The boosting loop on the device of `bins_t` (u8 [F, n]; rows
    [0, num_numerical) numerical, the rest categorical; default all
    numerical), T <= num_trees iterations of loss_obj.num_dims trees,
    with oblique splits when `obl` is given (ops/oblique.py:
    ObliqueInputs for sparse-oblique, ops/mhld.py:MHLDInputs for MHLD),
    categorical-set candidates when `set_bits` (i32 [n, Fs, W]) is,
    monotone directions per feature (`monotone`, monotone_directions)
    and DART when dart_dropout > 0 (module docstring).
    With `valid`, every tree scores the validation rows; with lookahead >
    0 as well (and num_trees > lookahead, as the JAX package), the loop
    runs in chunks of min(lookahead, MAX_CHUNK_TREES) iterations, reads
    each chunk's validation losses back once (HOST_READS) and stops once
    early_stop_hit. With `checkpoint` the chunks are its interval and
    each chunk ends with a snapshot; `deadline` (time.monotonic()) stops
    the loop at the first chunk boundary past it. On a card each chunk
    runs under torch's sync debug mode "error": no other host sync
    happens inside the loop but MHLD's one read a tree when the row
    weights change between iterations (ops/mhld.py). On a `mesh`
    (parallel/mesh.py) the trees grow on the bins laid over its devices
    (parallel/shards.py); the loop's per-row state stays on the device
    of `bins_t`, the mesh's first, and the trees are the single
    device's."""
    global HOST_READS
    if num_trees < 1:
        raise ValueError(f"num_trees must be >= 1, got {num_trees}")
    K = loss_obj.num_dims
    dev = bins_t.device
    F = bins_t.shape[0]
    Fs = 0 if set_bits is None else set_bits.shape[1]
    Pv = 0 if vs is None else len(vs.values) * vs.anchors_per_feature
    P = 0 if obl is None else obl.num_projections
    is_mhld = isinstance(obl, mhld.MHLDInputs)
    sampled = 0 < candidate_features < F + P + Pv + Fs
    dart = dart_dropout > 0.0
    keys = draws = columns = obl_w = drops = members = masks = scatter = None
    if sampling.draws or sampled or vs is not None or P or dart:
        keys_host = iteration_keys(seed, num_trees, K, vs is not None, "cpu",
                                   with_oblique=P > 0, with_dart=dart)
        keys = IterationKeys(*(None if k is None else k.to(dev)
                               for k in keys_host))
    if vs is not None:
        draws = vs_words(keys.vs, len(vs.values),
                         vs.num_closer + 2 * vs.num_projected)
    if P and not is_mhld:
        obl_w = obl.weights(keys.proj)
    elif P:
        masks = obl.masks(keys_host.proj)
        if not sampling.draws:
            # The row weights are the same every iteration: the scatter
            # matrices once before the loop, each chunk's projections at
            # its start.
            scatter = obl.scatter(obl.sums(weights).cpu().numpy())
            HOST_READS += 1
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
    clen = chunk_length(lookahead, stopping, num_trees, checkpoint, deadline)
    on_card = dev.type == "cuda"
    mesh_rows = None
    if mesh is not None:
        if Fs:
            raise unported("categorical-set features on a mesh", 18)
        if dev != mesh.first_device:
            raise ValueError(f"the loop's device {dev} is not the mesh's "
                             f"first device {mesh.first_device}")
        # The projection and anchor columns of every tree go after the
        # numericals.
        mesh_rows = MeshRows(mesh, bins_t, num_numerical, extra=P + Pv)
    loop = _Loop(bins_t, labels, weights, loss_obj=loss_obj, rule=rule,
                 tree_cfg=tree_cfg, shrinkage=shrinkage,
                 hist_quant=hist_quant, vs=vs, draws=draws,
                 obl=obl, obl_w=obl_w, loop_of_one=clen == 1,
                 num_numerical=num_numerical, valid=valid,
                 sampling=sampling, keys=keys, columns=columns,
                 members=members, monotone=monotone, drops=drops,
                 num_trees=num_trees, masks=masks, scatter=scatter,
                 on_card=on_card, mesh_rows=mesh_rows)
    snaps = None
    if checkpoint is not None:
        snaps = Snapshots(checkpoint.directory, max_kept=2)
        if checkpoint.resume:
            loop.resume(snaps, checkpoint)
    walls = []
    chunks_done = 0
    with _PreemptionGuard() if snaps is not None else \
            contextlib.nullcontext() as guard, _flight_guard():
        while loop.iterations < num_trees:
            start = loop.iterations
            count = min(clen, num_trees - start)
            # DART runs its last chunk exactly; the other loops run
            # whole chunks and drop the excess (the JAX package's
            # _chunk_len), which decides the oblique quantiles' form.
            loop.loop_of_one = (count if dart else clen) == 1
            t0 = time.perf_counter_ns()
            if scatter is not None:
                loop.solve_chunk(start, count)
            if on_card:
                # The loop must never wait on the card: any synchronizing
                # call inside it raises instead of silently serializing
                # the trees.
                prev_mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
            try:
                for it in range(start, start + count):
                    loop.step(it)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(prev_mode)
            seen = None
            if stopping:
                # The chunk's one host read.
                seen = torch.stack(loop.valid_losses).cpu().numpy()
                HOST_READS += 1
            elif deadline is not None and on_card:
                # The deadline reads the host clock once the chunk ran.
                torch.cuda.synchronize(dev)
            dur = time.perf_counter_ns() - t0
            walls.append((start, count, t0, dur))
            _note_chunk(loop, start, count, num_trees, dur, seen)
            if snaps is not None:
                loop.save(snaps, checkpoint, start, count)
                HOST_READS += 1
                chunks_done += 1
                failpoints.hit("gbt.chunk")
            _oom_failpoint()
            if snaps is not None:
                if (checkpoint.preempt_after_chunks is not None
                        and chunks_done >= checkpoint.preempt_after_chunks):
                    guard.trigger(signal.SIGTERM)
                if guard.triggered:
                    # The snapshot just saved is the last one; export the
                    # buffered telemetry and the flight recorder before
                    # raising.
                    done = loop.iterations
                    if telemetry.ENABLED:
                        emit_train_spans(walls, done, tree_cfg.max_depth)
                        telemetry.flight_record(
                            "preempt", signal=guard.signal_name,
                            completed_iters=done, num_trees=num_trees)
                        telemetry.flush()
                        telemetry.flight_dump("preempt")
                    raise TrainingPreempted(
                        f"training preempted by {guard.signal_name}: "
                        f"snapshot at {done}/{num_trees} iterations in "
                        f"{checkpoint.directory!r} is resumable "
                        "(resume_training=True)")
            if stopping and early_stop_hit(seen, lookahead):
                break
            if (snaps is not None and checkpoint.abort_after_chunks
                    is not None
                    and chunks_done >= checkpoint.abort_after_chunks):
                raise _TrainingAborted(
                    f"aborted after {chunks_done} chunks "
                    f"({loop.iterations} iterations)")
            if deadline is not None and time.monotonic() >= deadline:
                break
    return loop.result(walls)


def _note_chunk(loop, start: int, count: int, num_trees: int, dur_ns: int,
                seen: Optional[np.ndarray]) -> None:
    """The chunk's training metrics and progress line (the JAX package's
    _note_chunk): ydf_train_iterations_total, ydf_train_chunk_latency_ns
    and the loss gauges when telemetry is on, a debug line. Reading the
    last losses is a host read (HOST_READS), made only for them."""
    global HOST_READS
    if not (telemetry.ENABLED or log.is_debug()):
        return
    tl = float(loop.losses[-1])
    HOST_READS += 1
    vl = None
    if loop.valid is not None:
        vl = float(seen[-1] if seen is not None else loop.valid_losses[-1])
    if telemetry.ENABLED:
        telemetry.counter("ydf_train_iterations_total").inc(count)
        telemetry.histogram("ydf_train_chunk_latency_ns").observe_ns(dur_ns)
        telemetry.gauge("ydf_train_last_train_loss").set(tl)
        if vl is not None:
            telemetry.gauge("ydf_train_last_valid_loss").set(vl)
    if log.is_debug():
        done = min(start + count, num_trees)
        log.debug(f"gbt: iter {done}/{num_trees} train_loss={tl:.6g}"
                  + (f" valid_loss={vl:.6g}" if vl is not None else "")
                  + f" chunk_s={dur_ns / 1e9:.3f}")


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
                 num_trees=0, masks=None, scatter=None, on_card=False,
                 mesh_rows=None):
        self.bins_t, self.labels, self.weights = bins_t, labels, weights
        # On a mesh, the bins laid over its devices (parallel/shards.py).
        self.mesh_rows = mesh_rows
        self.loss_obj, self.rule, self.cfg = loss_obj, rule, tree_cfg
        self.shrinkage, self.hist_quant = shrinkage, hist_quant
        self.vs, self.draws, self.valid = vs, draws, valid
        # The JAX package runs the iterations in loops of `clen` steps; a
        # loop of one rounds the projections' quantiles differently.
        self.obl, self.obl_w, self.loop_of_one = obl, obl_w, loop_of_one
        self.sampling, self.keys, self.columns = sampling, keys, columns
        self.members, self.drops = members, drops
        # MHLD: every iteration's subset masks (host), the scatter
        # matrices when the row weights stay (else None), the current
        # chunk's solved projections (its start and W [count, P, Fn]),
        # and every iteration's projections as the loop takes them.
        self.masks, self.scatter, self.on_card = masks, scatter, on_card
        self.chunk_w, self.obl_ws = None, []
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
        self.chunk_starts: List[int] = []  # the snapshots' chunk list
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
        extra = []  # the tree's projection, then anchor columns
        if self.obl is not None:
            if self.obl_w is not None:
                W = self.obl_w[it]
            else:
                W = self._mhld_weights(it, w_eff)
                self.obl_ws.append(W)
            # The projection columns go after the numerical features,
            # the JAX package's [num, obl, vs, cat].
            cols, bounds = oblique.projection_columns(
                self.obl.x_t, W, qs=self.qs, loop_of_one=self.loop_of_one)
            extra.append(cols)
            if valid is not None:
                cols_va, _ = oblique.projection_columns(
                    valid.x_t, W, bounds=bounds)
                grow_va = torch.cat([grow_va[:Fn], cols_va, grow_va[Fn:]])
            Fn += cols.shape[0]
            self.obl_bounds.append(bounds)
            if mono is not None:
                # A projection touching a constrained feature increases
                # with it (its coefficients are sign-forced).
                touch = (W.abs() * self.mono_num.abs()).sum(dim=1) > 0
                mono = torch.cat([self.mono_num, touch.float()])
        if self.vs is not None:
            # The anchor columns go between the numerical and the
            # categorical features, the JAX package's [num, vs, cat].
            anchors, bounds, cols = make_vs_projections(
                self.vs, {k: v[it] for k, v in self.draws.items()},
                self.qs)
            extra.append(cols)
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
        shards = None
        if self.mesh_rows is not None:
            # The same columns, cut over the mesh.
            shards = self.mesh_rows.for_tree(
                torch.cat(extra) if extra else None)
            grow_bins = None
        elif extra:
            grow_bins = torch.cat([grow_bins[:self.Fn], *extra,
                                   grow_bins[self.Fn:]])
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
                set_members=self.members, mono_dirs=mono, shards=shards,
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

    def solve_chunk(self, start: int, count: int) -> None:
        """MHLD with the row weights the same every iteration: the
        projections of iterations [start, start + count) solved on the
        host from the scatter matrices read before the loop, and copied
        to the device; called at the chunk's start, outside the sync
        debug mode "error"."""
        W = np.stack([self.obl.solve(self.scatter, self.masks[it])
                      for it in range(start, start + count)])
        self.chunk_w = (start, torch.from_numpy(W).to(self.bins_t.device))

    def _mhld_weights(self, it: int, w_eff: torch.Tensor) -> torch.Tensor:
        """Iteration `it`'s MHLD projections: from its chunk's solves
        when the row weights stay (solve_chunk); else at its row weights
        `w_eff`: the scatter sums on the device, one host read
        (HOST_READS, outside the sync debug mode "error"), the solves on
        the host, W copied back."""
        global HOST_READS
        if self.scatter is not None:
            start, W = self.chunk_w
            return W[it - start]
        packed = self.obl.sums(w_eff)
        with _sync_allowed(self.on_card):
            host = packed.cpu().numpy()
            HOST_READS += 1
            W = self.obl.solve(self.obl.scatter(host), self.masks[it])
            return torch.from_numpy(W).to(self.bins_t.device)

    # -- checkpoints ----------------------------------------------------- #

    def _carry(self) -> Dict[str, torch.Tensor]:
        """The state the next iteration reads (module docstring)."""
        out = {"init_pred": self.init_pred, "preds": self.preds}
        if self.valid is not None:
            out["vpreds"] = self.vpreds
        if self.drops is not None:
            out["contrib"], out["tree_scale"] = self.contrib, self.tree_scale
            if self.valid is not None:
                out["vcontrib"] = self.vcontrib
        return out

    def _chunk_arrays(self, start: int, count: int) -> Dict[str, np.ndarray]:
        """Iterations [start, start + count)'s outputs as numpy arrays
        (a chunk's payload)."""
        K = self.K
        trees = self.trees[start * K:(start + count) * K]
        out = {f"trees_{f}": torch.stack([getattr(t, f) for t in trees])
               for f in grower.TreeArrays._fields}
        out["lv"] = torch.stack(self.leaf_values[start * K:(start + count)
                                                 * K])
        out["tl"] = torch.stack(self.losses[start:start + count])
        if self.valid is not None:
            out["vl"] = torch.stack(self.valid_losses[start:start + count])
        if self.obl is not None:
            out["ob"] = torch.stack(self.obl_bounds[start:start + count])
            if self.obl_w is None:
                out["ow"] = torch.stack(self.obl_ws[start:start + count])
        if self.vs is not None:
            out["vsa"] = torch.stack(self.vs_anchors[start:start + count])
            out["vsb"] = torch.stack(self.vs_bounds[start:start + count])
        return {k: v.cpu().numpy() for k, v in out.items()}

    def save(self, snaps: Snapshots, ck: Checkpoint, start: int,
             count: int) -> None:
        """The chunk's payload (chunk_<start>.npz, durable), then the
        snapshot of the carry, the validation losses so far and the
        chunk list (the JAX package's order: a snapshot never names a
        payload that could be torn)."""
        path = os.path.join(ck.directory, f"chunk_{start}.npz")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **self._chunk_arrays(start, count))
        _durable_replace(tmp, path)
        arrays = {k: v.cpu().numpy() for k, v in self._carry().items()}
        if self.valid is not None:
            arrays["valid_losses"] = torch.stack(
                self.valid_losses).cpu().numpy()
        self.chunk_starts.append(start)
        done = start + count
        snaps.save(done, arrays, meta={
            "format": SNAPSHOT_FORMAT, "completed_iters": done,
            "fingerprint": ck.fingerprint,
            "chunk_starts": list(self.chunk_starts)})

    def resume(self, snaps: Snapshots, ck: Checkpoint) -> None:
        """Continues from the newest readable snapshot, if any: the
        carry back on the device, the finished chunks' outputs from
        their payloads (and so the look-ahead stop's history)."""
        state = snaps.latest()
        if state is None:
            return
        _, arrays, meta = state
        if meta.get("format") != SNAPSHOT_FORMAT:
            raise ValueError(
                f"Snapshot in {ck.directory!r} was not written by "
                "ydf_tpu_torch (the JAX package's snapshots hold its own "
                "program state and do not resume in the port); refusing "
                "to resume. Delete the directory or disable "
                "resume_training.")
        if meta.get("fingerprint") != ck.fingerprint:
            raise ValueError(
                f"Snapshot in {ck.directory!r} was created with different "
                "data or hyperparameters; refusing to resume. Delete the "
                "directory or disable resume_training.")
        dev = self.bins_t.device
        for k, v in arrays.items():
            if k != "valid_losses":
                setattr(self, k, torch.from_numpy(v).to(dev))
        for st in meta["chunk_starts"]:
            with np.load(os.path.join(ck.directory, f"chunk_{st}.npz")) as z:
                part = {k: torch.from_numpy(z[k]).to(dev) for k in z.files}
            fields = [part[f"trees_{f}"] for f in grower.TreeArrays._fields]
            self.trees.extend(grower.TreeArrays(*(a[i] for a in fields))
                              for i in range(fields[0].shape[0]))
            self.leaf_values.extend(part["lv"])
            self.losses.extend(part["tl"])
            if "vl" in part:
                self.valid_losses.extend(part["vl"])
            if "ob" in part:
                self.obl_bounds.extend(part["ob"])
            if "ow" in part:
                self.obl_ws.extend(part["ow"])
            if "vsa" in part:
                self.vs_anchors.extend(part["vsa"])
                self.vs_bounds.extend(part["vsb"])
        self.chunk_starts = list(meta["chunk_starts"])
        self.iterations = meta["completed_iters"]

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
            obl_out = (self.obl_w[:T] if self.obl_w is not None
                       else torch.stack(self.obl_ws),
                       torch.stack(self.obl_bounds))
        return BoostResult(
            trees=stacked, leaf_values=leaf_values,
            train_loss=torch.stack(self.losses), init_pred=self.init_pred,
            vs_out=vs_out,
            valid_loss=(torch.stack(self.valid_losses)
                        if self.valid is not None else None),
            chunk_walls=walls, obl_out=obl_out,
        )
