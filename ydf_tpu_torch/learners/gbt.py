"""Gradient boosted trees learner (counterpart of ydf_tpu/learners/gbt.py:
GradientBoostedTreesLearner and the boosting step of _make_boost_fn).

    import ydf_tpu_torch as ydf
    model = ydf.GradientBoostedTreesLearner(label="label").train(data)
    model.predict(rows)                          # on the card by default
    model.evaluate(test)

One boosting iteration, K = 1 (binary classification or regression):
gradients and hessians of the loss at the current predictions, the
[g*w, h*w, w] stats rows, one tree grown by ops/grower.py, leaf values
-sum g / (sum h + l2) scaled by the shrinkage for the model, and the
prediction update. The loop stays on the device: the trees, leaf values
and losses are collected as device tensors and read back after the last
tree.

Validation and early stopping (the JAX package's defaults,
validation_ratio=0.1 and early_stopping="LOSS_INCREASE"): the rows are
split by np.random.RandomState(random_seed).permutation, the first
min(max(int(n * ratio), 1), n - 1) rows validating (gbt.py:396-430);
the binner is fitted on every row first, and the split gathers columns
of the one device bin matrix. Every tree routes the validation rows
(ops/routing.py:route_tree_bins), updates their predictions as the
training ones and records their loss. With look-ahead stopping the
loop runs in chunks of min(look_ahead, 25) trees and reads the chunk's
validation losses back once after it, the loop's only host read: it
stops once the best loss lies `look_ahead` trees back
(_early_stop_hit), and the model keeps argmin + 1 trees. Trees never
depend on the chunking: a chunk only decides where the loop stops.

NUMERICAL_VECTOR_SEQUENCE features (the JAX package's per-tree anchor
candidates, gbt.py:1312-1383): every tree draws, for each VS feature,
num_anchors closer-than anchors (vectors drawn from the data) and as many
projected-more-than anchors (differences of two drawn vectors), scores
every example against them (ops/vector_sequence.py, csrc/
vector_sequence.cu on a card), and bins the scores at their quantiles
into candidate columns inserted after the numerical features (before the
categorical ones, the JAX package's layout). The draws
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
from ydf_tpu_torch.ops.routing import route_tree_bins
from ydf_tpu_torch.ops.split_rules import HessianGainRule
from ydf_tpu_torch.ops.vector_sequence import vs_scores
from ydf_tpu_torch.utils import cuda_build, prng


#: Reads of the validation losses by the boosting loop in this process
#: (one per chunk of the look-ahead stop); the loop makes no other.
HOST_READS = 0
#: Most trees a chunk of the look-ahead stop grows (the JAX package's
#: in-memory early-stop loop, gbt.py:1918-1920).
MAX_CHUNK_TREES = 25


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})"
    )


def fma_update(preds: torch.Tensor, raw: torch.Tensor,
               scale: float) -> torch.Tensor:
    """preds + raw * scale rounded once to f32 (module docstring)."""
    s = float(np.float32(scale))
    return (preds.double() + raw.double() * s).float()


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


def early_stop_hit(valid_losses: np.ndarray, lookahead: int) -> bool:
    """Look-ahead early stopping (the JAX package's _early_stop_hit,
    reference early_stopping.h:29-66): the loss of the trees trained so
    far has not improved for `lookahead` trees."""
    if lookahead <= 0 or len(valid_losses) == 0:
        return False
    return len(valid_losses) - (int(np.argmin(valid_losses)) + 1) \
        >= lookahead


class GradientBoostedTreesLearner(GenericLearner):
    """The JAX package's learner surface for the training slices: binary
    classification (binomial loss) and regression (squared error) on
    numerical, boolean, categorical and numerical-vector-sequence
    features, with its validation split and look-ahead early stopping.
    `train(data, valid=None)`: an explicit validation set replaces the
    split."""

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
        self.early_stopping_num_trees_look_ahead = (
            early_stopping_num_trees_look_ahead)
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

    def train(self, data: InputData, valid: Optional[InputData] = None
              ) -> GradientBoostedTreesModel:
        t0 = time.perf_counter()
        prep = self._prepare(data, valid=valid)
        binner = prep["binner"]
        dev = self.device
        num_classes = len(prep.get("classes", [])) or 1
        loss_obj = make_loss(self.loss, self.task, num_classes)
        bins_t = prep["bins_t"]  # one copy for every tree and layer
        labels, weights, vs_all = (prep["labels"], prep["sample_weights"],
                                   prep["vs"])
        va = None  # (bins_t, labels, weights, vs) of the validation rows
        if valid is not None:
            va = (prep["valid_bins_t"], prep["valid_labels"],
                  prep["valid_sample_weights"], prep["valid_vs"])
        elif self.validation_ratio > 0 and self.early_stopping != "NONE":
            tr_idx, va_idx = split_validation(
                bins_t.shape[1], self.validation_ratio, self.random_seed)
            if len(va_idx):
                def rows(idx):
                    return (bins_t.index_select(
                                1, torch.from_numpy(idx).to(dev)),
                            labels[idx], weights[idx],
                            None if vs_all is None else
                            tuple(a[idx] for a in vs_all))

                va = rows(va_idx)
                bins_t, labels, weights, vs_all = rows(tr_idx)
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

        Ac, Ap = self._vs_anchor_counts()
        vs = valid_set = None
        if vs_all is not None and Ac + Ap > 0:
            vs = vs_inputs(vs_all, Ac, Ap, dev)
        if va is not None and va[0].shape[1] > 0:
            valid_set = ValidSet(
                va[0], *on_device(va[1], va[2]),
                None if vs is None else vs_inputs(va[3], Ac, Ap, dev))
        lookahead = (self.early_stopping_num_trees_look_ahead
                     if self.early_stopping == "LOSS_INCREASE" else 0)

        t1 = time.perf_counter()
        out = boost(
            bins_t, *on_device(labels, weights), loss_obj=loss_obj,
            rule=rule, tree_cfg=tree_cfg, num_trees=self.num_trees,
            shrinkage=self.shrinkage, seed=self.random_seed, vs=vs,
            num_numerical=binner.num_numerical, valid=valid_set,
            lookahead=lookahead,
        )
        train_losses = out.train_loss.cpu().numpy()
        valid_losses = (None if out.valid_loss is None
                        else out.valid_loss.cpu().numpy())
        if valid_losses is not None and self.early_stopping != "NONE":
            num_iters = int(np.argmin(valid_losses)) + 1
        else:
            num_iters = len(train_losses)
        trees = grower.TreeArrays(*(f[:num_iters] for f in out.trees))
        kwargs = {}
        if vs is not None:
            trees = trees._replace(feature=vs_feature_ids(
                trees.feature, binner.num_numerical, binner.num_features,
                out.vs_out[0].shape[1]))
            kwargs = forest_vs_kwargs(vs, *(a[:num_iters]
                                            for a in out.vs_out))
        forest = forest_from_stacked_trees(
            trees, out.leaf_values[:num_iters], binner.boundaries, **kwargs)
        t2 = time.perf_counter()
        self.last_timings["boost_s"] = t2 - t1
        model = GradientBoostedTreesModel(
            task=self.task, label=self.label,
            classes=prep.get("classes"),
            dataspec=prep["dataset"].dataspec, binner=binner, forest=forest,
            max_depth=self.max_depth,
            initial_predictions=out.init_pred.cpu().numpy(),
            num_trees_per_iter=1, loss_name=loss_obj.name,
            apply_link_function=self.apply_link_function,
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


def vs_feature_ids(feature: torch.Tensor, Fn: int, F: int,
                   Pv: int) -> torch.Tensor:
    """Grown feature ids ([numericals, anchors, categoricals], the JAX
    package's candidate layout) -> the forest's ([numericals,
    categoricals, anchors]): anchors move after the F binned features."""
    anchor = (feature >= Fn) & (feature < Fn + Pv)
    return torch.where(anchor, feature - Fn + F,
                       torch.where(feature >= Fn + Pv, feature - Pv,
                                   feature))


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


class BoostResult(NamedTuple):
    """boost()'s outputs, on the training device but `chunk_walls`."""

    trees: grower.TreeArrays    # stacked [T, ...]
    leaf_values: torch.Tensor   # f32 [T, N, 1]
    train_loss: torch.Tensor    # f32 [T]
    init_pred: torch.Tensor     # f32 [1]
    vs_out: Optional[tuple]     # (anchors [T, Pv, D], boundaries
                                # [T, Pv, B-1]) or None
    valid_loss: Optional[torch.Tensor]  # f32 [T], None without `valid`
    chunk_walls: List[tuple]    # (first tree, trees, host seconds)


def boost(bins_t: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
          *, loss_obj, rule, tree_cfg: TreeConfig, num_trees: int,
          shrinkage: float, seed: int = 123456,
          vs: Optional[VSInputs] = None, hist_quant: str = "f32",
          num_numerical: Optional[int] = None,
          valid: Optional[ValidSet] = None,
          lookahead: int = 0) -> BoostResult:
    """The boosting loop on the device of `bins_t` (u8 [F, n]; rows
    [0, num_numerical) numerical, the rest categorical; default all
    numerical), T <= num_trees trees. With `valid`, every tree scores the
    validation rows; with lookahead > 0 as well (and num_trees >
    lookahead, as the JAX package), the loop runs in chunks of
    min(lookahead, MAX_CHUNK_TREES) trees, reads each chunk's validation
    losses back once (HOST_READS) and stops once early_stop_hit. On a
    card each chunk runs under torch's sync debug mode "error": no other
    host sync happens inside the loop."""
    global HOST_READS
    if num_trees < 1:
        raise ValueError(f"num_trees must be >= 1, got {num_trees}")
    draws = None
    if vs is not None:
        draws = vs_draws(seed, num_trees, len(vs.values),
                         vs.num_closer + 2 * vs.num_projected,
                         bins_t.device)
    stopping = valid is not None and 0 < lookahead < num_trees
    clen = min(lookahead, MAX_CHUNK_TREES) if stopping else num_trees
    loop = _Loop(bins_t, labels, weights, loss_obj=loss_obj, rule=rule,
                 tree_cfg=tree_cfg, shrinkage=shrinkage,
                 hist_quant=hist_quant, vs=vs, draws=draws,
                 num_numerical=num_numerical, valid=valid)
    on_card = bins_t.device.type == "cuda"
    walls = []
    while len(loop.trees) < num_trees:
        start = len(loop.trees)
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


class _Loop:
    """The boosting loop's state: predictions (training and validation)
    and the per-tree outputs, as device tensors."""

    def __init__(self, bins_t, labels, weights, *, loss_obj, rule,
                 tree_cfg, shrinkage, hist_quant, vs, draws, num_numerical,
                 valid):
        self.bins_t, self.labels, self.weights = bins_t, labels, weights
        self.loss_obj, self.rule, self.cfg = loss_obj, rule, tree_cfg
        self.shrinkage, self.hist_quant = shrinkage, hist_quant
        self.vs, self.draws, self.valid = vs, draws, valid
        self.Fn = bins_t.shape[0] if num_numerical is None else num_numerical
        self.init_pred = loss_obj.initial_predictions(labels, weights)
        self.preds = self.init_pred.expand(bins_t.shape[1]).contiguous()
        if valid is not None:
            self.vpreds = self.init_pred.expand(
                valid.bins_t.shape[1]).contiguous()
        self.trees, self.leaf_values, self.losses = [], [], []
        self.valid_losses, self.vs_anchors, self.vs_bounds = [], [], []
        B = tree_cfg.num_bins
        if vs is not None:
            self.qs = prng.linspace_f32(1.0 / B, 1.0 - 1.0 / B, B - 1,
                                        device=bins_t.device)

    def step(self, it: int) -> None:
        """Tree `it`: stats, grow, leaf values, prediction updates,
        losses."""
        cfg, loss_obj, valid = self.cfg, self.loss_obj, self.valid
        g, h = loss_obj.grad_hess(self.labels, self.preds)
        # w_eff = w * 1: sampling at subsample 1.0 keeps every row.
        w = self.weights
        stats = torch.stack([g * w, h * w, w], dim=1)
        grow_bins = self.bins_t
        grow_va = None if valid is None else valid.bins_t
        Fn = self.Fn
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
            Fn += cols.shape[0]
            self.vs_anchors.append(anchors)
            self.vs_bounds.append(bounds)
        res = grower.grow_tree(
            grow_bins, stats, rule=self.rule, max_depth=cfg.max_depth,
            frontier=cfg.frontier, max_nodes=cfg.max_nodes,
            num_bins=cfg.num_bins, num_numerical=Fn,
            min_examples=cfg.min_examples, hist_quant=self.hist_quant,
        )
        lv_raw = self.rule.leaf_value(res.tree.leaf_stats)  # [N, 1]
        self.preds = fma_update(self.preds, lv_raw[res.leaf_id.long(), 0],
                                self.shrinkage)
        self.trees.append(res.tree)
        self.leaf_values.append(lv_raw * self.shrinkage)
        self.losses.append(loss_obj.loss(self.labels, self.preds, w))
        if valid is not None:
            timer = cuda_build.launch_timer("valid_route")
            vleaf = route_tree_bins(res.tree, grow_va, cfg.max_depth)
            self.vpreds = fma_update(self.vpreds, lv_raw[vleaf, 0],
                                     self.shrinkage)
            self.valid_losses.append(
                loss_obj.loss(valid.labels, self.vpreds, valid.weights))
            cuda_build.launch_done(timer)

    def result(self, walls) -> BoostResult:
        stacked = grower.TreeArrays(*(torch.stack(field)
                                      for field in zip(*self.trees)))
        vs_out = None
        if self.vs is not None:
            vs_out = (torch.stack(self.vs_anchors),
                      torch.stack(self.vs_bounds))
        return BoostResult(
            trees=stacked, leaf_values=torch.stack(self.leaf_values),
            train_loss=torch.stack(self.losses), init_pred=self.init_pred,
            vs_out=vs_out,
            valid_loss=(torch.stack(self.valid_losses)
                        if self.valid is not None else None),
            chunk_walls=walls,
        )
