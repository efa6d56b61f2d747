"""Random Forest learner (counterpart of ydf_tpu/learners/random_forest.py:
RandomForestLearner, _train_rf and the per-tree step of _rf_run_chunk).

    import ydf_tpu_torch as ydf
    model = ydf.RandomForestLearner(label="label").train(data)
    model.predict(rows)                          # on the card by default
    model.evaluate(test)
    model.self_evaluation()                      # out-of-bag evaluation

The JAX package's defaults: 300 trees of depth 16, min_examples 5, a
Poisson(1) bootstrap of the rows, sqrt(F) candidate features per node for
classification and F/3 for regression, winner-take-all votes, out-of-bag
evaluation, max_frontier="auto" (1024 slots from 10,240 rows up).

Tree t draws from key = fold_in(PRNGKey(seed), t): k_boot, k_grow,
k_honest, k_obl = split(key, 4). Its rows weigh w = w_base *
poisson(k_boot, 1.0, (n,)), its stats are basis * w (classification:
[one-hot label..., 1], so the stats are class counts; regression: [y,
y^2, 1]), the grower draws each layer's candidate features from k_grow
(ops/grower.py), and the leaves hold rule.leaf_value (the class
distribution, or the mean). Rows the bootstrap left out (count 0, base
weight > 0) vote on the tree for the out-of-bag evaluation: one-hot of
the leaf's top class (winner take all) or the leaf value, summed in tree
order in f32, as the JAX package does.

Sparse-oblique splits (split_axis="SPARSE_OBLIQUE", _rf_run_chunk's
projection step): tree t draws P = min(max(ceil(Fn ** exponent), 2),
max_num_projections) sparse projections of the Fn imputed numerical
features from k_obl (ops/oblique.py), projects every row in XLA's dot
order, bins each projection at its quantiles through the binning kernel
and grows on [numericals, projections, categoricals]; the candidate
features are drawn over all F + P columns while their count still
counts the F real features, as in the JAX package. The forest keeps the
projections after the real features (models/forest.py).

CATEGORICAL_SET features are candidates of every node (ops/grower.py's
set candidates, over the rows' packed sets on the device); the
out-of-bag votes follow the grown leaves, set splits included.

The bootstrap counts, the candidate features and the projections depend
on the seed
alone, so they are drawn for every tree before the loop (utils/prng.py:
poisson1; grower.candidate_masks; oblique.sample_projection_coefficients)
and read on the host once there: the
count of Knuth steps that sufficed and the widest candidate set of each
layer (HOST_READS). The loop itself reads nothing back (it runs under
torch.cuda.set_sync_debug_mode("error") on a card); the trees, leaf
values and out-of-bag sums are read after the last tree.

Uplift tasks (task=CATEGORICAL_UPLIFT or NUMERICAL_UPLIFT with
uplift_treatment=, the JAX package's uplift branch): the treatment column
is dictionary-encoded (code 1, the most frequent value, is control; code
2 treated; other codes weigh nothing) and kept out of the features; the
stats are [control, control y, treated, treated y, known] x w and the
rule UpliftEuclideanRule, whose leaves hold the uplift; only binary
treatments and (for CATEGORICAL_UPLIFT) binary outcomes, no out-of-bag
evaluation, extra_metadata names the treatment column.

Honest trees (honest=True): tree t also draws est = bernoulli(k_honest,
honest_ratio_leaf_examples, (n,)) on the device; the rows drawn weigh
nothing while the tree grows, then each leaf's stats are summed again
over them alone (honest_leaf_stats, in the JAX package's row order).

maximum_training_duration (seconds, the clock started at train()'s
entry) stops the tree loop at the first boundary of a chunk of
CHUNK_TREES trees past the deadline, as the JAX package's chunked loop
does; the forest keeps the trees grown, a prefix of the full run's.

A mesh (mesh=, parallel/mesh.py) grows every tree with the rows, and
optionally the columns, sharded over its devices (parallel/shards.py);
the tree loop's per-row state (bootstrap counts, stats, out-of-bag
votes) stays on the mesh's first device, so the rows need no padding
there and the out-of-bag evaluation sees the real rows alone. Under
feature parallelism the columns are padded with constant-zero columns
to a multiple of the feature axis, as the JAX package pads them: they
never split, and the candidate sampling draws over the padded count
with the pad columns scored -1, so a padded run grows the JAX package's
mesh forest and an unpadded one the single device's.

What the JAX package's learner offers and this port does not
(out-of-bag permutation importances, categorical-set features on a
mesh) raises NotImplementedError naming the ROADMAP item.
bootstrap_size_ratio is stored and unused, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ydf_tpu_torch.config import (
    UPLIFT_TASKS, Task, TreeConfig, resolve_max_frontier)
from ydf_tpu_torch.dataset.dataset import InputData
from ydf_tpu_torch.dataset.dataspec import ColumnType
from ydf_tpu_torch.learners.generic import GenericLearner, unported
from ydf_tpu_torch.metrics.metrics import evaluate_predictions
from ydf_tpu_torch.models.forest import (
    bake_winner_take_all,
    forest_from_stacked_trees,
)
from ydf_tpu_torch.models.rf_model import RandomForestModel
from ydf_tpu_torch.ops import grower, oblique, segment_sum
from ydf_tpu_torch.ops.split_rules import (
    ClassificationRule, RegressionRule, UpliftEuclideanRule)
from ydf_tpu_torch.parallel.mesh import FEATURE_AXIS, learner_device
from ydf_tpu_torch.parallel.shards import MeshRows
from ydf_tpu_torch.utils import prng

#: Reads of device values on the host by train_rf in this process: the
#: bootstrap's stop check and the candidate widths, before the loop; the
#: loop makes none.
HOST_READS = 0
#: Knuth steps of the first bootstrap draw; a draw that does not stop in
#: them is drawn again with twice as many (rate 1 passes 16 with
#: probability about 1e-14 a row).
POISSON_STEPS = 16
#: Trees whose bootstrap counts are drawn together (bounds the draw's
#: temporaries at POISSON_CHUNK x n).
POISSON_CHUNK = 25
#: Trees a chunk of the tree loop grows between deadline checks (the
#: JAX package's chunk_trees).
CHUNK_TREES = 25


class RandomForestLearner(GenericLearner):
    """The JAX package's RandomForestLearner for classification,
    regression and the uplift tasks on numerical, boolean, categorical
    and categorical-set features."""

    def __init__(
        self,
        label: str,
        task: Task = Task.CLASSIFICATION,
        num_trees: int = 300,
        max_depth: int = 16,
        min_examples: int = 5,
        bootstrap_training_dataset: bool = True,
        bootstrap_size_ratio: float = 1.0,
        num_candidate_attributes: int = 0,
        num_candidate_attributes_ratio: float = -1.0,
        split_axis: str = "AXIS_ALIGNED",
        sparse_oblique_num_projections_exponent: float = 1.0,
        sparse_oblique_projection_density_factor: float = 2.0,
        sparse_oblique_weights: str = "BINARY",
        sparse_oblique_max_num_projections: int = 64,
        winner_take_all: bool = True,
        compute_oob_performances: bool = True,
        compute_oob_variable_importances: bool = False,
        max_frontier="auto",
        uplift_treatment: Optional[str] = None,
        honest: bool = False,
        honest_ratio_leaf_examples: float = 0.5,
        maximum_training_duration: float = -1.0,
        mesh=None,
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
        if task not in (Task.CLASSIFICATION, Task.REGRESSION) + UPLIFT_TASKS:
            raise NotImplementedError(
                f"random forest task {task.value}: the port's forests "
                "train classification, regression and the uplift tasks")
        if split_axis not in ("AXIS_ALIGNED", "SPARSE_OBLIQUE"):
            raise ValueError(f"Unknown split_axis {split_axis!r}")
        oblique.check_weight_type(sparse_oblique_weights)
        if compute_oob_variable_importances:
            raise unported("out-of-bag permutation importances", 20)
        # A mesh trains on its first device (parallel/mesh.py).
        device = learner_device(mesh, device)
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
        self.max_depth = max_depth
        self.min_examples = min_examples
        self.bootstrap_training_dataset = bootstrap_training_dataset
        self.bootstrap_size_ratio = bootstrap_size_ratio
        self.num_candidate_attributes = num_candidate_attributes
        self.num_candidate_attributes_ratio = num_candidate_attributes_ratio
        self.split_axis = split_axis
        self.sparse_oblique_num_projections_exponent = (
            sparse_oblique_num_projections_exponent)
        self.sparse_oblique_projection_density_factor = (
            sparse_oblique_projection_density_factor)
        self.sparse_oblique_weights = sparse_oblique_weights
        self.sparse_oblique_max_num_projections = (
            sparse_oblique_max_num_projections)
        self.winner_take_all = winner_take_all
        self.compute_oob_performances = compute_oob_performances
        self.max_frontier = max_frontier
        self.uplift_treatment = uplift_treatment
        self.honest = honest
        self.honest_ratio_leaf_examples = honest_ratio_leaf_examples
        self.maximum_training_duration = maximum_training_duration
        self.mesh = mesh

    def _candidate_features(self, F: int) -> int:
        """Per-node attribute sample size; 0 selects the reference
        defaults, sqrt(F) for classification and F/3 for regression;
        -1 lets every feature compete."""
        if self.num_candidate_attributes_ratio > 0:
            return max(int(np.ceil(self.num_candidate_attributes_ratio * F)),
                       1)
        if self.num_candidate_attributes > 0:
            return min(self.num_candidate_attributes, F)
        if self.num_candidate_attributes == 0:
            if self.task == Task.CLASSIFICATION:
                return max(int(np.ceil(np.sqrt(F))), 1)
            return max(int(np.ceil(F / 3)), 1)
        return -1

    def train(self, data: InputData, valid: Optional[InputData] = None
              ) -> RandomForestModel:
        """Trains on `data`; `valid` is ignored, as in the JAX package
        (the forest evaluates itself out of bag)."""
        t0 = time.perf_counter()
        # The deadline's clock starts at train() entry.
        deadline = (time.monotonic() + self.maximum_training_duration
                    if self.maximum_training_duration
                    and self.maximum_training_duration > 0 else None)
        prep = self._prepare(data)
        binner = prep["binner"]
        dev = self.device
        bins_t = prep["bins_t"]
        n = bins_t.shape[1]
        w_base = torch.from_numpy(prep["sample_weights"]).to(dev)
        labels = prep["labels"]
        classes = None
        if self.task in UPLIFT_TASKS:
            rule = UpliftEuclideanRule()
            basis, classes = self._uplift_basis(prep)
        elif self.task == Task.CLASSIFICATION:
            classes = prep["classes"]
            C = len(classes)
            rule = ClassificationRule(num_classes=C)
            y = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
            basis = torch.cat([
                torch.nn.functional.one_hot(y, C).to(torch.float32),
                torch.ones((n, 1), dtype=torch.float32, device=dev)], 1)
        else:
            rule = RegressionRule()
            y = torch.from_numpy(labels.astype(np.float32)).to(dev)
            basis = torch.stack([y, torch.square(y), torch.ones_like(y)], 1)
        tree_cfg = TreeConfig(
            max_depth=self.max_depth,
            max_frontier=resolve_max_frontier(self.max_frontier, n,
                                              self.min_examples),
            num_bins=binner.num_bins,
            min_examples=self.min_examples,
        )
        oob_enabled = (self.compute_oob_performances
                       and self.bootstrap_training_dataset
                       and self.task not in UPLIFT_TASKS)
        obl = oblique_inputs(self, prep)
        num_valid = None
        if self.mesh is not None:
            fp = self.mesh.shape[FEATURE_AXIS]
            fpad = -bins_t.shape[0] % fp
            if fpad:
                # The JAX package's constant-zero pad columns (module
                # docstring).
                num_valid = bins_t.shape[0]
                bins_t = torch.cat([bins_t, bins_t.new_zeros(
                    (fpad, n))])
        t1 = time.perf_counter()
        out = train_rf(
            bins_t, w_base, basis, rule=rule, tree_cfg=tree_cfg,
            # Every leaf holds a row: at most 2n - 1 nodes.
            max_nodes=min(tree_cfg.max_nodes, 2 * n + 3),
            num_trees=self.num_trees,
            bootstrap=self.bootstrap_training_dataset,
            candidate_features=self._candidate_features(binner.num_features),
            num_numerical=binner.num_numerical, seed=self.random_seed,
            winner_take_all=(self.winner_take_all
                             and self.task == Task.CLASSIFICATION),
            compute_oob=oob_enabled, obl=obl, set_bits=prep["set_bits"],
            honest_ratio=(self.honest_ratio_leaf_examples if self.honest
                          else 0.0),
            deadline=deadline, mesh=self.mesh, num_valid_features=num_valid,
        )
        t2 = time.perf_counter()
        forest = oblique_forest(out, binner)
        model = RandomForestModel(
            task=self.task, label=self.label, classes=classes,
            dataspec=prep["dataset"].dataspec, binner=binner, forest=forest,
            max_depth=self.max_depth, winner_take_all=self.winner_take_all,
            extra_metadata=({"uplift_treatment": self.uplift_treatment}
                            if self.uplift_treatment else None),
        )
        if oob_enabled:
            model.oob_evaluation = oob_evaluation(
                self.task, labels, prep["sample_weights"],
                out.oob_sum.cpu().numpy(), out.oob_count.cpu().numpy(),
                classes, int(out.trees.feature.shape[0]))
        t3 = time.perf_counter()
        self.last_timings.update(out.timings)
        self.last_timings.update({"train_rf_s": t2 - t1,
                                  "finalize_s": t3 - t2,
                                  "train_s": t3 - t0})
        return model

    def _uplift_basis(self, prep):
        """The uplift stat basis f32 [n, 5] on the learner's device,
        [control, control * y, treated, treated * y, known] with control
        = known * (1 - t), treated = known * t (t: the treatment column's
        code is 2, known: it is 1 or 2, so rows with a missing or unseen
        treatment weigh nothing), y the outcome (1 for the second class
        of a CATEGORICAL_UPLIFT label); and the classes (None for
        NUMERICAL_UPLIFT)."""
        col = self.uplift_treatment
        if not col:
            raise ValueError("Uplift tasks require uplift_treatment=")
        ds = prep["dataset"]
        self._need("uplift_treatment", ds)
        if ds.dataspec.column_by_name(col).vocab_size > 3:
            raise NotImplementedError("Only binary treatments are supported")
        codes = torch.from_numpy(ds.encoded_categorical(col)).to(self.device)
        t01 = (codes == 2).to(torch.float32)
        known = (codes >= 1).to(torch.float32)
        labels = prep["labels"]
        classes = None
        if self.task == Task.CATEGORICAL_UPLIFT:
            classes = prep["classes"]
            if len(classes) != 2:
                raise NotImplementedError("Only binary outcomes are supported")
            y = (labels == 1).astype(np.float32)
        else:
            y = labels.astype(np.float32)
        y = torch.from_numpy(y).to(self.device)
        control = known * (1.0 - t01)
        treated = known * t01
        return torch.stack([control, control * y, treated, treated * y,
                            known], 1), classes


def oblique_inputs(learner, prep) -> Optional[oblique.ObliqueInputs]:
    """The projections' inputs of a random or isolation forest learner on
    its device, None without sparse-oblique splits (or numerical
    features). These learners pass no weight range: the sampler's
    defaults apply."""
    binner = prep["binner"]
    Fn = binner.num_numerical
    if learner.split_axis != "SPARSE_OBLIQUE" or Fn == 0:
        return None
    x = learner.raw_numerical(prep)
    return oblique.ObliqueInputs(
        x_t=torch.from_numpy(np.ascontiguousarray(x.T)).to(learner.device),
        num_projections=oblique.num_projections(
            Fn, learner.sparse_oblique_num_projections_exponent,
            learner.sparse_oblique_max_num_projections),
        density=learner.sparse_oblique_projection_density_factor,
        weight_type=learner.sparse_oblique_weights)


def oblique_forest(out, binner):
    """The Forest of a tree loop's result (RFResult, IFResult): grown
    feature ids remapped and each tree's projections attached when the
    trees have them."""
    trees, kwargs = out.trees, {}
    if out.obl_out is not None:
        W, bounds = out.obl_out
        trees = trees._replace(feature=oblique.feature_ids(
            trees.feature, binner.num_numerical, binner.num_features,
            W.shape[1]))
        kwargs = dict(oblique_weights=W, oblique_boundaries=bounds)
    return forest_from_stacked_trees(trees, out.leaf_values,
                                     binner.boundaries, **kwargs)


def oob_evaluation(task: Task, labels: np.ndarray, weights: np.ndarray,
                   sums: np.ndarray, count: np.ndarray,
                   classes: Optional[List[str]], num_trees: int) -> dict:
    """The out-of-bag evaluation (the JAX package's _attach_oob, itself
    the reference's EvaluateOOBPredictions) of the rows that were out of
    bag at least once: the votes normalized to probabilities, or the
    mean of the votes."""
    idx = count > 0
    s = np.asarray(sums, np.float64)[idx]
    if task == Task.CLASSIFICATION:
        preds = s / np.maximum(s.sum(axis=1, keepdims=True), 1e-12)
    else:
        preds = s[:, 0] / count[idx]
    ev = evaluate_predictions(task, np.asarray(labels)[idx], preds,
                              classes=classes,
                              weights=np.asarray(weights)[idx])
    return {
        "source": "oob",
        "num_examples": int(idx.sum()),
        "num_trees": num_trees,
        "metrics": {k: float(v) for k, v in ev.metrics.items()},
    }


class RFResult(NamedTuple):
    """train_rf's outputs, on the training device but `timings`."""

    trees: grower.TreeArrays       # stacked [T, ...]
    leaf_values: torch.Tensor      # f32 [T, N, V]
    oob_sum: Optional[torch.Tensor]    # f32 [n, V]
    oob_count: Optional[torch.Tensor]  # f32 [n]
    timings: Dict[str, float]
    obl_out: Optional[tuple] = None  # (projections [T, P, Fn], boundaries
                                     # [T, P, B-1]) or None


def honest_leaf_stats(tree: grower.TreeArrays, leaf_id: torch.Tensor,
                      est_stats: torch.Tensor) -> torch.Tensor:
    """The leaf stats of an honest tree (_rf_run_chunk's re-estimation):
    each leaf's stats summed again over the estimation rows (est_stats
    f32 [n, S], zero on the rows that grew the tree) that reach it; a
    leaf with no estimation weight, and every split node, keep the grown
    stats. The JAX package sums with jax.ops.segment_sum, which XLA's CPU
    code runs as a scatter-add in row order; a stable sort of the rows by
    leaf and the in-order run sums (ops/segment_sum.py,
    csrc/segment_sum.cu on a card) add in that order."""
    N, S = tree.leaf_stats.shape
    key, perm = torch.sort(leaf_id.long(), stable=True)
    sums = segment_sum.segment_sums(key, est_stats[perm].contiguous())
    head = segment_sum.run_heads(key)
    seg = est_stats.new_zeros((N + 1, S))
    seg[torch.where(head, key, N)] = sums  # row N: the other entries
    seg = seg[:N]
    use = tree.is_leaf & (seg[:, -1] > 0)
    return torch.where(use[:, None], seg, tree.leaf_stats)


def tree_keys(seed: int, num_trees: int, device) -> torch.Tensor:
    """[T, 4, 2]: split(fold_in(PRNGKey(seed), t), 4) for every tree:
    k_boot, k_grow, k_honest, k_oblique."""
    base = prng.prng_key(seed, device)[None]
    return prng.split(prng.fold_in(base, torch.arange(num_trees,
                                                      device=device)), 4)


def bootstrap_counts(k_boot: torch.Tensor, n: int) -> torch.Tensor:
    """u8 [T, n]: every tree's Poisson(1) counts (prng.poisson1) in
    chunks of POISSON_CHUNK trees, then one host read of whether every
    row stopped (if not, every chunk is drawn again with twice the
    steps)."""
    global HOST_READS
    steps = POISSON_STEPS
    while True:
        parts, stopped = [], []
        for t0 in range(0, k_boot.shape[0], POISSON_CHUNK):
            c, ok = prng.poisson1(k_boot[t0:t0 + POISSON_CHUNK], n, steps)
            parts.append(c.to(torch.uint8))
            stopped.append(ok)
        HOST_READS += 1
        if bool(torch.stack(stopped).all()):
            return torch.cat(parts)
        steps *= 2


def train_rf(bins_t: torch.Tensor, w_base: torch.Tensor,
             basis: torch.Tensor, *, rule, tree_cfg: TreeConfig,
             max_nodes: int, num_trees: int, bootstrap: bool,
             candidate_features: int, num_numerical: int, seed: int,
             winner_take_all: bool, compute_oob: bool,
             obl=None, set_bits: Optional[torch.Tensor] = None,
             honest_ratio: float = 0.0,
             deadline: Optional[float] = None, mesh=None,
             num_valid_features: Optional[int] = None) -> RFResult:
    """Grows `num_trees` trees on the device of `bins_t` (u8 [F, n];
    rows [0, num_numerical) numerical, the rest categorical) from the
    row weights w_base f32 [n] and the stat basis f32 [n, S] (module
    docstring), with sparse-oblique splits when `obl`
    (ops/oblique.py:ObliqueInputs) is given and categorical-set
    candidates when `set_bits` (i32 [n, Fs, W]) is, and honest leaves
    when `honest_ratio` > 0 (honest_leaf_stats). On a card the tree loop
    runs under torch's sync debug mode "error". With a `deadline`
    (time.monotonic()) the loop runs in chunks of CHUNK_TREES trees and
    stops at the first chunk boundary past it (on a card after waiting
    for the chunk), keeping the trees grown. On a `mesh` the trees grow
    on the bins laid over its devices, `bins_t` on its first;
    `num_valid_features`: the scalar columns before a mesh's pad columns
    (module docstring)."""
    global HOST_READS
    if num_trees < 1:
        raise ValueError(f"num_trees must be >= 1, got {num_trees}")
    if compute_oob and not bootstrap:
        raise ValueError("out-of-bag evaluation needs the bootstrap")
    F, n = bins_t.shape
    dev = bins_t.device
    cfg = tree_cfg
    t0 = time.perf_counter()
    keys = tree_keys(seed, num_trees, dev)
    counts = bootstrap_counts(keys[:, 0], n) if bootstrap else None
    O = rule.num_cat_orderings if F > num_numerical else 1
    P = 0 if obl is None else obl.num_projections
    columns = obl_w = qs = None
    if P:
        obl_w = obl.weights(keys[:, 3])
        B = cfg.num_bins
        qs = prng.linspace_f32(1.0 / B, 1.0 - 1.0 / B, B - 1, device=dev)
    Fs = 0 if set_bits is None else set_bits.shape[1]
    members = None
    if Fs:
        members = grower.set_members(set_bits)
        HOST_READS += 1
    if 0 < candidate_features < F + P + Fs:
        columns = grower.layer_columns(
            keys[:, 1], max_depth=cfg.max_depth, frontier=cfg.frontier,
            num_features=F + P, num_numerical=num_numerical + P,
            orderings=O, k=candidate_features, num_set=Fs,
            num_valid=(None if num_valid_features is None
                       else num_valid_features + P))
        HOST_READS += 1
    mesh_rows = None
    if mesh is not None:
        if Fs:
            raise unported("categorical-set features on a mesh", 18)
        mesh_rows = MeshRows(mesh, bins_t, num_numerical, extra=P)
    V = rule.num_outputs
    oob_sum = oob_count = None
    if compute_oob:
        oob_sum = torch.zeros((n, V), dtype=torch.float32, device=dev)
        oob_count = torch.zeros(n, dtype=torch.float32, device=dev)
        in_base = w_base > 0
    t1 = time.perf_counter()

    on_card = dev.type == "cuda"
    chunk = CHUNK_TREES if deadline is not None else num_trees
    trees, leaf_values, obl_bounds = [], [], []
    for start in range(0, num_trees, chunk):
        if on_card:
            prev_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(start, min(start + chunk, num_trees)):
                if bootstrap:
                    draws = counts[t]
                    w = w_base * draws.to(torch.float32)
                else:
                    w = w_base
                if honest_ratio > 0.0:
                    # Rows drawn for estimation grow nothing.
                    est = prng.bernoulli(keys[t, 2], honest_ratio,
                                         (n,)).to(torch.float32)
                    w_grow = w * (1.0 - est)
                else:
                    w_grow = w
                grow_bins, cols, shards = bins_t, None, None
                if P:
                    # One tree: the JAX package's chunk is a loop of one
                    # step.
                    cols, bounds = oblique.projection_columns(
                        obl.x_t, obl_w[t], qs=qs, loop_of_one=num_trees == 1)
                    obl_bounds.append(bounds)
                if mesh_rows is not None:
                    # The same columns, cut over the mesh.
                    shards, grow_bins = mesh_rows.for_tree(cols), None
                elif P:
                    grow_bins = torch.cat([bins_t[:num_numerical], cols,
                                           bins_t[num_numerical:]])
                res = grower.grow_tree(
                    grow_bins, basis * w_grow[:, None], rule=rule,
                    max_depth=cfg.max_depth, frontier=cfg.frontier,
                    max_nodes=max_nodes, num_bins=cfg.num_bins,
                    num_numerical=num_numerical + P,
                    min_examples=cfg.min_examples,
                    columns=None if columns is None else [
                        (idx[t].long(), ok[t]) for idx, ok in columns],
                    set_members=members, shards=shards,
                )
                tree = res.tree
                if honest_ratio > 0.0:
                    tree = tree._replace(leaf_stats=honest_leaf_stats(
                        tree, res.leaf_id, basis * (w * est)[:, None]))
                lv = rule.leaf_value(tree.leaf_stats)  # [N, V]
                if compute_oob:
                    oob_f = ((draws == 0) & in_base).to(torch.float32)
                    vote = lv[res.leaf_id.long()]
                    if winner_take_all:
                        vote = bake_winner_take_all(vote)
                    oob_sum = oob_sum + vote * oob_f[:, None]
                    oob_count = oob_count + oob_f
                trees.append(tree)
                leaf_values.append(lv)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(prev_mode)
        if deadline is not None and start + chunk < num_trees:
            if on_card:
                # The deadline reads the host clock once the chunk ran.
                torch.cuda.synchronize(dev)
            if time.monotonic() >= deadline:
                break
    stacked = grower.TreeArrays(*(torch.stack(f) for f in zip(*trees)))
    if on_card:
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    return RFResult(
        trees=stacked, leaf_values=torch.stack(leaf_values), oob_sum=oob_sum,
        oob_count=oob_count,
        timings={"draws_s": t1 - t0, "loop_s": t2 - t1},
        obl_out=(obl_w[:len(trees)], torch.stack(obl_bounds)) if P else None,
    )
