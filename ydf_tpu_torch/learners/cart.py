"""CART learner (counterpart of ydf_tpu/learners/cart.py: CartLearner,
_route_validation, prune_single_tree and _compact_pruned_tree): one
decision tree with reduced-error pruning on a holdout.

    import ydf_tpu_torch as ydf
    model = ydf.CartLearner(label="label").train(data)   # on the card
    model.predict(rows)
    model.self_evaluation()        # the holdout's evaluation

The JAX package's defaults: the random forest learner with one tree, no
bootstrap, every feature a candidate at every node, the class
distribution (not a vote) in the leaves, depth 16, 5 examples a leaf;
10% of the rows held out (np.random.RandomState(seed).uniform(size=n) <
validation_ratio, on the host) unless `valid=` is given. The dataspec is
inferred on all the rows before the split, so a class or category seen
only in the holdout stays in the dictionaries.

Pruning runs on the host in numpy over the tree's node arrays, as the JAX
package's does: the holdout rows are routed to their leaves in one pass
on the model's device (ops/routing.py:route_tree_values, set nodes
through the rows' packed sets), their weighted
class counts (classification) or [w, w y, w y^2] sums (regression) are
added up from the leaves in one reverse sweep over the node ids
(children have larger ids than their parent), and a split becomes a leaf
wherever predicting its own value scores at least as well on the holdout
as its pruned subtree: the weighted count of correct argmax classes, or
-SSE around the node's training mean. The kept nodes are renumbered
breadth first into fresh tensors on the model's device. A
CATEGORICAL_UPLIFT tree prunes by the holdout's area under the uplift
curve instead (prune_single_tree_uplift); a NUMERICAL_UPLIFT tree is not
pruned and trains on all the rows, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset.dataset import Dataset, InputData
from ydf_tpu_torch.learners.random_forest import RandomForestLearner
from ydf_tpu_torch.metrics.metrics import qini_curve
from ydf_tpu_torch.models.rf_model import RandomForestModel
from ydf_tpu_torch.ops.routing import route_tree_values


class CartLearner(RandomForestLearner):
    """The JAX package's CartLearner for classification, regression and
    the uplift tasks."""

    def __init__(
        self,
        label: str,
        task: Task = Task.CLASSIFICATION,
        max_depth: int = 16,
        min_examples: int = 5,
        validation_ratio: float = 0.1,
        **kwargs,
    ):
        kwargs.setdefault("num_trees", 1)
        kwargs.setdefault("bootstrap_training_dataset", False)
        kwargs.setdefault("num_candidate_attributes", -1)  # all features
        kwargs.setdefault("winner_take_all", False)
        super().__init__(label=label, task=task, max_depth=max_depth,
                         min_examples=min_examples, **kwargs)
        self.validation_ratio = validation_ratio

    def train(self, data: InputData, valid: Optional[InputData] = None
              ) -> RandomForestModel:
        """Grows the tree on the rows outside the holdout (or on `data`
        when `valid` is given), then prunes it on the holdout. Without a
        holdout (validation_ratio <= 0, or a draw that holds out no row
        or every row) it trains the unpruned tree on all of `data`."""
        prunable = self.task in (Task.CLASSIFICATION, Task.REGRESSION,
                                 Task.CATEGORICAL_UPLIFT)
        if not prunable or (valid is None and self.validation_ratio <= 0):
            return super().train(data)
        from ydf_tpu_torch.dataset.cache import DatasetCache

        if isinstance(data, DatasetCache):
            # The holdout is drawn from the full data's raw columns, which
            # a cache does not keep (the JAX package fails here too).
            raise TypeError(
                "CartLearner prunes on a holdout of in-memory rows; train "
                "from a DatasetCache with validation_ratio=0 (no pruning)")
        t0 = time.perf_counter()
        full = self._infer_dataset(data)
        if valid is None:
            n = full.num_rows
            rng = np.random.RandomState(self.random_seed)
            mask = rng.uniform(size=n) < self.validation_ratio
            if not mask.any() or mask.all():
                return super().train(data)
            train_part = {k: v[~mask] for k, v in full.data.items()}
            valid_part = {k: v[mask] for k, v in full.data.items()}
        else:
            train_part, valid_part = data, valid
        self._forced_dataspec = full.dataspec
        try:
            model = super().train(train_part)
        finally:
            del self._forced_dataspec
        timings = dict(self.last_timings)
        t1 = time.perf_counter()
        if self.task == Task.CATEGORICAL_UPLIFT:
            num_pruned = prune_single_tree_uplift(
                model, valid_part, weights_col=self.weights,
                treatment_col=self.uplift_treatment)
        else:
            num_pruned = prune_single_tree(model, valid_part,
                                           weights_col=self.weights,
                                           task=self.task)
        model.extra_metadata["num_pruned_nodes"] = num_pruned
        t2 = time.perf_counter()
        ev = model.evaluate(valid_part, weights=self.weights)
        model.oob_evaluation = {
            "source": "cart_validation",
            "num_examples": ev.num_examples,
            "metrics": {k: float(v) for k, v in ev.metrics.items()},
        }
        t3 = time.perf_counter()
        timings.update({"prune_s": t2 - t1, "valid_evaluate_s": t3 - t2,
                        "train_s": t3 - t0})
        self.last_timings = timings
        return model


def _route_validation(model, valid_data, weights_col):
    """The holdout encoded under the model's dataspec, routed through
    tree 0 in one pass on the model's device: (dataset, leaf ids i64
    [nv] numpy, weights f64 [nv])."""
    ds = Dataset.from_data(valid_data, dataspec=model.dataspec)
    x_num, x_cat = model._encode_inputs(ds)
    x_set = model._encode_sets(ds)
    dev = model.device
    leaves = route_tree_values(
        model.forest, 0, torch.from_numpy(x_num).to(dev),
        torch.from_numpy(x_cat).to(dev), model.binner.num_numerical,
        model.max_depth,
        x_set=None if x_set is None else torch.from_numpy(
            x_set.view(np.int32)).to(dev),
    ).cpu().numpy()
    w = (np.asarray(ds.data[weights_col], np.float64) if weights_col
         else np.ones((leaves.shape[0],), np.float64))
    return ds, leaves, w


def _tree0(forest) -> dict:
    """Tree 0's node arrays, numpy."""
    return {k: v[0] for k, v in forest.to_numpy().items()}


def prune_single_tree(model, valid_data, *, weights_col, task) -> int:
    """Reduced-error pruning of tree 0 of `model.forest`, in place on the
    model (module docstring). Returns the number of pruned nodes."""
    ds, leaves, w = _route_validation(model, valid_data, weights_col)
    tree = _tree0(model.forest)
    left, right = tree["left"], tree["right"]
    is_leaf = tree["is_leaf"]
    lv = tree["leaf_value"]  # [N, V]
    N = left.shape[0]

    if task == Task.CLASSIFICATION:
        y = ds.encoded_label(model.label, Task.CLASSIFICATION)
        agg = np.zeros((N, lv.shape[1]), np.float64)
        np.add.at(agg, (leaves, y), w)
        pred = lv.argmax(axis=1)
        # The weighted count of correct predictions: as a leaf and as a
        # subtree share the denominator, so counts compare accuracies.
        score_of = lambda a: a[np.arange(N), pred]  # noqa: E731
    else:
        y = np.asarray(ds.encoded_label(model.label, Task.REGRESSION),
                       np.float64)
        agg = np.zeros((N, 3), np.float64)
        np.add.at(agg, leaves, np.stack([w, w * y, w * y * y], axis=1))
        mean = lv[:, 0].astype(np.float64)
        # -SSE around the node's training mean.
        score_of = lambda a: -(  # noqa: E731
            a[:, 2] - 2.0 * mean * a[:, 1] + np.square(mean) * a[:, 0])

    # Rows land on leaves; children have larger ids than their parent, so
    # one reverse pass fills the split nodes.
    for v in range(N - 1, -1, -1):
        if not is_leaf[v]:
            agg[v] += agg[left[v]] + agg[right[v]]
    score_leaf = score_of(agg)

    # A node no holdout row reaches scores 0 both ways and is pruned.
    new_is_leaf = is_leaf.copy()
    subtree = score_leaf.copy()
    for v in range(N - 1, -1, -1):
        if is_leaf[v]:
            continue
        as_subtree = subtree[left[v]] + subtree[right[v]]
        if score_leaf[v] >= as_subtree:
            new_is_leaf[v] = True
        else:
            subtree[v] = as_subtree
    return _compact_pruned_tree(model, new_is_leaf)


def _compact_pruned_tree(model, new_is_leaf: np.ndarray) -> int:
    """Renumbers the nodes still reachable with `new_is_leaf` breadth
    first and writes the compacted tree onto the model, in fresh tensors
    on its device. Returns the number of removed nodes."""
    forest = model.forest
    tree = _tree0(forest)
    left, right, is_leaf = tree["left"], tree["right"], tree["is_leaf"]
    N = left.shape[0]
    old_count = int(tree["num_nodes"])
    if np.array_equal(new_is_leaf, is_leaf):
        return 0

    order = []
    mapping = np.zeros((N,), np.int64)
    queue = [0]
    while queue:
        v = queue.pop(0)
        mapping[v] = len(order)
        order.append(v)
        if not new_is_leaf[v]:
            queue.append(int(left[v]))
            queue.append(int(right[v]))
    order = np.asarray(order)
    M = order.shape[0]
    kept_leaf = new_is_leaf[order]

    def remap(old, fill, transform=None):
        vals = old[order]
        if transform is not None:
            vals = transform(vals)
        new = np.full_like(old, fill)
        new[:M] = vals
        return new

    dev = model.device
    arrays = {
        "feature": remap(tree["feature"], -1,
                         lambda v: np.where(kept_leaf, -1, v)),
        "threshold": remap(tree["threshold"], 0.0),
        "threshold_bin": remap(tree["threshold_bin"], 0),
        "is_cat": remap(tree["is_cat"], False, lambda v: v & ~kept_leaf),
        "is_set": remap(tree["is_set"], False, lambda v: v & ~kept_leaf),
        "cat_mask": remap(tree["cat_mask"].view(np.int32), 0),
        "left": remap(left, 0, lambda v: np.where(kept_leaf, 0, mapping[v])),
        "right": remap(right, 0,
                       lambda v: np.where(kept_leaf, 0, mapping[v])),
        "is_leaf": remap(new_is_leaf, True),
        "na_left": remap(tree["na_left"], False),
        "leaf_value": remap(tree["leaf_value"], 0.0),
        "cover": remap(tree["cover"], 0.0),
    }
    fields = {k: torch.from_numpy(np.ascontiguousarray(v[None])).to(dev)
              for k, v in arrays.items()}
    fields["num_nodes"] = torch.tensor([M], dtype=torch.int32, device=dev)
    model.forest = forest._replace(**fields)
    model._engine_cache = {}
    return old_count - M


def prune_single_tree_uplift(model, valid_data, *, weights_col,
                             treatment_col) -> int:
    """Reduced-error pruning of a CATEGORICAL_UPLIFT tree 0 (the JAX
    package's prune_single_tree_uplift, the reference's
    PruneTreeUpliftCategorical): per split node, from the deepest id up,
    the holdout AUUC of the node's own uplift given to all its rows
    against the AUUC of its pruned subtree's per-row uplifts; the node
    becomes a leaf when its own scores at least as well. A node's rows
    are its holdout rows with a known treatment in ascending order (so
    both scores break ties alike), gathered from the leaves up; a node
    whose rows lack a treatment arm scores 0 both ways and is pruned.
    Returns the number of pruned nodes."""
    ds, leaves, w = _route_validation(model, valid_data, weights_col)
    y = np.asarray(ds.encoded_label(model.label, Task.CLASSIFICATION))
    outcome = (y == 1).astype(np.int64)  # positive: the second class
    tcodes = np.asarray(ds.encoded_categorical(treatment_col))
    t01 = (tcodes == 2).astype(np.int64)
    tree = _tree0(model.forest)
    left, right, is_leaf = tree["left"], tree["right"], tree["is_leaf"]
    lv = tree["leaf_value"]  # [N, 1] uplift
    N = left.shape[0]

    members = [[] for _ in range(N)]
    for i in np.flatnonzero(tcodes >= 1):
        members[leaves[i]].append(i)
    members = [np.asarray(m, np.int64) for m in members]
    for v in range(N - 1, -1, -1):
        if not is_leaf[v]:
            members[v] = np.sort(np.concatenate([members[left[v]],
                                                 members[right[v]]]))

    def auuc(pred, idx):
        if idx.size == 0 or len(np.unique(t01[idx])) < 2:
            return 0.0
        return qini_curve(pred, outcome[idx], t01[idx],
                          weights=w[idx])["auuc"]

    preds = lv[leaves, 0].astype(np.float64)
    new_is_leaf = is_leaf.copy()
    for v in range(N - 1, -1, -1):
        if is_leaf[v]:
            continue
        E = members[v]
        as_subtree = auuc(preds[E], E)
        as_leaf = auuc(np.full(E.shape, lv[v, 0], np.float64), E)
        if as_leaf >= as_subtree:
            new_is_leaf[v] = True
            preds[E] = lv[v, 0]
    return _compact_pruned_tree(model, new_is_leaf)
