"""CART on ydf_tpu_torch, held against the JAX package on the CPU:
CartLearner with every default (one tree of depth 16 on every feature,
no bootstrap, a 10% holdout for reduced-error pruning) for
classification and regression; the pruning alone on a JAX-grown tree and
holdout; the dataspec of the full data (a class seen only in the
holdout); `valid=`; predict, evaluate, the holdout evaluation, save and
load in either direction; the unported options.

Tolerances: the trees (every node array, grown and pruned), the pruned
node counts and predictions bitwise (the stats are class counts or exact
sums of f32 labels, the gains replay XLA's arithmetic, and the pruning
is the same host float64 arithmetic on the same routed leaves);
evaluation metrics within 1e-12 (host float64 on the same predictions).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import re

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax  # noqa: F401

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.learners import cart as jax_cart
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.learners import cart
from ydf_tpu_torch.ops import histogram_kernels
from test_torch_random_forest import (
    FOREST_FIELDS,
    assert_same_forest,
    assert_same_metrics,
    make_frame,
    require_jax,
)

torch.set_num_threads(1)
ROWS = 8000


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def tasks(task):
    """(JAX kwargs, port kwargs) of a make_frame task."""
    if task == "regression":
        return (dict(task=JaxTask.REGRESSION),
                dict(task=Task.REGRESSION))
    return {}, {}


def train_pair(task, rows=ROWS, seed=1, **kw):
    require_jax()
    df = make_frame(rows, seed, task)
    jkw, pkw = tasks(task)
    jm = ydf.CartLearner(label="label", **jkw, **kw).train(df)
    learner = ydf_tpu_torch.CartLearner(label="label", device="cpu",
                                        **pkw, **kw)
    return df, jm, learner.train(df), learner


@pytest.fixture(scope="module", params=["binary", "regression"])
def pair(request):
    return request.param, train_pair(request.param)


def test_cart_grows_and_prunes_the_jax_tree(pair):
    """Every default on 8,000 rows (7,200 after the holdout): the pruned
    tree node for node, the pruned node count, the holdout evaluation."""
    task, (df, jm, pm, learner) = pair
    assert_same_forest(jm, pm)
    assert pm.forest.num_trees == 1 and learner.max_depth == 16
    pruned = pm.extra_metadata["num_pruned_nodes"]
    assert pruned == jm.extra_metadata["num_pruned_nodes"] > 0
    jo, po = jm.oob_evaluation, pm.self_evaluation()
    assert (po["source"], po["num_examples"]) == ("cart_validation",
                                                  jo["num_examples"])
    assert_same_metrics(jo["metrics"], po["metrics"])
    assert set(learner.last_timings) >= {"prune_s", "valid_evaluate_s",
                                         "loop_s", "train_s"}


def test_predict_and_evaluate_match_jax(pair):
    task, (df, jm, pm, _) = pair
    test = make_frame(1500, 9, task)
    want = np.asarray(jm.predict(test))
    got = pm.predict(test)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert_same_metrics(jm.evaluate(test).metrics, pm.evaluate(test).metrics)


def capture_jax(task, rows, seed, **kw):
    """A JAX CART train with the grown tree saved before pruning:
    (frame, JAX pruned model, the grown model's directory, holdout)."""
    import tempfile

    df = make_frame(rows, seed, task)
    jkw, _ = tasks(task)
    seen = {}
    original = jax_cart.prune_single_tree
    tmp = tempfile.mkdtemp()

    def prune(model, valid_data, **kwargs):
        model.save(tmp)
        seen["valid"] = dict(valid_data)
        return original(model, valid_data, **kwargs)

    jax_cart.prune_single_tree = prune
    try:
        jm = ydf.CartLearner(label="label", **jkw, **kw).train(df)
    finally:
        jax_cart.prune_single_tree = original
    return df, jm, tmp, seen["valid"]


@pytest.mark.parametrize("task", ["binary", "multiclass", "regression"])
def test_pruning_of_a_jax_grown_tree(task):
    """prune_single_tree and _compact_pruned_tree of the port on the JAX
    package's grown tree (loaded from its save before pruning) and the
    JAX learner's own holdout: the node arrays and the count bitwise."""
    require_jax()
    df, jm, grown_dir, valid = capture_jax(task, 5000, 4)
    grown = ydf_tpu_torch.load_model(grown_dir, device="cpu")
    port_task = Task.REGRESSION if task == "regression" else \
        Task.CLASSIFICATION
    n = cart.prune_single_tree(grown, valid, weights_col=None,
                               task=port_task)
    assert n == jm.extra_metadata["num_pruned_nodes"] > 0
    assert_same_forest(jm, grown)


def test_compaction_renumbers_breadth_first():
    """A hand-pruned tree: the kept nodes renumbered in BFS order, the
    cut subtrees' slots reset, fresh tensors (the engine cache cannot
    serve the unpruned tree)."""
    require_jax()
    _, _, grown_dir, _ = capture_jax("binary", 3000, 5)
    model = ydf_tpu_torch.load_model(grown_dir, device="cpu")
    old = model.forest
    tree = {k: v[0] for k, v in old.to_numpy().items()}
    new_is_leaf = tree["is_leaf"].copy()
    new_is_leaf[tree["left"][0]] = True  # the root's left child
    before = int(tree["num_nodes"])
    removed = cart._compact_pruned_tree(model, new_is_leaf)
    f = {k: v[0] for k, v in model.forest.to_numpy().items()}
    M = int(f["num_nodes"])
    assert removed == before - M > 0
    assert f["left"][0] == 1 and f["is_leaf"][1] and f["feature"][1] == -1
    assert f["is_leaf"][M:].all() and (f["feature"][M:] == -1).all()
    assert model.forest.feature is not old.feature
    # Every kept split's children are kept nodes in BFS order.
    kids = np.concatenate([[f["left"][v], f["right"][v]] for v in range(M)
                           if not f["is_leaf"][v]])
    assert np.array_equal(kids, np.arange(1, M))


def test_rare_class_only_in_the_holdout():
    """The dataspec comes from all the rows (after the JAX package's
    tests/test_cart.py:84): a class whose single row lands in the holdout
    stays in the dictionary; the tree equals JAX's for each seed."""
    require_jax()
    rng = np.random.RandomState(0)
    n = 200
    x = rng.normal(size=n)
    y = (x > 0).astype(np.int64)
    y[rng.randint(0, n)] = 2
    data = {"x": x.astype(np.float32), "y": y}
    for seed in range(5):
        kw = dict(label="y", max_depth=4, validation_ratio=0.3,
                  random_seed=seed)
        jm = ydf.CartLearner(**kw).train(data)
        pm = ydf_tpu_torch.CartLearner(device="cpu", **kw).train(data)
        assert len(pm.classes) == 3 and pm.classes == jm.classes
        assert_same_forest(jm, pm)


def test_explicit_valid_and_no_holdout():
    """`valid=` prunes on the given rows; validation_ratio=0 grows the
    unpruned tree on every row; both as the JAX package."""
    require_jax()
    df = make_frame(3000, 6)
    valid = make_frame(800, 7)
    jm = ydf.CartLearner(label="label").train(df, valid=valid)
    pm = ydf_tpu_torch.CartLearner(label="label", device="cpu").train(
        df, valid=valid)
    assert_same_forest(jm, pm)
    assert pm.self_evaluation()["num_examples"] == 800
    kw = dict(label="label", validation_ratio=0.0)
    jm = ydf.CartLearner(**kw).train(df)
    pm = ydf_tpu_torch.CartLearner(device="cpu", **kw).train(df)
    assert_same_forest(jm, pm)
    assert "num_pruned_nodes" not in pm.extra_metadata
    assert pm.self_evaluation() is None


def test_save_load_both_ways(pair, tmp_path):
    task, (df, jm, pm, _) = pair
    pm.save(str(tmp_path / "port"))
    jm.save(str(tmp_path / "jax"))
    back_jax = ydf.load_model(str(tmp_path / "port"))
    back_port = ydf_tpu_torch.load_model(str(tmp_path / "jax"), device="cpu")
    assert isinstance(back_port, ydf_tpu_torch.RandomForestModel)
    assert back_port.self_evaluation() == jm.oob_evaluation
    assert back_port.extra_metadata == jm.extra_metadata
    assert back_jax.oob_evaluation == pm.oob_evaluation
    head = df.iloc[:700]
    want = np.asarray(jm.predict(head))
    assert np.asarray(back_jax.predict(head)).tobytes() == want.tobytes()
    assert back_port.predict(head).tobytes() == want.tobytes()


@pytest.mark.parametrize("kwargs,item", [
    # The uplift task and honest trees train since ROADMAP item 15
    # (tests/test_torch_uplift.py, tests/test_torch_honest.py): these
    # cases hold the port to what the JAX package does with them ("jax").
    (dict(task=Task.CATEGORICAL_UPLIFT), "jax"),
    # Sparse-oblique splits train (tests/test_torch_oblique.py); MHLD is
    # the GBT's alone, and the JAX package's CART rejects it.
    (dict(split_axis="MHLD_OBLIQUE"), None),
    (dict(honest=True), "jax"),
])
def test_unported_options_raise(kwargs, item):
    """MHLD splits raise; an option the port has ("jax") trains a small
    frame as the JAX package does: the same error (the uplift task
    without uplift_treatment) or the same pruned tree (honest=True)."""
    if item == "jax":
        require_jax()
        df = make_frame(1200, 3)
        jkw = dict(kwargs)
        if "task" in jkw:
            jkw["task"] = JaxTask[jkw["task"].value]
        try:
            jm, jerr = ydf.CartLearner(label="label", max_depth=6,
                                       **jkw).train(df), None
        except Exception as e:  # the JAX package's behaviour
            jm, jerr = None, e
        learner = ydf_tpu_torch.CartLearner(label="label", max_depth=6,
                                            device="cpu", **kwargs)
        if jerr is not None:
            with pytest.raises(type(jerr), match=re.escape(str(jerr))):
                learner.train(df)
        else:
            pm = learner.train(df)
            assert_same_forest(jm, pm)
            assert pm.extra_metadata == jm.extra_metadata
        return
    error, match = ((NotImplementedError, f"item {item}") if item
                    else (ValueError, "split_axis"))
    with pytest.raises(error, match=match):
        ydf_tpu_torch.CartLearner(label="label", device="cpu", **kwargs)


def test_learner_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ydf_tpu_torch.CartLearner(label="label")


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["binary", "regression"])
def test_cart_on_card_matches_cpu_port(task):
    """CART with every default on 30,000 rows on the card and on the CPU:
    the same grown and pruned tree, holdout evaluation and predictions;
    one root and 15 routed launches."""
    _need_card()
    df = make_frame(30_000, 13, task)
    _, pkw = tasks(task)
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    cm = ydf_tpu_torch.CartLearner(label="label", **pkw).train(df)
    assert histogram_kernels.LAUNCHES == {"histogram": 1,
                                          "histogram_routed": 15}
    pm = ydf_tpu_torch.CartLearner(label="label", device="cpu",
                                   **pkw).train(df)
    cf, pf = cm.forest.to_numpy(), pm.forest.to_numpy()
    for f in FOREST_FIELDS:
        assert cf[f].tobytes() == pf[f].tobytes(), f
    assert cm.extra_metadata == pm.extra_metadata
    assert cm.self_evaluation() == pm.self_evaluation()
    assert cm.predict(df).tobytes() == pm.predict(df).tobytes()


@pytest.mark.gpu
def test_routed_kernel_at_wide_layers_on_many_rows():
    """csrc/histogram_routed.cu on every fused layer of a CART tree grown
    on 450,000 rows (Lh up to 512, Sq 3, the widest routed launch of the
    paths): new_slot, new_leaf and the class-count histogram torch.equal
    to the plain version."""
    _need_card()
    df = make_frame(500_000, 19)
    captured = []
    original = histogram_kernels.histogram_routed

    def record(*args):
        captured.append(args)
        return original(*args)

    histogram_kernels.histogram_routed = record
    try:
        ydf_tpu_torch.CartLearner(label="label").train(df)
    finally:
        histogram_kernels.histogram_routed = original
    assert max(a[5] for a in captured) == 512
    assert captured[0][0].shape[1] > 440_000
    for args in captured:
        got = original(*args)
        want = histogram_kernels.histogram_routed_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), args[5]
