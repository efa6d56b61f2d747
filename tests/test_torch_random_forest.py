"""The random forest on ydf_tpu_torch, held against the JAX package on
the CPU: RandomForestLearner with every default at depth 16 (Poisson
bootstrap, per-node candidate features, frontier "auto", out-of-bag
evaluation) on a binary label with categorical columns and NaNs;
predict, evaluate, self_evaluation, save and load in
either direction; the unported options; the loop's host reads.
tests/test_torch_rf_regression.py holds the regression forest,
tests/test_torch_rf_multiclass.py the 3-class forest and the split
rules, tests/test_torch_rf_draws.py the random draws.

The JAX side is the JAX package's CPU path as it trains by default (the
native histogram and fused routing, named by the train_rf fixture's
config). Tolerances, and why:
  * trees (every node array), leaf values, predictions: bitwise. The
    stats are class counts or exact sums of f32 labels in f64, the gains
    replay XLA's arithmetic (ops/split_rules.py), and the draws are
    bitwise (tests/test_torch_rf_draws.py);
  * out-of-bag and evaluate metrics: 1e-12 (host float64 on the same
    predictions).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import os

import re

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax  # noqa: F401

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.learners import random_forest
from ydf_tpu_torch.ops import grower, histogram_kernels

torch.set_num_threads(1)
FOREST_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
                 "right", "is_leaf", "leaf_value", "cover", "num_nodes",
                 "threshold")
METRIC_ATOL = 1e-12
ROWS = 3000
TREES = 10


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def make_frame(n, seed, task="binary"):
    """Six numerical columns (NaNs in x1), two categorical ones, and a
    label that depends on both: "binary" (two strings), "multiclass"
    (three) or "regression" (f32)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    d = {f"x{i}": rng.normal(size=n).astype(np.float32) for i in range(6)}
    d["x1"][rng.random(n) < 0.1] = np.nan
    d["c0"] = rng.choice(["a", "b", "c", "d", "e"], n)
    d["c1"] = rng.choice([f"v{i}" for i in range(12)], n)
    z = (d["x0"] + 0.5 * np.nan_to_num(d["x1"]) + (d["c0"] == "a")
         - 0.7 * (d["c1"] == "v3") + rng.normal(size=n) * 0.5)
    if task == "binary":
        d["label"] = np.where(z > 0.2, "yes", "no")
    elif task == "multiclass":
        d["label"] = np.array(["p", "q", "r"])[np.digitize(z, [-0.5, 0.6])]
    else:
        d["label"] = z.astype(np.float32)
    return pd.DataFrame(d)


def assert_same_forest(jax_model, port_model):
    jf = {f: np.asarray(getattr(jax_model.forest, f))
          for f in jax_model.forest._fields}
    pf = port_model.forest.to_numpy()
    for f in FOREST_FIELDS:
        a, b = np.ascontiguousarray(jf[f]), np.ascontiguousarray(pf[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


def assert_same_metrics(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) <= METRIC_ATOL, (k, a[k], b[k])


def train_pair(task):
    require_jax()
    df = make_frame(ROWS, 1, task)
    kw = dict(label="label", num_trees=TREES)
    if task == "regression":
        jm = ydf.RandomForestLearner(task=JaxTask.REGRESSION, **kw).train(df)
        learner = ydf_tpu_torch.RandomForestLearner(
            task=Task.REGRESSION, device="cpu", **kw)
    else:
        jm = ydf.RandomForestLearner(**kw).train(df)
        learner = ydf_tpu_torch.RandomForestLearner(device="cpu", **kw)
    return df, jm, learner.train(df), learner


@pytest.fixture(scope="module")
def binary():
    return train_pair("binary")


def test_default_forest_grows_the_jax_trees(binary):
    """Depth 16, 10 trees on 3,000 rows (frontier "auto" = 512): every
    node array and leaf value bitwise, the out-of-bag evaluation within
    1e-12."""
    check_forest(*binary)


def check_forest(df, jm, pm, learner):
    assert pm.forest.leaf_value.shape[0] == TREES
    assert_same_forest(jm, pm)
    assert int(pm.forest.num_nodes.max()) > 2 ** 8  # deep trees
    jo, po = jm.oob_evaluation, pm.self_evaluation()
    assert (po["source"], po["num_examples"], po["num_trees"]) == (
        jo["source"], jo["num_examples"], jo["num_trees"])
    assert_same_metrics(jo["metrics"], po["metrics"])


def test_predict_and_evaluate_match_jax(binary):
    check_predict(binary[1], binary[2], "binary")


def check_predict(jm, pm, task):
    test = make_frame(1500, 9, task)
    want = np.asarray(jm.predict(test))
    got = pm.predict(test)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert_same_metrics(jm.evaluate(test).metrics,
                        pm.evaluate(test).metrics)


def test_binary_forest_has_categorical_splits_and_votes(binary):
    _, _, pm, learner = binary
    f = pm.forest
    assert bool((f.is_cat & ~f.is_leaf).any())
    assert f.leaf_value.shape[-1] == 2
    # frontier "auto" at 3,000 rows, and the node cap 2n + 3 is not hit.
    assert pm.winner_take_all and learner.max_depth == 16
    assert pm.list_compatible_engines() == ["Routed"]


def test_save_load_both_ways(binary, tmp_path):
    """The port's save loads in the JAX package, and the JAX package's
    in the port, each predicting as the model it came from."""
    df, jm, pm, _ = binary
    pm.save(str(tmp_path / "port"))
    jm.save(str(tmp_path / "jax"))
    back_jax = ydf.load_model(str(tmp_path / "port"))
    back_port = ydf_tpu_torch.load_model(str(tmp_path / "jax"), device="cpu")
    assert isinstance(back_port, ydf_tpu_torch.RandomForestModel)
    assert back_port.self_evaluation() == jm.oob_evaluation
    assert back_jax.oob_evaluation == pm.oob_evaluation
    head = df.iloc[:700]
    want = np.asarray(jm.predict(head))
    assert np.asarray(back_jax.predict(head)).tobytes() == want.tobytes()
    assert back_port.predict(head).tobytes() == want.tobytes()
    again = ydf_tpu_torch.load_model(str(tmp_path / "port"), device="cpu")
    assert again.predict(head).tobytes() == want.tobytes()


@pytest.mark.parametrize("kwargs,item", [
    # Honest trees and the uplift tasks train since ROADMAP item 15
    # (tests/test_torch_honest.py, tests/test_torch_uplift.py): these
    # cases hold the port to what the JAX package does with them ("jax").
    (dict(honest=True), "jax"),
    # Sparse-oblique splits train (tests/test_torch_oblique.py); MHLD is
    # the GBT's alone, and the JAX package's random forest rejects it.
    (dict(split_axis="MHLD_OBLIQUE"), None),
    (dict(task=Task.CATEGORICAL_UPLIFT), "jax"),
    (dict(uplift_treatment="t"), "jax"),
    (dict(compute_oob_variable_importances=True), 20),
    (dict(mesh=object()), 18),
    # A deadline trains since ROADMAP item 17: a generous one keeps every
    # tree (tests/test_torch_checkpoint.py cuts the forest short).
    (dict(maximum_training_duration=10.0), "jax"),
])
def test_unported_options_raise(kwargs, item):
    """The options the port lacks raise naming their ROADMAP item; an
    option it has ("jax") trains a small frame as the JAX package does:
    the same error (an uplift task without uplift_treatment), or the
    same trees (honest trees; a treatment column on a classification
    task is kept out of the features)."""
    if item == "jax":
        require_jax()
        df = make_frame(400, 3)
        df["t"] = np.where(df["x2"] > 0, "b", "a")
        kw = dict(label="label", num_trees=2, max_depth=5)
        jkw = dict(kwargs)
        if "task" in jkw:
            jkw["task"] = JaxTask[jkw["task"].value]
        try:
            jm, jerr = ydf.RandomForestLearner(**kw, **jkw).train(df), None
        except Exception as e:  # the JAX package's behaviour
            jm, jerr = None, e
        learner = ydf_tpu_torch.RandomForestLearner(device="cpu", **kw,
                                                    **kwargs)
        if jerr is not None:
            with pytest.raises(type(jerr), match=re.escape(str(jerr))):
                learner.train(df)
        else:
            pm = learner.train(df)
            assert_same_forest(jm, pm)
            assert "t" not in pm.binner.feature_names or (
                "uplift_treatment" not in kwargs)
        return
    error, match = ((NotImplementedError, f"item {item}") if item
                    else (ValueError, "split_axis"))
    if "mesh" in kwargs:
        # Item 18's mesh trains (tests/test_torch_mesh_forest.py): an
        # object that is not a Mesh raises TypeError.
        error, match = TypeError, "Mesh"
    with pytest.raises(error, match=match):
        ydf_tpu_torch.RandomForestLearner(label="label", device="cpu",
                                          **kwargs)


def test_learner_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ydf_tpu_torch.RandomForestLearner(label="label")


def test_loop_reads_nothing_on_the_host(monkeypatch):
    """train_rf reads the device twice, both before its loop (the
    bootstrap's stop check, the candidate widths); inside the loop every
    host read raises (the CPU stand-in of the card's sync debug mode)."""
    df = make_frame(600, 3)
    grow = grower.grow_tree
    banned = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
              "__float__")

    def guarded(*args, **kwargs):
        saved = {name: getattr(torch.Tensor, name) for name in banned}

        def refuse(name):
            def f(*a, **k):
                raise AssertionError(f"host read in the loop: {name}")
            return f

        for name in banned:
            setattr(torch.Tensor, name, refuse(name))
        try:
            return grow(*args, **kwargs)
        finally:
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)

    monkeypatch.setattr(grower, "grow_tree", guarded)
    reads = random_forest.HOST_READS
    model = ydf_tpu_torch.RandomForestLearner(
        label="label", num_trees=3, max_depth=6, device="cpu").train(df)
    assert random_forest.HOST_READS - reads == 2
    assert model.self_evaluation()["num_trees"] == 3


def test_node_cap_follows_the_rows():
    """The node arrays hold min(TreeConfig.max_nodes, 2n + 3) nodes: at 40
    rows the cap."""
    df = make_frame(40, 5)
    pm = ydf_tpu_torch.RandomForestLearner(
        label="label", num_trees=2, min_examples=1, device="cpu").train(df)
    assert pm.forest.feature.shape[1] == 2 * 40 + 3


def test_gain_trace_records_each_layers_two_best_gains(monkeypatch):
    """grower.GAIN_TRACE (the diagnostic chip_smoke's phase 9 prints for
    a tree that differs from JAX's): one f32 [Ld, 2] a layer, the best
    gain first; None records nothing."""
    df = make_frame(600, 3)
    monkeypatch.setattr(grower, "GAIN_TRACE", [])
    ydf_tpu_torch.RandomForestLearner(
        label="label", num_trees=1, max_depth=5, device="cpu").train(df)
    trace = grower.GAIN_TRACE
    assert [t.shape for t in trace] == [(min(2 ** d, 64), 2)
                                        for d in range(5)]
    assert all(bool((t[:, 0] >= t[:, 1]).all()) for t in trace)
    assert bool(torch.isfinite(trace[0][0, 0]))


@pytest.mark.gpu
def test_forest_on_card_matches_cpu_port():
    """The default forest (depth 16) on the card and on the CPU: the same
    trees bitwise (integer class counts, exact in any order), the same
    out-of-bag evaluation and predictions; launches of the three
    training kernels and no serving kernel."""
    _need_card()
    df = make_frame(20_000, 13)
    kw = dict(label="label", num_trees=4)
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    cm = ydf_tpu_torch.RandomForestLearner(**kw).train(df)
    assert histogram_kernels.LAUNCHES == {"histogram": 4,
                                          "histogram_routed": 4 * 15}
    pm = ydf_tpu_torch.RandomForestLearner(device="cpu", **kw).train(df)
    cf, pf = cm.forest.to_numpy(), pm.forest.to_numpy()
    for f in FOREST_FIELDS:
        assert cf[f].tobytes() == pf[f].tobytes(), f
    assert cm.self_evaluation() == pm.self_evaluation()
    assert cm.predict(df).tobytes() == pm.predict(df).tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_routed_kernel_on_forest_layers(task):
    """csrc/histogram_routed.cu on every fused layer of a default
    forest's first tree (Lh = 1 .. 512 at 20,000 rows; Sq 3 for a binary
    label, 4 for three classes): new_slot, new_leaf and the histogram of
    class counts torch.equal to the plain version."""
    _need_card()
    df = make_frame(20_000, 17, task)
    captured = []
    original = histogram_kernels.histogram_routed

    def record(*args):
        captured.append(args)
        return original(*args)

    histogram_kernels.histogram_routed = record
    try:
        ydf_tpu_torch.RandomForestLearner(label="label", num_trees=1).train(
            df)
    finally:
        histogram_kernels.histogram_routed = original
    assert [a[5] for a in captured][-6:] == [512] * 6
    assert captured[0][4].shape[1] == (3 if task == "binary" else 4)
    for args in captured:
        got = original(*args)
        want = histogram_kernels.histogram_routed_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), args[5]
