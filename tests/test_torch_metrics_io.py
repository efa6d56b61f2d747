"""ydf_tpu_torch's metrics, model.evaluate and model.save held against the
JAX package: evaluate_predictions on the same predictions (to 1e-12,
intervals included), evaluate() of one model in both packages, and
saves that each package loads from the other with raw scores bitwise
equal. Everything runs on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX.
    import jax  # noqa: F401

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.metrics import metrics as jax_metrics
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.metrics import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_DEFAULT = os.path.join(REPO, "ydf_tpu_torch", "testdata",
                             "train_default")
torch.set_num_threads(1)
ATOL = 1e-12


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def predictions(kind, n=1500, seed=0):
    """(labels, predictions, weights) of one kind, seeded numpy."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, n)
    if kind == "binary":
        y = rng.integers(0, 2, n)
        p = np.clip(0.3 * y + 0.7 * rng.uniform(size=n), 0, 1)
        p[:40] = 0.5  # ties
        return y, p.astype(np.float32), w
    if kind == "multiclass":
        y = rng.integers(0, 3, n)
        logits = rng.normal(size=(n, 3)) + np.eye(3)[y]
        e = np.exp(logits)
        return y, (e / e.sum(1, keepdims=True)).astype(np.float32), w
    y = rng.exponential(size=n).astype(np.float32)
    return y, (y + rng.normal(0, 0.3, n)).astype(np.float32), w


def assert_same(got, want):
    assert got.task == want.task and got.num_examples == want.num_examples
    assert list(got.metrics) == list(want.metrics)
    for k, v in want.metrics.items():
        assert abs(got.metrics[k] - v) <= ATOL, k
    if want.confusion is not None:
        assert np.array_equal(got.confusion, want.confusion)
    if want.roc_curve is not None:
        for a, b in zip(got.roc_curve, want.roc_curve):
            assert np.array_equal(a, b)
    assert (got.confidence_intervals is None) == (
        want.confidence_intervals is None)
    for k, (lo, hi) in (want.confidence_intervals or {}).items():
        glo, ghi = got.confidence_intervals[k]
        assert np.allclose([glo, ghi], [lo, hi], rtol=0, atol=ATOL,
                           equal_nan=True), k


@pytest.mark.parametrize("intervals", [False, True])
@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression"])
@pytest.mark.parametrize("weighted", [False, True])
def test_evaluate_predictions_matches_jax(kind, intervals, weighted):
    require_jax()
    y, p, w = predictions(kind)
    task = "REGRESSION" if kind == "regression" else "CLASSIFICATION"
    kw = dict(weights=w if weighted else None,
              confidence_intervals=intervals, num_bootstrap=60, seed=5)
    classes = None if kind == "regression" else [
        str(c) for c in range(p.shape[1] if p.ndim == 2 else 2)]
    want = jax_metrics.evaluate_predictions(JaxTask(task), y, p,
                                            classes=classes, **kw)
    got = metrics.evaluate_predictions(Task(task), y, p, classes=classes,
                                       **kw)
    assert_same(got, want)
    assert str(got) == str(want)


def test_unported_tasks_raise():
    # Ranking, survival (ROADMAP item 11) and the uplift tasks (item 15)
    # evaluate, their inputs required as in the JAX package; the HTML
    # report does not.
    with pytest.raises(AssertionError, match="needs treatments"):
        metrics.evaluate_predictions(Task.NUMERICAL_UPLIFT, np.zeros(3),
                                     np.zeros(3))
    with pytest.raises(AssertionError, match="group ids"):
        metrics.evaluate_predictions(Task.RANKING, np.zeros(3), np.zeros(3))
    with pytest.raises(ValueError, match="requires events"):
        metrics.evaluate_predictions(Task.SURVIVAL_ANALYSIS, np.zeros(3),
                                     np.zeros(3))
    ev = metrics.evaluate_predictions(Task.REGRESSION, np.ones(3),
                                      np.ones(3))
    with pytest.raises(NotImplementedError, match="item 20"):
        ev.to_html()


def frame(n, seed):
    """A few numerical columns (NaNs in one) and two string columns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    c = rng.integers(0, 9, n)
    y = ((x[:, 0] + (c % 3 == 0) + 0.3 * rng.normal(size=n)) > 0.5)
    d = {f"x{i}": x[:, i] for i in range(4)}
    d["x1"] = np.where(rng.uniform(size=n) < 0.05, np.nan, d["x1"]).astype(
        np.float32)
    d["c"] = np.array([f"k{v}" for v in c])
    d["d"] = np.array(["ab"[v % 2] + str(v % 5) for v in c])
    d["label"] = y.astype(np.int64)
    d["y"] = (x[:, 0] * 2 + c * 0.1).astype(np.float32)
    d["w"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def port_models():
    """Port models trained on the CPU with the defaults (validation split,
    early stopping, categorical splits): binary and regression."""
    data = frame(1500, 0)
    out = {}
    for kind, label, task in (("binary", "label", Task.CLASSIFICATION),
                              ("regression", "y", Task.REGRESSION)):
        drop = "y" if label == "label" else "label"
        d = {k: v for k, v in data.items() if k not in (drop, "w")}
        out[kind] = ydf_tpu_torch.GradientBoostedTreesLearner(
            label=label, task=task, num_trees=40, device="cpu").train(d)
    return out


@pytest.mark.parametrize("kind", ["binary", "regression"])
def test_port_save_loads_in_jax(tmp_path, port_models, kind):
    require_jax()
    pm = port_models[kind]
    assert (pm.forest.is_cat & ~pm.forest.is_leaf).any()
    pm.save(str(tmp_path / "m"))
    jm = ydf.load_model(str(tmp_path / "m"))
    fresh = frame(700, 1)
    fresh["c"][:30] = "unseen"
    got = pm._raw_scores(fresh, combine="sum")
    want = np.asarray(jm._raw_scores(fresh, combine="sum"))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert jm.training_logs == json.loads(json.dumps(pm.training_logs))
    assert_same(pm.evaluate(fresh, weights="w"),
                jm.evaluate(fresh, weights="w"))


@pytest.mark.parametrize("kind", ["binary", "regression"])
def test_port_save_round_trip(tmp_path, port_models, kind):
    pm = port_models[kind]
    pm.save(str(tmp_path / "m"))
    back = ydf_tpu_torch.load_model(str(tmp_path / "m"), device="cpu")
    fresh = frame(500, 2)
    assert np.array_equal(back.predict(fresh).view(np.int32),
                          pm.predict(fresh).view(np.int32))
    assert back.training_logs["num_trees"] == pm.training_logs["num_trees"]


def test_jax_save_loads_in_port(tmp_path):
    require_jax()
    data = frame(1500, 3)
    d = {k: v for k, v in data.items() if k not in ("y", "w")}
    jm = ydf.GradientBoostedTreesLearner(label="label",
                                         num_trees=40).train(d)
    jm.save(str(tmp_path / "j"))
    pm = ydf_tpu_torch.load_model(str(tmp_path / "j"), device="cpu")
    fresh = frame(600, 4)
    want = np.asarray(jm._raw_scores(fresh, combine="sum"))
    got = pm._raw_scores(fresh, combine="sum")
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert_same(pm.evaluate(fresh), jm.evaluate(fresh))
    assert_same(pm.evaluate(fresh, confidence_intervals=True,
                            num_bootstrap=40),
                jm.evaluate(fresh, confidence_intervals=True,
                            num_bootstrap=40))


def test_fixture_model_evaluates_like_jax():
    """The committed train_default JAX model, loaded by the port on the
    CPU, evaluates to the JAX package's metrics on rows of the fixture's
    recipe (the full comparison on 100,000 rows runs in chip_smoke.py)."""
    require_jax()
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, test = smoke.make_frame(0, 3000)
    jm = ydf.load_model(TRAIN_DEFAULT)
    pm = ydf_tpu_torch.load_model(TRAIN_DEFAULT, device="cpu")
    assert_same(pm.evaluate(test), jm.evaluate(test))
    exp = np.load(os.path.join(TRAIN_DEFAULT, "expected.npz"))
    with open(os.path.join(TRAIN_DEFAULT, "config.json")) as f:
        cfg = json.load(f)
    assert pm.forest.feature.shape[0] == cfg["num_trees"]
    np.testing.assert_array_equal(pm.initial_predictions,
                                  exp["initial_predictions"])
