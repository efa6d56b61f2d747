"""Multiclass gradient boosted trees on ydf_tpu_torch (K trees an
iteration: learners/losses.py:MultinomialLogLikelihood, learners/gbt.py's
per-class loop) held against the JAX package on the CPU, and the
committed fixture train_multiclass.

Every comparison is bitwise:
  * the softmax gradients and hessians and the reported loss against
    jax.jit of the JAX loss, K = 3 and 5, rows with large margins;
  * the trees (node arrays and leaf values), initial predictions, losses
    and kept counts against the JAX learner at 3,000 rows (K = 3, the
    validation split and early stopping) and 2,000 rows (K = 5, no
    validation): the JAX package adds the stored round(raw * shrinkage)
    to every class column (the fixture's update_form, read from XLA's
    machine code), and the port replays it;
  * the trees' iteration-major order (tree it * K + k is class k's);
  * predictions, evaluate() and saves in both directions;
  * one encode per predict, bitwise equal to scoring each class apart.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX.
    import jax

    import ydf_tpu as ydf
    from ydf_tpu.learners import losses as jax_losses
except ImportError:
    jax = None

import ydf_tpu_torch
from ydf_tpu_torch.config import TreeConfig
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.learners import losses
from ydf_tpu_torch.models import generic_model
from ydf_tpu_torch.ops import grower
from ydf_tpu_torch.ops.split_rules import HessianGainRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_MULTICLASS = os.path.join(REPO, "ydf_tpu_torch", "testdata",
                                "train_multiclass")
torch.set_num_threads(1)
FOREST_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
                 "right", "is_leaf", "leaf_value", "cover", "num_nodes",
                 "threshold")


def require_jax():
    if jax is None:
        pytest.skip("needs the JAX package, the reference")


def bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def load_chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def make_frame(n, seed, K):
    """K classes cut from a non-linear logit plus logistic noise (each
    about 1/K of the rows), 6 normal features (NaNs in f5) and a
    categorical column that carries some signal."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    z = (x[:, 0] - 0.5 * x[:, 1] + np.sin(2 * x[:, 2])
         + rng.logistic(size=n))
    y = np.searchsorted(np.quantile(z, np.linspace(0, 1, K + 1)[1:-1]), z)
    x[rng.uniform(size=n) < 0.03, 5] = np.nan
    data = {f"f{i}": x[:, i] for i in range(6)}
    code = np.where(rng.uniform(size=n) < 0.5, y, rng.integers(0, 9, n))
    data["c0"] = np.array([f"v{c}" for c in code])
    data["label"] = y
    return data


@pytest.mark.parametrize("K", [3, 5])
def test_softmax_grad_hess_and_loss_match_jax(K):
    require_jax()
    rng = np.random.default_rng(K)
    n = 20_000
    preds = rng.normal(0, 3, (n, K)).astype(np.float32)
    preds[:300] *= 40  # large margins: exp underflows, p rounds to 1
    labels = rng.integers(0, K, n).astype(np.int32)
    w = rng.uniform(0.5, 2, n).astype(np.float32)
    jl = jax_losses.MultinomialLogLikelihood(K)
    pl = losses.MultinomialLogLikelihood(K)
    jg, jh = jax.jit(jl.grad_hess)(labels, preds)
    g, h = pl.grad_hess(torch.from_numpy(labels), torch.from_numpy(preds))
    assert np.array_equal(bits(g), bits(jg))
    assert np.array_equal(bits(h), bits(jh))
    want = jax.jit(jl.loss)(labels, preds, w)
    got = pl.loss(torch.from_numpy(labels), torch.from_numpy(preds),
                  torch.from_numpy(w))
    assert bits(got).tolist() == bits(want).tolist()
    assert pl.initial_predictions(torch.from_numpy(labels),
                                  torch.from_numpy(w)).tolist() == [0.0] * K


def assert_same_forest(jm, pm):
    jf = {f: np.asarray(getattr(jm.forest, f)) for f in jm.forest._fields}
    pf = pm.forest.to_numpy()
    assert jf["feature"].shape[0] == pf["feature"].shape[0]
    for t in range(jf["feature"].shape[0]):
        for f in FOREST_FIELDS:
            assert np.asarray(jf[f][t]).tobytes() == pf[f][t].tobytes(), (
                f"tree {t} (iteration {t // pm.num_trees_per_iter}, class "
                f"{t % pm.num_trees_per_iter}): {f}")


@pytest.mark.parametrize("K,n,hp", [
    (3, 3000, dict(num_trees=10)),
    (5, 2000, dict(num_trees=6, validation_ratio=0.0)),
    # GOSS ranks rows by |g| summed over the K class columns.
    (3, 3000, dict(num_trees=6, sampling_method="GOSS")),
])
def test_multiclass_trees_match_jax(K, n, hp):
    require_jax()
    data = make_frame(n, K, K)
    jm = ydf.GradientBoostedTreesLearner(label="label", **hp).train(data)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", device="cpu", **hp).train(data)
    assert pm.num_trees_per_iter == jm.num_trees_per_iter == K
    assert_same_forest(jm, pm)
    assert bits(pm.initial_predictions).tolist() == bits(
        jm.initial_predictions).tolist()
    for key in ("train_loss", "valid_loss"):
        want, got = jm.training_logs[key], pm.training_logs[key]
        assert (want is None) == (got is None), key
        if want is not None:
            assert np.array_equal(bits(got), bits(want)), key
    assert pm.training_logs["num_trees"] == jm.training_logs["num_trees"]
    test = make_frame(800, K + 10, K)
    jp, pp = jm.predict(test), pm.predict(test)
    assert pp.shape == (800, K) and pp.tobytes() == np.asarray(
        jp).tobytes()
    je, pe = jm.evaluate(test), pm.evaluate(test)
    for k in je.metrics:
        assert pe.metrics[k] == pytest.approx(je.metrics[k], abs=1e-12)
    assert np.array_equal(pe.confusion, je.confusion)
    with tempfile.TemporaryDirectory() as d:
        jm.save(os.path.join(d, "jax"))
        pm.save(os.path.join(d, "port"))
        from_jax = ydf_tpu_torch.load_model(os.path.join(d, "jax"),
                                            device="cpu")
        from_port = ydf.load_model(os.path.join(d, "port"))
        assert from_jax.predict(test).tobytes() == pp.tobytes()
        assert np.asarray(from_port.predict(test)).tobytes() == pp.tobytes()
        assert from_jax.num_trees_per_iter == K


def test_trees_are_iteration_major():
    """Tree it * K + k is class k's tree of iteration it: iteration 0's
    trees equal the grower's on each class column's stats at the zero
    initial predictions."""
    K, n = 3, 1500
    data = make_frame(n, 1, K)
    rng = np.random.default_rng(0)
    bins_t = torch.from_numpy(rng.integers(0, 32, (4, n)).astype(np.uint8))
    labels = torch.from_numpy(data["label"].astype(np.float32))
    w = torch.ones(n)
    cfg = TreeConfig(max_depth=4, max_frontier=16, num_bins=32)
    loss = losses.MultinomialLogLikelihood(K)
    out = port_gbt.boost(bins_t, labels, w, loss_obj=loss,
                         rule=HessianGainRule(), tree_cfg=cfg, num_trees=2,
                         shrinkage=0.1)
    assert out.trees.feature.shape[0] == 2 * K
    assert out.train_loss.shape == (2,) and out.init_pred.shape == (K,)
    g, h = loss.grad_hess(labels, torch.zeros(n, K))
    for k in range(K):
        stats = torch.stack([g[:, k] * w, h[:, k] * w, w], dim=1)
        tree = grower.grow_tree(bins_t, stats, rule=HessianGainRule(),
                                max_depth=4, frontier=cfg.frontier,
                                max_nodes=cfg.max_nodes, num_bins=32).tree
        for f, a in zip(grower.TreeArrays._fields, tree):
            assert torch.equal(getattr(out.trees, f)[k], a), (k, f)


def test_predict_encodes_once():
    """A K-class predict encodes and copies the rows once and scores each
    class's trees on them: bitwise equal to scoring each class apart."""
    K = 3
    data = make_frame(1200, 2, K)
    m = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", num_trees=4, validation_ratio=0.0,
        device="cpu").train(data)
    calls = []
    original = generic_model.Dataset.from_data

    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    generic_model.Dataset.from_data = counted
    try:
        got = m.predict(data)
    finally:
        generic_model.Dataset.from_data = original
    assert len(calls) == 1
    full = m.forest
    per_class = []
    try:
        for k in range(K):
            m.forest = m._dim_forests[k]
            per_class.append(m._raw_scores(data, combine="sum")[:, 0]
                             + m.initial_predictions[k])
    finally:
        m.forest = full
    s = np.stack(per_class, axis=1)
    e = np.exp(s - s.max(axis=1, keepdims=True))
    assert got.tobytes() == (e / e.sum(axis=1, keepdims=True)).tobytes()


def test_three_class_frame_matches_the_fixture_generator():
    """chip_smoke.py's copy of the three-class frame gives the fixture
    script's rows (the binary frame's bytes are held by
    test_torch_default_train.py), each class 20-45% of the rows."""
    require_jax()
    import sys

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_torch_port_fixtures as fixtures
    finally:
        sys.path.pop(0)
    smoke = load_chip_smoke()
    assert tuple(fixtures.CLASS_CUTS) == smoke.CLASS_CUTS
    want = fixtures.make_frame(smoke.DEFAULT_CAT_SEED, 3000, 500,
                               keep_label=True, classes=3)
    got = smoke.make_frame(3000, 500, classes=3)
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        assert smoke.frame_sha256(w) == smoke.frame_sha256(g)
    frac = np.bincount(got[0]["label"], minlength=3) / 3000
    assert ((frac > 0.2) & (frac < 0.45)).all(), frac


def test_fixture_config_matches_chip_smoke():
    smoke = load_chip_smoke()
    with open(os.path.join(TRAIN_MULTICLASS, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["test_rows"], cfg["cat_seed"],
            cfg["compare_rows"], cfg["learner"], cfg["full_iterations"],
            tuple(cfg["generator"]["class_cuts"])) == (
        smoke.MC_ROWS, smoke.MC_TEST_ROWS, smoke.DEFAULT_CAT_SEED,
        smoke.MC_COMPARE_ROWS, smoke.MC_HP, smoke.MC_FULL_ITERATIONS,
        smoke.CLASS_CUTS)
    assert cfg["update_form"] == ["unfused"] * cfg["num_trees_per_iter"]
    assert all(f["fma"] == 0 for f in cfg["update_fusions"])
    assert all(0.2 < c < 0.45 for c in cfg["class_fractions"])


@pytest.fixture(scope="module")
def fixture_frames():
    smoke = load_chip_smoke()
    train, test = smoke.make_frame(smoke.MC_ROWS, smoke.MC_TEST_ROWS,
                                   classes=3)
    with open(os.path.join(TRAIN_MULTICLASS, "config.json")) as f:
        cfg = json.load(f)
    assert smoke.frame_sha256(test) == cfg["test_sha256"]
    return smoke, test, cfg


def test_fixture_model_predicts_and_evaluates_like_jax(fixture_frames):
    """The committed JAX model on the CPU port: probabilities on the
    stored rows bitwise; evaluate() on 5,000 test rows equal to the JAX
    package's evaluation of the same model."""
    smoke, test, cfg = fixture_frames
    exp = np.load(os.path.join(TRAIN_MULTICLASS, "expected.npz"))
    model_dir = os.path.join(TRAIN_MULTICLASS, "model")
    m = ydf_tpu_torch.load_model(model_dir, device="cpu")
    assert m.num_trees_per_iter == 3
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    assert m.predict(head).tobytes() == exp["model_proba"].tobytes()
    if jax is None:
        return
    part = {k: v[:5000] for k, v in test.items()}
    pe = m.evaluate(part)
    je = ydf.load_model(model_dir).evaluate(part)
    for k in je.metrics:
        assert pe.metrics[k] == pytest.approx(je.metrics[k], abs=1e-12)
    assert np.array_equal(pe.confusion, je.confusion)


# ---- on the card -------------------------------------------------------


@pytest.mark.gpu
def test_multiclass_on_card_matches_cpu():
    """Three classes with every default on the card and on the CPU: the
    same trees and predictions bitwise; K root histograms and K (depth -
    1) routed launches an iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from ydf_tpu_torch.ops import histogram_kernels

    data = make_frame(6000, 5, 3)
    kw = dict(label="label", num_trees=5)
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    card = ydf_tpu_torch.GradientBoostedTreesLearner(**kw).train(data)
    trained = card.training_logs["num_trees_trained"]
    assert histogram_kernels.LAUNCHES == {
        "histogram": 3 * trained, "histogram_routed": 3 * trained * 5}
    cpu = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                    **kw).train(data)
    cf, pf = card.forest.to_numpy(), cpu.forest.to_numpy()
    for f in FOREST_FIELDS:
        assert cf[f].tobytes() == pf[f].tobytes(), f
    assert card.predict(data).tobytes() == cpu.predict(data).tobytes()
