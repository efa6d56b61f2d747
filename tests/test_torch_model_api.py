"""The model and learner API of ydf_tpu_torch beyond predict / evaluate /
save, held against the JAX package on its own saved models: the
introspection accessors, predict_class, self_evaluation, predict_leaves
and distance, serialize / deserialize_model, describe, the GBT's
plot_training_logs, benchmark, and the learners' learner_name /
hyperparameters / validate_hyperparameters /
extract_input_feature_names. Everything compares exactly: numbers
bitwise, text line for line.
"""

import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import ydf_tpu as ydf
except ImportError:
    ydf = None

import ydf_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "ydf_tpu_torch", "testdata")
torch.set_num_threads(1)

#: JAX-saved models: a binary GBT, a GBT with validation logs, a 3-class
#: GBT, a binary random forest with OOB, an uplift forest, a CART, an
#: isolation forest, a vector-sequence GBT, and a YDF-format import.
MODELS = {
    "gbt_d6": "gbt_d6",
    "default": "train_default",
    "multiclass": "train_multiclass/model",
    "rf": "train_rf/rf_small",
    "uplift": "train_uplift/rf_small",
    "cart": "train_cart/model",
    "if": "train_if/model",
    "vs": "train_vs",
    "imported": "ydf_format/gbt_d6",
}
REQUESTS = {"uplift": "ydf_format/uplift_requests.npz"}


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def bytes_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def requests(name, rows=256):
    """Rows the model reads: gbt_d6's requests, the uplift requests, or
    train_vs's fresh rows made by chip_smoke's generator."""
    if name == "vs":
        import chip_smoke

        return chip_smoke.make_vs_data(rows, seed=1)
    path = REQUESTS.get(name, "gbt_d6/requests.npz")
    with np.load(os.path.join(TESTDATA, path)) as z:
        return {k: z[k][:rows] for k in z.files}


_CACHE = {}


def models(name):
    """(JAX model, port model on the CPU), loaded once."""
    require_jax()
    if name not in _CACHE:
        d = os.path.join(TESTDATA, MODELS[name])
        _CACHE[name] = (ydf.load_model(d),
                        ydf_tpu_torch.load_model(d, device="cpu"))
    return _CACHE[name]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_introspection(name):
    jm, pm = models(name)
    assert pm.input_feature_names() == jm.input_feature_names()
    assert pm.num_trees() == jm.num_trees()
    assert pm.num_nodes() == jm.num_nodes()
    assert pm.name() == jm.name()
    assert pm.data_spec().to_json() == jm.data_spec().to_json()
    assert pm.label_col_idx() == jm.label_col_idx()
    assert pm.input_features() == jm.input_features()
    assert pm.input_features_col_idxs() == jm.input_features_col_idxs()
    if jm.classes:
        assert pm.label_classes() == jm.label_classes()
    else:
        with pytest.raises(ValueError, match="classification"):
            pm.label_classes()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_describe_matches_jax(name):
    jm, pm = models(name)
    assert pm.describe().splitlines() == jm.describe().splitlines()
    with pytest.raises(NotImplementedError, match="item 20"):
        pm.describe(output_format="html")


@pytest.mark.parametrize("name", ["gbt_d6", "multiclass", "rf", "cart"])
def test_predict_class(name):
    jm, pm = models(name)
    req = requests(name)
    assert np.array_equal(pm.predict_class(req), np.asarray(
        jm.predict_class(req)))


def test_predict_class_refuses_anomaly_detection():
    _, pm = models("if")
    with pytest.raises(ValueError, match="classification"):
        pm.predict_class(requests("if"))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_self_evaluation(name):
    jm, pm = models(name)
    assert pm.self_evaluation() == jm.self_evaluation()
    if name == "default":
        assert pm.self_evaluation()["source"] == "gbt_validation"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_predict_leaves_and_distance(name):
    jm, pm = models(name)
    req = requests(name)
    leaves = pm.predict_leaves(req)
    assert leaves.dtype == np.int32
    assert bytes_equal(leaves, np.asarray(jm.predict_leaves(req)))
    half = {k: v[:100] for k, v in req.items()}
    other = {k: v[100:180] for k, v in req.items()}
    assert bytes_equal(pm.distance(half), np.asarray(jm.distance(half)))
    assert bytes_equal(pm.distance(half, other),
                       np.asarray(jm.distance(half, other)))


def test_proximity_chunks_by_the_cell_cap(monkeypatch):
    """Chunked by the cap on compared cells, the proximity is the one of
    a single chunk."""
    from ydf_tpu_torch.ops import routing

    rng = np.random.default_rng(0)
    l1 = torch.from_numpy(rng.integers(0, 5, (37, 29)).astype(np.int32))
    l2 = torch.from_numpy(rng.integers(0, 5, (23, 29)).astype(np.int32))
    whole = routing.leaf_proximity(l1, l2)
    monkeypatch.setattr(routing, "PROXIMITY_CELLS", 23 * 29 * 4)
    assert bytes_equal(routing.leaf_proximity(l1, l2).numpy(),
                       whole.numpy())
    want = (l1[:, None] == l2[None]).sum(2).numpy().astype(np.float32) * (
        np.float32(1) / np.float32(29))
    assert bytes_equal(whole.numpy(), want)


@pytest.mark.parametrize("name", ["gbt_d6", "rf", "if", "imported"])
def test_serialize_both_ways(name):
    jm, pm = models(name)
    req = requests(name)
    want = np.asarray(jm.predict(req))
    from_port = ydf.deserialize_model(pm.serialize())
    assert bytes_equal(np.asarray(from_port.predict(req)), want)
    from_jax = ydf_tpu_torch.deserialize_model(jm.serialize(), device="cpu")
    assert bytes_equal(from_jax.predict(req), want)
    again = ydf_tpu_torch.deserialize_model(pm.serialize(), device="cpu")
    assert bytes_equal(again.predict(req), want)


@pytest.mark.parametrize("name", ["gbt_d6", "default", "multiclass"])
def test_plot_training_logs(name):
    jm, pm = models(name)
    assert pm.plot_training_logs() == jm.plot_training_logs()


def test_plot_training_logs_without_logs():
    _, pm = models("imported")
    assert pm.plot_training_logs() == "<svg/>"


@pytest.mark.parametrize("name,engines", [
    ("gbt_d6", {"routed", "quickscorer", "binned_quickscorer",
                "BankScorer"}),
    ("multiclass", {"routed"}),
    ("rf", {"routed"}),
    ("imported", {"routed"}),
])
def test_benchmark_keys(name, engines):
    """benchmark's keys are the JAX package's; engines=True times the
    engines whose envelope takes the model (an import routes natively,
    so only the routed one)."""
    jm, pm = models(name)
    req = requests(name, rows=64)
    got = pm.benchmark(req, num_runs=2, engines=True)
    want = jm.benchmark(req, num_runs=2)
    assert set(got) - {"engines_ns_per_example"} == set(want)
    assert got["num_examples"] == 64 and got["num_runs"] == 2
    assert set(got["engines_ns_per_example"]) == engines
    assert all(v > 0 for v in got["engines_ns_per_example"].values())
    assert "engines_ns_per_example" not in pm.benchmark(req, num_runs=1)
    with pytest.raises(ValueError, match="num_runs"):
        pm.benchmark(req, num_runs=0)


def test_latency_histogram_matches_jax():
    require_jax()
    from ydf_tpu.utils import telemetry as jt

    from ydf_tpu_torch.utils import telemetry as pt

    rng = np.random.default_rng(1)
    a, b = pt.LatencyHistogram(), jt.LatencyHistogram()
    assert a.percentile_ns(50) is None
    for v in rng.integers(0, 10**9, 300).tolist() + [0, 1, 2**63]:
        a.observe_ns(v)
        b.observe_ns(v)
    for p in (0, 1, 50, 90, 99, 100):
        assert a.percentile_ns(p) == b.percentile_ns(p)
    assert pt.peak_rss_bytes() > 0


# --------------------------------------------------------------------- #
# Learner API
# --------------------------------------------------------------------- #

LEARNERS = ["GradientBoostedTreesLearner", "RandomForestLearner",
            "CartLearner", "IsolationForestLearner"]


def _learners(cls_name):
    kw = {} if cls_name == "IsolationForestLearner" else {"label": "label"}
    return (getattr(ydf, cls_name)(**kw),
            getattr(ydf_tpu_torch, cls_name)(device="cpu", **kw))


@pytest.mark.parametrize("cls_name", LEARNERS)
def test_learner_api(cls_name):
    require_jax()
    jl, pl = _learners(cls_name)
    assert pl.learner_name() == jl.learner_name() == cls_name
    jh, ph = jl.hyperparameters(), pl.hyperparameters()
    assert ph["device"] == torch.device("cpu")
    common = set(jh) & set(ph)
    assert len(common) > 10
    for k in sorted(common):
        want = getattr(jh[k], "value", jh[k])
        got = getattr(ph[k], "value", ph[k])
        assert got == want, k
    pl.validate_hyperparameters()
    req = requests("gbt_d6", rows=300)
    req["label"] = (req["f1"] > 0).astype(np.int64)
    assert pl.extract_input_feature_names(req) == (
        jl.extract_input_feature_names(req))


@pytest.mark.parametrize("name,value,error", [
    ("num_trees", 0, ValueError),
    ("num_trees", 2.5, TypeError),
    ("max_depth", -3, ValueError),
    ("num_bins", 257, ValueError),
    ("num_bins", "many", TypeError),
])
def test_validate_hyperparameters_catches_late_changes(name, value, error):
    pl = ydf_tpu_torch.GradientBoostedTreesLearner(label="y", device="cpu")
    pl.validate_hyperparameters()
    setattr(pl, name, value)
    with pytest.raises(error, match=name):
        pl.validate_hyperparameters()


def test_validate_hyperparameters_choices():
    pl = ydf_tpu_torch.GradientBoostedTreesLearner(label="y", device="cpu")
    pl.loss = "HINGE"
    with pytest.raises(ValueError, match="expected one of"):
        pl.validate_hyperparameters()
    pl.loss = ydf_tpu_torch.CustomLoss(
        initial_predictions_fn=lambda y, w: y.mean(),
        gradient_and_hessian_fn=lambda y, p: (p - y, torch.ones_like(p)),
        loss_fn=lambda y, p: ((p - y) ** 2).mean())
    pl.validate_hyperparameters()
    spec = type(pl).hyperparameter_spec()
    assert spec["label"].kind == "config" and spec["device"].kind == "config"
    assert spec["num_bins"].allow_auto and spec["num_bins"].type == "int"


@pytest.mark.gpu
def test_model_api_on_card():
    """predict_leaves, distance and serialize on the card equal the CPU
    port's (the JAX package's, above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    d = os.path.join(TESTDATA, "gbt_d6")
    cpu = ydf_tpu_torch.load_model(d, device="cpu")
    card = ydf_tpu_torch.load_model(d)
    req = requests("gbt_d6")
    assert np.array_equal(card.predict_leaves(req), cpu.predict_leaves(req))
    assert bytes_equal(card.distance(req), cpu.distance(req))
    back = ydf_tpu_torch.deserialize_model(card.serialize())
    assert back.device.type == "cuda"
    assert bytes_equal(back.predict(req), cpu.predict(req))
    got = card.benchmark(req, num_runs=2, engines=True)
    assert set(got["engines_ns_per_example"]) == {
        "routed", "quickscorer", "binned_quickscorer", "BankScorer"}
