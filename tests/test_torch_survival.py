"""The SURVIVAL_ANALYSIS task on ydf_tpu_torch's GBT, held against the
JAX package on the CPU: the Cox proportional-hazard loss (gradients,
hessians and loss against jax.jit of the JAX methods, with entry ages,
weights and tied times), its schedule's errors, the event column's
parsing, small Cox GBTs trained by both packages (the validation split,
an explicit valid=, entry ages, weights), JAX-saved survival models,
save -> load with the model's metadata, and the concordance index.

Tolerance: bitwise (gradients, hessians, losses, node arrays, leaf
values, predictions, a NaN as any NaN); evaluation metrics within 1e-12
(host float64 on the same predictions).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import warnings

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.learners import gbt as jax_gbt
    from ydf_tpu.learners import survival_loss as jax_surv
    from ydf_tpu.metrics import metrics as jax_metrics
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.learners import survival_loss
from ydf_tpu_torch.metrics import metrics
from test_torch_default_train import load_chip_smoke

torch.set_num_threads(1)
SMOKE = load_chip_smoke()
NODE_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
               "right", "is_leaf", "num_nodes", "threshold", "leaf_value")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def same_bits(a, b):
    """Bitwise, a NaN equal to any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(
        bits(np.where(nan, 0, a)), bits(np.where(nan, 0, b)))


def cox_case(seed, n, entry=False, weights=False, ties=False):
    rng = np.random.RandomState(seed)
    t = rng.exponential(size=n).astype(np.float32)
    if ties:
        t = (np.round(t * 4) / 4).astype(np.float32)
    ev = rng.rand(n) < 0.7
    en = (t * rng.rand(n)).astype(np.float32) if entry else None
    w = (rng.rand(n) + 0.5).astype(np.float32) if weights else None
    p = (rng.randn(n) * 0.5).astype(np.float32)
    return t, ev, en, w, p


COX_CASES = {
    "plain": dict(seed=0, n=500),
    "entry": dict(seed=1, n=3000, entry=True),
    "weights": dict(seed=2, n=2000, weights=True),
    "entry_weights_ties": dict(seed=3, n=1000, entry=True, weights=True,
                               ties=True),
    "large": dict(seed=4, n=40_000),
}


@pytest.mark.parametrize("case", sorted(COX_CASES))
def test_cox_loss_bitwise_to_jax(case):
    """grad_hess and loss against jax.jit of the JAX methods, bitwise:
    the fused multiply-adds, exp(2p) for exp(p)^2, jnp.cumsum's blocked
    scan and the loss's f32 reciprocal scale."""
    require_jax()
    t, ev, en, w, p = cox_case(**COX_CASES[case])
    jl = jax_surv.CoxProportionalHazardLoss()
    jl.register_survival("train", t, ev, en, weights=w)
    pl = survival_loss.CoxProportionalHazardLoss()
    pl.register_survival("train", t, ev, en, weights=w)
    g, h = jax.jit(lambda y, q: jl.grad_hess(y, q))(jnp.asarray(t),
                                                   jnp.asarray(p[:, None]))
    lo = jax.jit(lambda y, q: jl.loss(y, q, None))(jnp.asarray(t),
                                                   jnp.asarray(p[:, None]))
    pg, ph = pl.grad_hess(torch.from_numpy(t), torch.from_numpy(p))
    plo = pl.loss(torch.from_numpy(t), torch.from_numpy(p), None)
    assert np.array_equal(bits(pg.numpy()), bits(np.asarray(g)[:, 0]))
    assert np.array_equal(bits(ph.numpy()), bits(np.asarray(h)[:, 0]))
    assert np.array_equal(bits(plo.numpy()), bits(np.float32(lo)))


def test_cox_schedule_errors():
    loss = survival_loss.CoxProportionalHazardLoss()
    with pytest.raises(ValueError, match="entry age exceeds"):
        loss.register_survival("train", np.ones(3), np.ones(3, bool),
                               np.array([0.5, 2.0, 0.0]))
    loss.register_survival("train", np.ones(3), np.ones(3, bool))
    with pytest.raises(ValueError, match="registered for 3"):
        loss.grad_hess(torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError, match="No survival structure"):
        loss.loss(torch.ones(3), torch.zeros(3), None, tag="valid")


@pytest.mark.parametrize("values", [
    np.array([1, 0, 1]), np.array([True, False, True]),
    np.array([1.0, 0.0, 1.0]),
    np.array(["true", "No", "Y"], dtype=object),
    np.array(["T", "f", "1"]),
    np.array([1.0, np.nan, 0.0]),
    np.array(["yes", "maybe", "no"], dtype=object),
    np.array(["yes", None, "no"], dtype=object),
])
def test_event_column_parsing_matches_jax(values):
    """bool_column: the accepted indicators, and the errors on missing
    or unknown values, as the JAX package's _bool_column."""
    require_jax()
    try:
        want = jax_gbt._bool_column(values)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_gbt.bool_column(values)
        assert str(got.value) == str(e)
        return
    assert np.array_equal(port_gbt.bool_column(values), want)


def surv_frames(rows=2500, entry=False, weights=False):
    return SMOKE.make_surv_frame(rows, 400, seed=7, entry=entry,
                                 weights=weights)


def train_both(train, valid=None, **kw):
    kw = dict(dict(label="time", label_event_observed="event",
                   num_trees=10), **kw)
    jm = ydf.GradientBoostedTreesLearner(
        task=JaxTask.SURVIVAL_ANALYSIS, **kw).train(train, valid=valid)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        task=Task.SURVIVAL_ANALYSIS, device="cpu", **kw).train(
            train, valid=valid)
    return jm, pm


@pytest.mark.parametrize("option", ["default", "no_validation", "valid",
                                    "entry", "weights"])
def test_small_cox_gbts_match_jax(option):
    """Every tree, the kept count, the losses, the predictions and the
    concordance of a small Cox GBT trained by both packages."""
    require_jax()
    kw, valid = {}, None
    train, test = surv_frames(entry=option == "entry",
                              weights=option == "weights")
    if option == "no_validation":
        kw["validation_ratio"] = 0.0
    elif option == "valid":
        valid, _ = SMOKE.make_surv_frame(500, 10, seed=9)
    elif option == "entry":
        kw["label_entry_age"] = "entry"
    elif option == "weights":
        kw["weights"] = "w"
    jm, pm = train_both(train, valid, **kw)
    jf = {f: np.asarray(getattr(jm.forest, f)) for f in NODE_FIELDS}
    pf = pm.forest.to_numpy()
    for f in NODE_FIELDS:
        assert same_bits(pf[f], jf[f]), f
    jl, pl = jm.training_logs, pm.training_logs
    assert (pl["num_trees"], pl["num_trees_trained"]) == (
        jl["num_trees"], jl["num_trees_trained"])
    for key in ("train_loss", "valid_loss"):
        if jl[key] is not None:
            assert same_bits(np.float32(pl[key]), np.float32(jl[key])), key
    assert same_bits(pm.predict(test), np.asarray(jm.predict(test)))
    je, pe = jm.evaluate(test).metrics, pm.evaluate(test).metrics
    assert abs(pe["concordance"] - je["concordance"]) <= 1e-12
    assert pm.extra_metadata == jm.extra_metadata


def test_survival_models_load_and_save_both_ways(tmp_path):
    """A JAX-saved Cox model loads in the port and predicts bitwise; the
    port's save keeps extra_metadata, so evaluate still reads the event
    column; the JAX package loads the port's save."""
    require_jax()
    train, test = surv_frames()
    jm = ydf.GradientBoostedTreesLearner(
        label="time", task=JaxTask.SURVIVAL_ANALYSIS,
        label_event_observed="event", num_trees=5,
        validation_ratio=0.0).train(train)
    jm.save(str(tmp_path / "jax"))
    pm = ydf_tpu_torch.load_model(str(tmp_path / "jax"), device="cpu")
    assert pm.task == Task.SURVIVAL_ANALYSIS
    assert pm.extra_metadata == {"label_event_observed": "event"}
    want = np.asarray(jm.predict(test))
    assert np.array_equal(bits(pm.predict(test)), bits(want))
    pm.save(str(tmp_path / "port"))
    back = ydf_tpu_torch.load_model(str(tmp_path / "port"), device="cpu")
    assert back.extra_metadata == jm.extra_metadata
    ev, jev = back.evaluate(test).metrics, jm.evaluate(test).metrics
    assert abs(ev["concordance"] - jev["concordance"]) <= 1e-12
    jback = ydf.load_model(str(tmp_path / "port"))
    assert np.array_equal(bits(np.asarray(jback.predict(test))), bits(want))


@pytest.mark.parametrize("n,weighted", [(500, False), (3000, True),
                                        (9000, False)])
def test_concordance_matches_jax(n, weighted):
    """Harrell's C-index (ties half, the RandomState(7) subsample above
    8,000 rows) against the JAX package's evaluate_predictions."""
    require_jax()
    t, ev, _, w, p = cox_case(n, n, weights=weighted, ties=True)
    p = np.round(p, 1)
    want = jax_metrics.evaluate_predictions(
        JaxTask.SURVIVAL_ANALYSIS, t, p, weights=w, events=ev)
    got = metrics.evaluate_predictions(Task.SURVIVAL_ANALYSIS, t, p,
                                       weights=w, events=ev)
    assert abs(got.metrics["concordance"]
               - want.metrics["concordance"]) <= 1e-12
    with pytest.raises(ValueError, match="requires events"):
        metrics.evaluate_predictions(Task.SURVIVAL_ANALYSIS, t, p)


def test_survival_surface_errors():
    train, _ = surv_frames(rows=300)
    with pytest.raises(ValueError, match="requires label_event_observed"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="time", task=Task.SURVIVAL_ANALYSIS, device="cpu",
            num_trees=1).train(train)
    with pytest.raises(ValueError, match="SURVIVAL_ANALYSIS"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="time", task=Task.REGRESSION, device="cpu",
            loss="COX_PROPORTIONAL_HAZARD", num_trees=1).train(train)
    bad = dict(train, event=np.where(np.arange(300) == 5, np.nan,
                                     train["event"].astype(float)))
    with pytest.raises(ValueError, match="missing values"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="time", task=Task.SURVIVAL_ANALYSIS, device="cpu",
            label_event_observed="event", num_trees=1).train(bad)
    m = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="time", task=Task.SURVIVAL_ANALYSIS, device="cpu",
        label_event_observed="event", num_trees=1,
        validation_ratio=0.0).train(train)
    assert m.loss_name == "COX_PROPORTIONAL_HAZARD"
    assert "event" not in m.binner.feature_names


@pytest.mark.gpu
def test_cox_loss_on_card_equals_cpu():
    """The Cox loss's plain PyTorch on the card: gradients, hessians and
    loss bitwise to the CPU's, with no host sync."""
    _need_card()
    t, ev, en, w, p = cox_case(5, 200_000, entry=True, weights=True)
    out = []
    for dev in ("cpu", "cuda"):
        loss = survival_loss.CoxProportionalHazardLoss()
        loss.register_survival("train", t, ev, en, weights=w, device=dev)
        yt, pt = torch.from_numpy(t).to(dev), torch.from_numpy(p).to(dev)
        if dev == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            g, h = loss.grad_hess(yt, pt)
            lo = loss.loss(yt, pt, None)
        finally:
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        out.append([a.cpu().numpy() for a in (g, h, lo)])
    for a, b in zip(*out):
        assert np.array_equal(bits(a), bits(b))


@pytest.mark.gpu
def test_small_cox_gbt_on_card_equals_cpu():
    """A small Cox GBT with entry ages on the card: every tree and the
    predictions bitwise to the CPU port's."""
    _need_card()
    train, test = surv_frames(entry=True)
    kw = dict(label="time", task=Task.SURVIVAL_ANALYSIS,
              label_event_observed="event", label_entry_age="entry",
              num_trees=8, validation_ratio=0.0)
    cpu = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                    **kw).train(train)
    card = ydf_tpu_torch.GradientBoostedTreesLearner(device="cuda",
                                                     **kw).train(train)
    a, b = cpu.forest.to_numpy(), card.forest.to_numpy()
    for f in NODE_FIELDS:
        assert same_bits(a[f], b[f]), f
    assert same_bits(cpu.predict(test), card.predict(test))
