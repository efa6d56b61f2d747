"""The GBT losses of ydf_tpu_torch (learners/losses.py) held against the
JAX package's loss objects on the CPU, and the loss configurations of
the committed fixture train_gbt_options trained by the CPU port.

Tolerances, per loss, against jax.jit of the JAX object on the same
seeded inputs:
  * Poisson and mean absolute error: initial prediction, gradients,
    hessians and the reported loss bitwise (XLA's exp and log, its sums'
    order, jnp.cumsum's blocked scan in the weighted median);
  * binary focal: the initial prediction, the gradients and the loss
    bitwise; the hessians within 2^-23 absolute. The port replays the
    hessian as XLA compiles it inside the JAX learner's boosting loop,
    where one more multiply-add is contracted than in a standalone
    jax.jit(grad_hess); the two programs then differ by one rounding of
    a product whose magnitude is below 1, at most an ulp of 1 (2^-23),
    and the learner's trees are held bitwise instead (the fixture test
    below, and tests/test_torch_gbt_sampling.py's helpers);
  * a CustomLoss written as squared error grows the squared-error trees
    bitwise.
"""

import json
import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX.
    import jax

    from ydf_tpu.learners import losses as jax_losses
except ImportError:
    jax = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.learners import losses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIONS = os.path.join(REPO, "ydf_tpu_torch", "testdata",
                       "train_gbt_options")
torch.set_num_threads(1)
FOCAL_HESS_ATOL = 2.0 ** -23


def require_jax():
    if jax is None:
        pytest.skip("needs the JAX package, the reference")


def bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def inputs(name, n=20_000, seed=0):
    """(labels, scores, weights) f32 numpy for a loss: counts from
    exp(0.3 s) for Poisson, s plus Laplace noise (with ties) for MAE,
    {0, 1} otherwise; scores with large margins in the first rows."""
    rng = np.random.default_rng(seed)
    s = rng.normal(0, 2, n).astype(np.float32)
    s[:200] *= 15
    w = rng.uniform(0.5, 2, n).astype(np.float32)
    if name == "POISSON":
        y = rng.poisson(np.exp(0.3 * np.clip(s, -20, 20)))
    elif name == "MEAN_AVERAGE_ERROR":
        y = np.round(s + rng.laplace(size=n), 1)  # ties for the median
    else:
        y = rng.uniform(size=n) < 0.4
    return y.astype(np.float32), s, w


@pytest.mark.parametrize("name", ["POISSON", "MEAN_AVERAGE_ERROR",
                                  "BINARY_FOCAL_LOSS"])
@pytest.mark.parametrize("weighted", [False, True])
def test_pointwise_loss_matches_jax(name, weighted):
    require_jax()
    y, s, w = inputs(name)
    if not weighted:
        w = np.ones_like(w)
    jl = jax_losses.make_loss(name, None, 1)
    pl = losses.make_loss(name, Task.REGRESSION, 1)
    ty, ts, tw = (torch.from_numpy(a) for a in (y, s, w))
    want = jax.jit(jl.initial_predictions)(y, w)
    assert bits(pl.initial_predictions(ty, tw)).tolist() == \
        bits(want).tolist()
    jg, jh = jax.jit(jl.grad_hess)(y, s[:, None])
    g, h = pl.grad_hess(ty, ts)
    assert np.array_equal(bits(g), bits(jg[:, 0]))
    if name == "BINARY_FOCAL_LOSS":
        diff = np.abs(h.numpy() - np.asarray(jh[:, 0]))
        assert diff.max() <= FOCAL_HESS_ATOL, diff.max()
        assert float(h.min()) >= np.float32(1e-12)  # clamped at EPS
    else:
        assert np.array_equal(bits(h), bits(jh[:, 0]))
    want = jax.jit(jl.loss)(y, s[:, None], w)
    assert bits(pl.loss(ty, ts, tw)).tolist() == bits(want).tolist()


def test_weighted_median_and_ties():
    """MAE's initial prediction is the smallest label whose cumulative
    weight reaches half the total, in a stable order."""
    require_jax()
    jl = jax_losses.MeanAverageError()
    pl = losses.MeanAverageError()
    for y, w in (([1, 1, 1, 2, 3], [1, 1, 1, 1, 1]),
                 ([3, 1, 2, 2], [1, 5, 1, 1]),
                 ([5, 4], [1, 1]), ([7.5], [2.0])):
        y = np.asarray(y, np.float32)
        w = np.asarray(w, np.float32)
        want = jax.jit(jl.initial_predictions)(y, w)
        got = pl.initial_predictions(torch.from_numpy(y),
                                     torch.from_numpy(w))
        assert bits(got).tolist() == bits(want).tolist(), (y, w)


def test_make_loss_maps_every_name():
    for name, cls in (("BINOMIAL_LOG_LIKELIHOOD",
                       losses.BinomialLogLikelihood),
                      ("SQUARED_ERROR", losses.MeanSquaredError),
                      ("POISSON", losses.PoissonLoss),
                      ("MEAN_AVERAGE_ERROR", losses.MeanAverageError),
                      ("BINARY_FOCAL_LOSS", losses.BinaryFocalLoss)):
        assert isinstance(losses.make_loss(name, Task.REGRESSION, 1), cls)
    multi = losses.make_loss("DEFAULT", Task.CLASSIFICATION, 4)
    assert isinstance(multi, losses.MultinomialLogLikelihood)
    assert multi.num_dims == 4
    assert isinstance(losses.make_loss("DEFAULT", Task.CLASSIFICATION, 2),
                      losses.BinomialLogLikelihood)
    # The ranking and survival losses (ported since ROADMAP item 11):
    # the tasks' defaults, XE_NDCG_MART by name.
    from ydf_tpu_torch.learners import ranking_loss, survival_loss

    for name, task, cls in (
            ("DEFAULT", Task.RANKING, ranking_loss.LambdaMartNdcg),
            ("XE_NDCG_MART", Task.RANKING, ranking_loss.XeNdcg),
            ("DEFAULT", Task.SURVIVAL_ANALYSIS,
             survival_loss.CoxProportionalHazardLoss),
            ("COX_PROPORTIONAL_HAZARD", Task.REGRESSION,
             survival_loss.CoxProportionalHazardLoss)):
        assert type(losses.make_loss(name, task, 1)) is cls
    with pytest.raises(ValueError, match="No default GBT loss"):
        losses.make_loss("DEFAULT", Task.NUMERICAL_UPLIFT, 1)
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.make_loss("NOPE", Task.REGRESSION, 1)


def mse_custom_loss(weighted):
    def init(y, w):
        return losses.MeanSquaredError().initial_predictions(y, w)

    def grad_hess(y, s):
        g = s - y
        return g, torch.ones_like(g)

    if weighted:
        def loss_fn(y, s, w):
            return torch.sqrt(torch.sum(w * (s - y) ** 2) / torch.sum(w))
    else:
        def loss_fn(y, s):
            return torch.sqrt(torch.mean((s - y) ** 2))
    return losses.CustomLoss(init, grad_hess, loss_fn)


@pytest.mark.parametrize("weighted", [False, True])
def test_custom_loss_as_mse_grows_the_mse_trees(weighted):
    rng = np.random.default_rng(3)
    n = 3000
    x = rng.normal(size=(n, 5)).astype(np.float32)
    data = {f"f{i}": x[:, i] for i in range(5)}
    data["label"] = (x[:, 0] - x[:, 1] ** 2
                     + rng.normal(0, 0.3, n)).astype(np.float32)
    kw = dict(label="label", task=Task.REGRESSION, num_trees=8,
              device="cpu")
    want = ydf_tpu_torch.GradientBoostedTreesLearner(**kw).train(data)
    got = ydf_tpu_torch.GradientBoostedTreesLearner(
        loss=mse_custom_loss(weighted), **kw).train(data)
    wf, gf = want.forest.to_numpy(), got.forest.to_numpy()
    for f in wf:
        assert wf[f].tobytes() == gf[f].tobytes(), f
    assert got.loss_name == "CUSTOM"
    assert got.training_logs["num_trees"] == want.training_logs["num_trees"]
    assert np.allclose(got.training_logs["valid_loss"],
                       want.training_logs["valid_loss"], rtol=1e-5)


def test_custom_loss_contract():
    """The JAX CustomLoss's contract: the hessian clamped at EPS, K = 1,
    a fingerprint of the callables' bytecode."""
    a = losses.CustomLoss(lambda y, w: torch.zeros(1),
                          lambda y, s: (s - y, torch.zeros_like(s)),
                          lambda y, s: torch.mean(s))
    g, h = a.grad_hess(torch.ones(4), torch.zeros(4))
    assert torch.equal(g, -torch.ones(4))
    assert float(h.min()) == pytest.approx(1e-12)
    assert a.num_dims == 1
    assert a.initial_predictions(torch.ones(3), torch.ones(3)).shape == (1,)
    b = losses.CustomLoss(lambda y, w: torch.zeros(1),
                          lambda y, s: (s - y, torch.zeros_like(s)),
                          lambda y, s: torch.mean(s))
    c = losses.CustomLoss(lambda y, w: torch.zeros(1) + 1.0,
                          lambda y, s: (s - y, torch.zeros_like(s)),
                          lambda y, s: torch.mean(s))
    assert a.fingerprint() == b.fingerprint() != c.fingerprint()


def train_option(name):
    """(model, expected arrays, result record) of one train_gbt_options
    configuration trained by the CPU port."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(OPTIONS, "config.json")) as f:
        cfg = json.load(f)
    c, res = cfg["configs"][name], cfg["results"][name]
    train, test = smoke.options_frame(c["frame"], cfg["cat_seed"],
                                      cfg["rows"], cfg["test_rows"])
    assert smoke.frame_sha256(train) == res["train_sha256"]
    assert smoke.frame_sha256(test) == res["test_sha256"]
    m = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", num_trees=cfg["num_trees"], device="cpu",
        task=Task[c.get("task", "CLASSIFICATION")],
        **c["learner"]).train(train)
    exp = np.load(os.path.join(OPTIONS, "expected.npz"))
    fo = m.forest.to_numpy()
    got = [smoke.tree_sha256(fo, t) for t in range(fo["feature"].shape[0])]
    want = [h.tobytes().hex() for h in exp[f"{name}/tree_sha256"]]
    return m, exp, res, got, want, m.predict(test)


def check_option(name):
    m, exp, res, got, want, pred = train_option(name)
    assert got == want
    assert m.training_logs["num_trees"] == res["num_trees"]
    assert m.training_logs["num_trees_trained"] == res["num_trees_trained"]
    assert m.num_trees_per_iter == res["num_trees_per_iter"]
    assert bits(m.initial_predictions).tolist() == bits(
        exp[f"{name}/initial_predictions"]).tolist()
    want = exp[f"{name}/valid_loss"][:res["num_trees"]]
    if m.loss_name == "BINOMIAL_LOG_LIKELIHOOD":
        # The reported binomial loss uses torch's softplus and sums.
        np.testing.assert_allclose(m.training_logs["valid_loss"], want,
                                   rtol=1e-5)
    else:
        assert np.array_equal(bits(m.training_logs["valid_loss"]),
                              bits(want))
    assert pred.tobytes() == exp[f"{name}/predictions"].tobytes()


@pytest.mark.parametrize("name", ["poisson", "mae", "focal"])
def test_loss_configuration_matches_the_fixture(name):
    """The CPU port on train_gbt_options' loss configurations (20,000
    rows, 30 trees, every other default): every tree by hash, the kept
    count, the validation losses and the predictions bitwise."""
    check_option(name)


# ---- on the card -------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["POISSON", "MEAN_AVERAGE_ERROR",
                                  "BINARY_FOCAL_LOSS"])
def test_losses_on_card_match_cpu(name):
    """Each loss's initial prediction, gradients, hessians and loss on the
    card equal the CPU's bitwise (the same replicas of XLA's arithmetic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    y, s, w = inputs(name)
    pl = losses.make_loss(name, Task.REGRESSION, 1)
    cpu = [torch.from_numpy(a) for a in (y, s, w)]
    card = [a.cuda() for a in cpu]
    for fn in (lambda a: pl.initial_predictions(a[0], a[2]),
               lambda a: pl.grad_hess(a[0], a[1])[0],
               lambda a: pl.grad_hess(a[0], a[1])[1],
               lambda a: pl.loss(*a)):
        assert torch.equal(fn(card).cpu(), fn(cpu))
