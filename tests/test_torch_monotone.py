"""Monotone constraints on ydf_tpu_torch's GBT, held against the JAX
package on the CPU: the split search's monotone validity (layer_decide),
the leaf clamp after training (_clamp_monotone_leaves, with and without
oblique projections), the sign-forced oblique coefficients, whole
trainings at one output, three classes and with sparse-oblique splits,
the model's monotonicity along the constrained features, the
constructor's checks; and the train_monotone fixture's configuration
against chip_smoke.py's constants.

The JAX side trains with its CPU defaults (the native histogram and
fused routing). Tolerance: bitwise (split decisions, every node array,
clamped leaf values, predictions); evaluation metrics within 1e-12.
"""

import json
import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.learners.gbt import _clamp_monotone_leaves
    from ydf_tpu.ops import grower as jax_grower
    from ydf_tpu.ops.oblique import (
        sample_projection_coefficients as jax_sample,
    )
    from ydf_tpu.ops.split_rules import HessianGainRule as JaxRule
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.models.forest import Forest
from ydf_tpu_torch.ops import grower, oblique
from ydf_tpu_torch.ops.split_rules import HessianGainRule
from ydf_tpu_torch.utils import prng
from test_torch_default_train import candidate_hist, load_chip_smoke

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_MONOTONE = os.path.join(REPO, "ydf_tpu_torch", "testdata",
                              "train_monotone")
CONSTRAINTS = {"f0": 1, "f1": -1, "f2": 1}
NODE_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
               "right", "is_leaf", "num_nodes", "threshold",
               "oblique_weights")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def frame(n, seed=0, classes=2):
    """Six normal features (NaNs in f0), a label from the generator's
    logit: f0 increasing, f1 decreasing, f2 through sin (its +1
    constraint binds), a categorical column."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    logit = (x[:, 0] - 0.5 * x[:, 1] + np.sin(2 * x[:, 2])
             + x[:, 3] * x[:, 4])
    if classes == 2:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    else:
        y = np.digitize(logit + rng.logistic(size=n), (-0.8, 0.8))
    data = {f"f{i}": x[:, i] for i in range(6)}
    data["f0"] = np.where(rng.uniform(size=n) < 0.03, np.nan,
                          data["f0"]).astype(np.float32)
    data["c"] = np.array([f"v{v}" for v in rng.randint(0, 5, n)])
    data["label"] = y
    return data


@pytest.mark.parametrize("first", [1.0, -1.0, 0.0])
def test_monotone_validity_matches_jax_layer_decide(first):
    """layer_decide with monotone directions (a cut is valid only when
    d * (leaf_value(right) - leaf_value(left)) >= 0) against the JAX
    grower's layer_decide on the same candidates, for every sign
    pattern of the other four columns; some patterns move a split."""
    require_jax()
    Fn, Fc, B, L, N = 2, 3, 32, 4, 15
    hist = candidate_hist(Fn=Fn, Fc=Fc, B=B)
    Ld = hist.shape[0]
    left, ranks = grower.scalar_candidates(
        torch.from_numpy(hist), num_numerical=Fn, rule=HessianGainRule())
    parent = hist[:, 0].sum(axis=1)
    kw = dict(L=L, B=B, N=N, min_examples=1, min_split_gain=1e-9,
              children_in_frontier=True)
    args = (torch.from_numpy(parent), torch.ones(Ld, dtype=torch.bool),
            torch.arange(Ld), torch.tensor(Ld, dtype=torch.int32))
    free = grower.layer_decide(left, ranks, *args, rule=HessianGainRule(),
                               num_numerical=Fn, **kw)
    moved = 0
    for rest in np.ndindex(2, 2, 2, 2):
        d = np.array((first,) + tuple(2.0 * np.array(rest) - 1),
                     np.float32)
        want = jax_grower.layer_decide(
            jnp.asarray(left.numpy()),
            jnp.asarray(ranks.numpy())[:, :, None], None,
            jnp.asarray(parent), jnp.ones(Ld, bool), jnp.arange(Ld),
            jnp.asarray(Ld, jnp.int32), None, None, jnp.asarray(d), None,
            rule=JaxRule(), Fn=Fn, Fc=Fc, O=1, Fs=0, W=1,
            candidate_features=-1, num_valid_features=None, **kw)
        got = grower.layer_decide(left, ranks, *args, rule=HessianGainRule(),
                                  num_numerical=Fn,
                                  mono_dirs=torch.from_numpy(d), **kw)
        for field in ("do_split", "best_f", "best_t", "go_left_bins",
                      "left_stats"):
            assert np.array_equal(getattr(got, field).numpy(),
                                  np.asarray(getattr(want, field))), field
        moved += not (torch.equal(got.best_f, free.best_f)
                      and torch.equal(got.best_t, free.best_t))
    assert moved > 0


@pytest.mark.parametrize("split_axis", ["AXIS_ALIGNED", "SPARSE_OBLIQUE"])
def test_leaf_clamp_matches_jax(split_axis):
    """clamp_monotone_leaves on a JAX forest grown without constraints
    (so the clamp has work) against the JAX package's
    _clamp_monotone_leaves on the same forest: leaf values bitwise; a
    projection touching a constrained feature counts as increasing."""
    require_jax()
    data = frame(2000, seed=4)
    jm = ydf.GradientBoostedTreesLearner(
        label="label", num_trees=10, validation_ratio=0.0,
        split_axis=split_axis).train(data)
    want = _clamp_monotone_leaves(jm.forest, jm.binner, CONSTRAINTS)
    port = Forest.from_numpy({f: np.asarray(getattr(jm.forest, f))
                              for f in jm.forest._fields})
    pb = ydf_tpu_torch.binner_from_jax(jm.binner.to_json())
    got = port_gbt.clamp_monotone_leaves(port, pb, CONSTRAINTS)
    wl = np.asarray(want.leaf_value)
    assert not np.array_equal(wl, np.asarray(jm.forest.leaf_value))
    assert np.array_equal(bits(got.leaf_value.numpy()), bits(wl))


def test_sign_forced_coefficients_match_jax():
    """The oblique sampler with monotone directions: constrained
    features' coefficients take the constraint's sign."""
    require_jax()
    key = prng.split(prng.prng_key(3), 4)
    mono = np.array([1, -1, 0, 1, 0, 0], np.float32)
    for wt in ("BINARY", "CONTINUOUS", "POWER_OF_TWO", "INTEGER"):
        got = oblique.sample_projection_coefficients(
            key, 6, 6, weight_type=wt, monotone_vec=torch.from_numpy(mono))
        for i in range(4):
            want = jax_sample(
                jnp.asarray(key[i].numpy().astype(np.uint32)), 6, 6,
                weight_type=wt, monotone_vec=jnp.asarray(mono))
            assert np.array_equal(bits(got[i].numpy()), bits(want)), wt
        w = got.numpy()
        assert (w[..., 0] >= 0).all() and (w[..., 1] <= 0).all()


@pytest.mark.parametrize("kind", ["binary", "three_class", "oblique"])
def test_monotone_trainings_grow_the_jax_trees(kind):
    """The default GBT with monotonic_constraints, 30 iterations, on a
    small frame: K = 1, K = 3 and SPARSE_OBLIQUE (the projections'
    directions and sign-forced coefficients); every node array, the
    clamped leaf values, the kept count and predictions bitwise."""
    require_jax()
    data = frame(2500, seed=1, classes=3 if kind == "three_class" else 2)
    fresh = frame(500, seed=2, classes=3 if kind == "three_class" else 2)
    kw = dict(label="label", num_trees=30,
              monotonic_constraints=CONSTRAINTS)
    if kind == "oblique":
        kw["split_axis"] = "SPARSE_OBLIQUE"
    jm = ydf.GradientBoostedTreesLearner(**kw).train(data)
    if kind == "oblique":
        jm.force_engine("Routed")
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        device="cpu", **kw).train(data)
    assert pm.training_logs["num_trees"] == jm.training_logs["num_trees"]
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    for field in NODE_FIELDS:
        assert np.array_equal(pf[field], jf[field]), field
    assert np.array_equal(bits(pf["leaf_value"]), bits(jf["leaf_value"]))
    assert np.array_equal(bits(pm.predict(fresh)),
                          bits(np.asarray(jm.predict(fresh))))
    je, pe = jm.evaluate(fresh).metrics, pm.evaluate(fresh).metrics
    for k, v in je.items():
        assert abs(pe[k] - v) <= 1e-12, k


def test_monotone_model_is_monotone():
    """Along a grid of each constrained feature (the others fixed per
    row) the positive-class probability never moves against the
    constraint."""
    data = frame(3000, seed=5)
    m = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", num_trees=40, monotonic_constraints=CONSTRAINTS,
        device="cpu").train(data)
    base = {k: v[:50] for k, v in frame(50, seed=6).items()}
    grid = np.linspace(-3, 3, 41, dtype=np.float32)
    for name, d in CONSTRAINTS.items():
        probs = []
        for g in grid:
            rows = dict(base)
            rows[name] = np.full(50, g, np.float32)
            probs.append(np.asarray(m.predict(rows), np.float64))
        steps = np.diff(np.stack(probs), axis=0) * d
        assert (steps >= -1e-7).all(), name


def test_monotone_constructor_checks():
    kw = dict(label="label", device="cpu", validation_ratio=0.0,
              num_trees=1)
    data = frame(200)
    with pytest.raises(ValueError, match="Unknown monotonic"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            monotonic_constraints={"zz": 1}, **kw).train(data)
    with pytest.raises(ValueError, match="non-numerical"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            monotonic_constraints={"c": -1}, **kw).train(data)
    # Directions are sign(d).
    m = ydf_tpu_torch.GradientBoostedTreesLearner(
        monotonic_constraints={"f0": 2.5, "f1": -0.5}, **kw).train(data)
    assert port_gbt.monotone_directions(
        {"f0": 2.5, "f1": -0.5}, m.binner)[:2] == (1, -1)


def test_train_monotone_fixture_matches_chip_smoke_constants():
    """The committed fixture is the configuration phase 13 drives."""
    smoke = load_chip_smoke()
    with open(os.path.join(TRAIN_MONOTONE, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["constraints"] == smoke.MONOTONE_CONSTRAINTS
    assert cfg["gbt"]["rows"] == smoke.DEFAULT_ROWS
    assert cfg["gbt"]["test_rows"] == smoke.DEFAULT_TEST_ROWS
    assert cfg["gbt"]["learner"] == smoke.DEFAULT_HP
    exp = np.load(os.path.join(TRAIN_MONOTONE, "expected.npz"))
    for run in ("gbt", "three_class", "oblique"):
        T = cfg[run]["num_trees"] * (3 if run == "three_class" else 1)
        assert exp[f"{run}/tree_sha256"].shape == (T, 32)
