"""DISCRETIZED_NUMERICAL columns against the JAX package: the stored
boundaries of dataspec inference (discretize_numerical_columns /
detect_numerical_as_discretized), the binner's stored-boundary branch
(f32 casts that collide, thinning to the bin budget), and the committed
small runs (ydf_tpu_torch/testdata/train_discretized) of the four
learners trained with discretize_numerical_columns=True: every tree by
hash, the predictions bitwise, and the GBT's save_ydf files byte for
byte the JAX package's export_ydf_model.
"""

import json
import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import ydf_tpu as ydf
    from ydf_tpu.dataset import dataspec as jspec
except ImportError:
    ydf = None

import chip_smoke
import ydf_tpu_torch
from ydf_tpu_torch.dataset import dataspec as pspec
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import Dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_DISCRETIZED = os.path.join(REPO, "ydf_tpu_torch", "testdata",
                                 "train_discretized")
torch.set_num_threads(1)


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def columns(n=4000, seed=0):
    """Dense floats with NaNs, a low-cardinality int column, a bool, a
    categorical, a column of values a few ulps apart (their f64
    midpoints collide in f32), and a label."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[rng.uniform(size=n) < 0.05] = np.nan
    near = 1.0 + rng.integers(0, 6, n) * 2.0 ** -50
    return {
        "x": x, "k": rng.integers(0, 12, n), "b": rng.uniform(size=n) < 0.5,
        "c": np.array([f"v{i}" for i in rng.integers(0, 5, n)]),
        "near": near, "f32": rng.normal(size=n).astype(np.float32),
        "label": rng.integers(0, 2, n),
    }


@pytest.mark.parametrize("max_bins", [255, 7, 2])
def test_infer_dataspec_discretized_equals_the_jax_package(max_bins):
    """Every numerical column but the label, the bool and the user-typed
    one is DISCRETIZED_NUMERICAL with the JAX package's boundaries (f64
    midpoints of <= max_bins distinct values, else deduplicated
    quantiles)."""
    require_jax()
    cols = columns()
    types = {"f32": pspec.ColumnType.NUMERICAL}
    got = pspec.infer_dataspec(cols, label="label", column_types=types,
                               detect_numerical_as_discretized=True,
                               discretized_max_bins=max_bins)
    want = jspec.infer_dataspec(
        cols, label="label", column_types={"f32": jspec.ColumnType.NUMERICAL},
        detect_numerical_as_discretized=True, discretized_max_bins=max_bins)
    assert got.to_json() == want.to_json()
    kinds = {c.name: c.type.value for c in got.columns}
    assert kinds == {"x": "DISCRETIZED_NUMERICAL",
                     "k": "DISCRETIZED_NUMERICAL", "b": "BOOLEAN",
                     "c": "CATEGORICAL", "near": "DISCRETIZED_NUMERICAL",
                     "f32": "NUMERICAL", "label": "NUMERICAL"}
    for v in (cols["x"][~np.isnan(cols["x"])], cols["k"], cols["near"]):
        assert pspec.discretized_boundaries(v, max_bins) == \
            jspec._discretized_boundaries(v, max_bins)


@pytest.mark.parametrize("num_bins", [32, 256])
def test_binner_on_stored_boundaries_equals_the_jax_package(num_bins):
    """The stored boundaries cast to f32 (the "near" column's collide:
    its bins skip an empty one) and thinned by linspace / round when
    there are more than num_bins - 1; the bins bitwise."""
    require_jax()
    from ydf_tpu.dataset.binning import Binner as JaxBinner
    from ydf_tpu.dataset.dataset import Dataset as JaxDataset

    cols = columns()
    ds = Dataset.from_data(cols, label="label",
                           detect_numerical_as_discretized=True)
    jds = JaxDataset.from_data(cols, label="label",
                               detect_numerical_as_discretized=True)
    feats = ["x", "k", "b", "c", "near", "f32"]
    got = Binner.fit(ds, feats, num_bins=num_bins)
    want = JaxBinner.fit(jds, feats, num_bins=num_bins)
    assert got.to_json() == want.to_json()
    near = got.feature_names.index("near")
    b = got.boundaries[near, :got.feature_num_bins[near] - 1]
    assert len(np.unique(b)) < len(b)  # collided boundaries
    bins = got.transform(ds, "cpu").numpy()
    assert np.array_equal(bins, want.transform(jds, impl="numpy"))
    counts = np.bincount(bins[:, near], minlength=len(b) + 1)
    assert (counts == 0).any()


def test_discretized_inputs_stay_numerical_at_train_time():
    """A learner without the flag keeps NUMERICAL columns; with it, the
    inferred numerical features are discretized."""
    cols = columns(600)
    hp = dict(label="label", num_trees=2, device="cpu")
    plain = ydf_tpu_torch.GradientBoostedTreesLearner(**hp).train(cols)
    disc = ydf_tpu_torch.GradientBoostedTreesLearner(
        discretize_numerical_columns=True, num_discretized_numerical_bins=9,
        **hp).train(cols)
    assert plain.dataspec.column_by_name("x").type.value == "NUMERICAL"
    col = disc.dataspec.column_by_name("x")
    assert col.type.value == "DISCRETIZED_NUMERICAL"
    assert len(col.discretized_boundaries) <= 8
    i = disc.binner.feature_names.index("x")
    assert np.array_equal(
        disc.binner.boundaries[i, :len(col.discretized_boundaries)],
        np.asarray(col.discretized_boundaries, np.float32))
    spec = ydf_tpu_torch.GradientBoostedTreesLearner.hyperparameter_spec()
    assert spec["num_discretized_numerical_bins"].min_value == 2
    assert spec["discretize_numerical_columns"].default is False


def fixture():
    with open(os.path.join(TRAIN_DISCRETIZED, "config.json")) as f:
        cfg = json.load(f)
    return cfg, np.load(os.path.join(TRAIN_DISCRETIZED, "expected.npz"))


@pytest.mark.parametrize("run", ["gbt", "gbt_256", "gbt_bins_40", "rf",
                                 "cart", "if"])
def test_small_runs_equal_the_fixture(tmp_path, run):
    cfg, exp = fixture()
    rc = cfg["small"]["runs"][run]
    train, test = chip_smoke.make_frame(cfg["small"]["rows"],
                                        cfg["small"]["test_rows"])
    m = getattr(ydf_tpu_torch, rc["learner"])(
        device="cpu", **rc["learner_args"]).train(train)
    assert chip_smoke.check_run_trees(exp, run, m) == rc["num_trees"]
    pred = np.asarray(m.predict(test))
    assert chip_smoke.same_bits(pred, exp[f"{run}/predictions"])
    assert chip_smoke.array_sha256(pred) == rc["predictions_sha256"]
    if "export_sha256" in rc:
        m.save_ydf(str(tmp_path / "m"))
        assert chip_smoke.file_sha256s(str(tmp_path / "m")) == \
            rc["export_sha256"]
        back = ydf_tpu_torch.load_model(str(tmp_path / "m"), device="cpu")
        assert chip_smoke.same_bits(np.asarray(back.predict(test)), pred)


def test_discretized_model_serves_on_the_bank(tmp_path):
    """A GBT trained on discretized columns imputes at encode time: the
    bank takes it (registry's first choice); its YDF import routes
    missing values natively and serves routed."""
    cols = columns(800)
    m = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", num_trees=3, discretize_numerical_columns=True,
        device="cpu").train(cols)
    from ydf_tpu_torch.serving import bank_scorer

    assert bank_scorer.in_envelope(m)
    assert m.list_compatible_engines()[0] == "BankScorer"
    m.save_ydf(str(tmp_path / "m"))
    back = ydf_tpu_torch.load_model(str(tmp_path / "m"), device="cpu")
    assert back.native_missing and back.list_compatible_engines() == [
        "Routed"]
    assert chip_smoke.same_bits(np.asarray(back.predict(cols)),
                                np.asarray(m.predict(cols)))
