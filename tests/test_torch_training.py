"""ydf_tpu_torch training slice held against the JAX package: dataspec
inference, Binner fit and transform, the grower on the same stats, and
GradientBoostedTreesLearner.train end to end (binomial and squared
error), plus the learner's surface and the committed train_bench
fixture's configuration.

Which JAX implementations the comparisons run against (named, never
"auto"): the grower and the learners use the JAX package's CPU path,
the native histogram and the native fused routing (hist_impl="native",
route_impl="native"), whose structure the port follows (root histogram,
fused route + histogram per deeper layer, standalone last route).

Tolerances, and why:
  * int8 stats: every node array bitwise (integer accumulation is exact
    in both packages);
  * f32 stats: every node array bitwise too (the port rounds the
    histograms once from f64 sums, as the JAX package's f64 block
    partials do, and replays its f32 root totals and prefix sums over
    bins: ops/histogram.py:sum_rows_f32, utils/prng.py:cumsum_f32);
  * end to end: the same trees at these seeds; the train loss within
    rtol 1e-5 and predictions within 1e-5 (the sigmoid and the f32 sums
    round differently in torch and XLA by an ulp or so).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import json
import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.dataset.binning import Binner as JaxBinner
    from ydf_tpu.dataset.dataset import Dataset as JaxDataset
    from ydf_tpu.dataset.dataspec import ColumnType as JaxColumnType
    from ydf_tpu.models.forest import Forest as JaxForest
    from ydf_tpu.ops import grower as jax_grower
    from ydf_tpu.ops.routing import forest_predict_values as jax_routed
    from ydf_tpu.ops.split_rules import HessianGainRule as JaxRule
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task, TreeConfig
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import Dataset
from ydf_tpu_torch.dataset.dataspec import ColumnType
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.learners.losses import BinomialLogLikelihood
from ydf_tpu_torch.ops import grower
from ydf_tpu_torch.ops.split_rules import HessianGainRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
TRAIN_BENCH = os.path.join(REPO, "ydf_tpu_torch", "testdata", "train_bench")
STRUCTURE = ("feature", "threshold_bin", "left", "right", "is_leaf",
             "num_nodes", "cat_mask", "threshold")
HP = dict(num_trees=5, max_depth=4, validation_ratio=0.0,
          early_stopping="NONE")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def make_data(n, features, seed):
    """The bench's synthetic Higgs-like table at a small size: normal
    features, a binary label from a non-linear logit, and a float
    regression label; one column carries NaNs."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, features)).astype(np.float32)
    logit = (x[:, 0] - 0.5 * x[:, 1] + np.sin(2 * x[:, 2])
             + x[:, 3] * x[:, 4])
    data = {f"f{i}": x[:, i] for i in range(features)}
    data["f5"] = np.where(rng.uniform(size=n) < 0.05, np.nan,
                          data["f5"]).astype(np.float32)
    data["label"] = (rng.uniform(size=n)
                     < 1 / (1 + np.exp(-logit))).astype(np.int64)
    data["y"] = (logit + rng.normal(0, 0.3, n)).astype(np.float32)
    return data


@pytest.fixture(scope="module")
def trained():
    """kind -> (JAX model, port model trained on the CPU, train data):
    the two JAX training runs of this file."""
    require_jax()
    data = make_data(4000, 8, seed=0)
    out = {}
    for kind, label, task in (
        ("binomial", "label", Task.CLASSIFICATION),
        ("squared_error", "y", Task.REGRESSION),
    ):
        drop = "y" if label == "label" else "label"
        d = {k: v for k, v in data.items() if k != drop}
        jm = ydf.GradientBoostedTreesLearner(
            label=label, task=JaxTask(task.value), **HP).train(d)
        pm = ydf_tpu_torch.GradientBoostedTreesLearner(
            label=label, task=task, device="cpu", **HP).train(d)
        out[kind] = (jm, pm, d)
    return out


@pytest.mark.parametrize("kind", ["binomial", "squared_error"])
def test_learner_grows_the_same_trees(trained, kind):
    jm, pm, _ = trained[kind]
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    for field in STRUCTURE:
        assert jf[field].dtype == pf[field].dtype, field
        assert np.array_equal(jf[field], pf[field]), field
    np.testing.assert_allclose(pf["leaf_value"], jf["leaf_value"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pf["cover"], jf["cover"], rtol=1e-6)
    assert pm.num_trees_per_iter == 1 and pm.loss_name == jm.loss_name


@pytest.mark.parametrize("kind", ["binomial", "squared_error"])
def test_learner_loss_and_predictions_within_tolerance(trained, kind):
    jm, pm, d = trained[kind]
    np.testing.assert_allclose(pm.training_logs["train_loss"],
                               jm.training_logs["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(pm.initial_predictions,
                               jm.initial_predictions, rtol=1e-6)
    fresh = {k: v for k, v in make_data(1500, 8, seed=9).items()
             if k in d and k not in ("label", "y")}
    np.testing.assert_allclose(pm.predict(fresh), jm.predict(fresh),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["binomial", "squared_error"])
def test_port_forest_scored_by_jax_routed_scorer(trained, kind):
    """The reverse carry-over: the port-trained forest's arrays, scored
    by the JAX package's routed engine, equal the port's own raw scores
    (its serving engine) bitwise."""
    jm, pm, d = trained[kind]
    fresh = make_data(1200, 8, seed=11)
    got = pm._raw_scores(fresh, combine="sum")[:, 0]
    x_num, x_cat, _ = jm._encode_inputs(
        JaxDataset.from_data(fresh, dataspec=jm.dataspec))
    want = np.asarray(jax_routed(
        JaxForest.from_numpy(pm.forest.to_numpy()), jnp.asarray(x_num),
        jnp.asarray(x_cat), num_numerical=pm.binner.num_numerical,
        max_depth=pm.max_depth, combine="sum"))[:, 0]
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_dataspec_and_label_encoding_match_jax(trained):
    jm, pm, d = trained["binomial"]
    assert [c.to_json() for c in pm.dataspec.columns] == [
        c.to_json() for c in jm.dataspec.columns]
    assert pm.classes == jm.classes
    jds = JaxDataset.from_data(
        d, label="label", column_types={"label": JaxColumnType.CATEGORICAL})
    pds = Dataset.from_data(
        d, label="label", column_types={"label": ColumnType.CATEGORICAL})
    assert np.array_equal(
        pds.encoded_label("label", Task.CLASSIFICATION),
        jds.encoded_label("label", JaxTask.CLASSIFICATION))


def ingest_frame(n, seed):
    """Dense normals, a column with NaNs, a low-cardinality integer
    column (the midpoint path), a boolean column."""
    rng = np.random.default_rng(seed)
    return {
        "dense": rng.normal(size=n).astype(np.float32),
        "holes": np.where(rng.uniform(size=n) < 0.1, np.nan,
                          rng.exponential(size=n)).astype(np.float32),
        "levels": rng.integers(0, 40, n),
        "flag": rng.uniform(size=n) < 0.3,
        "y": rng.integers(0, 2, n),
    }


@pytest.mark.parametrize("n", [3001, 210_000])  # 210k: the sampled path
def test_binner_fit_and_transform_match_jax(n):
    require_jax()
    data = ingest_frame(n, seed=n)
    feats = ["dense", "holes", "levels", "flag"]
    jds = JaxDataset.from_data(
        data, label="y", column_types={"y": JaxColumnType.CATEGORICAL})
    pds = Dataset.from_data(
        data, label="y", column_types={"y": ColumnType.CATEGORICAL})
    assert [c.to_json() for c in pds.dataspec.columns] == [
        c.to_json() for c in jds.dataspec.columns]
    jb = JaxBinner.fit(jds, feats, num_bins=256)
    pb = Binner.fit(pds, feats, num_bins=256)
    assert pb.to_json() == jb.to_json()
    assert pb.boundaries.tobytes() == jb.boundaries.tobytes()
    got = pb.transform(pds, torch.device("cpu")).numpy()
    assert np.array_equal(got, jb.transform(jds, impl="numpy"))
    carried = ydf_tpu_torch.binner_from_jax(jb.to_json())
    assert carried.boundaries.tobytes() == jb.boundaries.tobytes()


def grower_inputs(n=5000, F=8, seed=2):
    """Bins and binomial [g, h, w] stats as numpy, fed to both growers."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 64, (n, F)).astype(np.uint8)
    score = (bins[:, 0].astype(np.float32) / 32 - 1
             + 0.5 * np.sin(bins[:, 1] / 9.0) - (bins[:, 2] > 40))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-score))).astype(np.float32)
    p = np.float32(0.4)
    g = (p - y).astype(np.float32)
    h = np.full(n, p * (1 - p), np.float32)
    w = np.ones(n, np.float32)
    return bins, np.stack([g * w, h * w, w], axis=1)


@pytest.mark.parametrize("quant", ["int8", "f32"])
def test_grower_matches_jax_on_the_same_stats(quant):
    require_jax()
    bins, stats = grower_inputs()
    cfg = TreeConfig(max_depth=5, max_frontier=16, num_bins=64,
                     min_examples=5)
    kw = dict(max_depth=cfg.max_depth, frontier=cfg.frontier,
              max_nodes=cfg.max_nodes, num_bins=cfg.num_bins,
              min_examples=cfg.min_examples)
    want = jax_grower.grow_tree(
        jnp.asarray(bins), jnp.asarray(stats), jax.random.PRNGKey(0),
        hist_impl="native", hist_quant=quant, hist_subtract=True,
        route_impl="native", route_fuse=True, rule=JaxRule(),
        num_numerical=bins.shape[1], **kw)
    got = grower.grow_tree(
        torch.from_numpy(bins.T.copy()), torch.from_numpy(stats),
        rule=HessianGainRule(), hist_quant=quant, **kw)
    wt = {k: np.asarray(v) for k, v in want.tree._asdict().items()}
    gt = {k: v.numpy() for k, v in got.tree._asdict().items()}
    gt["cat_mask"] = gt["cat_mask"].view(np.uint32)
    assert int(wt["num_nodes"]) > 15  # a real tree, several layers deep
    for field in ("feature", "threshold_bin", "left", "right", "is_leaf",
                  "num_nodes", "cat_mask", "is_cat", "is_set"):
        assert np.array_equal(gt[field], wt[field]), field
    assert np.array_equal(got.leaf_id.numpy(), np.asarray(want.leaf_id))
    assert np.array_equal(gt["leaf_stats"], wt["leaf_stats"])


def test_sibling_reconstruction_matches_direct_histograms():
    """Each layer's reconstructed histogram (parent - smaller child)
    equals the directly computed one, on integer-valued stats where
    both are exact."""
    bins, _ = grower_inputs(n=3000, F=4, seed=5)
    rng = np.random.default_rng(6)
    stats = rng.integers(-4, 5, (3000, 3)).astype(np.float32)
    stats[:, 2] = 1.0
    bins_t = torch.from_numpy(bins.T.copy())
    from ydf_tpu_torch.ops.histogram import histogram

    root = histogram(bins_t, torch.zeros(3000, dtype=torch.int32),
                     torch.from_numpy(stats), 1, 64)
    left_rows = bins[:, 0] <= 20
    slot2 = torch.from_numpy(np.where(left_rows, 0, 1).astype(np.int32))
    direct = histogram(bins_t, slot2, torch.from_numpy(stats), 2, 64)
    small_is_left = torch.tensor([left_rows.sum() <= (~left_rows).sum()])
    small = direct[0:1] if small_is_left[0] else direct[1:2]
    rebuilt = grower.sibling_reconstruct(small, root, small_is_left, 2)
    assert torch.equal(rebuilt, direct)


def test_learner_surface_raises_for_what_is_not_ported():
    kw = dict(label="label", device="cpu")
    cases = [
        dict(validation_ratio=0.0, dart_dropout=0.1),
        dict(validation_ratio=0.0, subsample=0.5),
        dict(validation_ratio=0.0, sampling_method="GOSS"),
        dict(validation_ratio=0.0, num_candidate_attributes=3),
        dict(validation_ratio=0.0, split_axis="SPARSE_OBLIQUE"),
        dict(validation_ratio=0.0, monotonic_constraints={"f0": 1}),
        dict(validation_ratio=0.0, task=Task.RANKING),
    ]
    for extra in cases:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ydf_tpu_torch.GradientBoostedTreesLearner(**{**kw, **extra})
    data = make_data(300, 6, seed=1)
    # Ported since: the validation split with early stopping (the
    # defaults) and categorical input columns both train.
    split = ydf_tpu_torch.GradientBoostedTreesLearner(
        validation_ratio=0.1, num_trees=2, **kw).train(data)
    assert split.training_logs["valid_loss"] is not None
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(
        validation_ratio=0.0, num_trees=2, **kw)
    cat = learner.train({**data, "c": np.array(["a", "b", "c"] * 100)})
    assert "c" in cat.binner.feature_names[cat.binner.num_numerical:]
    multi = {**data, "label": np.arange(300) % 3}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        learner.train(multi)
    with pytest.raises(NotImplementedError, match="loss"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            loss="POISSON", validation_ratio=0.0, **kw).train(data)


def test_learner_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="label", validation_ratio=0.0)


def test_train_bench_fixture_matches_chip_smoke_constants():
    """The committed fixture was written for the configuration
    chip_smoke.py trains."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(TRAIN_BENCH, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["rows"] == smoke.TRAIN_ROWS
    assert cfg["features"] == smoke.TRAIN_FEATURES
    assert cfg["learner"] == smoke.TRAIN_HP
    assert cfg["data_seed"] == smoke.DATA_SEED
    assert cfg["request_rows"] == smoke.TRAIN_REQUEST_ROWS
    assert cfg["request_seed"] == smoke.REQUEST_SEED
    assert set(cfg["jax_impls"]) == {"hist_impl", "route_impl",
                                     "update_uses_fma", "hist_quant"}
    size = sum(os.path.getsize(os.path.join(TRAIN_BENCH, f))
               for f in os.listdir(TRAIN_BENCH))
    assert size < 1 << 20


def test_train_bench_data_generator_matches_bench():
    """chip_smoke.py's copy of the bench's data generator gives the
    bench's rows."""
    require_jax()
    import importlib.util

    import bench

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want, x, y = bench.make_data(3000, 28)
    got = smoke.make_data(3000, 28)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# ---- on the card -------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.gpu
def test_train_on_card_grows_the_cpu_port_trees():
    """The learner on the card and on the CPU, same data: the same trees
    at this seed. Leaf values within 2e-5 (+ rtol 1e-4) and predictions
    within 1e-4: the card sums each histogram cell in f32 (the plain
    version in f64), sibling subtraction and the prefix sums carry that
    rounding, and a leaf's gradient sum is a small difference of large
    sums (measured on the H100: 5.6e-6 at most, one leaf of 155)."""
    _need_card()
    d = {k: v for k, v in make_data(20_000, 8, seed=3).items() if k != "y"}
    card = ydf_tpu_torch.GradientBoostedTreesLearner(label="label", **HP)
    cm = card.train(d)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", device="cpu", **HP).train(d)
    assert cm.device.type == "cuda"
    cf, pf = cm.forest.to_numpy(), pm.forest.to_numpy()
    for field in STRUCTURE:
        assert np.array_equal(cf[field], pf[field]), field
    np.testing.assert_allclose(cf["leaf_value"], pf["leaf_value"],
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(cm.training_logs["train_loss"],
                               pm.training_logs["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(cm.predict(d), pm.predict(d), atol=1e-4)


@pytest.mark.gpu
def test_boosting_loop_does_not_sync_with_the_host():
    """boost() runs its loop under torch's sync debug mode "error", so
    finishing the loop shows that no tree made the host wait on the
    card; the mode is restored after it."""
    _need_card()
    rng = np.random.default_rng(4)
    n = 50_000
    bins_t = torch.from_numpy(rng.integers(0, 256, (8, n)).astype(
        np.uint8)).cuda()
    labels = torch.from_numpy((rng.uniform(size=n) < 0.4).astype(
        np.float32)).cuda()
    weights = torch.ones(n, device="cuda")
    cfg = TreeConfig(max_depth=6, max_frontier=32, num_bins=256)
    out = port_gbt.boost(
        bins_t, labels, weights, loss_obj=BinomialLogLikelihood(),
        rule=HessianGainRule(), tree_cfg=cfg, num_trees=3, shrinkage=0.1)
    assert torch.cuda.get_sync_debug_mode() == 0  # restored
    assert out[0].feature.shape == (3, cfg.max_nodes)
    assert torch.isfinite(out[2]).all()
