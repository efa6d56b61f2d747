"""ydf_tpu_torch serving path held against the JAX package: loading,
the parameter carry-over (forest_from_jax), encoding, end-to-end
predict, the engine registry, the device default, the committed
fixtures, and the port's isolation from JAX.

Raw scores compare bitwise (every engine adds one f32 per tree in tree
order). Predictions compare bitwise too: the port applies the link in
numpy float32 with the JAX package's expressions (gbt_model.py:18).
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import pandas as pd

    import ydf_tpu as ydf
    from ydf_tpu.config import Task
    from ydf_tpu.dataset.dataset import Dataset as JaxDataset
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.dataset.dataset import Dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The suite runs in parallel workers: one intra-op thread per worker keeps
# these tests from crowding the timing-sensitive tests of other files.
torch.set_num_threads(1)
TESTDATA = os.path.join(REPO, "ydf_tpu_torch", "testdata")
FIXTURES = ("gbt_d6", "gbt_d8")


def make_data(n, seed):
    """3 numerical columns with NaNs, 2 categorical columns, and both a
    regression and a binary label."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    c0 = rng.integers(0, 5, n)
    c1 = rng.integers(0, 30, n)
    logit = (x[:, 0] * x[:, 1] - x[:, 2] + 1.2 * (c0 == 2)
             - 0.1 * (c1 % 5))
    data = {
        "n0": np.where(rng.uniform(size=n) < 0.1, np.nan, x[:, 0]),
        "n1": np.where(rng.uniform(size=n) < 0.05, np.nan, x[:, 1]),
        "n2": x[:, 2],
        "c0": np.array([f"k{v}" for v in c0]),
        "c1": np.array([f"m{v}" for v in c1]),
    }
    data["n0"] = data["n0"].astype(np.float32)
    data["n1"] = data["n1"].astype(np.float32)
    y_reg = (logit + rng.normal(0, 0.3, n)).astype(np.float32)
    y_cls = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    return data, y_reg, y_cls


def make_queries(n=1200, seed=21):
    """Scoring inputs: NaNs, missing ("") and unseen categories."""
    data, _, _ = make_data(n, seed)
    rng = np.random.default_rng(seed + 1)
    for c in ("c0", "c1"):
        col = data[c].astype("<U8")
        col[rng.uniform(size=n) < 0.05] = "never"
        col[rng.uniform(size=n) < 0.03] = ""
        data[c] = col
    return data


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """name → (JAX model, saved directory): a binary classifier at
    depth 4 and a regressor at depth 6, both on mixed features."""
    require_jax()
    data, y_reg, y_cls = make_data(2500, seed=4)
    out = {}
    for name, task, y, depth in (
        ("cls_d4", Task.CLASSIFICATION, y_cls, 4),
        ("reg_d6", Task.REGRESSION, y_reg, 6),
    ):
        m = ydf.GradientBoostedTreesLearner(
            label="y", task=task, num_trees=14, max_depth=depth,
            validation_ratio=0.0, early_stopping="NONE",
        ).train({**data, "y": y})
        path = str(tmp_path_factory.mktemp(name))
        m.save(path)
        out[name] = (m, path)
    return out


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


@pytest.mark.parametrize("name", ["cls_d4", "reg_d6"])
def test_forest_from_jax_carries_every_array(trained, name):
    m, path = trained[name]
    want = m.forest.to_numpy()
    got = ydf_tpu_torch.forest_from_jax(want).to_numpy()
    assert set(got) == set(want)
    for k in want:
        assert bytes_equal(got[k], want[k]), k
    loaded = ydf_tpu_torch.load_model(path, device="cpu")
    for k, v in loaded.forest.to_numpy().items():
        assert bytes_equal(v, want[k]), k
    assert loaded.max_depth == m.max_depth
    assert np.array_equal(loaded.initial_predictions, m.initial_predictions)


def test_forest_from_jax_backfills_old_saves(trained):
    m, _ = trained["reg_d6"]
    f = m.forest.to_numpy()
    for k in ("na_left", "is_set", "cover", "oblique_weights",
              "oblique_na_repl", "vs_anchor", "vs_feat", "vs_is_closer"):
        f.pop(k)
    from ydf_tpu.models.forest import Forest as JaxForest

    want = JaxForest.from_numpy(f).to_numpy()
    got = ydf_tpu_torch.forest_from_jax(f).to_numpy()
    for k in want:
        assert bytes_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["cls_d4", "reg_d6"])
def test_encoding_matches_jax(trained, name):
    m, path = trained[name]
    pm = ydf_tpu_torch.load_model(path, device="cpu")
    q = make_queries()
    want_num, want_cat, _ = m._encode_inputs(
        JaxDataset.from_data(q, dataspec=m.dataspec)
    )
    for data in (q, pd.DataFrame(q)):
        got_num, got_cat = pm._encode_inputs(
            Dataset.from_data(data, pm.dataspec)
        )
        assert bytes_equal(got_num, want_num)
        assert bytes_equal(got_cat, want_cat)
    # Object columns (None / NaN cells) and numbers as categories.
    obj = dict(q)
    obj["c0"] = np.array([None, float("nan"), "k1", "NA", 3] * 240,
                         dtype=object)
    want = JaxDataset.from_data(obj, dataspec=m.dataspec)
    got = Dataset.from_data(obj, pm.dataspec)
    assert np.array_equal(got.encoded_categorical("c0"),
                          want.encoded_categorical("c0"))
    num = {"c1": np.array([1.0, 2.5, np.nan, 7.0] * 10)}
    assert np.array_equal(
        Dataset.from_data(num, pm.dataspec).encoded_categorical("c1", -1),
        JaxDataset.from_data(num, dataspec=m.dataspec)
        .encoded_categorical("c1", missing_code=-1),
    )


@pytest.mark.parametrize("name", ["cls_d4", "reg_d6"])
@pytest.mark.parametrize("engine", [None, "BankScorer", "Routed"])
def test_predict_matches_jax_end_to_end(trained, name, engine):
    m, path = trained[name]
    pm = ydf_tpu_torch.load_model(path, device="cpu")
    pm.force_engine(engine)
    q = make_queries()
    want_raw = m._raw_scores(q, combine="sum")[:, 0]
    got_raw = pm._raw_scores(q, combine="sum")[:, 0]
    assert bytes_equal(got_raw, want_raw)
    assert bytes_equal(pm.predict(q), m.predict(q))
    assert bytes_equal(pm.predict(pd.DataFrame(q)), m.predict(q))


def test_predict_links_and_multi_output(trained):
    """Poisson's exp link, raw margins without the link, and the
    per-dimension loop of K > 1 outputs, in both packages."""
    m, path = trained["reg_d6"]
    q = make_queries(n=300)
    for attr, value in (("loss_name", "POISSON"),
                        ("apply_link_function", False)):
        pm = ydf_tpu_torch.load_model(path, device="cpu")
        old = getattr(m, attr)
        setattr(m, attr, value)
        setattr(pm, attr, value)
        try:
            assert bytes_equal(pm.predict(q), m.predict(q)), attr
        finally:
            setattr(m, attr, old)
    pm = ydf_tpu_torch.load_model(path, device="cpu")
    init = np.array([0.25, -0.5], np.float32)
    old_init = m.initial_predictions
    m.num_trees_per_iter, m.initial_predictions = 2, init
    pm.num_trees_per_iter, pm.initial_predictions = 2, init
    try:
        got = pm.predict(q)
        assert got.shape == (300, 2)
        assert bytes_equal(got, m.predict(q))
        assert pm.forest.num_trees == 14  # the full forest is restored
    finally:
        m.num_trees_per_iter, m.initial_predictions = 1, old_init


def test_registry_ranks_and_forcing(trained):
    pm = ydf_tpu_torch.load_model(trained["reg_d6"][1], device="cpu")
    assert pm.list_compatible_engines() == [
        "QuickScorer", "BankScorer", "Routed"]
    from ydf_tpu_torch.serving import quickscorer

    assert isinstance(pm._fast_engine(), quickscorer.QuickScorerEngine)
    d8 = ydf_tpu_torch.load_model(os.path.join(TESTDATA, "gbt_d8"),
                                  device="cpu")
    assert d8.list_compatible_engines() == ["BankScorer", "Routed"]
    from ydf_tpu_torch.serving import bank_scorer

    assert isinstance(d8._fast_engine(), bank_scorer.BankScorerEngine)
    with pytest.raises(ValueError, match="not compatible"):
        d8.force_engine("QuickScorer")
    with pytest.raises(ValueError, match="Unknown engine"):
        pm.force_engine("PallasBank")
    pm.force_engine("Routed")
    assert pm._fast_engine() is None
    pm.force_engine(None)
    assert pm._fast_engine() is not None


def test_load_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ydf_tpu_torch.load_model(os.path.join(TESTDATA, "gbt_d6"))


@pytest.mark.parametrize("name", FIXTURES)
def test_committed_fixture_is_fresh(name):
    """The JAX package reproduces the committed expected.npz, and the
    port's CPU path matches it bitwise."""
    require_jax()
    d = os.path.join(TESTDATA, name)
    req = dict(np.load(os.path.join(d, "requests.npz")))
    exp = np.load(os.path.join(d, "expected.npz"))
    m = ydf.load_model(d)
    assert bytes_equal(m._raw_scores(req, combine="sum")[:, 0], exp["raw"])
    assert bytes_equal(m.predict(req), exp["predictions"])
    pm = ydf_tpu_torch.load_model(d, device="cpu")
    assert bytes_equal(pm._raw_scores(req, combine="sum")[:, 0], exp["raw"])
    assert bytes_equal(pm.predict(req), exp["predictions"])


def _port_sources():
    pkg = os.path.join(REPO, "ydf_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    banned = ("jax", "jaxlib", "flax", "ydf_tpu")
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_import_leaves_no_jax_in_sys_modules():
    code = (
        "import sys, ydf_tpu_torch\n"
        "from ydf_tpu_torch.serving import registry\n"
        "from ydf_tpu_torch.learners import gbt\n"
        "from ydf_tpu_torch.ops import grower, histogram_kernels, binning\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ydf_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("name", FIXTURES)
def test_predict_on_card_matches_jax(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from ydf_tpu_torch.serving import bank_scorer, quickscorer

    d = os.path.join(TESTDATA, name)
    req = dict(np.load(os.path.join(d, "requests.npz")))
    exp = np.load(os.path.join(d, "expected.npz"))
    pm = ydf_tpu_torch.load_model(d)
    assert pm.device.type == "cuda"
    for engine in pm.list_compatible_engines():
        pm.force_engine(engine)
        launched = quickscorer.KERNEL_LAUNCHES + bank_scorer.KERNEL_LAUNCHES
        assert bytes_equal(pm._raw_scores(req, combine="sum")[:, 0],
                           exp["raw"]), engine
        assert bytes_equal(pm.predict(req), exp["predictions"]), engine
        after = quickscorer.KERNEL_LAUNCHES + bank_scorer.KERNEL_LAUNCHES
        assert after > launched or engine == "Routed"
