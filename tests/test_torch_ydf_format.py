"""The reference YDF model format in ydf_tpu_torch, held against the JAX
package: the wire codec (utils/protowire.py), the importer and the
exporter (models/ydf_format.py), load_model's routing to them, and the
DISCRETIZED_NUMERICAL columns an imported or JAX-trained model serves.

Nothing here has a tolerance: imports predict bitwise what the JAX
package's load_ydf_model predicts, and exports write the bytes its
export_ydf_model writes (compared file by file, not by loading them).
The committed fixture ydf_tpu_torch/testdata/ydf_format/ holds the JAX
exports, their SHA-256 and the JAX importer's predictions and leaves
(`python scripts/make_torch_port_fixtures.py --only ydf_format`).
"""

import filecmp
import gzip
import hashlib
import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import ydf_tpu as ydf
    from ydf_tpu.models import ydf_format as jax_format
    from ydf_tpu.utils import protowire as jax_pw
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.dataset.dataspec import ColumnType
from ydf_tpu_torch.models import ydf_format
from ydf_tpu_torch.utils import protowire as pw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "ydf_tpu_torch", "testdata")
FORMAT = os.path.join(TESTDATA, "ydf_format")
torch.set_num_threads(1)

with open(os.path.join(FORMAT, "config.json")) as _f:
    CONFIG = json.load(_f)
MODELS = sorted(CONFIG["models"])


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def requests(name):
    with np.load(os.path.join(TESTDATA,
                              CONFIG["models"][name]["requests"])) as z:
        return {k: z[k] for k in z.files}


def make_data(n, seed):
    """Numerical columns with NaNs, a boolean-valued and two categorical
    columns, and a binary label."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    c0 = rng.integers(0, 5, n)
    c1 = rng.integers(0, 40, n)
    logit = x[:, 0] * x[:, 1] - x[:, 2] + 1.2 * (c0 == 2) - 0.05 * c1
    data = {
        "n0": np.where(rng.uniform(size=n) < 0.1, np.nan, x[:, 0]).astype(
            np.float32),
        "n1": np.where(rng.uniform(size=n) < 0.05, np.nan,
                       x[:, 1]).astype(np.float32),
        "n2": x[:, 2],
        "c0": np.array([f"k{v}" for v in c0]),
        "c1": np.array([f"m{v}" for v in c1]),
        "y": (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(
            np.int64),
    }
    return data


# --------------------------------------------------------------------- #
# Wire codec
# --------------------------------------------------------------------- #

VARINTS = [0, 1, 127, 128, 300, 2**31 - 1, 2**32, 2**63 - 1, -1, -2**31]


@pytest.mark.parametrize("value", VARINTS)
def test_varint_round_trip(value):
    enc = pw.encode_varint(value)
    got, pos = pw.read_varint(enc, 0)
    assert pos == len(enc)
    assert got == value & ((1 << 64) - 1)
    assert pw.get_sint(pw.decode(pw.put_int(3, value)), 3) == (
        value if value < 2**63 else value - 2**64)
    if ydf is not None:
        assert enc == jax_pw.encode_varint(value)


def _message(mod, seed):
    """A message of every field kind from seeded values, written with
    the wire module `mod` (the port's or the JAX package's)."""
    rng = np.random.default_rng(seed)
    f32 = rng.normal(size=7).astype(np.float32)
    f64 = rng.normal(size=5)
    ints = rng.integers(0, 2**40, 6).tolist()
    buf = (mod.put_int(1, ints[0]) + mod.put_bool(2, True)
           + mod.put_float(3, float(f32[0]))
           + mod.put_double(4, float(f64[0]))
           + mod.put_str(5, "naïve ütf-8") + mod.put_bytes(6, b"\x00\xff")
           + mod.put_msg(7, mod.put_int(1, 5) + mod.put_float(2, -0.0))
           + mod.put_packed_floats(8, f32) + mod.put_packed_doubles(9, f64)
           + mod.put_packed_varints(10, ints)
           + mod.put_msg(7, mod.put_int(1, 6)))
    return buf, f32, f64, ints


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_protowire_round_trip(seed):
    buf, f32, f64, ints = _message(pw, seed)
    m = pw.decode(buf)
    assert pw.get_int(m, 1) == ints[0]
    assert pw.get_bool(m, 2) is True
    assert np.float32(pw.get_float(m, 3)) == f32[0]
    assert pw.get_double(m, 4) == f64[0]
    assert pw.get_str(m, 5) == "naïve ütf-8"
    assert pw.get_bytes(m, 6) == b"\x00\xff"
    assert pw.get_int(pw.get_msg(m, 7), 1) == 6  # the last one wins
    assert [pw.get_int(x, 1) for x in pw.get_repeated_msg(m, 7)] == [5, 6]
    assert bytes_equal(pw.get_packed_floats(m, 8), f32)
    assert bytes_equal(pw.get_packed_doubles(m, 9), f64)
    assert pw.get_packed_varints(m, 10) == ints
    assert pw.get_int(m, 99, 17) == 17
    if ydf is not None:
        assert buf == _message(jax_pw, seed)[0]
        assert jax_pw.decode(buf) == m


def test_blob_sequence_gzip():
    """A version-1 blob sequence with a gzip body (compression = 1) reads
    the same records as the plain one, and a model whose node shard is
    so compressed loads to the same predictions."""
    import tempfile

    rng = np.random.default_rng(3)
    records = [rng.bytes(int(k)) for k in rng.integers(0, 300, 20)]
    with tempfile.TemporaryDirectory() as tmp:
        plain = os.path.join(tmp, "plain")
        ydf_format.write_blob_sequence(plain, records)
        with open(plain, "rb") as f:
            body = f.read()[8:]
        packed = os.path.join(tmp, "packed")
        with open(packed, "wb") as f:
            f.write(b"BS" + struct.pack("<H", 1) + b"\x01\x00\x00\x00"
                    + gzip.compress(body))
        assert list(ydf_format.read_blob_sequence(plain)) == records
        assert list(ydf_format.read_blob_sequence(packed)) == records

        src = os.path.join(FORMAT, "uplift_rf")
        d = os.path.join(tmp, "model")
        shutil.copytree(src, d)
        shard = os.path.join(d, "nodes-00000-of-00001")
        with open(shard, "rb") as f:
            body = f.read()[8:]
        with open(shard, "wb") as f:
            f.write(b"BS" + struct.pack("<H", 1) + b"\x01\x00\x00\x00"
                    + gzip.compress(body))
        req = requests("uplift_rf")
        a = ydf_tpu_torch.load_model(d, device="cpu").predict(req)
        b = ydf_tpu_torch.load_model(src, device="cpu").predict(req)
        assert bytes_equal(a, b)
    with pytest.raises(ValueError, match="bad magic"):
        list(ydf_format.read_blob_sequence(os.path.join(FORMAT,
                                                        "config.json")))


# --------------------------------------------------------------------- #
# Import
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", MODELS)
def test_import_matches_committed_jax_predictions(name):
    """The port's load_model of each committed YDF directory predicts
    and routes bitwise what the JAX package's load_ydf_model did when
    the fixture was written."""
    exp = np.load(os.path.join(FORMAT, "expected.npz"))
    req = requests(name)
    m = ydf_tpu_torch.load_model(os.path.join(FORMAT, name), device="cpu")
    assert m.native_missing
    assert m.extra_metadata["imported_from"] == "ydf"
    assert bytes_equal(m.predict(req), exp[f"{name}/predictions"])
    leaves = m.predict_leaves(req)
    assert leaves.dtype == np.int32
    assert np.array_equal(leaves, exp[f"{name}/leaves"])


@pytest.mark.parametrize("name", MODELS)
def test_import_matches_jax_loader(name):
    """Field by field, the imported forest, binner and dataspec are the
    JAX importer's."""
    require_jax()
    d = os.path.join(FORMAT, name)
    jm = jax_format.load_ydf_model(d)
    pm = ydf_format.load_ydf_model(d, device="cpu")
    assert type(pm).__name__ == type(jm).__name__
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    for k in jf:
        assert bytes_equal(np.asarray(jf[k]), pf[k]), k
    assert pm.binner.to_json() == jm.binner.to_json()
    assert pm.dataspec.to_json() == jm.dataspec.to_json()
    assert (pm.task.value, pm.label, pm.classes, pm.max_depth) == (
        jm.task.value, jm.label, jm.classes, jm.max_depth)
    assert pm.extra_metadata == jm.extra_metadata
    req = requests(name)
    assert bytes_equal(pm.predict(req), np.asarray(jm.predict(req)))


def test_prefixed_directory():
    d = os.path.join(FORMAT, "prefixed")
    assert ydf_format._detect_prefix(d) == "cart_"
    a = ydf_format.load_ydf_model(d, prefix="cart_", device="cpu")
    b = ydf_tpu_torch.load_model(d, device="cpu")
    req = requests("prefixed")
    assert bytes_equal(a.predict(req), b.predict(req))
    assert a.task.value == "CATEGORICAL_UPLIFT"


def test_ambiguous_prefix_raises(tmp_path):
    src = os.path.join(FORMAT, "gbt_d6")
    d = tmp_path / "multi"
    d.mkdir()
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), d / f"a_{f}")
        shutil.copy(os.path.join(src, f), d / f"b_{f}")
    with pytest.raises(ValueError, match="several models"):
        ydf_tpu_torch.load_model(str(d), device="cpu")
    m = ydf_format.load_ydf_model(str(d), prefix="b_", device="cpu")
    assert m.num_trees() == 300


def test_not_a_model_directory(tmp_path):
    assert not ydf_format.is_ydf_model_dir(str(tmp_path))
    with pytest.raises(ValueError, match="holds no model"):
        ydf_tpu_torch.load_model(str(tmp_path), device="cpu")


# --------------------------------------------------------------------- #
# Export
# --------------------------------------------------------------------- #


def _sha256s(d, prefix=""):
    out = {}
    for fname in sorted(os.listdir(d)):
        with open(os.path.join(d, fname), "rb") as f:
            out[fname[len(prefix):]] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.mark.parametrize("name", MODELS)
def test_export_matches_recorded_sha256(name, tmp_path):
    """The port's export of each fixture's source model (loaded from
    the JAX package's model.json) writes the files the JAX export wrote,
    and so does its export of the imported model."""
    cfg = CONFIG["models"][name]
    src = ydf_tpu_torch.load_model(os.path.join(TESTDATA, cfg["source"]),
                                   device="cpu")
    src.save_ydf(str(tmp_path / "a"))
    assert _sha256s(tmp_path / "a") == cfg["sha256"]
    imported = ydf_tpu_torch.load_model(os.path.join(FORMAT, name),
                                        device="cpu")
    ydf_format.export_ydf_model(imported, str(tmp_path / "b"))
    assert _sha256s(tmp_path / "b") == cfg["sha256"]
    assert _sha256s(os.path.join(FORMAT, name), cfg["prefix"]) == (
        cfg["sha256"])


@pytest.mark.parametrize("name", MODELS)
def test_export_byte_identical_to_jax(name, tmp_path):
    require_jax()
    src = os.path.join(TESTDATA, CONFIG["models"][name]["source"])
    jax_format.export_ydf_model(ydf.load_model(src), str(tmp_path / "j"))
    ydf_tpu_torch.load_model(src, device="cpu").save_ydf(
        str(tmp_path / "p"))
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "p"))
    for f in files:
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "p" / f,
                           shallow=False), f


@pytest.fixture(scope="module")
def port_trained():
    data = make_data(3000, 5)
    m = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="y", num_trees=8, max_depth=4, validation_ratio=0.0,
        early_stopping="NONE", device="cpu").train(data)
    return m, make_data(500, 6)


def test_port_export_loads_in_jax(port_trained, tmp_path):
    """A port-trained GBT's export: the JAX importer and the port's
    predict bitwise the same, and what the trained model predicts."""
    require_jax()
    m, test = port_trained
    m.save_ydf(str(tmp_path / "m"))
    jm = jax_format.load_ydf_model(str(tmp_path / "m"))
    pm = ydf_tpu_torch.load_model(str(tmp_path / "m"), device="cpu")
    want = m.predict(test)
    assert bytes_equal(np.asarray(jm.predict(test)), want)
    assert bytes_equal(pm.predict(test), want)
    jax_format.export_ydf_model(jm, str(tmp_path / "again"))
    for f in os.listdir(tmp_path / "m"):
        assert filecmp.cmp(tmp_path / "m" / f, tmp_path / "again" / f,
                           shallow=False), f


def test_jax_export_loads_in_port(tmp_path):
    """The reverse: a JAX-trained GBT with a categorical column, exported
    by the JAX package, predicts in the port what it predicts in JAX."""
    require_jax()
    data, test = make_data(3000, 7), make_data(500, 8)
    jm = ydf.GradientBoostedTreesLearner(
        label="y", num_trees=8, max_depth=4, validation_ratio=0.0,
        early_stopping="NONE").train(data)
    jm.save_ydf(str(tmp_path / "m"))
    pm = ydf_tpu_torch.load_model(str(tmp_path / "m"), device="cpu")
    assert bytes_equal(pm.predict(test), np.asarray(jm.predict(test)))
    ji = ydf.load_model(str(tmp_path / "m"))
    assert bytes_equal(pm.predict_leaves(test),
                       np.asarray(ji.predict_leaves(test)))


@pytest.fixture(scope="module")
def discretized():
    """A JAX GBT trained on DISCRETIZED_NUMERICAL columns, saved both
    ways."""
    require_jax()
    import tempfile

    data, test = make_data(3000, 9), make_data(500, 10)
    jm = ydf.GradientBoostedTreesLearner(
        label="y", num_trees=6, max_depth=4, validation_ratio=0.0,
        early_stopping="NONE", discretize_numerical_columns=True,
    ).train(data)
    tmp = tempfile.mkdtemp()
    jm.save(os.path.join(tmp, "json"))
    jm.save_ydf(os.path.join(tmp, "ydf"))
    yield jm, test, tmp
    shutil.rmtree(tmp)


@pytest.mark.parametrize("saved", ["json", "ydf"])
def test_discretized_numerical_serves(discretized, saved):
    """DISCRETIZED_NUMERICAL columns encode and serve as numerical ones:
    the JAX-saved model and its YDF export predict in the port what
    they predict in JAX; the binner fits on their stored boundaries as
    the JAX binner does."""
    jm, test, tmp = discretized
    d = os.path.join(tmp, saved)
    pm = ydf_tpu_torch.load_model(d, device="cpu")
    assert any(c.type == ColumnType.DISCRETIZED_NUMERICAL
               for c in pm.dataspec.columns)
    assert bytes_equal(pm.predict(test),
                       np.asarray(ydf.load_model(d).predict(test)))
    if saved == "json":
        assert bytes_equal(pm.predict(test), np.asarray(jm.predict(test)))
        from ydf_tpu_torch.dataset.binning import Binner
        from ydf_tpu_torch.dataset.dataset import Dataset

        from ydf_tpu.dataset.binning import Binner as JaxBinner
        from ydf_tpu.dataset.dataset import Dataset as JaxDataset

        ds = Dataset.from_data(test, dataspec=pm.dataspec)
        jds = JaxDataset.from_data(test, dataspec=jm.dataspec)
        assert Binner.fit(ds, ["n0", "c0"]).to_json() == JaxBinner.fit(
            jds, ["n0", "c0"]).to_json()
        # The binner bins an encoded DISCRETIZED_NUMERICAL column as a
        # numerical one, bitwise the JAX binner's bins.

        bins = pm.binner.transform(ds, "cpu").numpy()
        jbins = np.asarray(jm.binner.transform(
            JaxDataset.from_data(test, dataspec=jm.dataspec)))
        assert np.array_equal(bins, jbins[:, :bins.shape[1]])
        pm.save_ydf(os.path.join(tmp, "port_ydf"))
        for f in os.listdir(os.path.join(tmp, "ydf")):
            assert filecmp.cmp(os.path.join(tmp, "ydf", f),
                               os.path.join(tmp, "port_ydf", f),
                               shallow=False), f


@pytest.mark.gpu
@pytest.mark.parametrize("name", MODELS)
def test_import_on_card(name):
    """On the card an import serves routed (native missing values) and
    predicts bitwise the committed JAX predictions and leaves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    exp = np.load(os.path.join(FORMAT, "expected.npz"))
    req = requests(name)
    m = ydf_tpu_torch.load_model(os.path.join(FORMAT, name))
    assert m.device.type == "cuda"
    assert m.list_compatible_engines() == ["Routed"]
    assert bytes_equal(m.predict(req), exp[f"{name}/predictions"])
    assert np.array_equal(m.predict_leaves(req), exp[f"{name}/leaves"])
