"""The port's readers against the JAX package's: the CSV loader
(csrc/csv_loader.cc through dataset/native_csv.py) bitwise against
ydf_tpu.dataset.native_csv, typed, glob and sharded paths, TFRecord read
and write with its masked crc32c, Avro (null and deflate codecs, unions,
set and vector-sequence cells; the files come from chip_smoke's encoder,
the reference's Avro files being absent), polars / xarray / Grain
through duck-typed stand-ins, and the model's entry points on typed
paths (predict, evaluate, predict_tf_examples). Nothing falls back: a
failed loader build and a file the loader refuses raise.
"""

import gzip
import os
import sys
import types

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import ydf_tpu  # noqa: F401
except ImportError:
    ydf_tpu = None

import chip_smoke
import ydf_tpu_torch
from ydf_tpu_torch.dataset import avro, dataset, frame_io, native_csv, tfrecord
from ydf_tpu_torch.dataset.dataset import Dataset

torch.set_num_threads(1)


def require_jax():
    if ydf_tpu is None:
        pytest.skip("needs the JAX package, the reference")


def same_columns(a, b):
    """Two column dicts hold the same names, dtypes and values (floats
    bitwise, object cells by value)."""
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype.kind == "f":
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), k
        else:
            assert [np.asarray(v).tolist() if isinstance(v, np.ndarray)
                    else v for v in x.tolist()] == [
                np.asarray(v).tolist() if isinstance(v, np.ndarray) else v
                for v in y.tolist()], k


CSV = (
    'a,b,"c, quoted",d,e\n'
    '1.5,x,"he said ""hi""",,NA\n'
    '-2,y,plain,3e-5,\n'
    '\n'
    '+7,,"multi\nline",nan,N/A\n'
    '0.1,NaN,z,1e308,null\n'
)


def test_loader_bitwise_the_jax_loader(tmp_path):
    """Quoting, escaped quotes, embedded newlines, a blank line, pandas'
    NA markers, '+' signs and extreme floats: the same columns."""
    require_jax()
    from ydf_tpu.dataset import native_csv as jax_csv

    p = str(tmp_path / "a.csv")
    with open(p, "w") as f:
        f.write(CSV)
    got = native_csv.read_csv(p)
    same_columns(got, jax_csv.read_csv(p))
    assert got["a"].dtype == np.float64 and got["b"].dtype == object
    assert np.isnan(got["d"][2]) and got["b"][2] == "" and got["b"][3] == ""
    assert got["e"].dtype == object and list(got["e"]) == [""] * 4


def test_loader_on_fixture_floats_matches_pandas(tmp_path):
    """chip_smoke.csv_text writes each float in the shortest repr of its
    own type: the loader and pandas read those cells to the same bits
    (the two readers the JAX package picks between)."""
    pd = pytest.importorskip("pandas")
    train, _ = chip_smoke.make_frame(2000, 10)
    p = str(tmp_path / "f.csv")
    with open(p, "w") as f:
        f.write(chip_smoke.csv_text(train))
    got = native_csv.read_csv(p)
    ref = pd.read_csv(p)
    for k, v in got.items():
        if v.dtype.kind == "f":
            w = ref[k].to_numpy().astype(np.float64)
            assert np.array_equal(v.view(np.int64), w.view(np.int64)), k
            if train[k].dtype == np.float32:
                assert np.array_equal(v.astype(np.float32), train[k],
                                      equal_nan=True), k


def test_loader_refusal_raises_with_the_file(tmp_path):
    p = str(tmp_path / "bad.csv")
    with open(p, "w") as f:
        f.write("a,b\n1,2\n3\n")
    with pytest.raises(ValueError, match="bad.csv.*inconsistent"):
        native_csv.read_csv(p)
    with pytest.raises(ValueError, match="cannot open"):
        native_csv.read_csv(str(tmp_path / "missing.csv"))


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native_csv, "SOURCE", str(src))
    monkeypatch.setattr(native_csv, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native_csv, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="build failed.*broken.cc"):
        native_csv.build()
    assert not (tmp_path / "lib.so").exists()


@pytest.mark.parametrize("path, want", [
    ("csv:/x/a.csv", ("csv", "/x/a.csv")),
    ("/x/a.csv", ("csv", "/x/a.csv")),
    ("tfrecord:/x/a", ("tfrecord", "/x/a")),
    ("tfrecordv2+gz+tfe:/x/a", ("tfrecord", "/x/a")),
    ("tfrecord-nocompression:/x/a", ("tfrecord", "/x/a")),
    ("tfrecordv2+tfe:/x/a", ("tfrecord", "/x/a")),
    ("avro:/x/a.avro", ("avro", "/x/a.avro")),
])
def test_split_typed_path(path, want):
    assert dataset._split_typed_path(path) == want
    if ydf_tpu is not None:
        from ydf_tpu.dataset.dataset import _split_typed_path

        assert _split_typed_path(path) == want


def test_unknown_prefix_and_no_file_raise(tmp_path):
    with pytest.raises(ValueError, match="prefix 'parquet'"):
        dataset._split_typed_path("parquet:/x")
    with pytest.raises(FileNotFoundError):
        dataset._resolve_typed_path(f"csv:{tmp_path}/none-*.csv")


def test_sharded_glob_path_equals_the_jax_dataset(tmp_path):
    """csv:dir/part-*.csv reads the shards in sorted order, as the JAX
    package does (pandas hidden from it: its native branch)."""
    require_jax()
    from ydf_tpu.dataset.dataset import Dataset as JaxDataset

    train, _ = chip_smoke.make_frame(900, 10)
    for k, (a, b) in enumerate(((600, 900), (0, 300), (300, 600))):
        with open(tmp_path / f"part-{k}.csv", "w") as f:
            f.write(chip_smoke.csv_text(
                {c: v[a:b] for c, v in train.items()}))
    path = f"csv:{tmp_path}/part-*.csv"
    got = Dataset.from_data(path, label="label")
    want = JaxDataset.from_data(path, label="label")
    same_columns(got.data, want.data)
    assert got.dataspec.to_json() == want.dataspec.to_json()
    assert np.array_equal(got.data["f1"][:300].astype(np.float32),
                          train["f1"][600:900])


def small_model(rows=1500):
    train, test = chip_smoke.make_frame(rows, 300)
    m = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", num_trees=4, device="cpu").train(train)
    return m, test


def test_tfrecord_write_read_bitwise_the_jax_package(tmp_path):
    """The writer's bytes (uncompressed; gzip's header holds the write
    time), the reader's columns and predict on a tfrecord path: equal to
    the JAX package's and to the in-memory predict."""
    require_jax()
    from ydf_tpu.dataset import tfrecord as jtf

    m, test = small_model()
    a, b = str(tmp_path / "p.tfrecord"), str(tmp_path / "j.tfrecord")
    tfrecord.write_tfrecord_columns(a, test)
    jtf.write_tfrecord_columns(b, test)
    assert open(a, "rb").read() == open(b, "rb").read()
    same_columns(tfrecord.read_tfrecord_columns([a]),
                 jtf.read_tfrecord_columns([b]))
    gz = str(tmp_path / "t.tfrecord.gz")
    tfrecord.write_tfrecord_columns(gz, test, compressed=True)
    with gzip.open(gz, "rb") as f:
        assert f.read() == open(a, "rb").read()
    want = m.predict(test)
    for path in (f"tfrecord:{gz}", f"tfrecordv2+tfe:{a}"):
        got = m.predict(path)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    records = list(tfrecord.iter_records(gz))
    got = m.predict_tf_examples(records[:100])
    assert np.array_equal(got.view(np.int32), want[:100].view(np.int32))


def test_crc32c_and_sharded_tfrecord_names(tmp_path):
    """crc32c of "123456789" is 0xE3069283 (the Castagnoli check
    value); the masked form is TensorFlow's; a path without a pattern
    finds its "-?????-of-?????" shards."""
    assert tfrecord._crc32c(b"123456789") == 0xE3069283
    c = tfrecord._crc32c(b"abc")
    assert tfrecord._masked_crc(b"abc") == (
        ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF)
    cols = {"x": np.arange(6, dtype=np.float64), "s": np.array(list("abcdef"))}
    for k in range(2):
        tfrecord.write_tfrecord_columns(
            str(tmp_path / f"d-{k:05d}-of-00002"),
            {c: v[3 * k:3 * k + 3] for c, v in cols.items()})
    files = tfrecord.resolve_tfrecord_path(str(tmp_path / "d"))
    assert [os.path.basename(f) for f in files] == [
        "d-00000-of-00002", "d-00001-of-00002"]
    got = Dataset.from_data(f"tfrecord:{tmp_path}/d").data
    assert np.array_equal(got["x"], cols["x"])
    assert list(got["s"]) == list("abcdef")


def avro_columns():
    """Columns of every cell type the Avro encoder writes: nullable
    doubles, longs, nullable strings, string sets (with a missing and an
    empty one) and vector sequences (with a missing one)."""
    sets = np.empty(5, object)
    for i, v in enumerate([["a", "b"], [], None, ["c"], ["a"]]):
        sets[i] = v
    seqs = np.empty(5, object)
    for i, v in enumerate([[[1.0, 2.0], [3.0, 4.0]], [[0.5, -1.0]], None,
                           [[2.0, 2.0]], [[1.0, 1.0], [0.0, 0.0]]]):
        seqs[i] = None if v is None else np.asarray(v, np.float32)
    return {
        "x": np.array([1.5, np.nan, -2.0, 3.25, 0.0], np.float32),
        "n": np.array([1, -7, 0, 2 ** 40, 3], np.int64),
        "s": np.array(["u", "", "w", "u", "v"]),
        "tags": sets, "seq": seqs,
    }


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_rows_and_columns_equal_the_jax_reader(tmp_path, codec):
    require_jax()
    from ydf_tpu.dataset import avro as javro

    p = str(tmp_path / "a.avro")
    chip_smoke.write_avro(p, avro_columns(), codec=codec, block_rows=2)
    rows, schema = avro.read_avro_rows(p)
    jrows, jschema = javro.read_avro_rows(p)
    assert schema == jschema and rows == jrows
    got = avro.read_avro_columns([p, p])
    same_columns(got, javro.read_avro_columns([p, p]))
    assert got["x"].dtype == np.float64 and np.isnan(got["x"][1])
    assert got["s"][1] == "" and got["tags"][2] is None
    assert got["tags"][1] == [] and got["seq"][0].shape == (2, 2)


def test_avro_predict_equals_in_memory(tmp_path):
    m, test = small_model()
    p = str(tmp_path / "t.avro")
    chip_smoke.write_avro(p, test)
    got = m.predict(f"avro:{p}")
    want = m.predict(test)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_evaluate_and_train_on_csv_paths(tmp_path):
    """evaluate("csv:...") equals evaluate of the loader's columns, and
    train on a sharded path equals train on the same columns."""
    train, test = chip_smoke.make_frame(1500, 300)
    names = chip_smoke.write_csv_shards(str(tmp_path), train, test, 2)
    assert names == ["train-0.csv", "train-1.csv", "test.csv"]
    path = f"csv:{tmp_path}/train-*.csv"
    hp = dict(label="label", num_trees=3, device="cpu")
    m = ydf_tpu_torch.GradientBoostedTreesLearner(**hp).train(path)
    cols = dataset.read_path_columns(path)
    m2 = ydf_tpu_torch.GradientBoostedTreesLearner(**hp).train(cols)
    for f in ("feature", "threshold_bin", "leaf_value"):
        assert torch.equal(getattr(m.forest, f), getattr(m2.forest, f))
    ev = m.evaluate(f"csv:{tmp_path}/test.csv").metrics
    ev2 = m.evaluate(native_csv.read_csv(str(tmp_path / "test.csv"))).metrics
    assert ev == ev2


class _Series:
    def __init__(self, v):
        self.v = v

    def to_numpy(self):
        return self.v


class _Frame:
    """polars' surface the adapter uses: columns, [name], row slices."""

    def __init__(self, cols):
        self.cols = cols
        self.columns = list(cols)

    def __getitem__(self, k):
        if isinstance(k, slice):
            return _Frame({c: v[k] for c, v in self.cols.items()})
        return _Series(self.cols[k])

    def __len__(self):
        return len(next(iter(self.cols.values())))


class _XArrayVar:
    def __init__(self, v):
        self.values = v


class _XDataset:
    def __init__(self, cols):
        self.cols = cols
        self.data_vars = list(cols)

    def __getitem__(self, k):
        return _XArrayVar(self.cols[k])


class _MapDataset:
    def __init__(self, rows):
        self.rows = rows

    def __iter__(self):
        return iter(self.rows)


def test_frames_and_grain_through_stand_ins(monkeypatch):
    """polars, xarray and Grain are detected through sys.modules (the
    libraries are not installed here): stand-in classes registered under
    their names ingest like the dict of the same columns."""
    monkeypatch.setitem(sys.modules, "polars",
                        types.SimpleNamespace(DataFrame=_Frame))
    monkeypatch.setitem(sys.modules, "xarray",
                        types.SimpleNamespace(Dataset=_XDataset))
    monkeypatch.setitem(sys.modules, "grain",
                        types.SimpleNamespace(MapDataset=_MapDataset))
    cols = {"x": np.array([1.0, np.nan, 3.0]),
            "c": np.array(["a", "b", "a"], object)}
    want = Dataset.from_data(dict(cols))
    for data in (_Frame(cols), _XDataset(cols)):
        got = Dataset.from_data(data)
        same_columns(got.data, want.data)
        assert got.dataspec.to_json() == want.dataspec.to_json()
    rows = [{"x": 1.0, "c": b"a"}, {"x": None, "c": "b"},
            {"x": np.float64(3.0), "c": "a"}]
    got = Dataset.from_data(_MapDataset(rows))
    assert list(got.data) == ["x", "c"]
    assert np.isnan(got.data["x"][1]) and list(got.data["c"]) == [
        "a", "b", "a"]
    chunks = list(frame_io.iter_frame_chunks(_Frame(cols), 2))
    assert [len(c["x"]) for c in chunks] == [2, 1]
    chunks = list(frame_io.iter_frame_chunks(cols, 2))
    assert [len(c["c"]) for c in chunks] == [2, 1]
    with pytest.raises(ValueError, match="1-D"):
        frame_io.xarray_to_columns(_XDataset({"m": np.zeros((2, 2))}))
    if ydf_tpu is not None:
        from ydf_tpu.dataset import grain_io as jgrain

        same_columns(got.data, jgrain.to_columns(_MapDataset(rows)))
