"""The streaming dataset cache (dataset/cache.py) against the JAX
package's: every data file and cache_meta.json byte-identical (pandas
hidden from the JAX package, so both read the CSV through their loader)
in exact and sketch modes, at several chunkings, with weights, the
ranking, uplift and survival columns, raw numericals, feature and row
shards, a mixed-type column's recount and an in-memory frame; with
pandas present on files both readers type the same way; each package
opening the other's cache; integrity checks, reuse, shard rebuilds; and
the small committed runs (ydf_tpu_torch/testdata/train_cache): the
port's caches of their CSV files equal to the JAX package's by SHA-256
and the four learners trained from them equal tree by tree.
"""

import hashlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.dataset import cache as jcache
except ImportError:
    ydf = None

import chip_smoke
import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset import cache as pcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CACHE = os.path.join(REPO, "ydf_tpu_torch", "testdata", "train_cache")
torch.set_num_threads(1)


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def file_sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def frame(n, seed):
    """Columns of every kind a cache stores: floats with NaNs, a
    low-cardinality float, a categorical with missing cells, a string
    label, weights, a ranking group and relevance, a string treatment,
    survival event, entry and departure ages."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    x[rng.uniform(size=n) < 0.1] = np.nan
    c = np.array([f"v{k}" for k in rng.integers(0, 7, n)])
    c[rng.uniform(size=n) < 0.05] = ""
    entry = rng.uniform(0, 2, n).astype(np.float32)
    return {
        "x": x, "y": rng.normal(size=n).astype(np.float32),
        "z": rng.integers(0, 5, n).astype(np.float32) / 4, "c": c,
        "label": np.array(["no", "yes"])[(rng.uniform(size=n) < 0.4) * 1],
        "w": rng.uniform(0.5, 2, n).astype(np.float32),
        "q": np.array([f"q{k}" for k in np.sort(rng.integers(0, 40, n))]),
        "rel": rng.integers(0, 5, n).astype(np.float32),
        "t": np.array(["ctl", "trt"])[(rng.uniform(size=n) < 0.4) * 1],
        "ev": (rng.uniform(size=n) < 0.7).astype(np.float32),
        "entry": entry,
        "age": entry + rng.exponential(size=n).astype(np.float32),
    }


def write_files(d, parts):
    for k, cols in enumerate(parts):
        with open(os.path.join(d, f"part-{k}.csv"), "w") as f:
            f.write(chip_smoke.csv_text(cols))
    return f"csv:{d}/part-*.csv"


def both(tmp_path, data, port_kw, jax_kw=None):
    """(port cache, JAX cache) of `data` (a path or a frame)."""
    jax_kw = dict(port_kw if jax_kw is None else jax_kw)
    if "task" in jax_kw:
        jax_kw["task"] = JaxTask[jax_kw["task"].name]
    p = pcache.create_dataset_cache(data, str(tmp_path / "port"),
                                    device="cpu", **port_kw)
    j = jcache.create_dataset_cache(data, str(tmp_path / "jax"), **jax_kw)
    return p, j


def same_caches(p, j):
    """Every file byte for byte; cache_meta.json field for field."""
    names = sorted(os.listdir(p.path))
    assert names == sorted(os.listdir(j.path))
    for name in names:
        a, b = os.path.join(p.path, name), os.path.join(j.path, name)
        if name == "cache_meta.json":
            ma, mb = json.load(open(a)), json.load(open(b))
            assert list(ma) == list(mb)
            for k in ma:
                assert ma[k] == mb[k], k
        else:
            assert file_sha256(a) == file_sha256(b), name


CONFIGS = {
    "exact_chunks_100": dict(label="label", chunk_rows=100),
    "exact_one_chunk": dict(label="label", chunk_rows=1 << 20),
    "sketch": dict(label="label", chunk_rows=150, boundaries="sketch",
                   sketch_k=16),
    "weights": dict(label="label", weights="w", chunk_rows=256),
    "ranking": dict(label="rel", task=Task.RANKING, ranking_group="q",
                    chunk_rows=300),
    "uplift": dict(label="label", task=Task.CATEGORICAL_UPLIFT,
                   uplift_treatment="t", chunk_rows=300),
    "survival": dict(label="age", task=Task.SURVIVAL_ANALYSIS,
                     label_event_observed="ev", label_entry_age="entry",
                     chunk_rows=300),
    "raw_numerical": dict(label="label", store_raw_numerical=True,
                          chunk_rows=300),
    "shards": dict(label="label", feature_shards=3, row_shards=2,
                   chunk_rows=200),
    "features_bins": dict(label="label", features=["y", "c", "x"],
                          num_bins=64, min_vocab_frequency=40,
                          chunk_rows=300),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_cache_bitwise_the_jax_package(tmp_path, monkeypatch, config):
    require_jax()
    monkeypatch.setitem(sys.modules, "pandas", None)
    data = frame(1100, 1)
    parts = [{k: v[a:b] for k, v in data.items()}
             for a, b in ((0, 500), (500, 1100))]
    src = write_files(str(tmp_path), parts)
    p, j = both(tmp_path, src, CONFIGS[config])
    same_caches(p, j)
    assert p.num_rows == 1100 and np.array_equal(p.bins, j.bins)


def test_mixed_type_column_recount(tmp_path, monkeypatch):
    """"c" numeric (not integral) in one file and text in the other:
    recounted as categorical, the same files."""
    require_jax()
    monkeypatch.setitem(sys.modules, "pandas", None)
    data = frame(800, 2)
    parts = [{k: v[a:b] for k, v in data.items()}
             for a, b in ((0, 400), (400, 800))]
    parts[0]["c"] = np.round(data["y"][:400], 2) + np.float32(0.005)
    src = write_files(str(tmp_path), parts)
    p, j = both(tmp_path, src, dict(label="label", chunk_rows=128))
    same_caches(p, j)
    col = p.dataspec.column_by_name("c")
    assert col.type.value == "CATEGORICAL" and col.vocab_size > 7


def test_in_memory_frame(tmp_path):
    require_jax()
    data = frame(700, 3)
    p, j = both(tmp_path, data, dict(label="label", chunk_rows=256,
                                     weights="w"))
    same_caches(p, j)
    assert p._meta["source"] == "<in-memory frame>"


def test_pandas_present_integer_label(tmp_path):
    """With pandas the JAX package reads chunks through it (an integer
    label is int64); the port reads through its loader (float64) and
    keys the numbers as encoding does: the same files."""
    require_jax()
    pytest.importorskip("pandas")
    train, _ = chip_smoke.cache_frames(1200, 10)
    parts = [{k: v[a:b] for k, v in train.items()}
             for a, b in ((0, 700), (700, 1200))]
    src = write_files(str(tmp_path), parts)
    p, j = both(tmp_path, src, dict(label="label", chunk_rows=256,
                                    task=Task.NUMERICAL_UPLIFT,
                                    uplift_treatment="treat"))
    same_caches(p, j)
    q, k = both(tmp_path / "b", src, dict(label="label", chunk_rows=300))
    same_caches(q, k)
    assert sorted(q.label_classes()) == ["0", "1"]


def test_each_package_opens_the_others_cache(tmp_path, monkeypatch):
    require_jax()
    monkeypatch.setitem(sys.modules, "pandas", None)
    src = write_files(str(tmp_path), [frame(600, 4)])
    p, j = both(tmp_path, src, dict(label="label", weights="w",
                                    feature_shards=2, chunk_rows=200))
    jp = jcache.DatasetCache(p.path, verify="full")
    pj = pcache.DatasetCache(j.path, verify="full")
    assert np.array_equal(jp.bins, pj.bins)
    assert jp.binner.to_json() == pj.binner.to_json()
    assert jp.dataspec.to_json() == pj.dataspec.to_json()
    assert np.array_equal(jp.shard_bins(1), pj.shard_bins(1, verify=True))
    assert jp.label_classes() == pj.label_classes()
    assert np.array_equal(np.asarray(jp.sample_weights),
                          np.asarray(pj.sample_weights))


def small_cache(tmp_path, **kw):
    src = write_files(str(tmp_path), [frame(500, 5)])
    return pcache.create_dataset_cache(src, str(tmp_path / "c"),
                                       label="label", device="cpu",
                                       chunk_rows=128, **kw), src


def test_verify_finds_corruption(tmp_path):
    c, _ = small_cache(tmp_path)
    path = os.path.join(c.path, "bins.npy")
    with open(path, "r+b") as f:
        f.seek(200)
        b = f.read(1)
        f.seek(200)
        f.write(bytes([b[0] ^ 1]))
    pcache.DatasetCache(c.path)  # sizes only: passes
    with pytest.raises(pcache.CacheCorruptionError, match="block 0"):
        pcache.DatasetCache(c.path, verify="full")
    with open(path, "ab") as f:
        f.write(b"x")
    with pytest.raises(pcache.CacheCorruptionError, match="bytes"):
        pcache.DatasetCache(c.path)
    os.remove(os.path.join(c.path, "cache_meta.json"))
    with pytest.raises(pcache.CacheCorruptionError, match="no cache_meta"):
        pcache.DatasetCache(c.path)
    with pytest.raises(ValueError, match="verify mode"):
        pcache.DatasetCache(c.path, verify="some")


def test_reuse_and_rebuild(tmp_path):
    """reuse=True returns a verified cache of the same request untouched,
    rebuilds one whose shard layout or bytes changed (with a warning
    for the corrupt one)."""
    c, src = small_cache(tmp_path)
    bins = os.path.join(c.path, "bins.npy")
    t0 = os.stat(bins).st_mtime_ns
    same = pcache.create_dataset_cache(src, c.path, label="label",
                                       device="cpu", chunk_rows=128,
                                       reuse=True)
    assert os.stat(bins).st_mtime_ns == t0 and same.feature_shards == 0
    sharded = pcache.create_dataset_cache(src, c.path, label="label",
                                          device="cpu", chunk_rows=128,
                                          reuse=True, feature_shards=2)
    assert sharded.feature_shards == 2 and os.path.isfile(
        os.path.join(c.path, "bins_shard_1.npy"))
    with open(bins, "r+b") as f:
        f.seek(300)
        f.write(b"\xff\xfe")
    with pytest.warns(RuntimeWarning, match="rebuilding"):
        again = pcache.create_dataset_cache(
            src, c.path, label="label", device="cpu", chunk_rows=128,
            reuse=True, feature_shards=2)
    again.verify(full=True)
    assert np.array_equal(again.shard_bins(0), sharded.shard_bins(0))


def test_row_and_feature_shards_stream_and_rebuild(tmp_path):
    c, _ = small_cache(tmp_path, feature_shards=3, row_shards=2)
    full = np.asarray(c.bins)
    for k in range(2):
        lo, hi = c.row_shard_range(k)
        assert np.array_equal(c.load_row_shard_streamed(k), full[lo:hi])
        got = c.load_row_shard_streamed(k, col_range=(1, 3))
        assert np.array_equal(got, full[lo:hi, 1:3])
    name = os.path.join(c.path, "bins_rows_1.npy")
    want = open(name, "rb").read()
    with open(name, "r+b") as f:
        f.seek(len(want) - 1)
        f.write(b"\x07" if want[-1:] != b"\x07" else b"\x08")
    with pytest.raises(pcache.CacheCorruptionError, match="row shard"):
        c.load_row_shard_streamed(1)
    c.rebuild_row_shard(1)
    assert open(name, "rb").read() == want
    shard = os.path.join(c.path, "bins_shard_2.npy")
    want = open(shard, "rb").read()
    os.remove(shard)
    c.rebuild_feature_shard(2)
    assert open(shard, "rb").read() == want
    pcache.DatasetCache(c.path, verify="full")
    with pytest.raises(ValueError, match="exceeds"):
        pcache.shard_col_ranges(2, 3)


def test_entry_points_refuse(tmp_path):
    """A non-CSV path raises; so does device=None without a card."""
    with pytest.raises(NotImplementedError, match="CSV input only"):
        pcache.create_dataset_cache("avro:/x.avro", str(tmp_path / "c"),
                                    label="y", device="cpu")
    if not torch.cuda.is_available():
        src = write_files(str(tmp_path), [frame(50, 6)])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pcache.create_dataset_cache(src, str(tmp_path / "c"),
                                        label="label")


def test_learner_checks_the_cache(tmp_path):
    c, _ = small_cache(tmp_path, weights="w")
    G = ydf_tpu_torch.GradientBoostedTreesLearner
    with pytest.raises(ValueError, match="built for label"):
        G(label="y", device="cpu").train(c)
    with pytest.raises(ValueError, match="weights column"):
        G(label="label", device="cpu").train(c)
    with pytest.raises(ValueError, match="store_raw_numerical"):
        G(label="label", weights="w", split_axis="SPARSE_OBLIQUE",
          device="cpu").train(c)
    with pytest.raises(ValueError, match="ranking_group"):
        G(label="label", weights="w", task=Task.RANKING, ranking_group="q",
          device="cpu").train(c)
    with pytest.raises(TypeError, match="validation_ratio=0"):
        ydf_tpu_torch.CartLearner(label="label", weights="w",
                                  device="cpu").train(c)


def fixture_config():
    with open(os.path.join(TRAIN_CACHE, "config.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    """The small runs' CSV files (chip_smoke.cache_frames), their
    SHA-256 held against the fixture's."""
    cfg = fixture_config()["small"]
    d = str(tmp_path_factory.mktemp("small"))
    train, test = chip_smoke.cache_frames(cfg["rows"], cfg["test_rows"])
    names = chip_smoke.write_csv_shards(d, train, test, cfg["shards"])
    assert {n: file_sha256(os.path.join(d, n)) for n in names} == cfg[
        "csv_sha256"]
    return d, test


@pytest.mark.parametrize("run", ["gbt", "rf_weights", "uplift", "cart",
                                 "if", "oblique"])
def test_small_runs_equal_the_fixture(small_files, tmp_path, run):
    """The port's cache of the run's CSV files equals the JAX package's
    (file SHA-256s and the metadata), and the learner trained from it
    equals the JAX one: every tree by hash, the node counts, the GBT's
    kept count, the predictions bitwise; the GBT's reported losses
    (torch's binomial loss) within chip_smoke.REPORTED_LOSS_RTOL."""
    d, test = small_files
    cfg = fixture_config()
    rc = cfg["small"]["runs"][run]
    exp = np.load(os.path.join(TRAIN_CACHE, "expected.npz"))
    kw = dict(rc["cache_args"])
    if "task" in kw:
        kw["task"] = Task[kw["task"]]
    c = pcache.create_dataset_cache(f"csv:{d}/train-*.csv",
                                    str(tmp_path / "c"), device="cpu",
                                    chunk_rows=cfg["small"]["chunk_rows"],
                                    **kw)
    assert chip_smoke.cache_record(c) == rc["cache"]
    hp = dict(rc["learner_args"])
    if "task" in hp:
        hp["task"] = Task[hp["task"]]
    m = getattr(ydf_tpu_torch, rc["learner"])(device="cpu", **hp).train(c)
    assert chip_smoke.check_run_trees(exp, run, m) == rc["num_trees"]
    if "num_trees_kept" in rc:
        logs = m.training_logs
        assert (logs["num_trees"], logs["num_trees_trained"]) == (
            rc["num_trees_kept"], rc["num_trees_trained"])
        for k in ("train_loss", "valid_loss"):
            got = np.array([r[k] for r in logs["iterations"]], np.float32)
            np.testing.assert_allclose(got, exp[f"{run}/{k}"],
                                       rtol=chip_smoke.REPORTED_LOSS_RTOL)
    pred = np.asarray(m.predict(test))
    assert chip_smoke.same_bits(pred[:len(exp[f"{run}/predictions"])],
                                exp[f"{run}/predictions"])
    assert chip_smoke.array_sha256(pred) == rc["predictions_sha256"]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [65_536, 59_464, 1])
def test_binning_kernel_at_chunk_shapes_on_card(rows):
    """csrc/binning.cu at pass 2's chunk shapes (28 numericals, NaNs to
    impute, collided and +inf-padded boundaries) == its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from ydf_tpu_torch.ops import binning

    rng = np.random.default_rng(rows)
    F = 28
    v = rng.normal(size=(F, rows)).astype(np.float32)
    v[rng.uniform(size=(F, rows)) < 0.03] = np.nan
    b = np.sort(rng.normal(size=(F, 255)).astype(np.float32), axis=1)
    b[:, 10] = b[:, 11]  # two boundaries that collide: an empty bin
    nb = rng.integers(0, 256, F).astype(np.int32)
    for f in range(F):
        b[f, nb[f]:] = np.inf
    imp = rng.normal(size=F).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (v, b, nb, imp)]
    before = binning.KERNEL_LAUNCHES
    got = binning.bin_columns(*args)
    assert binning.KERNEL_LAUNCHES == before + 1
    want = binning.bin_columns_plain(*args)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cache_built_on_card_equals_cpu(tmp_path):
    """Pass 2 on the card (one binning launch a chunk) writes the bytes
    the plain version writes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from ydf_tpu_torch.ops import binning

    src = write_files(str(tmp_path), [frame(1000, 8)])
    before = binning.KERNEL_LAUNCHES
    card = pcache.create_dataset_cache(src, str(tmp_path / "card"),
                                       label="label", chunk_rows=300)
    assert binning.KERNEL_LAUNCHES == before + 4
    cpu = pcache.create_dataset_cache(src, str(tmp_path / "cpu"),
                                      label="label", chunk_rows=300,
                                      device="cpu")
    for name in card._meta["integrity"]["files"]:
        assert file_sha256(os.path.join(card.path, name)) == file_sha256(
            os.path.join(cpu.path, name)), name
    shutil.rmtree(tmp_path / "card")
