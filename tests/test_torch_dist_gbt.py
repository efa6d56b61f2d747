"""Feature-parallel distributed GBT training in the port
(parallel/dist_gbt.py, parallel/dist_worker.py): 2 and 3 in-process CPU
workers, more shards than workers, f32 / bf16x2 / int8
(YDF_TPU_HIST_QUANT), row and candidate-feature sampling, regression and
binary classification, every tree equal by hash to the port's
single-device GBT trained from the same cache and to the JAX package's
distributed GBT on its own in-process workers (predictions within 1e-6);
each chaos case (worker loss mid-layer, dropped split broadcast and shard
load, a corrupt shard rebuilt, a straggler's deadline, a real worker
shutdown, the verify mode, the epoch fence, resume at the same and at
another worker count, a snapshot crash, a reattach's drop) ends in the
same trees; the unsupported configurations raise the JAX package's
errors; the manager never reads the bin matrix. The JAX package's CLI
resume test is not ported (the CLI is ROADMAP item 20)."""

import hashlib
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.dataset.cache import create_dataset_cache as jax_cache
    from ydf_tpu.parallel import dist_worker as jdist_worker
    from ydf_tpu.parallel import worker_service as jws
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset.cache import DatasetCache, create_dataset_cache
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.parallel import dist_gbt, dist_worker
from ydf_tpu_torch.parallel import worker_service as ws
from ydf_tpu_torch.parallel.worker_service import WorkerPool, start_worker
from ydf_tpu_torch.utils import failpoints

torch.set_num_threads(1)
HASH_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
               "right", "is_leaf", "leaf_value", "cover", "num_nodes")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def workers():
    """A factory of in-process CPU workers; shut down after the test."""
    started = []

    def start(n, device="cpu"):
        ports = [free_port() for _ in range(n)]
        for p in ports:
            start_worker(p, blocking=False, device=device)
        addrs = [f"127.0.0.1:{p}" for p in ports]
        WorkerPool(addrs).ping_all()
        started.extend(addrs)
        return addrs

    yield start
    if started:
        WorkerPool(started).shutdown_all()
    dist_worker.reset_state()


@pytest.fixture
def jax_workers():
    started = []

    def start(n):
        require_jax()
        ports = [free_port() for _ in range(n)]
        for p in ports:
            jws.start_worker(p, blocking=False)
        addrs = [f"127.0.0.1:{p}" for p in ports]
        started.extend(addrs)
        return addrs

    yield start
    if started:
        jws.WorkerPool(started).shutdown_all()
        jdist_worker.reset_state()


def frame(n=3000, seed=7, binary=False):
    """tests/test_worker_dist_gbt.py's frame: NaN numericals and a
    categorical column."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, 4)).astype(np.float64)
    x[rng.rand(n) < 0.08, 0] = np.nan
    cat = rng.choice(["aa", "bb", "cc", "dd"], size=n)
    y = (x[:, 1] * 1.5 - np.nan_to_num(x[:, 0]) + (cat == "aa") * 2.0
         + rng.normal(scale=0.3, size=n))
    if binary:
        y = (x[:, 1] > 0).astype(np.int64)
    return {"f0": x[:, 0], "f1": x[:, 1], "f2": x[:, 2], "f3": x[:, 3],
            "c0": cat, "y": y if binary else y.astype(np.float32)}


def make_cache(tmp_path, shards, binary=False, name="cache", **kw):
    return create_dataset_cache(
        frame(binary=binary), str(tmp_path / name), label="y",
        task=Task.CLASSIFICATION if binary else Task.REGRESSION,
        feature_shards=shards, device="cpu", **kw)


def learner(num_trees=4, binary=False, **kw):
    return ydf_tpu_torch.GradientBoostedTreesLearner(
        label="y", task=Task.CLASSIFICATION if binary else Task.REGRESSION,
        num_trees=num_trees, max_depth=4, validation_ratio=0.0,
        early_stopping="NONE", device="cpu", **kw)


def tree_hashes(forest_np):
    out = []
    for t in range(forest_np["feature"].shape[0]):
        h = hashlib.sha256()
        for f in HASH_FIELDS:
            h.update(np.ascontiguousarray(forest_np[f][t]).tobytes())
        out.append(h.hexdigest())
    return out


def jax_forest_np(m):
    return {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}


def assert_same_trees(got, want):
    """Every tree by hash, the initial predictions and the losses."""
    a = tree_hashes(got.forest.to_numpy())
    b = tree_hashes(want.forest.to_numpy())
    assert len(a) == len(b)
    first = next((t for t in range(len(a)) if a[t] != b[t]), None)
    assert first is None, f"tree {first} differs"
    assert np.array_equal(np.asarray(got.initial_predictions),
                          np.asarray(want.initial_predictions))
    assert got.training_logs["train_loss"] == want.training_logs["train_loss"]


# --------------------------------------------------------------------- #
# The single device's trees, and the JAX package's
# --------------------------------------------------------------------- #


CONFIGS = {
    "2w_2s": dict(workers=2, shards=2),
    "3w_5s": dict(workers=3, shards=5),
    "bf16x2": dict(workers=2, shards=2, quant="bf16x2", trees=3),
    "int8": dict(workers=2, shards=3, quant="int8", trees=5),
    "sampled": dict(workers=2, shards=2, hp=dict(
        subsample=0.7, num_candidate_attributes=3)),
    "binary": dict(workers=2, shards=2, binary=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dist_equals_single_device_and_the_jax_package(
        name, tmp_path, workers, jax_workers, monkeypatch):
    c = CONFIGS[name]
    quant = c.get("quant", "f32")
    if quant != "f32":
        monkeypatch.setenv("YDF_TPU_HIST_QUANT", quant)
    binary = c.get("binary", False)
    hp = dict(c.get("hp", {}), num_trees=c.get("trees", 4), binary=binary)
    cache = make_cache(tmp_path, c["shards"], binary=binary)
    single = learner(**hp).train(cache)
    reads0 = dist_gbt.HOST_READS
    dist = learner(distributed_workers=workers(c["workers"]),
                   **hp).train(cache)
    assert_same_trees(dist, single)
    d = dist.training_logs["distributed"]
    assert d["workers"] == c["workers"]
    assert d["feature_shards"] == c["shards"]
    assert d["hist_quant"] == quant and d["reduce_bytes"] > 0
    assert d["rpc_count"]["build_histograms"] > 0
    # One host read a tree for the operand (two with int8's scale), one
    # a layer for its tables.
    T = hp["num_trees"]
    assert dist_gbt.HOST_READS - reads0 == T * (
        (2 if quant == "int8" else 1) + 4)
    test = frame(n=256, seed=11, binary=binary)
    assert np.array_equal(dist.predict(test), single.predict(test))

    # The JAX package's distributed model on its own workers.
    require_jax()
    from ydf_tpu.learners.gbt import _make_boost_fn

    _make_boost_fn.cache_clear()
    jc = jax_cache(frame(binary=binary), str(tmp_path / "jax_cache"),
                   label="y", task=JaxTask.CLASSIFICATION if binary
                   else JaxTask.REGRESSION, feature_shards=c["shards"])
    jl = ydf.GradientBoostedTreesLearner(
        label="y", task=JaxTask.CLASSIFICATION if binary
        else JaxTask.REGRESSION, num_trees=hp["num_trees"], max_depth=4,
        validation_ratio=0.0, early_stopping="NONE",
        distributed_workers=jax_workers(c["workers"]), **c.get("hp", {}))
    jm = jl.train(jc)
    _make_boost_fn.cache_clear()
    assert jm.training_logs["distributed"]["hist_quant"] == quant
    assert tree_hashes(dist.forest.to_numpy()) == tree_hashes(
        jax_forest_np(jm))
    np.testing.assert_allclose(dist.predict(test), jm.predict(test),
                               rtol=0, atol=1e-6)


def test_the_manager_never_reads_the_bin_matrix(tmp_path, workers,
                                                monkeypatch):
    """The memory contract: distributed training leaves bins.npy to the
    workers (their shard files)."""
    cache = make_cache(tmp_path, 2)
    single = learner().train(cache)

    def no_bins(self):
        raise AssertionError("the manager read the bin matrix")

    monkeypatch.setattr(DatasetCache, "bins", property(no_bins))
    dist = learner(distributed_workers=workers(2)).train(cache)
    assert_same_trees(dist, single)


def test_a_failed_kernel_on_a_worker_raises(tmp_path, workers, monkeypatch):
    """No fallback: a worker's failed launch comes back as an error and
    the manager raises; nothing is recomputed on the manager."""
    from ydf_tpu_torch.ops import histogram_kernels

    cache = make_cache(tmp_path, 2)
    addrs = workers(2)

    def broken(*a, **k):
        raise RuntimeError("histogram kernel failed: launch error")

    monkeypatch.setattr(histogram_kernels, "histogram", broken)
    with pytest.raises(dist_gbt.DistributedTrainingError,
                       match="histogram kernel failed"):
        learner(distributed_workers=addrs).train(cache)


def test_worker_layers_route_by_the_merged_bitmap(tmp_path, workers,
                                                 monkeypatch):
    """A worker launches the root kernel once a tree and shard, and the
    routed kernel at every deeper layer with the merged go-left bitmap
    as its row-direction table (every slot is_set, a direction a row),
    as a mesh's feature axis does; the trees stay the single device's."""
    from ydf_tpu_torch.ops import histogram_kernels

    cache = make_cache(tmp_path, 3)
    single = learner().train(cache)
    calls = {"histogram": 0, "routed": []}
    root, routed = (histogram_kernels.histogram,
                    histogram_kernels.histogram_routed)

    def count_root(*a, **k):
        calls["histogram"] += 1
        return root(*a, **k)

    def count_routed(bins_t, slot, leaf, tables, *a, **k):
        calls["routed"].append((bool(tables.is_set.all()),
                                tables.set_go_left.shape[0],
                                bins_t.shape[1]))
        return routed(bins_t, slot, leaf, tables, *a, **k)

    monkeypatch.setattr(histogram_kernels, "histogram", count_root)
    monkeypatch.setattr(histogram_kernels, "histogram_routed",
                        count_routed)
    dist = learner(distributed_workers=workers(2)).train(cache)
    assert_same_trees(dist, single)
    trees, depth, shards = 4, 4, 3
    assert calls["histogram"] == trees * shards
    assert len(calls["routed"]) == trees * (depth - 1) * shards
    assert all(is_set and dirs == n for is_set, dirs, n in calls["routed"])


def test_get_telemetry_reports_the_launch_times(workers, monkeypatch):
    """get_telemetry returns the launch counts and the timed spans by
    name; without CUDA nothing is timed (the spans are CUDA events) and
    time_launches leaves the recording off."""
    from ydf_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "LAUNCH_EVENTS", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    addr = workers(1)
    pool = WorkerPool(addr)
    for _ in range(2):
        r = pool.request(0, {"verb": "get_telemetry",
                             "reset_launches": True, "time_launches": True})
        assert set(r["launches"]) == {"histogram", "histogram_routed"}
        assert r["launch_ms"] == {}
    assert cuda_build.LAUNCH_EVENTS is None
    pool.close()


def test_telemetry_merges_the_workers_spans(tmp_path, workers):
    """With telemetry on, the workers' request spans are drained at the
    end of the train and merged into the manager's trace, one pid row a
    worker (in-process workers get synthetic rows), each carrying the
    manager's trace context; the trees do not change."""
    from ydf_tpu_torch.utils import telemetry

    cache = make_cache(tmp_path, 2)
    ref = learner(num_trees=2).train(cache)
    addrs = workers(2)
    out = tmp_path / "tele"
    with telemetry.active(str(out)):
        dist = learner(num_trees=2, distributed_workers=addrs).train(cache)
    with open(out / f"trace-{os.getpid()}.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert_same_trees(dist, ref)
    reqs = [e for e in events if e.get("name") == "worker.request"
            and e["args"].get("verb") == "build_histograms"]
    # (The drain's own requests, recorded after it, keep this pid.)
    assert {e["pid"] for e in reqs} == {1_000_000, 1_000_001}
    assert all("trace" in e["args"] for e in reqs)
    names = {e.get("name") for e in events}
    assert {"dist.tree", "dist.layer", "train"} <= names, names
    assert dist.training_logs["distributed"]["telemetry_drained_events"]


# --------------------------------------------------------------------- #
# Configuration guard rails
# --------------------------------------------------------------------- #


def test_unsupported_configurations_raise(tmp_path, workers):
    addrs = workers(2)
    with pytest.raises(ValueError, match="DatasetCache"):
        learner(distributed_workers=addrs).train(frame())
    plain = make_cache(tmp_path, 0, name="plain")
    with pytest.raises(ValueError, match="feature_shards"):
        learner(distributed_workers=addrs).train(plain)
    cache = make_cache(tmp_path, 2)
    with pytest.raises(ValueError, match="validation"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="y", task=Task.REGRESSION, num_trees=3, device="cpu",
            distributed_workers=addrs).train(cache)
    with pytest.raises(ValueError, match="validation"):
        learner(distributed_workers=addrs).train(cache, valid=frame(n=100))
    for kw, what in ((dict(sampling_method="GOSS"), "sampling_method"),
                     (dict(split_axis="SPARSE_OBLIQUE"), "SPARSE_OBLIQUE"),
                     (dict(dart_dropout=0.1), "dart_dropout"),
                     (dict(monotonic_constraints={"f1": 1}), "monotonic"),
                     (dict(maximum_training_duration=10.0),
                      "maximum_training_duration"),
                     (dict(mesh=ydf_tpu_torch.make_mesh(["cpu"] * 2)),
                      "combined with RPC workers")):
        with pytest.raises(ValueError, match=what):
            learner(distributed_workers=addrs, **kw).train(cache)
    three = create_dataset_cache(
        {**frame(), "y": np.random.RandomState(0).randint(0, 3, 3000)},
        str(tmp_path / "three"), label="y", feature_shards=2, device="cpu")
    with pytest.raises(ValueError, match="multi-output losses"):
        learner(distributed_workers=addrs, binary=True).train(three)
    rows = make_cache(tmp_path, 0, name="rows", row_shards=2)
    with pytest.raises(NotImplementedError, match="item 18"):
        learner(distributed_workers=addrs).train(rows)
    with pytest.raises(NotImplementedError, match="item 18"):
        learner(distributed_workers=addrs, distributed_membership=object())


# --------------------------------------------------------------------- #
# Chaos
# --------------------------------------------------------------------- #


@pytest.mark.chaos
@pytest.mark.parametrize("schedule,site", [
    ("dist.histogram_rpc=drop_conn@5", "dist.histogram_rpc"),
    ("dist.split_broadcast=drop_conn@2", "dist.split_broadcast"),
    ("dist.shard_load=drop_conn", "dist.shard_load"),
    ("worker.send=drop_conn@7", "worker.send"),
])
def test_chaos_dropped_rpcs_recover_the_same_trees(schedule, site, tmp_path,
                                                   workers):
    cache = make_cache(tmp_path, 2)
    ref = learner().train(cache)
    addrs = workers(2)
    with failpoints.active(schedule):
        dist = learner(distributed_workers=addrs).train(cache)
        assert site in failpoints.fired_sites()
    assert_same_trees(dist, ref)
    assert dist.training_logs["distributed"]["recoveries"] >= 1


@pytest.mark.chaos
def test_chaos_corrupt_shard_rebuilt(tmp_path, workers):
    cache = make_cache(tmp_path, 2)
    ref = learner().train(cache)
    path = os.path.join(cache.path, "bins_shard_0.npy")
    before = open(path, "rb").read()
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    dist = learner(distributed_workers=workers(2)).train(cache)
    assert_same_trees(dist, ref)
    assert dist.training_logs["distributed"]["shard_rebuilds"] >= 1
    assert open(path, "rb").read() == before


@pytest.mark.chaos
def test_chaos_straggler_deadline(tmp_path, workers, monkeypatch):
    """A worker that answers pings but never real work: its requests hit
    YDF_TPU_DIST_RPC_TIMEOUT_S, it is quarantined, its shard moves."""
    hung = socket.socket()
    hung.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    hung.bind(("127.0.0.1", 0))
    hung.listen(8)
    stop = threading.Event()

    def serve(conn):
        try:
            conn.settimeout(5.0)
            while not stop.is_set():
                seq = ws._recv_seq_or_idle(conn)
                if seq is None:
                    continue
                req = ws._recv_msg(conn)
                if req.get("verb") == "ping":
                    ws._send_seq_frame(conn, seq, ws._encode_frame(
                        {"ok": True, "clock_ns": time.perf_counter_ns()}))
        except Exception:
            pass
        finally:
            conn.close()

    def accept():
        while not stop.is_set():
            try:
                c, _ = hung.accept()
            except OSError:
                return
            threading.Thread(target=serve, args=(c,), daemon=True).start()

    threading.Thread(target=accept, daemon=True).start()
    cache = make_cache(tmp_path, 3)
    ref = learner().train(cache)
    addrs = workers(2) + [f"127.0.0.1:{hung.getsockname()[1]}"]
    monkeypatch.setattr(dist_gbt, "_RPC_TIMEOUT_S", 1.0)
    dist = learner(distributed_workers=addrs).train(cache)
    assert_same_trees(dist, ref)
    assert dist.training_logs["distributed"]["recoveries"] >= 1
    stop.set()
    hung.close()


@pytest.mark.chaos
def test_chaos_real_worker_shutdown_mid_train(tmp_path, workers):
    """Worker 1 (it owns shard 1) is really shut down once it has served
    tree 2: its shard moves with the manager's state."""
    cache = make_cache(tmp_path, 2)
    ref = learner(num_trees=6).train(cache)
    addrs = workers(3)

    def kill():
        deadline = time.time() + 30
        while time.time() < deadline:
            st = dist_worker.status(addrs[1])
            if any(s["pos"][0] >= 2 for s in st.values()):
                WorkerPool([addrs[1]]).shutdown_all()
                return
            time.sleep(0.002)

    t = threading.Thread(target=kill, daemon=True)
    t.start()
    dist = learner(num_trees=6, distributed_workers=addrs).train(cache)
    t.join()
    assert_same_trees(dist, ref)
    assert dist.training_logs["distributed"]["recoveries"] >= 1


@pytest.mark.chaos
def test_verify_mode_cross_checks_the_workers(tmp_path, workers,
                                              monkeypatch):
    cache = make_cache(tmp_path, 2)
    ref = learner().train(cache)
    monkeypatch.setattr(dist_gbt, "_VERIFY", True)
    dist = learner(distributed_workers=workers(2)).train(cache)
    assert_same_trees(dist, ref)
    assert dist.training_logs["distributed"]["rpc_count"]["leaf_stats"] == 4
    monkeypatch.setenv("YDF_TPU_DIST_VERIFY", "maybe")
    with pytest.raises(ValueError, match="YDF_TPU_DIST_VERIFY"):
        dist_gbt._parse_verify()
    monkeypatch.setenv("YDF_TPU_DIST_RPC_TIMEOUT_S", "0")
    with pytest.raises(ValueError, match="YDF_TPU_DIST_RPC_TIMEOUT_S"):
        dist_gbt._parse_rpc_timeout()


def test_epoch_fence_rejects_stale_rpcs(tmp_path):
    """A lower epoch gets the typed rejection and changes nothing; a
    zombie's reattach too; a work verb from an epoch that never attached
    answers need_shard."""
    cache = make_cache(tmp_path, 2)
    wid = "fence-worker"
    r = dist_worker.handle("load_cache_shard", {
        "key": "k", "shards": [0, 1], "cache_dir": cache.path, "epoch": 2},
        wid)
    assert r["ok"]
    st = dist_worker._get_state(wid, "k")
    assert st.epoch == 2
    stale = dist_worker.handle("build_histograms", {
        "key": "k", "epoch": 1, "tree": 0, "layer": 0, "reset": True,
        "shards": [0], "num_slots": 1, "num_bins": cache.binner.num_bins},
        wid)
    assert stale["ok"] is False and stale["stale_epoch"] is True
    assert stale["have_epoch"] == 2 and "stale manager epoch" in stale[
        "error"]
    assert st.pos == (-1, 0)
    stale2 = dist_worker.handle("load_cache_shard", {
        "key": "k", "shards": [0], "cache_dir": cache.path, "epoch": 1}, wid)
    assert stale2.get("stale_epoch") is True and st.epoch == 2
    ahead = dist_worker.handle("apply_split", {
        "key": "k", "epoch": 3, "tree": 0, "layer": 0, "tables": None,
        "shards": [0]}, wid)
    assert ahead.get("need_shard") is True and st.epoch == 2
    dist_worker.reset_state()


@pytest.mark.chaos
def test_chaos_epoch_fence_stops_the_manager(tmp_path, workers):
    """dist.epoch_fence fences one mid-train RPC (hits 1-2 are the shard
    loads): the manager stops loudly, and a clean rerun on the same
    workers gives the reference trees."""
    cache = make_cache(tmp_path, 2)
    ref = learner().train(cache)
    addrs = workers(2)
    with failpoints.active("dist.epoch_fence=error@3"):
        with pytest.raises(dist_gbt.DistributedTrainingError,
                           match="fenced out"):
            learner(distributed_workers=addrs).train(cache)
        assert "dist.epoch_fence" in failpoints.fired_sites()
    assert_same_trees(learner(distributed_workers=addrs).train(cache), ref)


def preempt_then_resume(cache, addrs, wd, resume_addrs=None, interval=2,
                        **kw):
    """Preempted at the first snapshot (2 trees), then resumed by a new
    manager."""
    l1 = learner(distributed_workers=addrs, working_dir=str(wd),
                 resume_training_snapshot_interval_trees=interval, **kw)
    l1._preempt_after_chunks = 1
    with pytest.raises(port_gbt.TrainingPreempted):
        l1.train(cache)
    return learner(distributed_workers=list(resume_addrs or addrs),
                   working_dir=str(wd), resume_training=True,
                   resume_training_snapshot_interval_trees=interval,
                   **kw).train(cache)


@pytest.mark.parametrize("quant,counts", [("f32", (2, 2)),
                                          ("int8", (2, 2)),
                                          ("f32", (2, 3))])
def test_resume_gives_the_same_trees(quant, counts, tmp_path, workers,
                                     monkeypatch):
    if quant != "f32":
        monkeypatch.setenv("YDF_TPU_HIST_QUANT", quant)
    cache = make_cache(tmp_path, 2)
    addrs = workers(max(counts))
    ref = learner(distributed_workers=addrs[:counts[0]]).train(cache)
    res = preempt_then_resume(cache, addrs[:counts[0]], tmp_path / "wd",
                              resume_addrs=addrs[:counts[1]])
    assert_same_trees(res, ref)
    d = res.training_logs["distributed"]
    assert d["resumed_from"] == 2 and d["epoch"] == 2
    assert d["snapshots"] >= 1 and d["snapshot_s"] > 0
    assert d["hist_quant"] == quant and d["workers"] == counts[1]


def test_resume_fingerprint_mismatch_raises(tmp_path, workers):
    cache = make_cache(tmp_path, 2)
    addrs = workers(2)
    l1 = learner(distributed_workers=addrs,
                 working_dir=str(tmp_path / "wd"),
                 resume_training_snapshot_interval_trees=2)
    l1._preempt_after_chunks = 1
    with pytest.raises(port_gbt.TrainingPreempted):
        l1.train(cache)
    with pytest.raises(ValueError, match="refusing to resume"):
        learner(distributed_workers=addrs, working_dir=str(tmp_path / "wd"),
                resume_training=True, shrinkage=0.05).train(cache)


@pytest.mark.chaos
def test_chaos_snapshot_crash_resumes_from_the_previous_boundary(
        tmp_path, workers):
    cache = make_cache(tmp_path, 2)
    addrs = workers(2)
    ref = learner(distributed_workers=addrs).train(cache)
    wd = str(tmp_path / "wd")
    with failpoints.active("dist.snapshot=error@2"):
        with pytest.raises(failpoints.FailpointError):
            learner(distributed_workers=addrs, working_dir=wd,
                    resume_training_snapshot_interval_trees=1).train(cache)
        assert "dist.snapshot" in failpoints.fired_sites()
    res = learner(distributed_workers=addrs, working_dir=wd,
                  resume_training=True,
                  resume_training_snapshot_interval_trees=1).train(cache)
    assert_same_trees(res, ref)
    assert res.training_logs["distributed"]["resumed_from"] == 1


@pytest.mark.chaos
def test_chaos_resume_attach_drop_and_corrupt_shard(tmp_path, workers):
    """The resumed manager's reattach drops a connection (the shards fail
    over) and finds shard 0 corrupted while it was down (rebuilt)."""
    cache = make_cache(tmp_path, 2)
    addrs = workers(2)
    ref = learner(distributed_workers=addrs).train(cache)
    wd = str(tmp_path / "wd")
    l1 = learner(distributed_workers=addrs, working_dir=wd,
                 resume_training_snapshot_interval_trees=2)
    l1._preempt_after_chunks = 1
    with pytest.raises(port_gbt.TrainingPreempted):
        l1.train(cache)
    path = os.path.join(cache.path, "bins_shard_0.npy")
    before = open(path, "rb").read()
    with open(path, "r+b") as f:
        f.seek(len(before) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with failpoints.active("dist.resume_attach=drop_conn"):
        res = learner(distributed_workers=addrs, working_dir=wd,
                      resume_training=True,
                      resume_training_snapshot_interval_trees=2).train(cache)
        assert "dist.resume_attach" in failpoints.fired_sites()
    assert_same_trees(res, ref)
    d = res.training_logs["distributed"]
    assert d["recoveries"] >= 1 and d["shard_rebuilds"] >= 1
    assert open(path, "rb").read() == before


# --------------------------------------------------------------------- #
# On a card
# --------------------------------------------------------------------- #


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["f32", "int8"])
def test_dist_on_the_card_equals_the_single_device(quant, tmp_path, workers,
                                                   monkeypatch):
    """Two workers on the card (cuda:0, or a card each), the manager on
    cuda:0: the trees are the single device's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    monkeypatch.setenv("YDF_TPU_HIST_QUANT", quant)
    n_cards = torch.cuda.device_count()
    cache = create_dataset_cache(frame(n=20_000), str(tmp_path / "c"),
                                 label="y", task=Task.REGRESSION,
                                 feature_shards=2, device="cuda")
    hp = dict(label="y", task=Task.REGRESSION, num_trees=5, max_depth=5,
              validation_ratio=0.0, early_stopping="NONE", device="cuda")
    single = ydf_tpu_torch.GradientBoostedTreesLearner(**hp).train(cache)
    addrs = workers(1, device="cuda:0") + workers(
        1, device="cuda:1" if n_cards >= 2 else "cuda:0")
    dist = ydf_tpu_torch.GradientBoostedTreesLearner(
        distributed_workers=addrs, **hp).train(cache)
    assert_same_trees(dist, single)
