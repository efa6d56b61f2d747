"""The port's RPC transport (ydf_tpu_torch/parallel/worker_service.py)
against the JAX package's: frames byte-identical for the same message
and secret, a port pool served by a JAX worker and a JAX pool by a port
worker; framing round trips (in-band, out-of-band segments, chunks above
the cap), HMAC, pipelined out-of-order responses, per-request deadlines,
the idle reaper, the frame cap, reconnect after a restart, quarantine
and backoff, the worker's device, the numpy-only wire, the unported
verbs and the orphan-state reaper. In-process workers on the CPU
(start_worker(..., blocking=False, device="cpu"))."""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    from ydf_tpu.parallel import worker_service as jws
except ImportError:
    jws = None

from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset.cache import create_dataset_cache
from ydf_tpu_torch.parallel import dist_worker
from ydf_tpu_torch.parallel import worker_service as ws
from ydf_tpu_torch.parallel.worker_service import WorkerPool, start_worker

torch.set_num_threads(1)


def require_jax():
    if jws is None:
        pytest.skip("needs the JAX package, the reference")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def cpu_worker(**kw):
    port = free_port()
    start_worker(port, host="127.0.0.1", blocking=False, device="cpu", **kw)
    return f"127.0.0.1:{port}"


def payloads():
    """Messages of every framing: small in-band, large arrays as
    out-of-band segments (one non-contiguous, which pickles in-band),
    nested containers and bytes."""
    rng = np.random.default_rng(5)
    big = rng.normal(size=(300, 40)).astype(np.float32)
    return [
        {"verb": "ping"},
        {"verb": "echo", "payload": {"a": np.arange(7, dtype=np.int32),
                                      "s": "x" * 100, "t": (1, 2.5, None)}},
        {"verb": "echo", "payload": {
            "hist": big, "bits": rng.integers(0, 2, 70_000).astype(bool),
            "view": big[:, ::2], "raw": bytes(range(256)) * 64,
            "u16": rng.integers(0, 2 ** 16, 5000).astype(np.uint16)}},
    ]


def same_payload(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_payload(a[k], b[k])
                                             for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


# --------------------------------------------------------------------- #
# Framing
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("secret", [None, b"k3y"])
def test_frames_round_trip_over_a_socket(secret):
    for msg in payloads():
        a, b = socket.socketpair()
        try:
            t = threading.Thread(target=ws._send_msg, args=(a, msg, secret))
            t.start()
            got = ws._recv_msg(b, secret)
            t.join()
        finally:
            a.close()
            b.close()
        assert same_payload(got, msg)


@pytest.mark.parametrize("secret", [None, b"k3y"])
def test_frames_byte_identical_to_the_jax_package(secret):
    """_encode_frame of the same numpy message and secret: the same
    header, segments and MAC in both packages, so either side's frames
    are the other's."""
    require_jax()
    for msg in payloads():
        p, j = ws._encode_frame(msg, secret), jws._encode_frame(msg, secret)
        assert p.header == j.header
        assert [bytes(s) for s in p.segments] == [bytes(s)
                                                  for s in j.segments]
        assert p.mac == j.mac
        assert p.verb == j.verb


def test_the_wire_is_numpy_only():
    with pytest.raises(TypeError, match="numpy"):
        ws._encode_frame({"verb": "echo", "payload": torch.zeros(3)})
    with pytest.raises(TypeError, match="numpy"):
        ws._encode_frame({"dtype": torch.bfloat16})
    # A bf16 operand travels as its uint16 bits with a dtype tag.
    x = torch.randn(50, 6).to(torch.bfloat16)
    w = dist_worker.to_wire(x)
    assert w["dtype"] == "bfloat16" and w["data"].dtype == np.uint16
    frame = ws._encode_frame({"stats": w})
    back = dist_worker.from_wire(
        __import__("pickle").loads(frame.header)["stats"], "cpu")
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)


def test_chunked_frames_round_trip_above_the_cap(monkeypatch):
    monkeypatch.setattr(ws, "_MAX_FRAME", 1 << 16)
    a, b = socket.socketpair()
    try:
        big = {"blob": list(range(40_000)), "x": "y"}  # in-band, > cap
        t = threading.Thread(target=ws._send_msg, args=(a, big, b"k"))
        t.start()
        got = ws._recv_msg(b, b"k")
        t.join()
    finally:
        a.close()
        b.close()
    assert got == big


def test_frame_cap_and_assembly_bound(monkeypatch):
    """A plain frame above the cap fails before any allocation, naming
    YDF_TPU_WORKER_MAX_FRAME; a chunk header past the assembly bound
    too; the env knob is validated eagerly."""
    monkeypatch.setattr(ws, "_MAX_FRAME", 1 << 16)
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("<Q", (1 << 16) + 1))
        with pytest.raises(ConnectionError,
                           match="YDF_TPU_WORKER_MAX_FRAME"):
            ws._recv_payload(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("<Q", ws._CHUNK_SENTINEL)
                  + struct.pack("<QQ", (1 << 16) * ws._CHUNK_FACTOR + 1, 2))
        with pytest.raises(ConnectionError, match="assembly bound"):
            ws._recv_payload(b)
    finally:
        a.close()
        b.close()
    monkeypatch.setenv("YDF_TPU_WORKER_MAX_FRAME", "1024")
    with pytest.raises(ValueError, match="64 KiB"):
        ws._parse_max_frame()
    monkeypatch.setenv("YDF_TPU_WORKER_MAX_FRAME", "nope")
    with pytest.raises(ValueError, match="integer byte count"):
        ws._parse_max_frame()
    monkeypatch.delenv("YDF_TPU_WORKER_MAX_FRAME")
    assert ws._parse_max_frame() == 4 << 30


def test_env_knobs_validated(monkeypatch):
    monkeypatch.setenv("YDF_TPU_WORKER_IDLE_TIMEOUT_S", "-1")
    with pytest.raises(ValueError, match="IDLE_TIMEOUT"):
        ws._parse_idle_timeout()
    for bad in ("banana", "-3", "0.0"):
        monkeypatch.setenv("YDF_TPU_WORKER_STATE_TTL_S", bad)
        with pytest.raises(ValueError, match="YDF_TPU_WORKER_STATE_TTL_S"):
            ws._parse_state_ttl()
    for off in ("0", "off", ""):
        monkeypatch.setenv("YDF_TPU_WORKER_STATE_TTL_S", off)
        assert ws._parse_state_ttl() is None
    monkeypatch.setenv("YDF_TPU_WORKER_STATE_TTL_S", "2.5")
    assert ws._parse_state_ttl() == 2.5
    monkeypatch.setenv("YDF_TPU_WORKER_SEND_TIMEOUT", "7.5")
    assert ws._send_timeout() == 7.5


# --------------------------------------------------------------------- #
# The worker and the pool
# --------------------------------------------------------------------- #


def test_start_worker_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        start_worker(free_port(), blocking=False)


def test_ping_echo_and_unported_verbs():
    addr = cpu_worker()
    pool = WorkerPool([addr], timeout_s=30.0)
    assert pool.request(0, {"verb": "ping"})["ok"]
    for msg in payloads()[1:]:
        resp = pool.request(0, msg)
        assert resp["ok"] and same_payload(resp["payload"], msg["payload"])
    for verb, item in (("train_score", 20), ("load_data", 20),
                       ("serve_predict", 19), ("row_histograms", 18),
                       ("cache_bin_rows", 18)):
        resp = pool.request(0, {"verb": verb, "key": "k"})
        assert not resp["ok"] and f"item {item}" in resp["error"], resp
    assert "unknown verb" in pool.request(0, {"verb": "nope"})["error"]
    tel = pool.request(0, {"verb": "get_telemetry"})
    assert tel["ok"] and tel["rss_bytes"] > 0
    # load_data_all's refusal surfaces as the pool's error.
    with pytest.raises(ConnectionError, match="failed load_data"):
        pool.load_data_all("k", {"a": np.zeros(3)}, None)
    pool.shutdown_all()


def test_hmac_mismatch_drops_the_connection(monkeypatch):
    addr = cpu_worker(secret=b"s3cret")
    good = WorkerPool([addr], timeout_s=10.0, secret=b"s3cret")
    assert good.request(0, {"verb": "ping"})["ok"]
    bad = WorkerPool([addr], timeout_s=5.0, secret=b"wrong")
    with pytest.raises((OSError, ConnectionError)):
        bad.request(0, {"verb": "ping"})
    anon = WorkerPool([addr], timeout_s=5.0)
    anon.secret = None
    with pytest.raises((OSError, ConnectionError)):
        anon.request(0, {"verb": "ping"})
    good.shutdown_all()
    monkeypatch.setenv("YDF_TPU_WORKER_SECRET", "env-secret")
    env = cpu_worker()
    pool = WorkerPool([env], timeout_s=10.0)
    assert pool.request(0, {"verb": "ping"})["ok"]
    pool.shutdown_all()


def test_pipelined_echo_completes_out_of_order():
    """Requests on one pooled connection complete in the order their
    handlers finish, each with its own payload; the connection is dialed
    once."""
    addr = cpu_worker()
    pool = WorkerPool([addr], timeout_s=30.0)
    assert pool.request(0, {"verb": "ping"})["ok"]
    rng = np.random.default_rng(1)
    done, lock = [], threading.Lock()

    def call(i, delay):
        arr = rng.normal(size=4000).astype(np.float32) + i
        resp = pool.request(0, {"verb": "echo", "delay_s": delay,
                                "payload": arr})
        assert np.array_equal(resp["payload"], arr)
        with lock:
            done.append(i)

    threads = [threading.Thread(target=call, args=(i, d))
               for i, d in enumerate((0.8, 0.4, 0.0))]
    for t in threads:
        t.start()
        time.sleep(0.05)
    for t in threads:
        t.join()
    assert done == [2, 1, 0], done
    snap = pool.transport_snapshot()
    assert snap["rpc_connects"] == 1 and snap["rpc_payload_bytes"] > 0
    pool.shutdown_all()


def test_per_request_deadline_leaves_the_connection_up():
    addr = cpu_worker()
    pool = WorkerPool([addr], timeout_s=30.0)
    assert pool.request(0, {"verb": "ping"})["ok"]
    t0 = time.monotonic()
    with pytest.raises(socket.timeout):
        pool.request(0, {"verb": "echo", "delay_s": 1.5, "payload": 1},
                     timeout_s=0.3)
    assert time.monotonic() - t0 < 1.2
    # The same connection serves the next request; the late response is
    # dropped by the reader.
    assert pool.request(0, {"verb": "ping"})["ok"]
    time.sleep(1.5)
    assert pool.request(0, {"verb": "echo", "payload": 7})["payload"] == 7
    assert pool.transport_snapshot()["rpc_connects"] == 1
    pool.shutdown_all()


def test_idle_connections_are_reaped(monkeypatch):
    monkeypatch.setattr(ws, "_IDLE_TIMEOUT_S", 0.3)
    monkeypatch.setenv("YDF_TPU_WORKER_SEND_TIMEOUT", "0.3")
    addr = cpu_worker()
    host, port = addr.split(":")
    stalled = socket.create_connection((host, int(port)))
    stalled.settimeout(10.0)
    t0 = time.monotonic()
    assert stalled.recv(1) == b"", "an idle connection was not closed"
    assert time.monotonic() - t0 < 5.0
    stalled.close()
    # A stalled peer never blocks another client.
    pool = WorkerPool([addr], timeout_s=10.0)
    other = socket.create_connection((host, int(port)))
    assert pool.request(0, {"verb": "ping"})["ok"]
    other.close()
    pool.shutdown_all()


def test_reconnect_after_a_worker_restart():
    port = free_port()
    addr = f"127.0.0.1:{port}"
    start_worker(port, blocking=False, device="cpu")
    pool = WorkerPool([addr], timeout_s=10.0, backoff_base_s=0.05,
                      backoff_max_s=0.2)
    assert pool.request(0, {"verb": "ping"})["ok"]
    WorkerPool([addr]).shutdown_all()
    time.sleep(0.3)
    start_worker(port, blocking=False, device="cpu")
    resp, idx = pool.request_retry(0, {"verb": "ping"})
    assert resp["ok"] and idx == 0
    assert pool.transport_snapshot()["rpc_connects"] >= 2
    pool.shutdown_all()


def test_quarantine_backoff_and_reprobe():
    live = free_port()
    start_worker(live, blocking=False, device="cpu")
    late = free_port()
    pool = WorkerPool([f"127.0.0.1:{late}", f"127.0.0.1:{live}"],
                      timeout_s=5.0, backoff_base_s=0.1, backoff_max_s=0.4)
    resp, idx = pool.request_retry(0, {"verb": "ping"})
    assert resp["ok"] and pool.addr_str(idx) == f"127.0.0.1:{live}"
    assert pool._health, "the failed worker was not quarantined"
    pool.mark_failed(0)  # a fresh hold: skipped without a network attempt
    assert pool.is_quarantined(0) and pool.pick_worker(0) == 1
    start_worker(late, blocking=False, device="cpu")
    time.sleep(0.7)
    assert pool.pick_worker(0) == 0 and not pool._health
    d0 = [pool.backoff_delay(0) for _ in range(20)]
    d3 = [pool.backoff_delay(3) for _ in range(20)]
    assert all(0.05 <= d < 0.15 for d in d0) and len(set(d0)) > 1
    assert all(0.2 <= d < 0.6 for d in d3)
    rr = WorkerPool(["h:1", "h:2", "h:3"])
    assert [rr.next_worker() for _ in range(6)] == [0, 1, 2, 0, 1, 2]
    rr.mark_failed(1)
    assert 1 not in [rr.next_worker() for _ in range(8)]
    for p in (live, late):
        WorkerPool([f"127.0.0.1:{p}"]).shutdown_all()


@pytest.mark.parametrize("direction", ["port_pool_jax_worker",
                                       "jax_pool_port_worker"])
def test_interop_with_the_jax_package(direction):
    """ping and echo across packages, both ways, with a secret."""
    require_jax()
    port = free_port()
    addr = f"127.0.0.1:{port}"
    if direction == "port_pool_jax_worker":
        jws.start_worker(port, blocking=False, secret=b"xk")
        pool = WorkerPool([addr], timeout_s=30.0, secret=b"xk")
    else:
        start_worker(port, blocking=False, device="cpu", secret=b"xk")
        pool = jws.WorkerPool([addr], timeout_s=30.0, secret=b"xk")
    pong = pool.request(0, {"verb": "ping"})
    assert pong["ok"] and isinstance(pong["clock_ns"], int)
    for msg in payloads()[1:]:
        resp = pool.request(0, msg)
        assert resp["ok"] and same_payload(resp["payload"], msg["payload"])
    pool.shutdown_all()


# --------------------------------------------------------------------- #
# Worker state housekeeping
# --------------------------------------------------------------------- #


def small_cache(tmp_path, n=400, seed=0):
    rng = np.random.RandomState(seed)
    frame = {"a": rng.normal(size=n), "b": rng.normal(size=n),
             "y": rng.normal(size=n).astype(np.float32)}
    return create_dataset_cache(frame, str(tmp_path / f"c{seed}"),
                                label="y", task=Task.REGRESSION,
                                feature_shards=2, device="cpu")


def test_worker_state_reaped_after_ttl(tmp_path):
    cache = small_cache(tmp_path)
    r = dist_worker.handle(
        "load_cache_shard", {"key": "ttl-k", "shards": [0, 1],
                             "cache_dir": cache.path, "epoch": 1}, "ttl-w")
    assert r["ok"] and r["shard_bytes"] > 0
    assert dist_worker.shard_bytes_total("ttl-w") > 0
    assert dist_worker.status("ttl-w")["ttl-k"]["shards"] == [0, 1]
    assert dist_worker.reap_idle_state(3600.0) == (0, 0)
    time.sleep(0.05)
    n, freed = dist_worker.reap_idle_state(0.02)
    assert n >= 1 and freed > 0
    assert dist_worker.shard_bytes_total("ttl-w") == 0
    r2 = dist_worker.handle(
        "build_histograms",
        {"key": "ttl-k", "epoch": 1, "tree": 0, "layer": 0, "reset": True,
         "shards": [0], "num_slots": 1, "num_bins": cache.binner.num_bins},
        "ttl-w")
    assert r2.get("need_shard") is True
    dist_worker.reset_state()


def test_worker_reaper_thread_runs_with_ttl(tmp_path, monkeypatch):
    cache = small_cache(tmp_path, n=300, seed=1)
    monkeypatch.setattr(ws, "_STATE_TTL_S", 0.2)
    addr = cpu_worker()
    pool = WorkerPool([addr])
    pool.load_data_each("reap-k", [{"shards": [0, 1],
                                    "cache_dir": cache.path, "epoch": 1}],
                        verb="load_cache_shard")
    assert dist_worker.shard_bytes_total(addr) > 0
    deadline = time.time() + 10
    while dist_worker.shard_bytes_total(addr) > 0 and time.time() < deadline:
        time.sleep(0.05)
    assert dist_worker.shard_bytes_total(addr) == 0
    pool.shutdown_all()


@pytest.mark.gpu
def test_worker_on_the_card_answers_histograms(tmp_path):
    """A worker on cuda:0 loads its shards on the card and its
    build_histograms (csrc/histogram.cu) equals the plain version on the
    same shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from ydf_tpu_torch.ops import histogram_kernels

    cache = small_cache(tmp_path, n=5000, seed=2)
    addr = None
    port = free_port()
    start_worker(port, blocking=False, device="cuda:0")
    addr = f"127.0.0.1:{port}"
    pool = WorkerPool([addr], timeout_s=120.0)
    rng = np.random.default_rng(3)
    stats = rng.normal(size=(5000, 3)).astype(np.float32)
    req = {"verb": "load_cache_shard", "key": "g", "shards": [0, 1],
           "cache_dir": cache.path, "epoch": 1}
    assert pool.request(0, req)["ok"]
    resp = pool.request(0, {
        "verb": "build_histograms", "key": "g", "epoch": 1, "tree": 0,
        "layer": 0, "reset": True, "shards": [0, 1], "num_slots": 1,
        "num_bins": cache.binner.num_bins, "quant": "f32",
        "stats": {"hist_stats": dist_worker.to_wire(torch.from_numpy(stats)),
                  "qscale": None}})
    assert resp["ok"], resp
    for k in (0, 1):
        bins_t = torch.from_numpy(np.array(cache.shard_bins(k))).t()
        want = histogram_kernels.histogram_plain(
            bins_t.contiguous(), torch.zeros(5000, dtype=torch.int32),
            torch.from_numpy(stats), 1, cache.binner.num_bins)
        assert np.array_equal(resp["hists"][k], want.numpy())
    pool.shutdown_all()
