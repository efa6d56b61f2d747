"""The port's telemetry, failpoints, log, exposition endpoints and
profiling (utils/telemetry.py, failpoints.py, log.py, telemetry_http.py,
profiling.py; counterparts of tests/test_telemetry.py,
test_failpoints.py, test_telemetry_http.py and test_profiling.py): the
failpoint grammar and its errors against the JAX module's, every site of
the port firing, metrics_text() of the same small training and predict
in both packages naming the same metrics and labels with equal counts,
the flushed trace and its spans, the memory ledger, the flight
recorder, the HTTP server on 127.0.0.1, and the profiler trace.
"""

import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request

import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import ydf_tpu as ydf
    from ydf_tpu.utils import failpoints as jax_failpoints
    from ydf_tpu.utils import telemetry as jax_telemetry
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.dataset import cache as pcache
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.utils import (failpoints, log, profiling, telemetry,
                                 telemetry_http)
from test_torch_checkpoint import data, gbt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


# ---- failpoints ---------------------------------------------------------


def test_parse_full_grammar():
    specs = failpoints.parse("cache.write_chunk=error@2;gbt.chunk=drop_conn@1;"
                             "snapshot.save=torn_write;cache.finalize="
                             "fail_once")
    assert (specs["cache.write_chunk"].action,
            specs["cache.write_chunk"].at) == ("error", 2)
    assert specs["gbt.chunk"].action == "drop_conn"
    assert specs["snapshot.save"].action == "torn_write"
    assert (specs["cache.finalize"].action,
            specs["cache.finalize"].at) == ("error", 1)
    assert failpoints.parse("") == {} == failpoints.parse(" ; ;")
    assert failpoints.parse(None) == {}


@pytest.mark.parametrize("bad", [
    "nosuch.site=error", "gbt.chunk=explode", "gbt.chunk", "gbt.chunk=",
    "gbt.chunk=error@0", "gbt.chunk=error@x",
    "gbt.chunk=error;gbt.chunk=error", "gbt.chunk=torn_write",
    "gbt.chunk=stall",
])
def test_parse_errors_match_jax(bad):
    """The same ValueError as the JAX module's; the lists of known or
    supporting sites differ (the port has fewer sites)."""
    require_jax()

    def message(mod):
        with pytest.raises(ValueError) as e:
            mod.parse(bad)
        return re.sub(r"\[.*\]", "[...]", str(e.value))

    assert message(failpoints) == message(jax_failpoints)


def test_env_schedule_is_validated_at_import():
    env = dict(os.environ, YDF_TPU_FAILPOINTS="gbt.chunk=errr",
               PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-c",
                        "import ydf_tpu_torch.utils.failpoints"],
                       env=env, capture_output=True, text=True)
    assert p.returncode != 0 and "is not one of" in p.stderr


def test_hit_fires_once_at_the_nth_and_active_restores():
    assert not failpoints.ENABLED
    assert failpoints.hit("gbt.chunk") is None  # unarmed: free
    with failpoints.active("gbt.chunk=error@2;cache.finalize=drop_conn"):
        assert failpoints.hit("gbt.chunk") is None
        with pytest.raises(failpoints.FailpointError):
            failpoints.hit("gbt.chunk")
        assert failpoints.hit("gbt.chunk") is None  # fired once
        with pytest.raises(ConnectionError):
            failpoints.hit("cache.finalize")
        assert sorted(failpoints.fired_sites()) == ["cache.finalize",
                                                    "gbt.chunk"]
        with failpoints.active("snapshot.save=torn_write"):
            assert failpoints.hit("snapshot.save") == "torn_write"
    assert not failpoints.ENABLED and failpoints.fired_sites() == []


def _fire(site, tmp_path):
    """Drives the code path of `site` with its failpoint armed; returns
    what the site raised (None when it swallows the fault)."""
    d = data(600)
    if site in ("gbt.chunk", "telemetry.oom", "snapshot.save",
                "snapshot.index"):
        learner = gbt(num_trees=4, validation_ratio=0.0,
                      working_dir=str(tmp_path / "wd"),
                      resume_training_snapshot_interval_trees=2)
        try:
            learner.train(d)
        except (failpoints.FailpointError, MemoryError) as e:
            return e
        return None
    if site in ("cache.write_chunk", "cache.finalize"):
        try:
            pcache.create_dataset_cache(
                d, str(tmp_path / "cache"), label="label", chunk_rows=200,
                device="cpu")
        except failpoints.FailpointError as e:
            return e
        return None
    if site.startswith("worker."):
        # The fault drops the connection: the client sees it die.
        return _fire_worker(site)
    if site.startswith("dist."):
        return _fire_dist(site, d, tmp_path)
    with telemetry.active(str(tmp_path / "tele")):
        telemetry.counter("ydf_x_total").inc()
        telemetry.flush()  # swallows the fault, counts it
        assert telemetry.snapshot()["counters"][
            "ydf_telemetry_flush_errors_total"] == 1
    return None


def _cpu_workers(n):
    """n in-process CPU workers (parallel/worker_service.py); their
    addresses."""
    import socket

    from ydf_tpu_torch.parallel.worker_service import start_worker

    addrs = []
    for _ in range(n):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        start_worker(port, blocking=False, device="cpu")
        addrs.append(f"127.0.0.1:{port}")
    return addrs


def _fire_worker(site):
    from ydf_tpu_torch.parallel.worker_service import WorkerPool

    addrs = _cpu_workers(1)
    pool = WorkerPool(addrs, timeout_s=10.0)
    try:
        pool.request(0, {"verb": "ping"})
    except ConnectionError as e:
        return e
    finally:
        pool.shutdown_all()
    return None


def _fire_dist(site, d, tmp_path):
    """A distributed GBT over two CPU workers from a two-shard cache;
    with a working_dir for the snapshot sites, resumed after a
    preemption for dist.resume_attach."""
    from ydf_tpu_torch.parallel.dist_gbt import DistributedTrainingError
    from ydf_tpu_torch.parallel.worker_service import WorkerPool

    cache = pcache.create_dataset_cache(
        d, str(tmp_path / "dcache"), label="label", feature_shards=2,
        device="cpu")
    addrs = _cpu_workers(2)
    kw = dict(num_trees=4, validation_ratio=0.0, distributed_workers=addrs)
    if site in ("dist.snapshot", "dist.resume_attach"):
        kw.update(working_dir=str(tmp_path / "dwd"),
                  resume_training_snapshot_interval_trees=2)
    try:
        if site == "dist.resume_attach":
            first = gbt(**kw)
            first._preempt_after_chunks = 1
            with pytest.raises(port_gbt.TrainingPreempted):
                first.train(cache)
            kw["resume_training"] = True
        gbt(**kw).train(cache)
    except (failpoints.FailpointError, DistributedTrainingError) as e:
        return e
    finally:
        WorkerPool(addrs).shutdown_all()
    return None


@pytest.mark.parametrize("site", sorted(failpoints.KNOWN_SITES))
def test_every_site_fires(site, tmp_path):
    action = "torn_write" if site == "snapshot.save" else "error"
    with failpoints.active(f"{site}={action}"):
        err = _fire(site, tmp_path)
        assert failpoints.fired_sites() == [site]
    if site == "telemetry.oom":
        assert isinstance(err, MemoryError)
    elif site == "telemetry.flush":
        assert err is None
    elif site.startswith("worker."):
        assert isinstance(err, ConnectionError)
    elif site == "dist.epoch_fence":
        # The worker answers the stale-epoch rejection; the manager stops.
        assert "fenced out" in str(err)
    else:
        assert isinstance(err, failpoints.FailpointError)


# ---- metrics, spans, the ledger, the flight recorder --------------------


def _families(text):
    """{metric: sorted label keys} of a Prometheus exposition, and the
    sample values by full name."""
    fams, values = {}, {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        base = name.split("{", 1)[0]
        keys = tuple(sorted(re.findall(r'(\w+)="', name)))
        fams.setdefault(base, set()).add(keys)
        values[name] = float(value)
    return fams, values


#: Families of the JAX package that the port has no counterpart of: its
#: native CPU kernels' and thread pool's counters, its device-loop
#: accounting.
JAX_ONLY = ("ydf_native_", "ydf_pool_", "ydf_train_dispatches",
            "ydf_train_host_sync")


def test_metrics_of_the_same_run_match_jax(tmp_path):
    """One small training (two chunks of the look-ahead stop) and one
    predict under telemetry in each package: the same metric families
    with the same label keys, the same iteration count, one serve
    request in the same batch bucket."""
    require_jax()
    d = data(2000)
    hp = dict(label="label", num_trees=12, max_depth=3,
              early_stopping_num_trees_look_ahead=6)
    rows = {k: v[:300] for k, v in d.items() if k != "label"}
    texts = {}
    with jax_telemetry.active(str(tmp_path / "jax")):
        ydf.GradientBoostedTreesLearner(**hp).train(d).predict(rows)
        texts["jax"] = jax_telemetry.metrics_text()
    with telemetry.active(str(tmp_path / "port")):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            device="cpu", **hp).train(d).predict(rows)
        texts["port"] = telemetry.metrics_text()
    (jf, jv), (pf, pv) = (_families(texts[k]) for k in ("jax", "port"))
    jf = {k: v for k, v in jf.items() if not k.startswith(JAX_ONLY)}
    assert set(pf) == set(jf), (sorted(set(pf) ^ set(jf)))
    for k in pf:
        assert pf[k] == jf[k], k
    assert pv["ydf_train_iterations_total"] == (
        jv["ydf_train_iterations_total"]) == 12
    bucket = [k for k in pv if k.startswith("ydf_serve_latency_ns_count")]
    assert len(bucket) == 1 and 'batch_pow2="512"' in bucket[0]
    assert pv[bucket[0]] == 1


def test_flush_writes_the_trace_and_the_ledger(tmp_path):
    d = data(1500)
    out = str(tmp_path / "tele")
    with telemetry.active(out):
        m = gbt(num_trees=6, validation_ratio=0.0).train(d)
        m.predict(d)
        telemetry.flush()
        mem = m.training_logs["memory"]
    assert mem["subsystems"]["bin_matrix"] > 0 and mem["rss_bytes"] > 0
    files = sorted(os.listdir(out))
    trace = [f for f in files if f.startswith("trace-")]
    assert trace and [f for f in files if f.startswith("metrics-")]
    with open(os.path.join(out, trace[0])) as f:
        names = {json.loads(line)["name"] for line in f}
    assert {"train", "train.chunk", "train.tree", "train.layer",
            "serve.predict", "serve.encode", "serve.kernel"} <= names
    assert m.training_profile["device_loop"] > 0


def test_disabled_span_is_one_shared_singleton():
    assert not telemetry.ENABLED
    assert telemetry.span("a") is telemetry.span("b")
    telemetry.emit_span("a", 0, 1)
    assert telemetry.events() == []


def test_preemption_writes_the_flight_recorder(tmp_path):
    out = str(tmp_path / "tele")
    learner = gbt(num_trees=6, validation_ratio=0.0,
                  working_dir=str(tmp_path / "wd"),
                  resume_training_snapshot_interval_trees=2)
    learner._preempt_after_chunks = 1
    with telemetry.active(out):
        with pytest.raises(port_gbt.TrainingPreempted):
            learner.train(data(600))
    dumps = [f for f in os.listdir(out) if f.startswith("flight_")]
    with open(os.path.join(out, dumps[0])) as f:
        head = json.loads(f.readline())
        kinds = {json.loads(line)["kind"] for line in f}
    assert head["reason"] == "preempt" and "preempt" in kinds


def test_log_levels():
    assert log._parse_level(None) == "info"
    with pytest.raises(ValueError, match="YDF_TPU_LOG"):
        log._parse_level("loud")
    old = log.LEVEL
    try:
        log.set_level("debug")
        assert log.is_debug()
    finally:
        log.set_level(old)


# ---- the HTTP endpoints -------------------------------------------------


def test_http_server_serves_metrics_on_loopback():
    p = telemetry_http._parse_metrics_port
    assert p(None) is None and p("0") == 0
    with pytest.raises(ValueError, match="outside"):
        p("70000")
    if telemetry_http.METRICS_PORT is None:
        assert telemetry_http.maybe_start_from_env() is None
    try:
        with telemetry.active():
            telemetry.counter("ydf_test_total").inc(2)
            srv = telemetry_http.start_metrics_server(port=0)
            assert srv.host == "127.0.0.1"

            def get(path):
                with urllib.request.urlopen(srv.url(path), timeout=5) as r:
                    return r.status, r.read().decode()

            status, body = get("/metrics")
            assert status == 200 and "ydf_test_total 2" in body
            assert get("/healthz") == (200, "ok\n")
            st = json.loads(get("/statusz")[1])
            assert "memory" in st and "YDF_TPU_LOG" in st["config"]
            with pytest.raises(urllib.error.HTTPError):
                get("/nope")
            assert telemetry.snapshot()["counters"][
                'ydf_metrics_http_requests_total{path="/metrics"}'] == 1
    finally:
        telemetry_http._reset_for_tests()


# ---- profiling ----------------------------------------------------------


def test_stage_timer_and_profiler_trace(tmp_path, monkeypatch):
    t = profiling.StageTimer()
    with t.stage("a"):
        pass
    prof = t.finish()
    assert {"a", "total", "other"} <= set(prof)
    assert profiling.format_profile(prof).startswith("total=")
    assert profiling.format_profile(None) == "(no profile)"
    monkeypatch.setenv("YDF_TPU_PROFILE_DIR", str(tmp_path))
    gbt(num_trees=2, validation_ratio=0.0).train(data(500))
    counts = profiling.trace_event_counts(str(tmp_path))
    secs = profiling.trace_event_seconds(str(tmp_path), ("aten::",))
    assert counts and secs and all(k.startswith("aten::") for k in secs)


@pytest.mark.gpu
def test_telemetry_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    with telemetry.active(str(tmp_path)):
        m = ydf_tpu_torch.GradientBoostedTreesLearner(
            label="label", num_trees=6, max_depth=3,
            validation_ratio=0.0).train(data(2000))
        m.predict(data(2000))
        text = telemetry.metrics_text()
    assert "ydf_train_iterations_total 6" in text
    assert "ydf_serve_requests_total" in text
