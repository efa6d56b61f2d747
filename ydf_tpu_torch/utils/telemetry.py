"""Process-wide telemetry: the metrics registry and tracing spans
(counterpart of ydf_tpu/utils/telemetry.py: the same environment
variables, metric names and exports).

Three primitives:

  * **Counters / gauges**: monotonically added and last-set values,
    keyed by (name, sorted label items).
  * **Latency histograms**: log2-bucketed (8 linear sub-buckets per
    octave, so ~12.5 % worst-case value resolution) over non-negative
    integer nanoseconds; p50/p90/p99 come from the buckets with linear
    interpolation inside the covering sub-bucket.
  * **Tracing spans**: `with telemetry.span("train.chunk"): ...` nest by
    wall-clock containment per thread (train -> chunk -> tree; serve.
    predict -> serve.encode / serve.kernel) and export as Chrome-tracing
    JSONL (one complete "X" event per line).

Enablement (the failpoints.py zero-overhead contract):

  * `YDF_TPU_TELEMETRY_DIR=/path`: enable AND export: every `flush()`
    (end of `train()`, the end of each checkpointed chunk, process exit)
    appends spans to `trace-<pid>.jsonl` and rewrites
    `metrics-<pid>.prom` (Prometheus text exposition) there. The
    directory is created EAGERLY at import so a bad path fails at the
    environment boundary.
  * `YDF_TPU_TELEMETRY=1|on`: enable the in-memory registry without
    export (`snapshot()`, `metrics_text()`, `events()`). Any other value
    raises ValueError at import.
  * `YDF_TPU_MEM_SAMPLE=0|off`: no RSS sample at span exits (default on).
  * Programmatic: `configure(...)`, or `with telemetry.active(dir): ...`
    which arms a FRESH registry and event buffer and restores the
    previous state on exit.

Overhead contract: with the variables unset, every instrumented site
costs one module-attribute lookup plus a bool check
(`telemetry.ENABLED`), and `span(name)` returns the same no-op singleton
(no allocation). Sites follow the pattern

    with telemetry.span("serve.predict") as sp:
        if telemetry.ENABLED:
            sp.set(batch=n, engine=name)

`flush()` NEVER raises: the exporter is observation, and a full disk or
an injected fault (failpoint site `telemetry.flush`) must not change the
trained model.

Also: span identity (`sid` / `parent`, `current_context()`), Prometheus
histograms as cumulative `_bucket` / `_sum` / `_count` series, the
flight recorder (a bounded ring of recent spans, log lines and failpoint
firings; `flight_dump(reason)` writes `flight_<pid>.jsonl` on
preemption and on a crash of the boosting loop, never raising), and the
MemoryLedger (per-subsystem bytes: pushed gauges and pull sources such
as `dataset_cache` and `bin_matrix`, with the RSS figures). The
exposition endpoints live in utils/telemetry_http.py.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "ENABLED",
    "EXPORT_DIR",
    "MEM_SAMPLE",
    "span",
    "counter",
    "gauge",
    "histogram",
    "emit_span",
    "events",
    "snapshot",
    "metrics_text",
    "flush",
    "reset",
    "active",
    "configure",
    "register_collector",
    "pow2_bucket",
    "LatencyHistogram",
    "Counter",
    "Gauge",
    "current_context",
    "flight_record",
    "flight_events",
    "flight_dump",
    "MemoryLedger",
    "ledger",
    "mem_set",
    "mem_add",
    "register_mem_source",
    "rss_bytes",
    "peak_rss_bytes",
    "COLLECTOR_METRICS",
]


# --------------------------------------------------------------------- #
# Env boundary (eager, like YDF_TPU_FAILPOINTS)
# --------------------------------------------------------------------- #

_ON_VALUES = ("1", "on")
_OFF_VALUES = ("", "0", "off")


def _parse_env(
    flag: Optional[str], directory: Optional[str]
) -> Tuple[bool, Optional[str]]:
    """Validates (YDF_TPU_TELEMETRY, YDF_TPU_TELEMETRY_DIR) eagerly.
    Returns (enabled, export_dir). A directory implies enabled; the
    directory is created here so a bad path fails at import, not at the
    first flush hours into training."""
    f = (flag or "").strip().lower()
    if f not in _ON_VALUES + _OFF_VALUES:
        raise ValueError(
            f"YDF_TPU_TELEMETRY={flag!r} is not one of "
            f"{list(_ON_VALUES + _OFF_VALUES)}"
        )
    d = (directory or "").strip() or None
    if d is not None:
        try:
            os.makedirs(d, exist_ok=True)
        except OSError as e:
            raise ValueError(
                f"YDF_TPU_TELEMETRY_DIR={d!r} cannot be created: "
                f"{type(e).__name__}: {e}"
            ) from e
    return (f in _ON_VALUES) or (d is not None), d


def _parse_mem_sample(raw: Optional[str]) -> bool:
    """Validates YDF_TPU_MEM_SAMPLE eagerly: whether span exits sample
    the process RSS into the memory ledger's resettable high-watermark
    (sampled_peak_rss_bytes). Default ON — the sample is throttled to
    one /proc read per 10 ms, and it only ever runs when telemetry
    itself is enabled (zero cost on the disabled path)."""
    v = ("1" if raw is None else raw).strip().lower()
    if v in _ON_VALUES or v == "":
        return True
    if v in _OFF_VALUES:
        return False
    raise ValueError(
        f"YDF_TPU_MEM_SAMPLE={raw!r} is not one of "
        f"{sorted(set(_ON_VALUES + _OFF_VALUES) - {''})} (or unset)"
    )


# --------------------------------------------------------------------- #
# Metrics
# --------------------------------------------------------------------- #


class Counter:
    """Monotonically increasing value. inc() is a plain add — the
    lock-free fast path (GIL-serialized; see module docstring)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-set value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


#: Linear sub-buckets per power-of-two octave: worst-case relative
#: bucket width (and so percentile error) is 1/_SUB = 12.5 %.
_SUB = 8
_NUM_BUCKETS = 64 * _SUB


class LatencyHistogram:
    """Log2-bucketed histogram over non-negative integer nanoseconds.

    Bucket index for v ≥ 1: octave e = v.bit_length() − 1, sub-bucket
    s = ⌊(v − 2^e) · 8 / 2^e⌋, index = 8·e + s; v < 1 → bucket 0.
    observe() is a list-slot `+=` (lock-free fast path); percentiles
    walk the 512 slots and interpolate linearly inside the covering
    sub-bucket, clamped to the exact observed [min, max]."""

    __slots__ = ("buckets", "count", "total", "min", "max")

    def __init__(self) -> None:
        self.buckets = [0] * _NUM_BUCKETS
        self.count = 0
        self.total = 0
        self.min = None  # exact extrema: clamp + zero-count answers
        self.max = None

    @staticmethod
    def bucket_index(v: int) -> int:
        if v < 1:
            return 0
        e = v.bit_length() - 1
        if e > 62:
            return _NUM_BUCKETS - 1
        return (e << 3) + (((v - (1 << e)) << 3) >> e)

    @staticmethod
    def bucket_bounds(i: int) -> Tuple[float, float]:
        e, s = i >> 3, i & 7
        base = float(1 << e)
        return base + s * base / _SUB, base + (s + 1) * base / _SUB

    def observe_ns(self, v) -> None:
        v = int(v)
        self.buckets[self.bucket_index(v)] += 1
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def observe_s(self, seconds: float) -> None:
        self.observe_ns(int(seconds * 1e9))

    def percentile_ns(self, p: float) -> Optional[float]:
        """Nearest-rank percentile with in-bucket linear interpolation;
        None while empty."""
        if self.count == 0:
            return None
        rank = min(max(int(math.ceil(p / 100.0 * self.count)), 1),
                   self.count)
        cum = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if cum + c >= rank:
                lo, hi = self.bucket_bounds(i)
                frac = (rank - cum) / c
                est = lo + frac * (hi - lo)
                return float(min(max(est, self.min), self.max))
            cum += c
        return float(self.max)  # unreachable, defensive

    def summary(self) -> Dict[str, float]:
        out = {
            "count": self.count,
            "sum_ns": self.total,
        }
        if self.count:
            out.update(
                min_ns=self.min,
                max_ns=self.max,
                p50_ns=self.percentile_ns(50),
                p90_ns=self.percentile_ns(90),
                p99_ns=self.percentile_ns(99),
            )
        return out


_MetricKey = Tuple[str, Tuple[Tuple[str, str], ...]]


class _Registry:
    """Process-wide metric store. Creation takes a lock; the returned
    metric objects are then incremented lock-free at the sites."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_MetricKey, Counter] = {}
        self._gauges: Dict[_MetricKey, Gauge] = {}
        self._hists: Dict[_MetricKey, LatencyHistogram] = {}

    @staticmethod
    def _key(name: str, labels: Dict[str, object]) -> _MetricKey:
        return name, tuple(sorted((k, str(v)) for k, v in labels.items()))

    def _get(self, store, cls, name, labels):
        key = self._key(name, labels)
        m = store.get(key)
        if m is None:
            with self._lock:
                m = store.setdefault(key, cls())
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> LatencyHistogram:
        return self._get(self._hists, LatencyHistogram, name, labels)


def _fmt_labels(items: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


# --------------------------------------------------------------------- #
# Memory ledger
# --------------------------------------------------------------------- #

#: Metric families produced by registered COLLECTORS (pull model): they
#: have no literal counter/gauge call site, so this dict is their
#: registry (name -> kind), the collector-side analogue of
#: failpoints.KNOWN_SITES; metrics_text() takes each family's kind
#: from it.
COLLECTOR_METRICS: Dict[str, str] = {
    # memory ledger (MemoryLedger below)
    "ydf_mem_bytes": "gauge",
    "ydf_mem_rss_bytes": "gauge",
    "ydf_mem_peak_rss_bytes": "gauge",
    "ydf_mem_sampled_peak_rss_bytes": "gauge",
}


def rss_bytes() -> int:
    """Current resident set size of this process in bytes
    (/proc/self/statm; 0 where unavailable — the accounting degrades,
    never raises)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        return 0


def peak_rss_bytes() -> int:
    """Process-LIFETIME peak RSS in bytes (getrusage ru_maxrss; kB on
    Linux). Monotone for the process — per-run peaks come from the
    ledger's resettable sampled watermark instead."""
    try:
        import resource

        return int(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        ) * 1024
    except Exception:
        return 0


class MemoryLedger:
    """Per-subsystem byte accounting: who holds how many bytes.

    Two feeds:

      * **pushed gauges** — `mem_set(subsystem, n)` / `mem_add(...)`
        from instrumented sites, gated on `telemetry.ENABLED` (the
        zero-overhead contract);
      * **pull sources** — `register_mem_source(subsystem, fn)` where
        `fn()` returns the subsystem's CURRENT resident bytes, sampled
        only at snapshot time (the dataset cache's memmaps, the device
        bin matrix). Sources are process-level facts and live in a
        module registry that survives `active()` — a run-scoped swap
        must not forget that a 2 GB cache is still open.

    `snapshot()` additionally reports current RSS, lifetime peak RSS,
    and the RESETTABLE `sampled_peak_rss_bytes` high-watermark fed by
    span exits (throttled; YDF_TPU_MEM_SAMPLE). Surfaced on /statusz
    (`memory` section), on `training_logs["memory"]` and in every
    metrics dump (`ydf_mem_*`)."""

    __slots__ = ("_lock", "_gauges", "_sampled_peak_rss",
                 "_last_sample_ns")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gauges: Dict[str, int] = {}
        self._sampled_peak_rss = 0
        self._last_sample_ns = 0

    def set_bytes(self, subsystem: str, n) -> None:
        self._gauges[subsystem] = int(n)

    def add_bytes(self, subsystem: str, delta) -> None:
        with self._lock:
            self._gauges[subsystem] = max(
                self._gauges.get(subsystem, 0) + int(delta), 0
            )

    def get_bytes(self, subsystem: str) -> int:
        v = self._gauges.get(subsystem)
        if v is not None:
            return v
        fn = _MEM_SOURCES.get(subsystem)
        if fn is None:
            return 0
        try:
            return int(fn())
        except Exception:
            return 0

    def note_rss(self, now_ns: int = 0) -> None:
        """Samples current RSS into the resettable high-watermark; at
        most one /proc read per 10 ms (span exits call this)."""
        if now_ns and now_ns - self._last_sample_ns < 10_000_000:
            return
        self._last_sample_ns = now_ns or time.perf_counter_ns()
        r = rss_bytes()
        if r > self._sampled_peak_rss:
            self._sampled_peak_rss = r

    def snapshot(self) -> Dict[str, object]:
        # A snapshot is itself a sample point: the watermark is "max
        # RSS over every observation", and observing includes scraping.
        self.note_rss()
        subs = dict(self._gauges)
        for name, fn in list(_MEM_SOURCES.items()):
            try:
                subs[name] = int(fn())
            except Exception:
                continue  # a broken source must never break the page
        return {
            "subsystems": subs,
            "rss_bytes": rss_bytes(),
            "peak_rss_bytes": peak_rss_bytes(),
            "sampled_peak_rss_bytes": int(self._sampled_peak_rss),
        }


#: Pull sources OUTSIDE the swappable state: what is resident in this
#: process does not change because a test armed a fresh registry.
_MEM_SOURCES: Dict[str, Callable[[], int]] = {}


def register_mem_source(subsystem: str, fn: Callable[[], int]) -> None:
    """Registers (or replaces) a pull source: `fn()` -> current bytes
    held by `subsystem`, sampled at snapshot()/metrics dumps only.
    Registration is cheap and unconditional (no ENABLED gate — the
    cost model is pull, not push)."""
    _MEM_SOURCES[subsystem] = fn


def ledger() -> MemoryLedger:
    return _STATE["ledger"]


def mem_set(subsystem: str, n) -> None:
    """Pushes a subsystem byte gauge; free no-op when telemetry is
    off (module-constant bool check, the failpoints contract)."""
    if not ENABLED:
        return
    _STATE["ledger"].set_bytes(subsystem, n)


def mem_add(subsystem: str, delta) -> None:
    if not ENABLED:
        return
    _STATE["ledger"].add_bytes(subsystem, delta)


def _ledger_metrics() -> Dict[str, float]:
    """The ledger as labeled collector samples (`ydf_mem_bytes{
    subsystem="…"}` + the RSS gauges), the default collector."""
    snap = _STATE["ledger"].snapshot()
    out: Dict[str, float] = {
        "ydf_mem_rss_bytes": float(snap["rss_bytes"]),
        "ydf_mem_peak_rss_bytes": float(snap["peak_rss_bytes"]),
        "ydf_mem_sampled_peak_rss_bytes": float(
            snap["sampled_peak_rss_bytes"]
        ),
    }
    for sub, n in snap["subsystems"].items():
        out[f'ydf_mem_bytes{{subsystem="{sub}"}}'] = float(n)
    return out


# --------------------------------------------------------------------- #
# Spans
# --------------------------------------------------------------------- #

#: Event-buffer cap — a run that never flushes must stay bounded; drops
#: are counted in ydf_telemetry_dropped_events_total.
_MAX_EVENTS = 200_000


class _NoopSpan:
    """Singleton returned by span() when telemetry is disabled. No state,
    no allocations: __enter__/__exit__ return existing objects only."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **kw):
        pass


_NOOP_SPAN = _NoopSpan()

#: Process-stable trace id: every span of this process belongs to it
#: (merged cross-process traces share one trace identity).
TRACE_ID = os.urandom(6).hex()

#: Monotonic span-id source (enabled path only — the disabled singleton
#: never allocates an id).
_SPAN_IDS = itertools.count(1)

#: Per-thread stack of OPEN span ids — the parent chain
#: current_context() reads. Thread-local: spans nest by wall-clock
#: containment per thread (module docstring), so the parent of a new
#: span is whatever span is open on the SAME thread.
_TLS = threading.local()


def _span_stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current_context() -> Optional[Dict[str, object]]:
    """The innermost OPEN span on this thread as a propagation context
    `{"trace": ..., "span": ...}`: what a caller stamps into a request
    so the callee's spans are attributable as children of the span that
    issued it. None when telemetry is disabled or no span is open."""
    if not ENABLED:
        return None
    st = _span_stack()
    if not st:
        return None
    return {"trace": TRACE_ID, "span": st[-1]}


class _Span:
    __slots__ = ("name", "args", "_t0", "sid", "parent")

    def __init__(self, name: str, args: Optional[dict]) -> None:
        self.name = name
        self.args = args
        self._t0 = 0
        self.sid = 0
        self.parent = 0

    def __enter__(self):
        st = _span_stack()
        self.parent = st[-1] if st else 0
        self.sid = next(_SPAN_IDS)
        st.append(self.sid)
        self._t0 = time.perf_counter_ns()
        return self

    def set(self, **kw):
        if self.args is None:
            self.args = {}
        self.args.update(kw)

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        st = _span_stack()
        if st and st[-1] == self.sid:
            st.pop()
        elif self.sid in st:  # exotic unwind order: drop up to this span
            del st[st.index(self.sid):]
        _record_event(
            self.name, self._t0, t1 - self._t0, self.args,
            sid=self.sid, parent=self.parent,
        )
        if MEM_SAMPLE:
            # Span boundaries are the ledger's RSS sample points (the
            # resettable per-run peak estimate); note_rss throttles to
            # one /proc read per 10 ms so span-dense paths pay ~nothing.
            _STATE["ledger"].note_rss(t1)
        return False


def _record_event(
    name: str, start_ns: int, dur_ns: int, args: Optional[dict],
    tid: Optional[int] = None, sid: int = 0, parent: int = 0,
) -> None:
    entry = (
        name,
        start_ns,
        max(int(dur_ns), 0),
        tid if tid is not None else threading.get_ident(),
        args,
        sid,
        parent,
    )
    _STATE["flight"].append(entry)  # bounded ring: recent-spans black box
    ev = _STATE["events"]
    if len(ev) >= _MAX_EVENTS:
        _STATE["registry"].counter(
            "ydf_telemetry_dropped_events_total"
        ).inc()
        return
    ev.append(entry)


# --------------------------------------------------------------------- #
# Module state
# --------------------------------------------------------------------- #

#: Flight-recorder ring capacity: recent spans, log lines and failpoint
#: firings kept for the crash-safe dump (flight_dump). A deque(maxlen)
#: append is O(1) and allocation-bounded — the ring can run for days.
_FLIGHT_CAP = 2048

_STATE: Dict[str, object] = {
    "registry": _Registry(),
    "events": [],
    "collectors": [],
    "flight": collections.deque(maxlen=_FLIGHT_CAP),
    "ledger": MemoryLedger(),
}
_FLUSH_LOCK = threading.Lock()

ENABLED, EXPORT_DIR = _parse_env(
    os.environ.get("YDF_TPU_TELEMETRY"),
    os.environ.get("YDF_TPU_TELEMETRY_DIR"),
)
MEM_SAMPLE = _parse_mem_sample(os.environ.get("YDF_TPU_MEM_SAMPLE"))


def span(name: str, args: Optional[dict] = None):
    """Tracing span context manager. Disabled → the shared no-op
    singleton (zero allocations). `args` takes a pre-built dict; hot
    sites attach labels with `sp.set(...)` under an ENABLED guard
    instead, so the disabled call carries no dict literal."""
    if not ENABLED:
        return _NOOP_SPAN
    return _Span(name, args)


def counter(name: str, **labels) -> Counter:
    return _STATE["registry"].counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _STATE["registry"].gauge(name, **labels)


def histogram(name: str, **labels) -> LatencyHistogram:
    return _STATE["registry"].histogram(name, **labels)


def emit_span(
    name: str, start_ns: int, dur_ns: int,
    args: Optional[dict] = None, tid: Optional[int] = None,
) -> None:
    """Records a complete span with EXPLICIT timestamps, for post-hoc
    attribution of work the host does not see start and end (the
    boosting loop's per-tree subdivision of each chunk, gbt.py).
    Attributed spans carry `{"attributed": true}` in args by
    convention."""
    if not ENABLED:
        return
    _record_event(name, start_ns, dur_ns, args, tid=tid)
    if MEM_SAMPLE:
        # Attributed spans are sample points too: a train that emits only
        # these must still feed the sampled RSS watermark (throttled like
        # the span-exit hook).
        _STATE["ledger"].note_rss(time.perf_counter_ns())


def register_collector(fn: Callable[[], Dict[str, float]]) -> None:
    """Registers a gauge collector: a callable returning {metric_name:
    value}, sampled at snapshot()/metrics_text() time: pull-model
    sources become registered metrics without a push at every event."""
    _STATE["collectors"].append(fn)


def _collected() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for fn in list(_STATE["collectors"]):
        try:
            out.update(fn())
        except Exception:
            continue  # a broken collector must never break the dump
    return out


def _default_collectors() -> None:
    """Registers the built-in collector once per state: the memory
    ledger. (The JAX package's native CPU kernel and thread-pool
    counters have no counterpart in the port.)"""
    register_collector(_ledger_metrics)


def pow2_bucket(n: int) -> int:
    """Power-of-two batch-size bucket (bounded label cardinality for
    the serving latency histogram): 1000 → 1024."""
    return 1 << max(int(n) - 1, 0).bit_length()


# --------------------------------------------------------------------- #
# Introspection / export
# --------------------------------------------------------------------- #


def events() -> List[dict]:
    """The in-memory span buffer as chrome-tracing event dicts (not yet
    flushed)."""
    return [_event_json(e) for e in list(_STATE["events"])]


def drain_events(match: Optional[Callable[[dict], bool]] = None
                 ) -> List[dict]:
    """Removes and returns buffered span events as chrome-tracing dicts
    (the worker half of the `get_telemetry` RPC); `match` filters on
    that form (an in-process worker drains only its own spans), None
    drains everything. Synchronized with flush(), so a concurrent export
    never writes a drained span twice."""
    with _FLUSH_LOCK:
        ev = _STATE["events"]
        if match is None:
            out = [_event_json(e) for e in ev]
            del ev[:]
            return out
        keep: List[object] = []
        out = []
        for e in ev:
            j = _event_json(e)
            if match(j):
                out.append(j)
            else:
                keep.append(e)
        ev[:] = keep
        return out


def ingest_events(chrome_events: List[dict]) -> None:
    """Appends chrome-tracing event dicts to the buffer: the distributed
    manager merges its workers' clock-corrected spans into one trace
    (its next flush writes them beside its own). The buffer's cap
    holds."""
    if not ENABLED:
        return
    ev = _STATE["events"]
    for i, e in enumerate(chrome_events):
        if len(ev) >= _MAX_EVENTS:
            _STATE["registry"].counter(
                "ydf_telemetry_dropped_events_total"
            ).inc(len(chrome_events) - i)
            return
        ev.append(dict(e))


def _event_json(e) -> dict:
    if isinstance(e, dict):
        return e  # an ingested chrome event (a worker's drained span)
    name, start_ns, dur_ns, tid, args = e[:5]
    ev = {
        "name": name,
        "cat": "ydf_tpu",
        "ph": "X",
        # Fractional µs (chrome tracing accepts doubles): integer-µs
        # flooring would break strict nesting containment for sub-µs
        # spans. Epoch is perf_counter's.
        "ts": start_ns / 1000,
        "dur": max(dur_ns, 1) / 1000,
        "pid": os.getpid(),
        "tid": tid,
    }
    if len(e) > 5 and e[5]:
        # Span identity as top-level fields (viewers ignore unknown
        # keys; args stay exactly what the site set): "sid" matches the
        # "parent_span" workers attach to propagated-context spans.
        ev["sid"] = e[5]
        if e[6]:
            ev["parent"] = e[6]
    if args:
        ev["args"] = args
    return ev


def snapshot() -> Dict[str, object]:
    """All metrics as one JSON-able dict:
    {"counters": {...}, "gauges": {...}, "histograms": {name: summary}}.
    Collector-sourced values appear under "gauges"."""
    _ensure_default_collectors()
    reg: _Registry = _STATE["registry"]

    def _name(key: _MetricKey) -> str:
        return key[0] + _fmt_labels(key[1])

    out = {
        "counters": {_name(k): c.value for k, c in reg._counters.items()},
        "gauges": {_name(k): g.value for k, g in reg._gauges.items()},
        "histograms": {
            _name(k): h.summary() for k, h in reg._hists.items()
        },
    }
    out["gauges"].update(_collected())
    return out


_DEFAULTS_REGISTERED = False


def _ensure_default_collectors() -> None:
    global _DEFAULTS_REGISTERED
    if _DEFAULTS_REGISTERED:
        return
    _DEFAULTS_REGISTERED = True
    try:
        _default_collectors()
    except Exception:
        pass  # ops import failure must not break telemetry itself


def _hist_exposition(name: str, labels, h: LatencyHistogram,
                     lines: List[str]) -> None:
    """One histogram as REAL cumulative Prometheus series: `_bucket`
    samples at octave upper bounds (le = 2^(e+1), derived from the log2
    buckets — boundaries are value-independent so a scraper can
    aggregate `_bucket` across workers), then `+Inf`, `_sum`, `_count`.
    Octaves are emitted from the first to the last non-empty one; the
    implied leading buckets are all zero-cumulative."""
    lines.append(f"# TYPE {name} histogram")
    per_octave = [
        sum(h.buckets[e << 3: (e + 1) << 3]) for e in range(64)
    ]
    nonzero = [e for e, c in enumerate(per_octave) if c]
    cum = 0
    if nonzero:
        for e in range(nonzero[0], nonzero[-1] + 1):
            cum += per_octave[e]
            lab = _fmt_labels(labels, 'le="%g"' % float(1 << (e + 1)))
            lines.append(f"{name}_bucket{lab} {cum}")
    inf_lab = _fmt_labels(labels, 'le="+Inf"')
    lines.append(f"{name}_bucket{inf_lab} {h.count}")
    lines.append(f"{name}_sum{_fmt_labels(labels)} {h.total}")
    lines.append(f"{name}_count{_fmt_labels(labels)} {h.count}")


def metrics_text() -> str:
    """Prometheus text exposition of the registry. Histograms export as
    real cumulative `_bucket`/`_sum`/`_count` series over the log2
    octave boundaries (aggregatable across workers by an actual
    scraper), not percentile gauges — percentiles stay available via
    snapshot()/summary()."""
    _ensure_default_collectors()
    reg: _Registry = _STATE["registry"]
    lines: List[str] = []
    for (name, labels), c in sorted(reg._counters.items()):
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name}{_fmt_labels(labels)} {c.value:g}")
    for (name, labels), g in sorted(reg._gauges.items()):
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{_fmt_labels(labels)} {g.value:g}")
    # Collector samples may carry inline labels (`name{k="v"}` keys —
    # the pool/ledger families): the TYPE line names the BASE metric,
    # once, with the kind from the COLLECTOR_METRICS registry.
    seen_bases = set()
    for mname, value in sorted(_collected().items()):
        base = mname.split("{", 1)[0]
        if base not in seen_bases:
            seen_bases.add(base)
            kind = COLLECTOR_METRICS.get(
                base, "counter" if base.endswith("_total") else "gauge"
            )
            lines.append(f"# TYPE {base} {kind}")
        lines.append(f"{mname} {value:g}")
    for (name, labels), h in sorted(reg._hists.items()):
        _hist_exposition(name, labels, h, lines)
    return "\n".join(lines) + "\n"


def flush(directory: Optional[str] = None) -> None:
    """Exports spans (append, `trace-<pid>.jsonl`) and metrics (rewrite,
    `metrics-<pid>.prom`) to `directory` (default: the armed
    EXPORT_DIR; no-op without one). NEVER raises — export is
    observation, and an exporter fault (full disk, or the
    `telemetry.flush` failpoint the chaos suite arms) must not perturb
    the training result. Failures are counted in
    ydf_telemetry_flush_errors_total and logged at debug level."""
    d = directory or EXPORT_DIR
    if d is None or not ENABLED:
        return
    with _FLUSH_LOCK:
        drained = list(_STATE["events"])
        del _STATE["events"][: len(drained)]
        try:
            from ydf_tpu_torch.utils import failpoints

            failpoints.hit("telemetry.flush")
            os.makedirs(d, exist_ok=True)
            pid = os.getpid()
            if drained:
                path = os.path.join(d, f"trace-{pid}.jsonl")
                with open(path, "a") as f:
                    for e in drained:
                        f.write(json.dumps(_event_json(e)) + "\n")
            with open(os.path.join(d, f"metrics-{pid}.prom"), "w") as f:
                f.write(metrics_text())
            from ydf_tpu_torch.utils import log

            log.debug(
                f"telemetry: flushed {len(drained)} spans to {d}"
            )
        except Exception as e:
            # Swallow, count, restore the drained spans for a later
            # attempt (bounded by _MAX_EVENTS as usual).
            _STATE["registry"].counter(
                "ydf_telemetry_flush_errors_total"
            ).inc()
            _STATE["events"][:0] = drained[
                : _MAX_EVENTS - len(_STATE["events"])
            ]
            try:
                from ydf_tpu_torch.utils import log

                log.debug(f"telemetry: flush failed: "
                          f"{type(e).__name__}: {e}")
            except Exception:
                pass


# --------------------------------------------------------------------- #
# Flight recorder — the crash-safe black box
# --------------------------------------------------------------------- #
#
# A bounded ring of the most recent spans (_record_event appends every
# completed span), log lines (utils/log.py writes through flight_record)
# and failpoint firings (utils/failpoints.py). flight_dump() writes the
# ring to `<dir>/flight_<pid>.jsonl` at the moments a normal flush would
# be lost: SIGTERM/SIGINT preemption and an unhandled exception in the
# boosting loop, so a run that died is diagnosable. Like flush(), the
# dump NEVER raises.


def flight_record(kind: str, **fields) -> None:
    """Appends one non-span entry (log line, failpoint firing, custom
    marker) to the flight ring. Free no-op when telemetry is off."""
    if not ENABLED:
        return
    _STATE["flight"].append((kind, time.perf_counter_ns(), fields))


def _flight_json(e) -> dict:
    if isinstance(e, tuple) and len(e) == 3 and isinstance(e[2], dict):
        kind, t_ns, fields = e
        return {"kind": kind, "ts": t_ns / 1000, **fields}
    j = _event_json(e)
    j["kind"] = "span"
    return j


def flight_events() -> List[dict]:
    """The current flight ring as JSON-able dicts (oldest first)."""
    return [_flight_json(e) for e in list(_STATE["flight"])]


def flight_dump(reason: str, directory: Optional[str] = None) -> Optional[str]:
    """Writes the flight ring to `<directory>/flight_<pid>.jsonl`
    (default: the armed EXPORT_DIR; no-op without one). The first line
    is a header naming the dump reason; each following line is one ring
    entry. Rewritten on every dump — the file always holds the LAST
    moments before the event that triggered it. NEVER raises; returns
    the path written, or None."""
    d = directory or EXPORT_DIR
    if d is None or not ENABLED:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"flight_{os.getpid()}.jsonl")
        entries = flight_events()
        # The header carries the MemoryLedger snapshot: a post-mortem
        # for an OOM (or any crash) must say WHO held the bytes. Built
        # defensively — a broken source must not cost the dump.
        try:
            memory = _STATE["ledger"].snapshot()
        except Exception:
            memory = None
        with open(path, "w") as f:
            f.write(json.dumps({
                "kind": "flight_dump",
                "reason": reason,
                "pid": os.getpid(),
                "trace": TRACE_ID,
                "entries": len(entries),
                "memory": memory,
            }) + "\n")
            for e in entries:
                f.write(json.dumps(e, default=str) + "\n")
        _STATE["registry"].counter(
            "ydf_telemetry_flight_dumps_total"
        ).inc()
        return path
    except Exception:
        _STATE["registry"].counter(
            "ydf_telemetry_flush_errors_total"
        ).inc()
        return None


def reset() -> None:
    """Clears the CURRENT registry, event buffer, flight ring and
    memory-ledger gauges (tests). Pull sources persist — they
    describe what is resident in the process, not a run."""
    _STATE["registry"] = _Registry()
    _STATE["events"] = []
    _STATE["flight"] = collections.deque(maxlen=_FLIGHT_CAP)
    _STATE["ledger"] = MemoryLedger()


def configure(
    enabled: Optional[bool] = None, directory: Optional[str] = None,
    mem_sample: Optional[bool] = None,
) -> None:
    """Programmatic arming, the post-import equivalent of the environment
    variables (parsed once at import). Validates like the environment
    boundary."""
    global ENABLED, EXPORT_DIR, MEM_SAMPLE
    if directory is not None:
        _, EXPORT_DIR = _parse_env(None, directory)
        ENABLED = True
    if enabled is not None:
        ENABLED = bool(enabled)
    if mem_sample is not None:
        MEM_SAMPLE = bool(mem_sample)


@contextlib.contextmanager
def active(directory: Optional[str] = None):
    """Arms telemetry with a FRESH registry + event buffer for the
    with-block (optionally exporting to `directory`), restoring the
    previous state — including disabled-ness — on exit. The test-side
    twin of the env vars, like failpoints.active()."""
    global ENABLED, EXPORT_DIR
    old = (
        ENABLED, EXPORT_DIR, _STATE["registry"], _STATE["events"],
        _STATE["collectors"], _STATE["flight"], _STATE["ledger"],
    )
    global _DEFAULTS_REGISTERED
    old_defaults = _DEFAULTS_REGISTERED
    _, d = _parse_env(None, directory)
    _STATE["registry"] = _Registry()
    _STATE["events"] = []
    _STATE["collectors"] = []
    _STATE["flight"] = collections.deque(maxlen=_FLIGHT_CAP)
    _STATE["ledger"] = MemoryLedger()
    _DEFAULTS_REGISTERED = False
    ENABLED, EXPORT_DIR = True, d
    try:
        yield
    finally:
        (
            ENABLED, EXPORT_DIR, _STATE["registry"], _STATE["events"],
            _STATE["collectors"], _STATE["flight"], _STATE["ledger"],
        ) = old
        _DEFAULTS_REGISTERED = old_defaults


# A process that armed export via env gets its tail spans/metrics even
# if nothing calls flush() explicitly (e.g. predict-only serving).
if EXPORT_DIR is not None:
    atexit.register(flush)
