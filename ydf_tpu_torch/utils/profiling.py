"""Per-stage training profiling and the profiler trace hook
(counterpart of ydf_tpu/utils/profiling.py: StageTimer, maybe_trace,
trace_event_seconds / trace_event_counts and format_profile).

* **Phase wall times**: `StageTimer` accumulates named host-clock
  phases of one train() (ingest and binning, the boosting loop, the
  model's assembly); the learners attach them to the model as
  `model.training_profile`.
* **A profiler trace**: with `YDF_TPU_PROFILE_DIR=/path` set, every
  train() wraps its loop in `torch.profiler` (the CPU and, on a card,
  CUDA activities) and writes the Chrome trace to
  `<dir>/<label>/trace-<pid>.json`. `trace_event_seconds` and
  `trace_event_counts` read such a directory back: the seconds and the
  number of events per name.

The JAX package's xplane parser, its native-kernel counters and its
device-loop accounting have no counterpart here (ROADMAP "Not queued"
and item 22).
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import time
from typing import Dict, Iterator, Optional


class StageTimer:
    """Accumulates named wall-time phases for one train() call."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t
            )

    def finish(self) -> Dict[str, float]:
        out = dict(self.seconds)
        out["total"] = time.perf_counter() - self._t0
        accounted = sum(self.seconds.values())
        out["other"] = max(out["total"] - accounted, 0.0)
        return out


@contextlib.contextmanager
def maybe_trace(label: str = "train") -> Iterator[None]:
    """torch.profiler around the block when YDF_TPU_PROFILE_DIR is set,
    its Chrome trace written to <dir>/<label>/trace-<pid>.json; no-op
    (no overhead) otherwise."""
    trace_dir = os.environ.get("YDF_TPU_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch

    path = os.path.join(trace_dir, label)
    os.makedirs(path, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(path, f"trace-{os.getpid()}.json"))


def _trace_events(trace_dir: str, substrings: Optional[tuple]):
    """(name, dur µs) of every complete event in the Chrome traces
    (*.json) under trace_dir, filtered to names holding any of
    `substrings` (None keeps all). Unreadable files are skipped."""
    for path in sorted(pathlib.Path(trace_dir).rglob("*.json")):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue  # partial or foreign file: skip
        events = data.get("traceEvents", []) if isinstance(data, dict) \
            else data
        for ev in events:
            if not isinstance(ev, dict) or ev.get("ph") != "X":
                continue
            name = ev.get("name")
            if not name:
                continue
            if substrings is not None and not any(s in name
                                                  for s in substrings):
                continue
            yield name, float(ev.get("dur", 0.0))


def trace_event_seconds(trace_dir: str, substrings: Optional[tuple] = None
                        ) -> Dict[str, float]:
    """Wall seconds per event name summed over the Chrome traces in
    trace_dir (maybe_trace's files, or any torch.profiler
    export_chrome_trace), filtered to names containing any of
    `substrings` (None keeps everything)."""
    out: Dict[str, float] = {}
    for name, dur_us in _trace_events(trace_dir, substrings):
        out[name] = out.get(name, 0.0) + dur_us / 1e6
    return out


def trace_event_counts(trace_dir: str, substrings: Optional[tuple] = None
                       ) -> Dict[str, int]:
    """Events per name in the Chrome traces in trace_dir (the same walk
    as trace_event_seconds, counting instead of summing): e.g. a kernel's
    launches in a traced train."""
    out: Dict[str, int] = {}
    for name, _ in _trace_events(trace_dir, substrings):
        out[name] = out.get(name, 0) + 1
    return out


def format_profile(profile: Optional[Dict[str, float]]) -> str:
    """One-line human summary, largest stages first."""
    if not profile:
        return "(no profile)"
    total = profile.get("total", 0.0)
    parts = [
        f"{k}={v:.3f}s"
        for k, v in sorted(profile.items(), key=lambda kv: -kv[1])
        if k != "total"
    ]
    return f"total={total:.3f}s  " + " ".join(parts)
