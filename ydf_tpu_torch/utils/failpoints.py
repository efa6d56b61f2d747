"""Process-wide fault-injection registry (failpoints); counterpart of
ydf_tpu/utils/failpoints.py, the same grammar, errors and environment
variable.

Named injection sites on the port's recovery paths: the dataset cache's
writes, the snapshot save and its index, the checkpointed boosting
loop's chunk boundary, and the telemetry exporter. Two ways to arm a
failpoint, both speaking the same grammar:

  * Environment (whole-process, e.g. a training subprocess):

        YDF_TPU_FAILPOINTS="cache.write_chunk=error@2;gbt.chunk=error"

    Parsed and validated EAGERLY at import: a misspelled site or action
    raises ValueError at the environment boundary, never a silently
    inert chaos run.

  * Programmatic (tests):

        with failpoints.active("snapshot.save=torn_write"):
            ...

Grammar: `site=action[@N]` entries joined by `;`. `@N` arms the spec on
the N-th hit of the site (1-based, default 1); every spec fires exactly
once, so a retried or resumed operation passes.

Actions:

  error       raise FailpointError at the armed hit.
  fail_once   alias of `error@1`.
  drop_conn   raise ConnectionError (a transport failure).
  torn_write  cooperative: hit() RETURNS "torn_write" and the site
              simulates a crash mid-write (truncate the payload, then
              raise FailpointError). Only snapshot.save takes it.
  stall       cooperative; no site of the port takes it.

Overhead contract: with YDF_TPU_FAILPOINTS unset, every instrumented
site costs one module-global boolean check (`ENABLED`, computed once at
import) plus a function call at chunk granularity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Dict, List, Optional

__all__ = [
    "FailpointError",
    "KNOWN_SITES",
    "ENABLED",
    "hit",
    "active",
    "parse",
    "fired_sites",
]


class FailpointError(RuntimeError):
    """An injected fault (actions `error` / `fail_once`, and the raise
    half of a cooperative `torn_write`). Deliberately NOT an OSError
    subclass: recovery paths that catch IO errors must be exercised via
    `drop_conn`, while FailpointError models an abrupt crash."""


#: Every instrumented site. parse() validates against this set so a
#: chaos schedule can never silently name a site that nothing hits.
KNOWN_SITES = frozenset(
    {
        # dataset/cache.py: the per-chunk write of pass 2, and the final
        # (atomic) cache_meta.json publish.
        "cache.write_chunk",
        "cache.finalize",
        # utils/snapshot.py: the payload write (torn_write-capable) and
        # the index update that follows it.
        "snapshot.save",
        "snapshot.index",
        # learners/gbt.py: the checkpointed boosting loop, after each
        # chunk's snapshot is durably saved.
        "gbt.chunk",
        # learners/gbt.py: the boosting loop's chunk boundaries; the
        # injected fault becomes a real MemoryError (the flight
        # recorder's "oom" dump).
        "telemetry.oom",
        # utils/telemetry.py: the span and metrics exporter; flush()
        # swallows the injected fault (export is observation).
        "telemetry.flush",
        # parallel/worker_service.py: a worker's request receive, the
        # window between receive and execution, and the response send;
        # a fault drops the connection.
        "worker.recv",
        "worker.handle",
        "worker.send",
        # parallel/dist_gbt.py: the manager's RPCs (shard load and
        # re-ship, each layer's histogram gather, the split broadcast);
        # drop_conn is a transport failure and drives the shards'
        # reassignment, and the trees stay the fault-free run's.
        "dist.shard_load",
        "dist.histogram_rpc",
        "dist.split_broadcast",
        # parallel/dist_gbt.py: the manager's tree-boundary snapshot
        # write (an error crashes the manager between boundaries; a
        # resume from the previous snapshot gives the same trees), and a
        # resumed manager's reattach of the shards.
        "dist.snapshot",
        "dist.resume_attach",
        # parallel/dist_worker.py: the worker's manager-epoch fence; an
        # error answers one request with the stale-epoch rejection, as if
        # a newer manager had attached (the state is not changed).
        "dist.epoch_fence",
    }
)

#: Sites that implement the cooperative torn_write action.
TORN_WRITE_SITES = frozenset({"snapshot.save"})

#: Sites that implement the cooperative stall action: none in the port
#: (the JAX package's native work-stealing pool is not ported), so the
#: grammar takes the action and every site refuses it.
STALL_SITES = frozenset()

_ACTIONS = ("error", "fail_once", "drop_conn", "torn_write", "stall")


@dataclasses.dataclass
class _Spec:
    site: str
    action: str
    at: int  # 1-based hit index the spec arms on
    hits: int = 0
    fired: bool = False


def parse(spec: str) -> Dict[str, _Spec]:
    """Parses a failpoint schedule string into {site: _Spec}, validating
    sites, actions and counts eagerly. Empty/blank input → {}."""
    out: Dict[str, _Spec] = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, action = entry.partition("=")
        site = site.strip()
        action = action.strip()
        if not sep or not action:
            raise ValueError(
                f"YDF_TPU_FAILPOINTS entry {entry!r} is not of the form "
                "'site=action[@N]'"
            )
        if site not in KNOWN_SITES:
            raise ValueError(
                f"YDF_TPU_FAILPOINTS names unknown site {site!r}; "
                f"known sites: {sorted(KNOWN_SITES)}"
            )
        at = 1
        if "@" in action:
            action, _, n = action.partition("@")
            action = action.strip()
            n = n.strip()
            if not n.isdigit() or int(n) < 1:
                raise ValueError(
                    f"YDF_TPU_FAILPOINTS count {n!r} for site {site!r} "
                    "must be a positive integer"
                )
            at = int(n)
        if action not in _ACTIONS:
            raise ValueError(
                f"YDF_TPU_FAILPOINTS action {action!r} for site {site!r} "
                f"is not one of {list(_ACTIONS)}"
            )
        if action == "fail_once":
            action = "error"
            # fail_once always means "the first hit" regardless of @N.
            at = 1
        if action == "torn_write" and site not in TORN_WRITE_SITES:
            raise ValueError(
                f"site {site!r} does not support torn_write (supported: "
                f"{sorted(TORN_WRITE_SITES)}); use 'error' instead"
            )
        if action == "stall" and site not in STALL_SITES:
            raise ValueError(
                f"site {site!r} does not support stall (supported: "
                f"{sorted(STALL_SITES)}); use 'error' instead"
            )
        if site in out:
            raise ValueError(
                f"YDF_TPU_FAILPOINTS lists site {site!r} twice"
            )
        out[site] = _Spec(site=site, action=action, at=at)
    return out


_LOCK = threading.Lock()
# Eager env parse at import: a malformed schedule fails the first
# ydf_tpu_torch import of the process, not the Nth training hour.
_SPECS: Dict[str, _Spec] = parse(os.environ.get("YDF_TPU_FAILPOINTS", ""))

#: Module-level constant when env-driven; flipped only by the
#: programmatic `active()` context manager. Sites read it through the
#: module (`failpoints.ENABLED`) so both stay O(attribute lookup).
ENABLED: bool = bool(_SPECS)


def hit(site: str) -> Optional[str]:
    """Called by an instrumented site. Free no-op unless a spec is armed
    for `site`. Raising actions raise here (FailpointError for error,
    ConnectionError for drop_conn); the cooperative torn_write action is
    RETURNED for the site to act on. Returns None when nothing fires."""
    if not ENABLED:
        return None
    with _LOCK:
        sp = _SPECS.get(site)
        if sp is None or sp.fired:
            return None
        sp.hits += 1
        if sp.hits != sp.at:
            return None
        sp.fired = True
        action, at = sp.action, sp.at
    try:
        # A firing failpoint is exactly the kind of event a post-mortem
        # wants in the flight recorder. Lazy import keeps this module
        # pure-stdlib at import time, and flight_record is a free no-op
        # when telemetry is off.
        from ydf_tpu_torch.utils import telemetry

        telemetry.flight_record(
            "failpoint", site=site, action=action, hit=at
        )
    except Exception:
        pass
    if action == "error":
        raise FailpointError(f"injected fault at {site!r} (hit {at})")
    if action == "drop_conn":
        raise ConnectionError(
            f"injected connection drop at {site!r} (hit {at})"
        )
    return action  # cooperative: "torn_write" / "stall"


def fired_sites() -> List[str]:
    """Sites of the CURRENTLY ARMED schedule whose spec has fired —
    chaos tests assert their schedule actually exercised the paths it
    named. Scoped with the schedule: `active()` arms fresh (unfired)
    specs and restores the previous set on exit."""
    with _LOCK:
        return [s.site for s in _SPECS.values() if s.fired]


@contextlib.contextmanager
def active(spec: str):
    """Arms `spec` (same grammar as the env var) for the duration of the
    with-block, on top of whatever is already armed; previous state is
    restored on exit. Thread-safe to *hit* concurrently, but nest/enter
    from one test thread at a time."""
    global _SPECS, ENABLED
    new = parse(spec)
    with _LOCK:
        old_specs, old_enabled = _SPECS, ENABLED
        merged = dict(old_specs)
        merged.update(new)
        _SPECS = merged
        ENABLED = True
    try:
        yield new
    finally:
        with _LOCK:
            _SPECS = old_specs
            ENABLED = old_enabled
