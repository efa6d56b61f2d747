"""Feature-parallel distributed GBT training: the manager (counterpart of
ydf_tpu/parallel/dist_gbt.py's DistGBTManager; the reference's
distributed_gradient_boosted_trees manager, the TF Boosted Trees
exchange of arxiv 1710.11555).

Workers (parallel/worker_service.py, parallel/dist_worker.py) each hold
some feature shards of a DatasetCache on their device; the bins never
come to the manager. The manager holds the labels, the predictions and
each row's slot and leaf on its own device and runs the single device's
boosting loop (learners/gbt.py:_Loop: the loss's initial predictions and
grad_hess, the row sample from the same key chain, the candidate
columns, the leaf values, the prediction update, the loss) with the
grower's `shards=` seam (ops/grower.py:grow_tree) pointed at this
manager, so the split search (scalar_candidates, layer_decide, sibling
subtraction) is the single device's own code on the same histograms.

One tree:
  begin        the tree's histogram operand (ops/histogram.py:
               prepare_stats_for_hist: f32, the bf16x2 halves or int8 on
               the tree's grid) read to the host once; it goes out with
               the tree's first request.
  root         build_histograms to every worker (reset, stats): each
               returns its shards' accumulators [Ld, Fk, B, S'] and the
               manager concatenates them in shard order, which is the
               feature order, and copies the layer to its device.
  routed       the previous layer's decision tables read to the host
               once; apply_split to the owners of the split columns
               only; their go-left bitmaps OR-ed; the manager routes its
               own rows (route_plain of the row-direction tables,
               parallel/shards.py:direction_tables); then
               build_histograms of the Lh smaller-child slots, the
               request carrying the tables and the merged bitmap, which
               each worker's routed kernel takes as its row-direction
               table (as a mesh's feature axis does).
  route_last   the last layer's tables, apply_split, the manager's route:
               its leaf ids are the tree's.
The grower adds the parent histograms (sibling subtraction), decides,
and the loop updates the predictions as on one device. Per tree the
manager reads the device 1 + max_depth times (HOST_READS: the operand
and each layer's tables); a histogram or a bitmap arriving is a copy to
the device. The loop cannot run under torch's sync debug mode "error":
every layer comes from a socket.

Faults. Every RPC runs with a deadline (YDF_TPU_DIST_RPC_TIMEOUT_S); a
worker that times out, drops its connection or fails is quarantined
(the pool's backoff) and its shards move to the next healthy worker,
which receives them with the manager's state (slot, leaf, position, the
tree's operand; before the last route when the retried request carries
it) and resumes where the lost one stood; a
worker that restarted answers need_shard and is re-shipped in place; a
shard that fails its crc at load is rebuilt from the cache's bins.npy
(dataset/cache.py:rebuild_feature_shard, the same bytes). A failed
kernel on a worker comes back as an error and the manager raises: no
layer is ever recomputed here, and no shard moves onto the manager.
YDF_TPU_DIST_VERIFY=1 asks a worker for its leaf_stats after each tree
and checks its leaf assignment against the manager's.

Checkpoints (working_dir): a snapshot (utils/snapshot.py) at every
`snapshot_interval`-th tree boundary and the last, of the trees so far,
their leaf values and losses and the predictions, fingerprinted by the
cache and the configuration (not the worker count) and stamped with the
manager's epoch. Every RPC carries the epoch; a resumed manager takes
the snapshot's epoch + 1, so the workers fence a zombie predecessor.
SIGTERM / SIGINT set a flag read at the next boundary (a forced
snapshot, then TrainingPreempted). Failpoints: dist.shard_load,
dist.histogram_rpc, dist.split_broadcast, dist.snapshot,
dist.resume_attach (and dist.epoch_fence on the workers).

Not ported: elastic membership (the JAX package's MembershipChannel)
and the row-parallel manager (ROADMAP Queue 1 item 18).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import signal as _signal
import time
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ydf_tpu_torch.ops.histogram_kernels import route_plain
from ydf_tpu_torch.parallel import dist_worker
from ydf_tpu_torch.parallel.shards import direction_tables
from ydf_tpu_torch.utils import failpoints, log, telemetry
from ydf_tpu_torch.utils.telemetry import LatencyHistogram

#: Reads of device values on the host by managers in this process: one a
#: tree for its histogram operand (two with int8's scale), one a layer
#: for its decision tables; and those of the rarer paths (a recovery's
#: state, a snapshot, the verify mode's leaf ids).
HOST_READS = 0
#: The `format` of the manager's snapshot metadata.
SNAPSHOT_FORMAT = "ydf_tpu_torch.dist_gbt/1"


class DistributedTrainingError(RuntimeError):
    """Distributed training could not complete: every worker is
    unreachable past the retry budget, or a worker reported an error
    that no recovery fixes."""


def _parse_rpc_timeout() -> float:
    """YDF_TPU_DIST_RPC_TIMEOUT_S, the per-RPC deadline (default 600 s),
    validated at import. A worker that does not answer within it is
    treated as a dropped connection."""
    raw = os.environ.get("YDF_TPU_DIST_RPC_TIMEOUT_S")
    if raw is None:
        return 600.0
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"YDF_TPU_DIST_RPC_TIMEOUT_S={raw!r} is not a number of "
            "seconds"
        ) from None
    if not v > 0:
        raise ValueError(f"YDF_TPU_DIST_RPC_TIMEOUT_S={raw} must be > 0")
    return v


def _parse_verify() -> bool:
    """YDF_TPU_DIST_VERIFY, the per-tree worker-state check, validated at
    import."""
    raw = os.environ.get("YDF_TPU_DIST_VERIFY")
    if raw is None:
        return False
    low = raw.strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise ValueError(
        f"YDF_TPU_DIST_VERIFY={raw!r} is not a boolean; expected one of "
        "1/0/true/false/yes/no/on/off"
    )


_RPC_TIMEOUT_S: float = _parse_rpc_timeout()
_VERIFY: bool = _parse_verify()


def _transport_fields(pool) -> Dict[str, Any]:
    """The pool's transport counters (connects, reuse rate, header and
    array bytes) for training_logs["distributed"]; the pool is made per
    train, so they are the run's."""
    snap = getattr(pool, "transport_snapshot", None)
    return snap() if callable(snap) else {}


class _DistStats:
    """The manager's exchange accounting (training_logs["distributed"];
    mirrored into telemetry when it is on)."""

    def __init__(self):
        self.rpc_ns: Dict[str, LatencyHistogram] = {}
        self.reduce_bytes = 0
        self.stats_bytes = 0
        self.bitmap_bytes = 0
        self.recoveries = 0
        self.shard_rebuilds = 0
        # Concatenating the shards' histograms and copying them to the
        # manager's device, summed over the layers.
        self.merge_ns = 0
        # Each exchange's wall, split into compute (the workers' handle
        # time and the manager's routing), network and straggler wait.
        self.exchange_ns = 0
        self.compute_ns = 0
        self.net_ns = 0
        self.wait_ns = 0
        self.exchanges = 0
        self.drained_events: Dict[str, int] = {}
        self.shard_bytes: Dict[str, int] = {}
        self.worker_rss_bytes: Dict[str, int] = {}
        self.config_mismatches = 0
        self.snapshots = 0
        self.snapshot_ns = 0
        self.snapshot_bytes = 0

    def observe_snapshot(self, dur_ns: int, nbytes: int) -> None:
        self.snapshots += 1
        self.snapshot_ns += int(dur_ns)
        self.snapshot_bytes += int(nbytes)
        if telemetry.ENABLED:
            telemetry.counter("ydf_dist_snapshots_total").inc()
            telemetry.counter("ydf_dist_snapshot_ns_total").inc(int(dur_ns))
            telemetry.counter("ydf_dist_snapshot_bytes_total").inc(
                int(nbytes))

    def observe_rpc(self, verb: str, dur_ns: int) -> None:
        self.rpc_ns.setdefault(verb, LatencyHistogram()).observe_ns(dur_ns)
        if telemetry.ENABLED:
            telemetry.histogram("ydf_dist_rpc_latency_ns",
                                verb=verb).observe_ns(dur_ns)

    def observe_merge(self, dur_ns: int) -> None:
        self.merge_ns += int(dur_ns)
        if telemetry.ENABLED:
            telemetry.counter("ydf_dist_merge_ns_total").inc(int(dur_ns))

    def drop_worker_shards(self, addr: str) -> None:
        """A quarantined worker's resident bytes leave the fleet total
        when its shards move (the replacement's load re-adds them)."""
        if self.shard_bytes.pop(addr, None) is not None and (
                telemetry.ENABLED):
            telemetry.mem_set("dist_shard_fleet",
                              sum(self.shard_bytes.values()))

    def observe_exchange(
            self, wall_ns: int,
            rpcs: Dict[int, Tuple[int, Optional[int]]]) -> None:
        """Splits one exchange's wall by the workers' histogram RPCs
        (wall, handle time): wait = slowest - median RPC (the fan-out is
        a barrier), net = median RPC - median handle time, compute = the
        rest. The three add up to the wall."""
        from statistics import median

        walls = sorted(w for w, _ in rpcs.values())
        wait = net = 0
        if walls:
            med_w = median(walls)
            wait = int(max(walls[-1] - med_w, 0))
            handles = sorted(h for _, h in rpcs.values() if h is not None)
            med_h = median(handles) if handles else med_w
            net = int(max(med_w - med_h, 0))
        wait = min(wait, wall_ns)
        net = min(net, wall_ns - wait)
        self.exchanges += 1
        self.exchange_ns += wall_ns
        self.wait_ns += wait
        self.net_ns += net
        self.compute_ns += wall_ns - wait - net
        if telemetry.ENABLED:
            telemetry.counter("ydf_dist_layer_wait_ns_total").inc(wait)
            telemetry.counter("ydf_dist_layer_net_ns_total").inc(net)
            telemetry.counter("ydf_dist_layer_compute_ns_total").inc(
                wall_ns - wait - net)

    def summary(self) -> Dict[str, Any]:
        out = {
            "reduce_bytes": int(self.reduce_bytes),
            "stats_bytes": int(self.stats_bytes),
            "bitmap_bytes": int(self.bitmap_bytes),
            "recoveries": int(self.recoveries),
            "shard_rebuilds": int(self.shard_rebuilds),
            "merge_s": self.merge_ns / 1e9,
            "exchanges": int(self.exchanges),
            "exchange_s": self.exchange_ns / 1e9,
            "compute_s": self.compute_ns / 1e9,
            "net_s": self.net_ns / 1e9,
            "wait_s": self.wait_ns / 1e9,
            "rpc_p50_ns": {v: h.percentile_ns(50)
                           for v, h in sorted(self.rpc_ns.items())},
            "rpc_count": {v: int(h.count)
                          for v, h in sorted(self.rpc_ns.items())},
            "rpc_total_ns": {v: int(h.total)
                             for v, h in sorted(self.rpc_ns.items())},
            "snapshots": int(self.snapshots),
            "snapshot_s": self.snapshot_ns / 1e9,
            "snapshot_bytes": int(self.snapshot_bytes),
            "shard_bytes": int(sum(self.shard_bytes.values())),
        }
        if self.shard_bytes:
            out["worker_shard_bytes"] = dict(self.shard_bytes)
        if self.worker_rss_bytes:
            out["worker_rss_bytes"] = dict(self.worker_rss_bytes)
        if self.config_mismatches:
            out["config_mismatches"] = int(self.config_mismatches)
        if self.drained_events:
            out["telemetry_drained_events"] = dict(self.drained_events)
        return out


def _pack_tables(tables) -> torch.Tensor:
    """A layer's RouteTables as one i32 vector (one host read):
    do_split, route_f, left_id, right_id, split_rank, hmap [L+1] each,
    then go_left [L+1, B]."""
    return torch.cat([
        tables.do_split.int(), tables.route_f.int(), tables.left_id.int(),
        tables.right_id.int(), tables.split_rank.int(), tables.hmap.int(),
        tables.go_left.int().reshape(-1)])


def _unpack_tables(packed: np.ndarray, L1: int, B: int) -> Dict[str, Any]:
    """_pack_tables' host copy as the wire tables (numpy, the JAX
    package's keys)."""
    col = [packed[i * L1:(i + 1) * L1] for i in range(6)]
    return {
        "L": L1 - 1,
        "do_split": col[0].astype(bool), "route_f": col[1],
        "left_id": col[2], "right_id": col[3], "split_rank": col[4],
        "hmap": col[5],
        "go_left_bins": packed[6 * L1:].reshape(L1, B).astype(bool),
    }


class DistGBTManager:
    """Drives one distributed GBT train over a WorkerPool and a
    feature-sharded DatasetCache (module docstring). `labels` and
    `weights` are the learner's encoded numpy columns; the loop runs on
    `device`."""

    #: The TreeArrays fields a snapshot stacks.
    _TREE_FIELDS = ("feature", "threshold_bin", "is_cat", "is_set",
                    "cat_mask", "left", "right", "is_leaf", "leaf_stats",
                    "num_nodes")

    def __init__(
        self, pool, cache, *, labels: np.ndarray, weights: np.ndarray,
        loss_obj, rule, tree_cfg, num_trees: int, shrinkage: float,
        subsample: float, candidate_features: int, num_numerical: int,
        seed: int, hist_quant: str, device="cuda",
        rpc_timeout_s: Optional[float] = None,
        verify: Optional[bool] = None,
        working_dir: Optional[str] = None, resume: bool = False,
        snapshot_interval: int = 50,
        preempt_after_snapshots: Optional[int] = None,
    ):
        self.pool = pool
        self.cache = cache
        self.labels, self.weights = labels, weights
        self.loss_obj = loss_obj
        self.rule = rule
        self.cfg = tree_cfg
        self.num_trees = int(num_trees)
        self.shrinkage = float(shrinkage)
        self.subsample = float(subsample)
        self.candidate_features = int(candidate_features)
        self.seed = seed
        self.hist_quant = hist_quant
        self.device = torch.device(device)
        self.rpc_timeout_s = (_RPC_TIMEOUT_S if rpc_timeout_s is None
                              else rpc_timeout_s)
        self.verify = _VERIFY if verify is None else verify

        self.num_shards = cache._require_shards()
        self.col_ranges = [cache.shard_col_range(k)
                           for k in range(self.num_shards)]
        self.F = cache.binner.num_scalar
        self.Fn = int(num_numerical)
        self.n = cache.num_rows
        self.key_id = f"dist-{uuid.uuid4().hex[:12]}"
        # Shard k starts on worker k % W and moves on a failure.
        self.owner: List[int] = [k % len(pool.addresses)
                                 for k in range(self.num_shards)]
        self.stats = _DistStats()
        # The manager's authoritative per-row state (what makes a lost
        # worker recoverable mid-tree), on its device.
        zeros = torch.zeros(self.n, dtype=torch.int32, device=self.device)
        self.slot, self.leaf_id = zeros, zeros
        self.pos = (-1, 0)
        # (slot, leaf_id, pos) before the last route: what a worker is
        # re-shipped for a request that carries that route.
        self.before_route = None
        # The bins of no columns that route_plain routes by directions on.
        self.no_cols = torch.empty((0, self.n), dtype=torch.uint8,
                                   device=self.device)
        self.it = 0
        self.cur_hist_stats = self.cur_qscale = None
        self.pending_route = None
        self._init_ckpt(working_dir, resume, snapshot_interval,
                        preempt_after_snapshots)

    # ---- checkpoint / resume / epoch ---------------------------------- #

    def _init_ckpt(self, working_dir, resume, snapshot_interval,
                   preempt_after_snapshots) -> None:
        """Arms the snapshots, derives the run key (deterministic with a
        working_dir, so a resumed manager reattaches to the same worker
        state) and reads the newest snapshot: its epoch always (a new
        manager on this directory fences the old one), its progress
        only with resume."""
        self.working_dir = working_dir
        self.resume = bool(resume)
        self.snapshot_interval = max(int(snapshot_interval or 50), 1)
        self.preempt_after_snapshots = preempt_after_snapshots
        self._snapshots_taken = 0
        #: The epoch every RPC carries (_stamp) and every snapshot keeps.
        self.epoch = 1
        self._snaps = None
        self._resume_state: Optional[Dict[str, Any]] = None
        if not working_dir:
            return
        from ydf_tpu_torch.utils.snapshot import Snapshots

        self._snaps = Snapshots(working_dir, max_kept=2)
        self.key_id = f"dist-{self._ckpt_fingerprint()[:16]}"
        state = self._snaps.latest()
        if state is None:
            if self.resume:
                log.info("dist: resume requested but no snapshot in "
                         f"{working_dir!r}; starting fresh")
            return
        _idx, arrays, meta = state
        self.epoch = int(meta.get("epoch", 0)) + 1
        if not self.resume:
            return
        if (meta.get("format") != SNAPSHOT_FORMAT
                or meta.get("fingerprint") != self._ckpt_fingerprint()):
            raise ValueError(
                f"Distributed snapshot in {working_dir!r} was created with "
                "a different worker/shard configuration or dataset (cache "
                "layout, hyperparameters, YDF_TPU_HIST_QUANT mode or seed "
                "differ from the current flags), or by another package; "
                "refusing to resume. Delete the working directory or "
                "restore the original configuration.")
        self._resume_state = {"arrays": arrays, "meta": meta}

    def _ckpt_fingerprint(self) -> str:
        """SHA-1 of the cache and the configuration a resume must match;
        the worker count is left out (a resume may change it)."""
        fp = hashlib.sha1()
        fp.update(repr(("feature", self.num_shards)).encode())
        fp.update(repr((
            self.cache._meta.get("request_fingerprint"), self.n, self.F,
            type(self.loss_obj).__name__, self.rule, self.cfg,
            self.num_trees, self.shrinkage, self.subsample,
            self.candidate_features, self.seed, self.hist_quant,
        )).encode())
        return fp.hexdigest()

    def _restore(self, loop) -> int:
        """Puts the resume snapshot's trees, leaf values, losses and
        predictions into the loop; returns the trees done (0 fresh)."""
        if self._resume_state is None:
            return 0
        from ydf_tpu_torch.ops.grower import TreeArrays

        arrays = self._resume_state["arrays"]
        done = int(self._resume_state["meta"]["completed_trees"])
        dev = self.device

        def on_dev(a):
            return torch.from_numpy(np.array(a)).to(dev)

        loop.trees = [TreeArrays(*(on_dev(arrays[f"tree_{f}"][t])
                                   for f in self._TREE_FIELDS))
                      for t in range(done)]
        loop.leaf_values = list(on_dev(arrays["lvs"]).unbind(0))
        loop.losses = list(on_dev(arrays["tls"]).unbind(0))
        loop.preds = on_dev(arrays["preds"])
        loop.iterations = done
        return done

    def _restore_owner_map(self) -> None:
        """The snapshot's shard owners, for addresses still in the
        rotation (the reattach's load is idempotent either way)."""
        if self._resume_state is None:
            return
        addrs = {self.pool.addr_str(i): i
                 for i in range(len(self.pool.addresses))}
        saved = self._resume_state["meta"].get("owner_addrs") or []
        for sid, addr in enumerate(saved[:len(self.owner)]):
            if addr in addrs:
                self.owner[sid] = addrs[addr]

    def _maybe_snapshot(self, done: int, loop, force: bool = False) -> bool:
        """The tree-boundary snapshot, on the cadence, at the last tree
        or when forced; returns whether one was written."""
        global HOST_READS
        if self._snaps is None or done == 0:
            return False
        if not (force or done % self.snapshot_interval == 0
                or done == self.num_trees):
            return False
        failpoints.hit("dist.snapshot")
        t0 = time.perf_counter_ns()
        trees = loop.trees[:done]
        arrays = {f"tree_{f}": torch.stack([getattr(t, f) for t in trees])
                  for f in self._TREE_FIELDS}
        arrays["lvs"] = torch.stack(loop.leaf_values[:done])
        arrays["tls"] = torch.stack(loop.losses[:done])
        arrays["preds"] = loop.preds
        arrays = {k: v.cpu().numpy() for k, v in arrays.items()}
        HOST_READS += 1
        meta = {
            "format": SNAPSHOT_FORMAT, "completed_trees": int(done),
            "fingerprint": self._ckpt_fingerprint(),
            "epoch": int(self.epoch), "num_trees": self.num_trees,
            "mode": "feature",
            "owner_addrs": [self.pool.addr_str(w) for w in self.owner],
        }
        self._snaps.save(done, arrays, meta)
        try:
            nbytes = os.path.getsize(self._snaps._payload_path(done))
        except OSError:
            nbytes = 0
        self.stats.observe_snapshot(time.perf_counter_ns() - t0, nbytes)
        return True

    def _tree_boundary(self, guard, done: int, loop) -> None:
        """A checkpointed run's boundary: the scheduled snapshot, the
        preempt-after-N-snapshots test hook, and on a preemption a forced
        snapshot then TrainingPreempted."""
        if self._snaps is None:
            return
        saved = self._maybe_snapshot(done, loop)
        if saved:
            self._snapshots_taken += 1
            if (self.preempt_after_snapshots is not None
                    and self._snapshots_taken >= self.preempt_after_snapshots
                    and not guard.triggered):
                guard.trigger(_signal.SIGTERM)
        if not guard.triggered:
            return
        if not saved:
            self._maybe_snapshot(done, loop, force=True)
        from ydf_tpu_torch.learners.gbt import TrainingPreempted

        if telemetry.ENABLED:
            telemetry.flight_record(
                "preempt", signal=guard.signal_name,
                completed_trees=done, num_trees=self.num_trees)
            telemetry.flush()
            telemetry.flight_dump("preempt")
        raise TrainingPreempted(
            f"distributed training preempted by {guard.signal_name}: "
            f"snapshot at {done}/{self.num_trees} trees in "
            f"{self.working_dir!r} is resumable (resume_training=True)")

    # ---- RPC plumbing -------------------------------------------------- #

    def _stamp(self, req: Dict[str, Any], widx: int) -> Dict[str, Any]:
        """The epoch (the workers' fence) and, with telemetry on, the
        open span's trace context, which the worker's request span
        records. Called on the thread holding the span."""
        req["epoch"] = self.epoch
        if telemetry.ENABLED:
            ctx = telemetry.current_context()
            if ctx is not None:
                req["_trace"] = {
                    **ctx, "worker_index": widx % len(self.pool.addresses)}
        return req

    def _request(self, widx: int, req: Dict[str, Any], site: str,
                 rpc_record=None):
        """One RPC with its failpoint and latency accounting; transport
        failures (the deadline included) raise for the caller's
        recovery. `rpc_record[widx]` = (wall ns, the worker's handle
        ns)."""
        failpoints.hit(site)
        t0 = time.perf_counter_ns()
        resp = self.pool.request(widx, req, timeout_s=self.rpc_timeout_s)
        wall_ns = time.perf_counter_ns() - t0
        self.stats.observe_rpc(req["verb"], wall_ns)
        if rpc_record is not None and isinstance(resp, dict):
            rpc_record[widx] = (wall_ns, resp.get("_handle_ns"))
        return resp

    def _state_payload(self, before_route: bool) -> Dict[str, Any]:
        """The manager's row state for a re-ship: before the last route
        when the retried request carries it (the worker then applies
        it), else the current one."""
        global HOST_READS
        HOST_READS += 1
        slot, leaf, pos = (self.before_route if before_route
                           else (self.slot, self.leaf_id, self.pos))
        return {
            "slot": slot.cpu().numpy(), "leaf_id": leaf.cpu().numpy(),
            "pos": pos, "hist_stats": self.cur_hist_stats,
            "qscale": self.cur_qscale,
        }

    def _pick_replacement(self, after: int) -> int:
        """The next healthy worker for a moved shard, waiting out the
        quarantines with the pool's backoff."""
        for attempt in range(self.pool.retry_attempts):
            idx = self.pool.pick_worker(after)
            if idx is not None:
                return idx
            time.sleep(self.pool.backoff_delay(attempt))
        raise DistributedTrainingError(
            "no reachable worker to take over a feature shard "
            f"(all {len(self.pool.addresses)} quarantined)")

    def _fenced(self, widx: int, resp) -> DistributedTrainingError:
        return DistributedTrainingError(
            f"fenced out: worker {self.pool.addr_str(widx)} holds manager "
            f"epoch {resp.get('have_epoch')} > ours ({self.epoch}) — a "
            "newer manager has attached to this run; this manager must "
            "stop")

    def _load_shards(self, widx: int, sids: List[int], with_state: bool,
                     site: str = "dist.shard_load",
                     before_route: bool = False) -> int:
        """Delivers shards (and on recovery the manager's state,
        _state_payload's) to a worker: on a transport failure to the next
        healthy one; on a corruption report after rebuilding the shards
        from bins.npy. Returns the worker that owns them."""
        rebuilt = False
        for _attempt in range(self.pool.retry_attempts):
            req = {"verb": "load_cache_shard", "key": self.key_id,
                   "shards": list(sids), "cache_dir": self.cache.path}
            if with_state:
                req["state"] = self._state_payload(before_route)
            try:
                resp = self._request(widx, self._stamp(req, widx), site)
            except (OSError, ConnectionError) as e:
                log.debug(f"dist: shard load on {self.pool.addr_str(widx)} "
                          f"failed ({e}); reassigning")
                self.pool.mark_failed(widx)
                self.stats.recoveries += 1
                self.stats.drop_worker_shards(self.pool.addr_str(widx))
                widx = self._pick_replacement(widx + 1)
                continue
            if resp.get("ok"):
                self.pool.mark_ok(widx)
                for sid in sids:
                    self.owner[sid] = widx
                self._note_shard_load(widx, resp)
                return widx
            if resp.get("stale_epoch"):
                raise self._fenced(widx, resp)
            if resp.get("corrupt") and not rebuilt:
                log.info(f"dist: cache shard(s) {sids} corrupt on load "
                         f"({resp.get('error')}); rebuilding from bins.npy")
                if telemetry.ENABLED:
                    telemetry.counter(
                        "ydf_dist_shard_corruption_total").inc()
                for sid in sids:
                    self.cache.rebuild_feature_shard(sid)
                self.stats.shard_rebuilds += len(sids)
                rebuilt = True
                continue
            raise DistributedTrainingError(
                f"worker {self.pool.addr_str(widx)} failed shard load: "
                f"{resp}")
        raise DistributedTrainingError(
            f"could not place shards {sids} on any worker within "
            f"{self.pool.retry_attempts} attempts")

    def _fan_out(self, groups: Dict[int, List[int]], make_req, site: str,
                 rpc_record=None):
        """Concurrent per-worker RPCs, handled in worker order so that
        recovery decisions are deterministic: [(widx, sids,
        response or exception)]. Requests are made and stamped on this
        thread (the open span is thread-local)."""
        order = sorted(groups)
        with ThreadPoolExecutor(max_workers=max(len(order), 1)) as ex:
            futs = {w: ex.submit(self._request, w,
                                 self._stamp(make_req(groups[w]), w), site,
                                 rpc_record)
                    for w in order}
            out = []
            for w in order:
                try:
                    out.append((w, groups[w], futs[w].result()))
                except BaseException as e:  # noqa: BLE001 — handled below
                    out.append((w, groups[w], e))
        return out

    def _groups(self, sids) -> Dict[int, List[int]]:
        g: Dict[int, List[int]] = {}
        for sid in sids:
            g.setdefault(self.owner[sid], []).append(sid)
        return g

    def _handle_failure(self, widx: int, sids: List[int],
                        before_route: bool) -> None:
        """A transport failure or deadline on `widx`: quarantine it and
        move its shards, with the manager's state, to the next healthy
        worker (after a best-effort drain of its last spans)."""
        self.pool.mark_failed(widx)
        self.stats.recoveries += 1
        self.stats.drop_worker_shards(self.pool.addr_str(widx))
        if telemetry.ENABLED:
            telemetry.counter("ydf_dist_recoveries_total").inc()
            self._drain_worker_telemetry([widx], timeout_s=5.0)
        new_w = self._pick_replacement(widx + 1)
        self._load_shards(new_w, sids, with_state=True,
                          before_route=before_route)

    def _note_shard_load(self, widx: int, resp: Dict[str, Any]) -> None:
        """Records a worker's resident bytes and logs a knob of
        dist_worker.DIST_CONFIG_KEYS that differs from the manager's."""
        addr = self.pool.addr_str(widx)
        sb = resp.get("shard_bytes")
        if isinstance(sb, int):
            self.stats.shard_bytes[addr] = sb
            if telemetry.ENABLED:
                telemetry.mem_set("dist_shard_fleet",
                                  sum(self.stats.shard_bytes.values()))
        wcfg = resp.get("config")
        if not isinstance(wcfg, dict):
            return
        mine = dist_worker.dist_config()
        for key in dist_worker.DIST_CONFIG_KEYS:
            if key in wcfg and wcfg[key] != mine.get(key):
                self.stats.config_mismatches += 1
                log.info(f"dist: config mismatch with worker {addr}: "
                         f"{key}={wcfg[key]!r} (manager: {mine.get(key)!r})")
                if telemetry.ENABLED:
                    telemetry.counter("ydf_dist_config_mismatch_total",
                                      key=key).inc()

    def _drain_worker_telemetry(self, indices: Optional[List[int]] = None,
                                timeout_s: Optional[float] = None) -> None:
        """Each worker's RSS, and with telemetry on its spans, merged into
        this process's trace: a worker's timestamps are corrected onto
        the manager's clock by the least-RTT of three pings (offset =
        worker clock - (send + rtt / 2)), and each worker gets its own
        pid row. An unreachable worker is skipped."""
        seen = set()
        for widx in (indices if indices is not None
                     else range(len(self.pool.addresses))):
            addr = self.pool.addr_str(widx)
            if addr in seen:
                continue
            seen.add(addr)
            t_out = timeout_s or min(30.0, self.rpc_timeout_s)
            offset_ns = None
            try:
                # A warm ping first, so the sampled ones ride an
                # established connection.
                self.pool.request(widx, {"verb": "ping"},
                                  timeout_s=min(10.0, t_out))
                best_rtt = None
                for _ in range(3):
                    t_send = time.perf_counter_ns()
                    pong = self.pool.request(widx, {"verb": "ping"},
                                             timeout_s=min(10.0, t_out))
                    t_recv = time.perf_counter_ns()
                    if not pong.get("ok") or "clock_ns" not in pong:
                        break
                    rtt = t_recv - t_send
                    if best_rtt is None or rtt < best_rtt:
                        best_rtt = rtt
                        offset_ns = pong["clock_ns"] - (t_send + rtt // 2)
                resp = self.pool.request(widx, {"verb": "get_telemetry"},
                                         timeout_s=t_out)
            except (OSError, ConnectionError):
                continue
            if not isinstance(resp, dict) or not resp.get("ok"):
                continue
            if isinstance(resp.get("rss_bytes"), int):
                self.stats.worker_rss_bytes[addr] = resp["rss_bytes"]
            if not telemetry.ENABLED:
                continue
            offset_ns = offset_ns or 0
            wpid = resp.get("pid")
            if wpid is None or wpid == os.getpid():
                # In-process workers: a pid row of their own.
                wpid = 1_000_000 + (widx % len(self.pool.addresses))
            merged = [{"name": "process_name", "ph": "M", "pid": wpid,
                       "cat": "ydf_tpu", "args": {"name": f"worker {addr}"}}]
            for ev in resp.get("events", []):
                ev = dict(ev)
                if "ts" in ev:
                    ev["ts"] = ev["ts"] - offset_ns / 1000.0
                ev["pid"] = wpid
                merged.append(ev)
            telemetry.ingest_events(merged)
            self.stats.drained_events[addr] = (
                self.stats.drained_events.get(addr, 0) + len(merged) - 1)
            telemetry.counter(
                "ydf_dist_telemetry_drained_events_total").inc(
                len(merged) - 1)

    def _exchange(self, sids: List[int], make_req, site: str, on_ok,
                  rpc_record=None, before_route: bool = False) -> None:
        """A fan-out that retries each shard group through failures,
        reassignments and need_shard answers until every shard of `sids`
        answered; `before_route`: the requests carry the last route."""
        pending = set(sids)
        for _attempt in range(4 * self.pool.retry_attempts):
            if not pending:
                return
            for widx, group, resp in self._fan_out(
                    self._groups(sorted(pending)), make_req, site,
                    rpc_record):
                if isinstance(resp, failpoints.FailpointError):
                    raise resp
                if isinstance(resp, BaseException):
                    if not isinstance(resp, (OSError, ConnectionError)):
                        raise resp
                    self._handle_failure(widx, group, before_route)
                    continue
                if resp.get("stale_epoch"):
                    # A newer manager attached to this run's worker state:
                    # going on would race two managers.
                    raise self._fenced(widx, resp)
                if resp.get("need_shard"):
                    # The worker restarted in place: re-ship to it.
                    self.stats.recoveries += 1
                    self._load_shards(widx, group, with_state=True,
                                      before_route=before_route)
                    continue
                if not resp.get("ok"):
                    raise DistributedTrainingError(
                        f"worker {self.pool.addr_str(widx)} failed "
                        f"{site}: {resp}")
                on_ok(widx, group, resp)
                pending -= set(group)
        raise DistributedTrainingError(
            f"shards {sorted(pending)} unanswered after retries ({site})")

    # ---- the grower's shards= seam -------------------------------------- #

    def for_tree(self, extra=None) -> "DistGBTManager":
        """The seam object of one tree (the boosting loop's mesh_rows
        interface); a tree adds no columns here."""
        if extra is not None:
            raise ValueError("distributed trees take no per-tree columns")
        return self

    def begin(self, op: torch.Tensor, L: int,
              qscale: Optional[torch.Tensor] = None) -> None:
        """A tree's start: its histogram operand to the host (sent with
        the first request) and every row on the root slot."""
        global HOST_READS
        self.cur_hist_stats = dist_worker.to_wire(op)
        self.cur_qscale = dist_worker.to_wire(qscale)
        HOST_READS += 1 if qscale is None else 2
        self.stats.stats_bytes += self.cur_hist_stats["data"].nbytes
        if telemetry.ENABLED:
            telemetry.counter("ydf_dist_stats_bytes_total").inc(
                self.cur_hist_stats["data"].nbytes)
        zeros = torch.zeros(self.n, dtype=torch.int32, device=self.device)
        self.slot, self.leaf_id = zeros, zeros
        self.pos = (self.it, 0)
        self.pending_route = self.before_route = None

    def _histograms(self, num_slots: int, B: int, reset: bool
                    ) -> torch.Tensor:
        """build_histograms on every shard; the accumulators concatenated
        in shard order, on the manager's device."""
        req = {"verb": "build_histograms", "key": self.key_id,
               "tree": self.it, "layer": self.pos[1], "reset": reset,
               "num_slots": num_slots, "num_bins": B,
               "quant": self.hist_quant}
        if reset:
            req["stats"] = {"hist_stats": self.cur_hist_stats,
                            "qscale": self.cur_qscale}
        if self.pending_route is not None:
            req["route"] = self.pending_route
        parts: Dict[int, np.ndarray] = {}
        rpcs: Dict[int, Tuple[int, Optional[int]]] = {}

        def on_hist(widx, group, resp):
            for k, h in resp["hists"].items():
                parts[int(k)] = h
                self.stats.reduce_bytes += h.nbytes
            if telemetry.ENABLED:
                telemetry.counter("ydf_dist_reduce_bytes_total").inc(
                    sum(h.nbytes for h in resp["hists"].values()))

        t0 = time.perf_counter_ns()
        self._exchange(list(range(self.num_shards)),
                       lambda sids: {**req, "shards": sids},
                       "dist.histogram_rpc", on_hist, rpc_record=rpcs,
                       before_route=not reset)
        t1 = time.perf_counter_ns()
        hist = torch.from_numpy(np.concatenate(
            [parts[k] for k in range(self.num_shards)], axis=1)).to(
            self.device)
        self.stats.observe_merge(time.perf_counter_ns() - t1)
        self.stats.observe_exchange(t1 - t0, rpcs)
        return hist

    def _route(self, tables, B: int) -> None:
        """The previous layer's decisions applied: the tables read once,
        apply_split to the owners of the split columns, the bitmaps
        OR-ed, the manager's rows routed; the next request carries the
        tables and the merged bitmap."""
        global HOST_READS
        L1 = tables.do_split.shape[0]
        wire = _unpack_tables(_pack_tables(tables).cpu().numpy(), L1, B)
        HOST_READS += 1
        merged = np.zeros(self.n, bool)
        do_split, route_f = wire["do_split"], wire["route_f"]
        # Only the owner of a split's column routes it.
        routing = [sid for sid, (lo, hi) in enumerate(self.col_ranges)
                   if np.any(do_split & (route_f >= lo) & (route_f < hi))]
        req = {"verb": "apply_split", "key": self.key_id, "tree": self.it,
               "layer": self.pos[1],
               "tables": {k: wire[k] for k in ("route_f", "go_left_bins")}}

        def on_bits(widx, group, resp):
            merged[:] |= dist_worker.unpack_bits(resp["bits"], self.n)
            self.stats.bitmap_bytes += len(resp["bits"])

        if routing:
            self._exchange(routing, lambda sids: {**req, "shards": sids},
                           "dist.split_broadcast", on_bits)
        self.before_route = (self.slot, self.leaf_id, self.pos)
        dirs = torch.from_numpy(merged.view(np.uint8)).to(self.device)
        self.slot, self.leaf_id, _ = route_plain(
            self.no_cols, self.slot, self.leaf_id,
            direction_tables(tables, dirs))
        self.pos = (self.it, self.pos[1] + 1)
        go_left = dist_worker.pack_bits(merged)
        self.stats.bitmap_bytes += len(go_left) * self.num_shards
        self.pending_route = {"tables": wire, "go_left": go_left}

    def root(self, Ld: int, B: int) -> torch.Tensor:
        with telemetry.span("dist.layer") as sp:
            if telemetry.ENABLED:
                sp.set(tree=self.it, layer=0)
            return self._histograms(Ld, B, reset=True)

    def routed(self, tables, Lh: int, B: int) -> torch.Tensor:
        with telemetry.span("dist.layer") as sp:
            if telemetry.ENABLED:
                sp.set(tree=self.it, layer=self.pos[1] + 1)
            self._route(tables, B)
            return self._histograms(Lh, B, reset=False)

    def route_last(self, tables, B: int) -> None:
        with telemetry.span("dist.layer") as sp:
            if telemetry.ENABLED:
                sp.set(tree=self.it, layer=self.pos[1] + 1)
            self._route(tables, B)

    def leaf_ids(self) -> torch.Tensor:
        return self.leaf_id

    # ---- the training loop ---------------------------------------------- #

    def train(self):
        """Runs the boosting loop: (learners/gbt.py:BoostResult, the
        run's training_logs["distributed"] record)."""
        from ydf_tpu_torch.learners import gbt
        from ydf_tpu_torch.ops import grower

        dev = self.device
        t0_ns = time.perf_counter_ns()
        # Keep going with the workers that answer; raises when none does.
        self.pool.ping_all(drop_unreachable=True)
        self.owner = [k % len(self.pool.addresses)
                      for k in range(self.num_shards)]
        self._restore_owner_map()
        # The load is the reattach too: crc-checked, adopts the epoch,
        # idempotent on a worker that holds the shards.
        site = ("dist.resume_attach" if self._resume_state is not None
                else "dist.shard_load")
        for widx, sids in self._groups(range(self.num_shards)).items():
            self._load_shards(widx, sids, with_state=False, site=site)

        T, F, cfg = self.num_trees, self.F, self.cfg
        sampled = 0 < self.candidate_features < F
        keys = columns = None
        if self.subsample < 1.0 or sampled:
            keys = gbt.IterationKeys(*(
                None if k is None else k.to(dev)
                for k in gbt.iteration_keys(self.seed, T, 1, False, "cpu")))
        if sampled:
            columns = grower.layer_columns(
                keys.tree.reshape(-1, 2), max_depth=cfg.max_depth,
                frontier=cfg.frontier, num_features=F,
                num_numerical=self.Fn,
                orderings=self.rule.num_cat_orderings,
                k=self.candidate_features)
        # The loop reads only the shape and device of its bins when they
        # live elsewhere: a one-byte stand-in of the bins' [F, n].
        no_bins = torch.zeros((), dtype=torch.uint8, device=dev).expand(
            F, self.n)
        loop = gbt._Loop(
            no_bins, torch.from_numpy(self.labels.astype(np.float32)).to(dev),
            torch.from_numpy(self.weights).to(dev), loss_obj=self.loss_obj,
            rule=self.rule, tree_cfg=cfg, shrinkage=self.shrinkage,
            hist_quant=self.hist_quant, vs=None, draws=None, obl=None,
            obl_w=None, loop_of_one=False, num_numerical=self.Fn,
            valid=None, sampling=gbt.Sampling("RANDOM", self.subsample),
            keys=keys, columns=columns, num_trees=T, mesh_rows=self)
        start_it = self._restore(loop)
        if start_it:
            log.info(f"dist: resuming at tree {start_it}/{T} from "
                     f"{self.working_dir!r} (manager epoch {self.epoch})")
        tree_ns = []
        guard_cm = (gbt._PreemptionGuard() if self._snaps is not None
                    else contextlib.nullcontext(None))
        with guard_cm as guard:
            for it in range(start_it, T):
                self.it = it
                t_tree = time.perf_counter_ns()
                with telemetry.span("dist.tree") as sp:
                    if telemetry.ENABLED:
                        sp.set(iteration=it)
                    loop.step(it)
                    if self.verify:
                        self._verify_tree(it, cfg.max_depth,
                                          loop.trees[-1])
                tree_ns.append(time.perf_counter_ns() - t_tree)
                if log.is_debug():
                    log.debug(f"dist gbt: iter {it + 1}/{T} "
                              f"tree_s={tree_ns[-1] / 1e9:.3f}")
                self._tree_boundary(guard, it + 1, loop)
        self._drain_worker_telemetry()
        wall_ns = time.perf_counter_ns() - t0_ns
        result = loop.result([(start_it, T - start_it, t0_ns, wall_ns)])
        logs = {
            "workers": len(self.pool.addresses),
            "feature_shards": self.num_shards,
            "hist_quant": self.hist_quant, "epoch": int(self.epoch),
            "resumed_from": int(start_it),
            "tree_s": [ns / 1e9 for ns in tree_ns],
            **self.stats.summary(), **_transport_fields(self.pool),
        }
        return result, logs

    def _verify_tree(self, it: int, D: int, tree) -> None:
        """YDF_TPU_DIST_VERIFY: the worker owning shard 0 applies the last
        route and reports its leaf assignment's crc, per-leaf counts and
        sums; a drifted worker raises (never a silently wrong tree)."""
        global HOST_READS
        N = tree.leaf_stats.shape[0]
        req = {"verb": "leaf_stats", "key": self.key_id, "tree": it,
               "layer": D, "route": self.pending_route,
               "num_nodes_cap": N + 1}
        got = {}

        def on_leaf(widx, group, r):
            got["resp"] = r

        self._exchange([0], lambda sids: dict(req), "dist.split_broadcast",
                       on_leaf, before_route=True)
        resp = got["resp"]
        leaf = self.leaf_id.cpu().numpy()
        leaf_stats = tree.leaf_stats.cpu().numpy()
        HOST_READS += 1
        want_crc = zlib.crc32(leaf.tobytes())
        if resp["leaf_crc"] != want_crc:
            raise DistributedTrainingError(
                f"worker leaf assignment diverged on tree {it}: crc "
                f"{resp['leaf_crc']:#x} != manager {want_crc:#x}")
        counts = np.bincount(leaf, minlength=N + 1)
        if not np.array_equal(resp["leaf_counts"], counts):
            raise DistributedTrainingError(
                f"worker per-leaf counts diverged on tree {it}")
        sums = resp.get("leaf_sums")
        if sums is not None:
            # The histogram algebra's leaf stats against the worker's
            # direct per-row sums: equal up to the order of the adds, at
            # the populated leaves.
            leafy = counts[:N] > 0
            mine = leaf_stats.astype(np.float64)[leafy]
            theirs = np.asarray(sums)[:N][leafy]
            scale = np.maximum(np.abs(mine), 1.0)
            if not np.allclose(theirs / scale, mine / scale, atol=1e-3):
                raise DistributedTrainingError(
                    f"worker per-leaf stat sums diverged on tree {it}")
