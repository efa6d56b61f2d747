"""Worker half of feature-parallel distributed GBT training (counterpart
of ydf_tpu/parallel/dist_worker.py's feature-parallel verbs; the
reference's distributed_gradient_boosted_trees/worker.cc).

A worker holds the bins of some feature shards of a DatasetCache on its
device and answers the manager (parallel/dist_gbt.py) through the RPC
service (parallel/worker_service.py):

  load_cache_shard   the shards' bins, crc-checked, from a shared cache
                     directory, copied once to the worker's device
                     feature-major, u8 [Fk, n], the layout the histogram
                     kernels take; on recovery also the manager's
                     authoritative row state, so a replacement resumes
                     where the lost worker stood.
  build_histograms   one layer's histogram accumulator of each of its
                     shards, [num_slots, Fk, B, S'] by hist slot, on the
                     operand of ops/histogram.py in every quant mode (f32
                     cells; int32 under int8; S' = 2S bf16 halves under
                     bf16x2); the manager's grower finishes them as the
                     single device does. The root layer launches the root
                     kernel (csrc/histogram.cu on a card); a deeper layer
                     launches the routed kernel (csrc/histogram_routed.cu)
                     as a mesh's feature axis does (parallel/shards.py):
                     the request carries the previous layer's decision
                     tables and the merged go-left bitmap, which becomes
                     the kernel's row-direction table, so the kernel
                     routes every row and builds the smaller children's
                     histograms in one pass without the split columns
                     this worker lacks. At a tree's start the request
                     carries the tree's histogram operand.
  apply_split        the go-left bit of every row whose slot splits on a
                     feature this worker owns, as a packed bitmap
                     (shards.owned_directions): only the owner of a
                     split's column routes it.
  leaf_stats         the last layer's routing applied (route_plain of the
                     row-direction tables), then per-leaf counts, f64 sums
                     of the dequantized stats and the crc of the leaf ids:
                     the manager's check that no worker's state drifted
                     (YDF_TPU_DIST_VERIFY).

The float split search runs only on the manager, through the single
device's grower, which is what makes the distributed trees the single
device's; a worker keeps each row's slot and leaf, moved only by the
merged bitmaps.

Every verb is fenced by the manager's epoch (`_check_epoch`): a request
from a lower epoch (a zombie manager, a delayed frame of a dead run) gets
the typed stale_epoch rejection before any state changes, and only the
shard-load verb may advance the epoch (a resumed manager's reattach).
With YDF_TPU_WORKER_STATE_TTL_S set, state idle past the TTL is reaped
(`reap_idle_state`).

The row-parallel verbs and the distributed cache build's verbs of the
JAX package answer an error naming ROADMAP item 18.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ydf_tpu_torch.ops.histogram_kernels import RouteTables, route_plain
from ydf_tpu_torch.parallel.shards import direction_tables, owned_directions
from ydf_tpu_torch.utils import cuda_build, failpoints, telemetry

#: The feature-parallel verbs this module serves.
FEATURE_VERBS = frozenset(
    {"load_cache_shard", "build_histograms", "apply_split", "leaf_stats"})
#: The JAX package's other distributed verbs: row-parallel and hybrid
#: training, and the distributed cache build.
UNPORTED_VERBS = frozenset(
    {"load_row_shard", "row_histograms", "row_apply_split",
     "route_validation", "cache_ingest_stats", "cache_bin_rows"})
VERBS = FEATURE_VERBS | UNPORTED_VERBS
#: The environment knobs that must agree between the manager and its
#: workers; each side reports them and the manager logs a mismatch at
#: shard-load time.
DIST_CONFIG_KEYS = ("YDF_TPU_HIST_QUANT", "YDF_TPU_CACHE_VERIFY",
                    "YDF_TPU_WORKER_MAX_FRAME")

# Worker state, keyed by (worker instance id, manager run key): several
# in-process workers (tests) hold separate state, as processes would.
_STATE: Dict[tuple, "_DistState"] = {}
_STATE_CAP = 8
_STATE_LOCK = threading.Lock()


def kernel_launches(reset: bool = False) -> Dict[str, int]:
    """The histogram kernels' launch counts in this process
    (ops/histogram_kernels.py:LAUNCHES, which the wrappers add to), for
    the get_telemetry verb; reset=True sets them to 0 after the read."""
    from ydf_tpu_torch.ops import histogram_kernels

    out = dict(histogram_kernels.LAUNCHES)
    if reset:
        for k in histogram_kernels.LAUNCHES:
            histogram_kernels.LAUNCHES[k] = 0
    return out


def launch_times(reset: bool = False,
                 start: bool = False) -> Dict[str, list]:
    """This process's timed device spans since the last reset, by name:
    [count, ms] (cuda_build.LAUNCH_EVENTS: the kernel wrappers' launches,
    "histogram_routed/Lh=k" by hist slots, and this module's
    dist_worker/apply_split and dist_worker/copy_out), for the
    get_telemetry verb. reset=True empties the record after the read;
    start=True turns the recording on in a process with CUDA (it adds
    two CUDA events a span, no sync; the read waits for each span's end
    event, on whichever card it was recorded)."""
    events = cuda_build.LAUNCH_EVENTS
    out: Dict[str, list] = {}
    for name, t0, t1 in events or ():
        t1.synchronize()
        c = out.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += t0.elapsed_time(t1)
    if reset and events is not None:
        events.clear()
    if start and events is None and torch.cuda.is_available():
        cuda_build.LAUNCH_EVENTS = []
    return out


def dist_config() -> Dict[str, Optional[str]]:
    """This process's values of DIST_CONFIG_KEYS (None when unset)."""
    return {k: os.environ.get(k) for k in DIST_CONFIG_KEYS}


# ------------------------------------------------------------------ #
# Wire helpers: numpy only (parallel/worker_service.py).
# ------------------------------------------------------------------ #


def to_wire(t: Optional[torch.Tensor]) -> Optional[Dict[str, Any]]:
    """A tensor as host numpy for a frame: {"data", "dtype"}; bf16 goes
    as its uint16 bits (the card's machine has no numpy bfloat16)."""
    if t is None:
        return None
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return {"data": t.view(torch.int16).numpy().view(np.uint16),
                "dtype": "bfloat16"}
    return {"data": t.numpy(), "dtype": str(t.dtype).split(".")[-1]}


def from_wire(w: Optional[Dict[str, Any]], device) -> Optional[torch.Tensor]:
    """to_wire's inverse, on `device`."""
    if w is None:
        return None
    a = np.asarray(w["data"])
    if w["dtype"] == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).to(
            device).view(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def pack_bits(bits) -> bytes:
    """bool [n] (numpy or tensor) -> packed little-bit-order bytes (the
    wire bitmap)."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
    return np.packbits(np.asarray(bits, np.uint8),
                       bitorder="little").tobytes()


def unpack_bits(data: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8), count=n,
                         bitorder="little").astype(bool)


def route_tables(route: Dict[str, Any], n: int, device) -> RouteTables:
    """A carried route (the previous layer's wire tables, padded to L + 1
    slots with the JAX package's keys, and the merged go-left bitmap) as
    row-direction tables on `device` (shards.direction_tables): what the
    routed kernel and route_plain take."""
    t = route["tables"]

    def on(a):
        return torch.from_numpy(np.array(a)).to(device)

    L1 = len(t["do_split"])
    tables = RouteTables(
        do_split=on(t["do_split"]), route_f=on(t["route_f"]),
        go_left=on(t["go_left_bins"]), left_id=on(t["left_id"]),
        right_id=on(t["right_id"]), split_rank=on(t["split_rank"]),
        hmap=on(t["hmap"]),
        is_set=torch.zeros(L1, dtype=torch.bool, device=device),
        set_go_left=torch.zeros(1, dtype=torch.uint8, device=device))
    dirs = on(unpack_bits(route["go_left"], n).view(np.uint8))
    return direction_tables(tables, dirs)


def dequantized_stats(hist_stats: torch.Tensor,
                      qscale: Optional[torch.Tensor]) -> torch.Tensor:
    """The f32 per-row stats a tree grows on, from its histogram operand
    (the grower's expressions: int8 x scale, bf16 halves added)."""
    if hist_stats.dtype == torch.int8:
        return hist_stats.float() * qscale[None, :].float()
    if hist_stats.dtype == torch.bfloat16:
        S = hist_stats.shape[1] // 2
        return hist_stats[:, :S].float() + hist_stats[:, S:].float()
    return hist_stats.float()


# ------------------------------------------------------------------ #
# State.
# ------------------------------------------------------------------ #


class _ShardSlice:
    __slots__ = ("bins", "owner", "local")

    def __init__(self, lo: int, hi: int, num_features: int,
                 bins: torch.Tensor):
        self.bins = bins  # u8 [hi - lo, n] on the worker's device
        # The columns this shard holds, and each one's row in `bins`
        # (shards.owned_directions' owner / local maps).
        col = torch.arange(num_features, device=bins.device)
        self.owner = (col >= lo) & (col < hi)
        self.local = (col - lo).clamp(0, max(hi - lo - 1, 0))


class _DistState:
    def __init__(self, n: int, device):
        self.n = int(n)
        self.device = torch.device(device)
        # One manager sends one request a worker at a time, but a
        # recovery replay can overlap a straggling original.
        self.lock = threading.Lock()
        # The highest manager epoch that attached this state (0: none).
        self.epoch = 0
        self.last_used = time.monotonic()
        self.shards: Dict[int, _ShardSlice] = {}
        self.slot = torch.zeros(n, dtype=torch.int32, device=self.device)
        self.leaf_id = torch.zeros_like(self.slot)
        self.hist_stats: Optional[torch.Tensor] = None
        self.qscale: Optional[torch.Tensor] = None
        # (tree, routing steps applied in it): a worker out of step with
        # a request answers need_shard, and the manager re-ships its state.
        self.pos = (-1, 0)


def _get_state(worker_id: str, key: str) -> Optional[_DistState]:
    with _STATE_LOCK:
        st = _STATE.get((worker_id, key))
        if st is not None:
            st.last_used = time.monotonic()
        return st


def _need(msg: str) -> Dict[str, Any]:
    # The manager re-ships the shards (and its state) and retries.
    return {"ok": False, "need_shard": True, "error": msg}


def _stale_reject(req_epoch: int, have: int) -> Dict[str, Any]:
    """The typed stale-epoch rejection; deliberately not need_shard: a
    zombie manager must not be invited to re-ship over a newer one."""
    if telemetry.ENABLED:
        telemetry.counter("ydf_dist_epoch_rejects_total").inc()
    return {
        "ok": False, "stale_epoch": True, "have_epoch": int(have),
        "error": (
            f"request from stale manager epoch {req_epoch} fenced: this "
            f"worker state was attached by manager epoch {have}"
        ),
    }


def _check_epoch(st, req: Dict[str, Any],
                 load: bool = False) -> Optional[Dict[str, Any]]:
    """The manager-epoch fence, before any state change: a lower epoch
    is rejected (stale_epoch); a higher one is adopted by the shard-load
    verb (the reattach) and answered need_shard by the others; an equal
    or absent epoch proceeds. The `dist.epoch_fence` failpoint turns one
    request into the rejection, as if a newer manager had attached."""
    e = req.get("epoch")
    if e is None:
        return None
    e = int(e)
    try:
        failpoints.hit("dist.epoch_fence")
    except failpoints.FailpointError:
        return _stale_reject(e, max(st.epoch, e + 1))
    if e < st.epoch:
        return _stale_reject(e, st.epoch)
    if e > st.epoch:
        if load:
            st.epoch = e
            return None
        return _need(
            f"worker state at epoch {st.epoch} has not been attached "
            f"by manager epoch {e}; re-ship shards"
        )
    return None


# ------------------------------------------------------------------ #
# Verbs.
# ------------------------------------------------------------------ #


def _load_cache_shard(req: Dict[str, Any], worker_id: str,
                      device) -> Dict[str, Any]:
    from ydf_tpu_torch.dataset.cache import CacheCorruptionError, DatasetCache

    key = req["key"]
    try:
        cache = DatasetCache(req["cache_dir"], verify="off")
        host = {}
        for k in req["shards"]:
            # The shard's crc blocks are checked here: a corrupt slice
            # surfaces at load (the manager rebuilds it), never as a
            # wrong histogram.
            host[k] = (cache.shard_col_range(k),
                       np.array(cache.shard_bins(k, verify=True)))
        n, F = cache.num_rows, cache.binner.num_scalar
    except CacheCorruptionError as e:
        return {"ok": False, "corrupt": True, "error": str(e)}
    with _STATE_LOCK:
        st = _STATE.get((worker_id, key))
        if st is None or st.n != n:
            while len(_STATE) >= _STATE_CAP:
                _STATE.pop(next(iter(_STATE)))
            st = _STATE[(worker_id, key)] = _DistState(n, device)
        st.last_used = time.monotonic()
    with st.lock:
        err = _check_epoch(st, req, load=True)
        if err is not None:
            return err
        for k, ((lo, hi), b) in host.items():
            # [n, Fk] on the host -> [Fk, n] on the device, made
            # feature-major there.
            st.shards[int(k)] = _ShardSlice(
                lo, hi, F,
                torch.from_numpy(b).to(st.device).t().contiguous())
        state = req.get("state")
        if state is not None:
            # Recovery re-ship: the manager's authoritative row state.
            for name in ("slot", "leaf_id"):
                setattr(st, name, torch.from_numpy(
                    np.array(state[name], np.int32)).to(st.device))
            st.pos = tuple(state["pos"])
            if state.get("hist_stats") is not None:
                st.hist_stats = from_wire(state["hist_stats"], st.device)
                st.qscale = from_wire(state.get("qscale"), st.device)
        # shard_bytes: what this load left resident (the manager's
        # training_logs["distributed"]); config: the knobs that must
        # agree with the manager's.
        return {
            "ok": True, "n": n, "shards": sorted(st.shards),
            "shard_bytes": _state_bytes(st),
            "config": dist_config(),
        }


def _sync_to(st: _DistState, req: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Brings the state to the request's (tree, layer) for leaf_stats:
    one step behind, the carried route is applied (route_plain of its
    row-direction tables, which reads no column); any other gap answers
    need_shard."""
    tree, layer = int(req["tree"]), int(req["layer"])
    if st.pos == (tree, layer):
        return None
    route = req.get("route")
    if st.pos == (tree, layer - 1) and route is not None:
        no_cols = torch.empty((0, st.n), dtype=torch.uint8, device=st.device)
        st.slot, st.leaf_id, _ = route_plain(
            no_cols, st.slot, st.leaf_id,
            route_tables(route, st.n, st.device))
        st.pos = (tree, layer)
        return None
    return _need(
        f"worker state at position {st.pos} cannot serve "
        f"(tree, layer) = {(tree, layer)}"
    )


def _timer(st: _DistState, name: str):
    """A CUDA-event span of this worker's device work on its card
    (LAUNCH_EVENTS, which get_telemetry's time_launches turns on); None
    on the CPU. _timer_done ends it."""
    if st.device.type != "cuda":
        return None
    with cuda_build.on_device(st.device):
        return cuda_build.launch_timer(name)


def _timer_done(st: _DistState, timer) -> None:
    if timer is not None:
        with cuda_build.on_device(st.device):
            cuda_build.launch_done(timer)


def _shard_slices(st: _DistState, req: Dict[str, Any]):
    """The request's shards, or (None, need_shard answer)."""
    out = []
    for k in req["shards"]:
        sh = st.shards.get(int(k))
        if sh is None:
            return None, _need(f"shard {k} not loaded")
        out.append((int(k), sh))
    return out, None


def _build_histograms(req: Dict[str, Any], worker_id: str,
                      device) -> Dict[str, Any]:
    from ydf_tpu_torch.ops import histogram, histogram_kernels

    st = _get_state(worker_id, req["key"])
    if st is None:
        return _need(f"unknown dist key {req['key']!r} (worker restarted?)")
    with st.lock:
        err = _check_epoch(st, req)
        if err is not None:
            return err
        stats = req.get("stats")
        if stats is not None:
            st.hist_stats = from_wire(stats["hist_stats"], st.device)
            st.qscale = from_wire(stats.get("qscale"), st.device)
        tree, layer = int(req["tree"]), int(req["layer"])
        route = req.get("route")
        if req.get("reset"):
            st.slot.zero_()
            st.leaf_id.zero_()
            st.pos = (tree, 0)
            tables = None
        elif st.pos == (tree, layer - 1) and route is not None:
            tables = route_tables(route, st.n, st.device)
        else:
            return _need(f"worker state at position {st.pos} cannot build "
                         f"(tree, layer) = {(tree, layer)}")
        if st.hist_stats is None:
            return _need("no gradient stats loaded for this tree")
        shards, err = _shard_slices(st, req)
        if err is not None:
            return err
        # The kernel operand of the tree's stats in the request's quant
        # mode (a pre-quantized int8 or bf16 operand passes through).
        op, _ = histogram.operand(st.hist_stats, req.get("quant") or "f32",
                                  st.qscale)
        num_slots, num_bins = int(req["num_slots"]), int(req["num_bins"])
        accs, moved = {}, None
        for k, sh in shards:
            if tables is None:
                # The root: every row on slot 0.
                accs[k] = histogram_kernels.histogram(
                    sh.bins, st.slot, op, num_slots, num_bins)
            else:
                # Every shard routes the same rows the same way.
                accs[k], *moved = histogram_kernels.histogram_routed(
                    sh.bins, st.slot, st.leaf_id, tables, op, num_slots,
                    num_bins)
        if moved is not None:
            st.slot, st.leaf_id = moved
            st.pos = (tree, layer)
        timer = _timer(st, "dist_worker/copy_out")
        hists = {k: a.cpu().numpy() for k, a in accs.items()}
        _timer_done(st, timer)
        return {"ok": True, "hists": hists}


def _apply_split(req: Dict[str, Any], worker_id: str,
                 device) -> Dict[str, Any]:
    st = _get_state(worker_id, req["key"])
    if st is None:
        return _need(f"unknown dist key {req['key']!r} (worker restarted?)")
    with st.lock:
        err = _check_epoch(st, req)
        if err is not None:
            return err
        pos = (int(req["tree"]), int(req["layer"]))
        if st.pos != pos:
            # apply_split routes with the current layer's slots; a worker
            # at another position would compute wrong bits.
            return _need(
                f"worker state at position {st.pos} cannot route "
                f"layer {pos}"
            )
        shards, err = _shard_slices(st, req)
        if err is not None:
            return err
        t = req["tables"]
        route_f = torch.from_numpy(np.array(t["route_f"])).to(st.device)
        go_left = torch.from_numpy(np.array(t["go_left_bins"])).to(st.device)
        timer = _timer(st, "dist_worker/apply_split")
        bits = None
        for _, sh in shards:
            d = owned_directions(sh.bins, st.slot, route_f, go_left,
                                 sh.owner, sh.local)
            bits = d if bits is None else bits | d
        bits = bits.cpu().numpy()
        _timer_done(st, timer)
        return {"ok": True, "bits": pack_bits(bits)}


def _leaf_stats(req: Dict[str, Any], worker_id: str,
                device) -> Dict[str, Any]:
    st = _get_state(worker_id, req["key"])
    if st is None:
        return _need(f"unknown dist key {req['key']!r} (worker restarted?)")
    with st.lock:
        err = _check_epoch(st, req)
        if err is not None:
            return err
        err = _sync_to(st, req)
        if err is not None:
            return err
        leaf = st.leaf_id.long()
        cap = int(req.get("num_nodes_cap", int(leaf.max()) + 1))
        counts = torch.bincount(leaf, minlength=cap)
        sums = None
        if st.hist_stats is not None:
            deq = dequantized_stats(st.hist_stats, st.qscale).double()
            sums = torch.zeros((cap, deq.shape[1]), dtype=torch.float64,
                               device=st.device).index_add_(0, leaf, deq)
            sums = sums.cpu().numpy()
        return {
            "ok": True,
            "leaf_counts": counts.cpu().numpy(),
            "leaf_sums": sums,
            "leaf_crc": zlib.crc32(st.leaf_id.cpu().numpy().tobytes()),
        }


_HANDLERS = {
    "load_cache_shard": _load_cache_shard,
    "build_histograms": _build_histograms,
    "apply_split": _apply_split,
    "leaf_stats": _leaf_stats,
}


def handle(verb: str, req: Dict[str, Any], worker_id: str = "local",
           device=None) -> Dict[str, Any]:
    """Runs one distributed verb for worker `worker_id`, whose shards
    live on `device` (None: the CPU, for direct calls)."""
    if verb in UNPORTED_VERBS:
        return {"ok": False, "error": (
            f"verb {verb!r} (row-parallel distributed training or the "
            "distributed cache build) is not ported yet (ROADMAP Queue 1 "
            "item 18)")}
    return _HANDLERS[verb](req, worker_id,
                           torch.device("cpu") if device is None else device)


# ------------------------------------------------------------------ #
# Housekeeping.
# ------------------------------------------------------------------ #


def _state_bytes(st: _DistState) -> int:
    """Resident bytes of one run's state: the shards' bins and the
    routing and stat arrays (the "dist_shard" memory-ledger row)."""
    total = 2 * st.slot.numel() * 4
    if st.hist_stats is not None:
        total += st.hist_stats.numel() * st.hist_stats.element_size()
    for sl in st.shards.values():
        total += sl.bins.numel()
    return int(total)


def shard_bytes_total(worker_id: Optional[str] = None) -> int:
    """Bytes resident in this process's worker state: every worker
    instance's, or `worker_id`'s."""
    with _STATE_LOCK:
        items = [st for (wid, _), st in _STATE.items()
                 if worker_id is None or wid == worker_id]
    return sum(_state_bytes(st) for st in items)


telemetry.register_mem_source("dist_shard", shard_bytes_total)


def reap_idle_state(ttl_s: float) -> Tuple[int, int]:
    """Drops run states idle past `ttl_s` (YDF_TPU_WORKER_STATE_TTL_S;
    worker_service runs the sweep): (entries reaped, bytes released). A
    manager that comes back after a reap gets need_shard and re-ships."""
    now = time.monotonic()
    reaped = freed = 0
    with _STATE_LOCK:
        for key, st in list(_STATE.items()):
            if now - st.last_used >= ttl_s:
                freed += _state_bytes(st)
                del _STATE[key]
                reaped += 1
    if reaped and telemetry.ENABLED:
        telemetry.counter("ydf_worker_state_reaped_total").inc(reaped)
    return reaped, freed


def status(worker_id: str = "local") -> Dict[str, Any]:
    """This worker instance's runs for /statusz: position, epoch, shards,
    rows and resident bytes of each."""
    with _STATE_LOCK:
        items = [(key, st) for (wid, key), st in _STATE.items()
                 if wid == worker_id]
    return {key: {"pos": list(st.pos), "epoch": st.epoch,
                  "shards": sorted(st.shards), "rows": st.n,
                  "device": str(st.device),
                  "shard_bytes": _state_bytes(st)}
            for key, st in items}


def reset_state() -> None:
    """Drops every run's state (tests)."""
    with _STATE_LOCK:
        _STATE.clear()
