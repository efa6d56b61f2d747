"""Device meshes for training on several devices (counterpart of
ydf_tpu/parallel/mesh.py).

    import ydf_tpu_torch as ydf
    mesh = ydf.make_mesh()                            # every visible card
    mesh = ydf.make_mesh(feature_parallelism=2)       # (data, feature)
    mesh = ydf.make_mesh(["cuda:0"] * 4)              # four shards, one card
    mesh = ydf.make_mesh(["cpu"] * 8)                 # the CPU tests' mesh
    model = ydf.GradientBoostedTreesLearner(label="y", mesh=mesh).train(df)

A Mesh is a (data, feature) grid of torch devices with the JAX package's
axis names. The learners lay the rows over the data axis and the bin
matrix's columns over the feature axis (parallel/shards.py); each device
builds the histograms of its rows and columns with the same kernels as
one device, and the shards' unrounded sums are merged on the mesh's
first device. A device may appear more than once: that is a placement
(several shards on one card, or the CPU), not a fallback.

Several processes: `init_distributed(address, num_processes, process_id,
backend=...)` joins a torch.distributed group; each process then builds a
mesh of its own devices, and the data axis spans every process's shards
(process r holds data shards [r * dp, (r + 1) * dp)). The caller names
the backend: "nccl" with one process a card, "gloo" for the CPU (or
several processes sharing a card, staged through the host).

Under GSPMD the JAX package gets all of this from sharding annotations;
the port writes the sharded loop out (per-shard launches, a merge, the
split search once on the merged histogram).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
FEATURE_AXIS = "feature"

_LOOPBACK = ("localhost", "127.0.0.1", "::1")


class Mesh:
    """A (data, feature) grid of torch devices; `shape` maps the axis
    names to their sizes, as jax.sharding.Mesh does. `rank` and `world`
    are this process's place in the torch.distributed group the mesh was
    made in (0 and 1 without one)."""

    def __init__(self, devices: np.ndarray, rank: int = 0, world: int = 1,
                 backend: Optional[str] = None):
        self.devices = devices
        self.axis_names = (DATA_AXIS, FEATURE_AXIS)
        self.rank, self.world, self.backend = rank, world, backend

    @property
    def shape(self) -> dict:
        dp, fp = self.devices.shape
        return {DATA_AXIS: dp, FEATURE_AXIS: fp}

    @property
    def first_device(self) -> torch.device:
        """Where the merged histograms, the split search and the loop's
        per-row state live."""
        return self.devices[0, 0]

    @property
    def data_shards(self) -> int:
        """Data shards over every process of the group."""
        return self.world * self.devices.shape[0]

    def local_shards(self) -> range:
        """This process's data shards, as global shard indices."""
        dp = self.devices.shape[0]
        return range(self.rank * dp, (self.rank + 1) * dp)

    def __repr__(self) -> str:
        dp, fp = self.devices.shape
        names = [[str(d) for d in row] for row in self.devices]
        return (f"Mesh({dp}x{fp}, rank {self.rank} of {self.world}, "
                f"devices={names})")


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {dev}: CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {dev}")
    return dev


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Joins this process to a torch.distributed group (the JAX
    package's init_distributed over jax.distributed). Nothing tells a
    program of its cluster here: pass the coordinator's "host:port" (or
    "tcp://host:port"), the world size, this process's rank and the
    backend: "nccl" (one process a card; this process takes card
    process_id % device_count) or "gloo" (the CPU, or processes sharing
    a card: the merges stage through the host). NCCL with more processes
    than cards on one host raises; no backend is ever switched quietly.
    Idempotent: a second call returns the rank. Returns this process's
    rank."""
    dist = torch.distributed
    if dist.is_initialized():
        return dist.get_rank()
    if backend not in ("nccl", "gloo"):
        raise ValueError(
            f"init_distributed needs backend='nccl' or backend='gloo', got "
            f"{backend!r}")
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError(
            "init_distributed needs coordinator_address, num_processes and "
            "process_id: nothing detects a cluster")
    address = coordinator_address
    if not address.startswith("tcp://"):
        address = "tcp://" + address
    host = address[len("tcp://"):].rsplit(":", 1)[0].strip("[]")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs CUDA: CUDA is not "
                               "available")
        cards = torch.cuda.device_count()
        if host in _LOOPBACK and num_processes > cards:
            raise ValueError(
                f"backend='nccl' needs one card a process: {num_processes} "
                f"processes on a host with {cards} card(s); NCCL cannot "
                "join two ranks on one card. Use backend='gloo' to put "
                "several processes on one card.")
        torch.cuda.set_device(process_id % cards)
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def make_mesh(devices: Optional[Sequence] = None,
              data_parallelism: Optional[int] = None,
              feature_parallelism: int = 1) -> Mesh:
    """Builds a (data, feature) mesh of `devices` (torch devices or their
    names; None: every visible CUDA device, and no CUDA raises). All the
    devices go on the data axis by default. In a torch.distributed group
    the devices are this process's own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() with no devices takes every CUDA device: CUDA "
                "is not available (pass devices=['cpu'] * 8 for the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    n = len(devs)
    if n == 0:
        raise ValueError("make_mesh needs at least one device")
    if data_parallelism is None:
        data_parallelism = n // feature_parallelism
    if data_parallelism * feature_parallelism != n:
        raise ValueError(
            f"mesh {data_parallelism}x{feature_parallelism} != {n} devices")
    arr = np.empty((data_parallelism, feature_parallelism), dtype=object)
    for k, d in enumerate(devs):
        arr[k // feature_parallelism, k % feature_parallelism] = d
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return Mesh(arr, dist.get_rank(), dist.get_world_size(),
                    dist.get_backend())
    return Mesh(arr)


def shard_rows(mesh: Mesh, n: int) -> Tuple[int, List[Tuple[int, int]]]:
    """(rows a shard, each local shard's real rows [start, stop)): the n
    rows padded to a multiple of the data shards, shard g holding rows
    [g * m, (g + 1) * m), the padding at the end of the last ones."""
    D = mesh.data_shards
    m = max(-(-n // D), 1)
    return m, [(min(g * m, n), min((g + 1) * m, n))
               for g in mesh.local_shards()]


def column_slices(F: int, parts: int) -> List[Tuple[int, int]]:
    """F columns cut into `parts` contiguous slices as even as F allows
    (the first F % parts slices one longer)."""
    q, r = divmod(F, parts)
    out, c = [], 0
    for j in range(parts):
        w = q + (j < r)
        out.append((c, c + w))
        c += w
    return out


def shard_batch(mesh: Mesh, x, batch_dim: int = 0) -> List[List]:
    """x cut over the data axis on `batch_dim` (a multiple of the data
    shards: pad_rows_to_multiple first) and replicated over the feature
    axis: [dp][fp] tensors, shard (i, j) on mesh.devices[i, j]. In a
    group, this process's shards."""
    x = torch.as_tensor(x)
    D = mesh.data_shards
    if x.shape[batch_dim] % D:
        raise ValueError(
            f"dim {batch_dim} ({x.shape[batch_dim]}) is not a multiple of "
            f"the {D} data shards: pad_rows_to_multiple first")
    m = x.shape[batch_dim] // D
    dp, fp = mesh.devices.shape
    return [[x.narrow(batch_dim, g * m, m).to(mesh.devices[i, j])
             for j in range(fp)]
            for i, g in enumerate(mesh.local_shards())]


def shard_batch_and_features(mesh: Mesh, bins) -> List[List]:
    """The [n, F] bin matrix cut over (data, feature): [dp][fp] tensors,
    rows over the data shards, columns over column_slices (F a multiple
    of the feature axis, as the JAX package requires)."""
    bins = torch.as_tensor(bins)
    fp = mesh.devices.shape[1]
    if bins.shape[1] % fp:
        raise ValueError(
            f"{bins.shape[1]} columns are not a multiple of the feature "
            f"axis ({fp}): pad the columns first")
    rows = shard_batch(mesh, bins)
    return [[rows[i][j][:, c0:c1]
             for j, (c0, c1) in enumerate(column_slices(bins.shape[1], fp))]
            for i in range(len(rows))]


def pad_rows_to_multiple(arrs, multiple: int) -> Tuple[list, int]:
    """Pads each array's axis 0 with zeros to a multiple of `multiple`
    (numpy arrays or torch tensors); zero weight rows are the caller's,
    through its weight array. Returns (arrays, rows added)."""
    n = arrs[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return list(arrs), 0
    out = []
    for a in arrs:
        if isinstance(a, torch.Tensor):
            out.append(torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]))
        else:
            out.append(np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)))
    return out, pad


@contextlib.contextmanager
def host_staging(device: torch.device):
    """Leaves torch's sync debug mode "error" for a gloo merge, which
    stages a card's tensors through the host: the one place the sharded
    training loop may wait on the card."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def learner_device(mesh, device):
    """The device a learner given `mesh=` trains on: the mesh's first
    (where its per-row state and the merged histograms live). A `mesh`
    that is not a Mesh raises TypeError; a `device` other than the
    mesh's first raises ValueError."""
    if mesh is None:
        return device
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh= takes a Mesh (ydf_tpu_torch.make_mesh), got "
            f"{type(mesh).__name__}")
    first = mesh.first_device
    if device is not None and (torch.device(device).type, torch.device(
            device).index or 0) != (first.type, first.index or 0):
        raise ValueError(f"device={device} is not the mesh's first device "
                         f"{first}")
    return first
