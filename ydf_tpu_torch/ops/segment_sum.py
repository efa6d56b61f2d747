"""Run sums in order: wrapper, plain PyTorch version and launch count.

`segment_sums` launches csrc/segment_sum.cu. The kernel has no TPU
counterpart: it replays the order of the XLA CPU dot behind the JAX
package's set-candidate einsum (ops/grower.py:set_item_stats), a
sequential sum of each run of equal keys that a PyTorch call does not
give (index_add_ and cumsum add in other orders).

key i64 [E] sorted so that each run of equal keys is contiguous, vals
f32 [E, S] in each run's order -> f32 [E, S]: at a run's first entry
(its head) the run's sum, added in order from 0 with one f32 rounding
an add; zeros elsewhere. A CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises.

The kernel stages tiles of `tile_entries(S)` entries in a block's shared
memory; TILE is the one place the tile is set (the tests and chip_smoke.py
put runs on its edges).
"""

from __future__ import annotations

import torch

from ydf_tpu_torch.utils import cuda_build

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; plain-version calls do not count).
KERNEL_LAUNCHES = 0

#: Entries a block of csrc/segment_sum.cu stages at most (its tile).
TILE = 1024
#: Entries a block stages at a time for a run that crosses its tile's end
#: (csrc/segment_sum.cu:kCont).
CONT = 512
#: Dynamic shared memory a block may take (csrc/segment_sum.cu:kSmemLimit).
SHARED_LIMIT = 232448 - 1024
#: The largest tile the kernel takes (csrc/segment_sum.cu:kMaxTile).
MAX_TILE = 4096


def shared_bytes(T: int, S: int) -> int:
    """A block's dynamic shared memory at a tile of T entries and S stats
    (csrc/segment_sum.cu:smem_bytes): keys, values, a continuation
    chunk's keys and values, the heads, the head flags."""
    C = min(CONT, T)
    return 8 * T + 4 * T * S + 8 * C + 4 * C * S + 4 * (T + 1) + T


def tile_entries(S: int) -> int:
    """The kernel's tile at S stats: TILE (at most MAX_TILE), halved (to a
    multiple of 4) while a block's shared memory would not fit."""
    T = min(TILE, MAX_TILE)
    while T > 4 and shared_bytes(T, S) > SHARED_LIMIT:
        T = max(4, T // 8 * 4)
    if shared_bytes(T, S) > SHARED_LIMIT:
        raise ValueError(f"{S} stats do not fit the kernel's shared memory")
    return T


def run_heads(key: torch.Tensor) -> torch.Tensor:
    """bool [E]: the entry heads its run."""
    head = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    if key.shape[0] > 1:
        head[1:] = key[1:] != key[:-1]
    return head


def _check(key: torch.Tensor, vals: torch.Tensor) -> None:
    if key.dtype != torch.int64 or key.dim() != 1:
        raise ValueError(f"key must be int64 [E], got {key.dtype} "
                         f"{tuple(key.shape)}")
    if vals.dtype != torch.float32 or vals.dim() != 2 or (
            vals.shape[0] != key.shape[0]):
        raise ValueError(f"vals must be float32 [{key.shape[0]}, S], got "
                         f"{vals.dtype} {tuple(vals.shape)}")


def segment_sums_plain(key: torch.Tensor, vals: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version of csrc/segment_sum.cu: step j adds every
    run's j-th entry to its sum (one host read of the runs' lengths)."""
    _check(key, vals)
    E, S = vals.shape
    out = torch.zeros((E, S), dtype=torch.float32, device=vals.device)
    if E == 0:
        return out
    head = run_heads(key)
    seg = torch.cumsum(head.long(), 0) - 1
    start = torch.nonzero(head)[:, 0]
    rank = torch.arange(E, device=key.device) - start[seg]
    order = torch.argsort(rank, stable=True)
    acc = torch.zeros((start.shape[0], S), dtype=torch.float32,
                      device=vals.device)
    off = 0
    for count in torch.bincount(rank).tolist():
        sl = order[off:off + count]
        s = seg[sl]
        acc[s] = acc[s] + vals[sl]
        off += count
    out[start] = acc
    return out


def segment_sums(key: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Run sums f32 [E, S] at the runs' heads, zeros elsewhere (module
    docstring)."""
    if vals.device.type == "cpu":
        return segment_sums_plain(key, vals)
    global KERNEL_LAUNCHES
    _check(key, vals)
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if key.device != dev:
        raise ValueError(f"tensors on {key.device} and {dev}")
    if not (key.is_contiguous() and vals.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    E, S = vals.shape
    if E * S >= 2 ** 31:
        raise ValueError(f"{E} x {S} entries: past the kernel's int range")
    out = torch.empty((E, S), dtype=torch.float32, device=dev)
    if E == 0 or S == 0:
        return out.zero_()
    T = tile_entries(S)
    fn = cuda_build.entry_point("segment_sum", "ydf_segment_sums", 3, 3)
    with cuda_build.on_device(dev):
        timer = cuda_build.launch_timer("segment_sum")
        status = fn(key.data_ptr(), vals.data_ptr(), out.data_ptr(), E, S, T,
                    torch.cuda.current_stream().cuda_stream)
        cuda_build.launch_done(timer)
    cuda_build.check_status(status, "segment sum kernel")
    KERNEL_LAUNCHES += 1
    return out
