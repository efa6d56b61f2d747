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
"""

from __future__ import annotations

import torch

from ydf_tpu_torch.utils import cuda_build

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; plain-version calls do not count).
KERNEL_LAUNCHES = 0


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
    fn = cuda_build.entry_point("segment_sum", "ydf_segment_sums", 3, 2)
    with cuda_build.on_device(dev):
        timer = cuda_build.launch_timer("segment_sum")
        status = fn(key.data_ptr(), vals.data_ptr(), out.data_ptr(), E, S,
                    torch.cuda.current_stream().cuda_stream)
        cuda_build.launch_done(timer)
    cuda_build.check_status(status, "segment sum kernel")
    KERNEL_LAUNCHES += 1
    return out
