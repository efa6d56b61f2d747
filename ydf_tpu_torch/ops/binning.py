"""Binning kernel: wrapper, plain PyTorch version and launch count
(counterpart of ydf_tpu/ops/binning_pallas.py).

`bin_columns` launches csrc/binning.cu (replaces the TPU kernel
`_bin_kernel`): values f32 [F, n] feature-major, boundaries f32
[F, max_b] ascending and +inf padded, nbounds i32 [F], impute f32 [F]
-> u8 bins [n, F], with bin = #{b < nb : boundary_b <= v} after NaN ->
impute, and a value still NaN binning to nb. A CPU tensor runs the plain
version (`bin_columns_jit`'s searchsorted formulation); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ydf_tpu_torch.utils import cuda_build

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; plain-version calls do not count).
KERNEL_LAUNCHES = 0
# Shared memory for a block's boundaries and output tile (binning.cu).
SMEM_BUDGET = 48 * 1024
ROWS_PER_BLOCK = 256


def _check(values, boundaries, nbounds, impute):
    if values.dtype != torch.float32 or values.dim() != 2:
        raise ValueError(
            f"values must be float32 [F, n], got {values.dtype} "
            f"{tuple(values.shape)}"
        )
    F = values.shape[0]
    if boundaries.dtype != torch.float32 or boundaries.dim() != 2 or (
        boundaries.shape[0] != F
    ):
        raise ValueError(f"boundaries must be float32 [{F}, max_b]")
    if boundaries.shape[1] > 255:
        raise ValueError("at most 255 boundaries per feature (u8 bins)")
    if nbounds.dtype != torch.int32 or tuple(nbounds.shape) != (F,):
        raise ValueError(f"nbounds must be int32 [{F}]")
    if impute.dtype != torch.float32 or tuple(impute.shape) != (F,):
        raise ValueError(f"impute must be float32 [{F}]")


def bin_columns_plain(values: torch.Tensor, boundaries: torch.Tensor,
                      nbounds: torch.Tensor,
                      impute: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of csrc/binning.cu: u8 [n, F]."""
    _check(values, boundaries, nbounds, impute)
    v = torch.where(torch.isnan(values), impute[:, None], values)
    idx = torch.searchsorted(boundaries.contiguous(), v.contiguous(),
                             right=True)
    nb = nbounds.long()[:, None].clamp(0, boundaries.shape[1])
    idx = torch.minimum(idx, nb)
    idx = torch.where(torch.isnan(v), nb, idx)
    return idx.t().to(torch.uint8).contiguous()


def bin_columns(values: torch.Tensor, boundaries: torch.Tensor,
                nbounds: torch.Tensor, impute: torch.Tensor) -> torch.Tensor:
    """u8 bins [n, F] of values f32 [F, n] (contiguous)."""
    if values.device.type == "cpu":
        return bin_columns_plain(values, boundaries, nbounds, impute)
    global KERNEL_LAUNCHES
    _check(values, boundaries, nbounds, impute)
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in (values, boundaries, nbounds, impute):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    F, n = values.shape
    max_b = boundaries.shape[1]
    out = torch.empty((n, F), dtype=torch.uint8, device=dev)
    if n == 0 or F == 0:
        return out
    Ft = max(1, min(F, SMEM_BUDGET // (max_b * 4 + ROWS_PER_BLOCK)))
    fn = cuda_build.entry_point("binning", "ydf_bin_columns", 5, 4)
    with torch.cuda.device(dev):
        timer = cuda_build.launch_timer("binning")
        status = fn(
            values.data_ptr(), boundaries.data_ptr(), nbounds.data_ptr(),
            impute.data_ptr(), out.data_ptr(), n, F, max_b, Ft,
            torch.cuda.current_stream().cuda_stream,
        )
        cuda_build.launch_done(timer)
    cuda_build.check_status(status, "binning kernel")
    KERNEL_LAUNCHES += 1
    return out
