"""Binning kernel: wrapper, plain PyTorch version and launch count
(counterpart of ydf_tpu/ops/binning_pallas.py).

`bin_columns` launches csrc/binning.cu (replaces the TPU kernel
`_bin_kernel`): values f32 [F, n] feature-major, boundaries f32
[F, max_b] ascending and +inf padded, nbounds i32 [F], impute f32 [F]
-> u8 bins, with bin = #{b < nb : boundary_b <= v} after NaN -> impute,
and a value still NaN binning to nb. The kernel writes the bins
feature-major, [F, n] contiguous (the training layout: the histogram
kernels read one feature's rows contiguously); both versions return
them as the [n, F] view of that matrix, whose `.t()` gives it back
without a copy. A CPU tensor runs the plain version (`bin_columns_jit`'s
searchsorted formulation); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ydf_tpu_torch.utils import cuda_build

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; plain-version calls do not count).
KERNEL_LAUNCHES = 0


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
                      nbounds: torch.Tensor, impute: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of csrc/binning.cu: u8 [n, F], the view of
    a contiguous [F, n]."""
    _check(values, boundaries, nbounds, impute)
    v = torch.where(torch.isnan(values), impute[:, None], values)
    idx = torch.searchsorted(boundaries.contiguous(), v.contiguous(),
                             right=True)
    nb = nbounds.long()[:, None].clamp(0, boundaries.shape[1])
    idx = torch.minimum(idx, nb)
    return torch.where(torch.isnan(v), nb, idx).to(torch.uint8).t()


def bin_columns(values: torch.Tensor, boundaries: torch.Tensor,
                nbounds: torch.Tensor, impute: torch.Tensor) -> torch.Tensor:
    """u8 bins [n, F], the view of a contiguous [F, n], of values f32
    [F, n] (contiguous)."""
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
    out = torch.empty((F, n), dtype=torch.uint8, device=dev)
    if n == 0 or F == 0:
        return out.t()
    fn = cuda_build.entry_point("binning", "ydf_bin_columns", 5, 3)
    with cuda_build.on_device(dev):
        timer = cuda_build.launch_timer("binning")
        status = fn(
            values.data_ptr(), boundaries.data_ptr(), nbounds.data_ptr(),
            impute.data_ptr(), out.data_ptr(), n, F, boundaries.shape[1],
            torch.cuda.current_stream().cuda_stream,
        )
        cuda_build.launch_done(timer)
    cuda_build.check_status(status, "binning kernel")
    KERNEL_LAUNCHES += 1
    return out.t()
