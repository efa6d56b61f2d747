"""NUMERICAL_VECTOR_SEQUENCE anchor scores: wrapper, plain PyTorch version
and launch count (counterpart of ydf_tpu/ops/vector_sequence.py).

Per (example, anchor), both "higher is more":
  * projected_more_than: score = max_{v in seq} <v, anchor>
  * closer_than:         score = -min_{v in seq} |v - anchor|^2, computed
    as (|v|^2 - 2 <v, anchor>) + |anchor|^2, the JAX package's expansion.
Empty sequences score -FLT_MAX (NEG_INF_SCORE), so they fall on the
negative side of every learned threshold.

`vs_scores` launches csrc/vector_sequence.cu (replaces the TPU kernel
`_vs_kernel`) on a CUDA tensor, or raises; a CPU tensor runs the plain
version, which repeats the kernel's arithmetic in the same order: |v|^2
and |a|^2 as fused multiply-adds over d in increasing order, a dot as
`dot_lanes(A)` interleaved chains of fused multiply-adds (d mod lanes)
summed pairwise. That is the order of the JAX package's CPU scores (XLA's
dot keeps 2 accumulators at 32 anchors and 4 at 16, measured with jax
0.9.0), so at those anchor counts the scores are bitwise equal to the JAX
package's; elsewhere they differ by rounding (within the bound
`score_tolerance` states).
"""

from __future__ import annotations

import torch

from ydf_tpu_torch.utils import cuda_build
from ydf_tpu_torch.utils.prng import fma_f32

NEG_INF_SCORE = torch.finfo(torch.float32).min  # -FLT_MAX, exactly
#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; plain-version calls do not count).
KERNEL_LAUNCHES = 0
# The kernel's blocks: WARPS warps, a warp a row at a time (grid-stride);
# at most BLOCKS_PER_SM blocks for each of the card's SMS SMs (H100 SXM),
# enough resident warps to keep the loads in flight.
WARPS = 4
SMS = 132
BLOCKS_PER_SM = 8
# The vector width the staged instantiation of the kernel is built for
# (the paths' width); other widths take the generic one.
STAGED_DIM = 16
# Examples per step of the plain version (bounds its float64 temporaries).
PLAIN_ROW_CHUNK = 1 << 14


def dot_lanes(num_anchors: int, dim: int) -> int:
    """Interleaved accumulators of a dot product: XLA's CPU dot's choice
    at this anchor count (2 at 32 anchors, 4 at 16, when they divide the
    dimension), else 1 (one chain in increasing d). One chain at 32
    anchors moves VS thresholds of the JAX package's trees by up to 9
    ulps (scripts/vs_dot_order_drift.py)."""
    lanes = {32: 2, 16: 4}.get(num_anchors, 1)
    return lanes if dim % lanes == 0 else 1


def _check(values, lengths, anchors, is_closer):
    if values.dtype != torch.float32 or values.dim() != 3:
        raise ValueError(
            f"values must be float32 [n, L, D], got {values.dtype} "
            f"{tuple(values.shape)}"
        )
    n, L, D = values.shape
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (n,):
        raise ValueError(f"lengths must be int32 [{n}]")
    if anchors.dtype != torch.float32 or anchors.dim() != 2 or (
        anchors.shape[1] != D
    ):
        raise ValueError(f"anchors must be float32 [A, {D}]")
    if is_closer.dtype != torch.bool or tuple(is_closer.shape) != (
        anchors.shape[0],
    ):
        raise ValueError(f"is_closer must be bool [{anchors.shape[0]}]")


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """sum over the last dim of x^2, fused multiply-adds in order."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for d in range(x.shape[-1]):
        acc = fma_f32(x[..., d], x[..., d], acc)
    return acc


def _scores_chunk(values, lengths, anchors, is_closer, a_sq, lanes):
    n, L, D = values.shape
    A = anchors.shape[0]
    acc = [torch.zeros((n, L, A), dtype=torch.float32, device=values.device)
           for _ in range(lanes)]
    for d in range(D):
        k = d % lanes
        acc[k] = fma_f32(values[:, :, d, None], anchors[None, None, :, d],
                      acc[k])
    while len(acc) > 1:
        acc = [acc[i] + acc[i + 1] for i in range(0, len(acc), 2)]
    dots = acc[0]
    d2 = (_sum_squares(values)[:, :, None] - 2.0 * dots) + a_sq
    valid = (torch.arange(L, device=values.device)[None, :]
             < lengths[:, None])[:, :, None]
    max_dot = torch.where(valid, dots, NEG_INF_SCORE).amax(dim=1)
    neg_min_d2 = -torch.where(valid, d2, -NEG_INF_SCORE).amin(dim=1)
    return torch.where(is_closer[None, :], neg_min_d2, max_dot)


def vs_scores_plain(values: torch.Tensor, lengths: torch.Tensor,
                    anchors: torch.Tensor,
                    is_closer: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of csrc/vector_sequence.cu: f32 [n, A]."""
    _check(values, lengths, anchors, is_closer)
    n, L, D = values.shape
    A = anchors.shape[0]
    if n == 0 or A == 0 or L == 0:
        return torch.full((n, A), NEG_INF_SCORE, dtype=torch.float32,
                          device=values.device)
    lanes = dot_lanes(A, D)
    a_sq = _sum_squares(anchors)
    lengths = lengths.clamp(0, L)
    return torch.cat([
        _scores_chunk(values[r:r + PLAIN_ROW_CHUNK],
                      lengths[r:r + PLAIN_ROW_CHUNK], anchors, is_closer,
                      a_sq, lanes)
        for r in range(0, n, PLAIN_ROW_CHUNK)
    ])


def vs_launch_shape(n: int) -> int:
    """Blocks of the kernel's grid for n rows: one row a warp while the
    card holds them all, then a grid-stride loop over rows."""
    return max(1, min(-(-n // WARPS), SMS * BLOCKS_PER_SM))


def vs_scores(values: torch.Tensor, lengths: torch.Tensor,
              anchors: torch.Tensor, is_closer: torch.Tensor) -> torch.Tensor:
    """Scores f32 [n, A] of values f32 [n, L, D] (zero-padded past
    lengths i32 [n]) against anchors f32 [A, D]; anchor a is closer_than
    iff is_closer[a] (bool [A])."""
    if values.device.type == "cpu":
        return vs_scores_plain(values, lengths, anchors, is_closer)
    global KERNEL_LAUNCHES
    _check(values, lengths, anchors, is_closer)
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in (values, lengths, anchors, is_closer):
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    n, L, D = values.shape
    A = anchors.shape[0]
    out = torch.empty((n, A), dtype=torch.float32, device=dev)
    if n == 0 or A == 0:
        return out
    if L == 0 or D == 0:
        return out.fill_(NEG_INF_SCORE)
    closer_u8 = is_closer.to(torch.uint8)
    staged = D == STAGED_DIM and values.data_ptr() % 16 == 0
    fn = cuda_build.entry_point("vector_sequence", "ydf_vs_scores", 5, 7)
    with cuda_build.on_device(dev):
        timer = cuda_build.launch_timer("vector_sequence")
        status = fn(
            values.data_ptr(), lengths.data_ptr(), anchors.data_ptr(),
            closer_u8.data_ptr(), out.data_ptr(), n, L, D, A,
            dot_lanes(A, D), vs_launch_shape(n), int(staged),
            torch.cuda.current_stream().cuda_stream,
        )
        cuda_build.launch_done(timer)
    cuda_build.check_status(status, "vector-sequence kernel")
    KERNEL_LAUNCHES += 1
    return out


def score_tolerance(values: torch.Tensor, lengths: torch.Tensor,
                    anchors: torch.Tensor) -> torch.Tensor:
    """M [n, A]: max over the row's vectors of |v|^2 + |a|^2 + 2|v||a|,
    the magnitude that bounds the rounding of a score (a difference of
    two scores of other summation orders stays within 1e-5 M)."""
    vn = values.double().square().sum(-1).sqrt()  # [n, L]
    L = values.shape[1]
    valid = torch.arange(L, device=values.device)[None, :] < lengths[:, None]
    vmax = torch.where(valid, vn, 0.0).amax(dim=1)  # [n]
    an = anchors.double().square().sum(-1).sqrt()  # [A]
    return ((vmax[:, None] + an[None, :]) ** 2).float()
