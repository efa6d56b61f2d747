"""The layer-histogram contract (counterpart of ydf_tpu/ops/histogram.py:
histogram and ydf_tpu/ops/grower.py:prepare_stats_for_hist).

`histogram(bins_t, slot, stats, num_slots, num_bins, quant, quant_scale)`
returns hist f32 [num_slots, F, num_bins, S]: the sum of each row's
stats into its (slot, feature, bin) cell, with rows on the trash slot
(slot == num_slots) dropped. The bin matrix is feature-major u8 [F, n]
(the JAX package takes [n, F]; the grower keeps one feature-major copy
per training run so the kernel's reads of a feature are coalesced).

Quantization modes of the stats operand, as in the JAX package:
  f32     exact input; the kernel accumulates f32.
  bf16x2  each f32 column split into a bf16 high part and a bf16
          residual (S doubled); accumulated in f32 and folded back.
  int8    round(stats / scale), clipped to +-127, with a per-column scale
          snapped up to a power of two; accumulated exactly in int32,
          dequantized once.
Callers on a hot loop pass the already-transformed operand (int8 or bf16
stats), detected by dtype, as the JAX package does. The GBT learner
takes the mode from YDF_TPU_HIST_QUANT (resolve_hist_quant; default f32).

The accumulation itself is ops/histogram_kernels.py: the CUDA kernel for
a CUDA tensor, its plain version for a CPU tensor. There is no impl
switch.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ydf_tpu_torch.ops import histogram_kernels

HIST_QUANTS = ("f32", "bf16x2", "int8")
_F32_TINY = torch.finfo(torch.float32).tiny


def resolve_hist_quant(value: Optional[str] = None) -> str:
    """The stats operand's quant mode (the JAX package's
    resolve_hist_quant): an explicit value wins, then
    YDF_TPU_HIST_QUANT, then "f32"; an unknown mode raises here."""
    if value is None:
        value = os.environ.get("YDF_TPU_HIST_QUANT")
        if value is None:
            return "f32"
        value = value.strip().lower()
    if value not in HIST_QUANTS:
        raise ValueError(f"YDF_TPU_HIST_QUANT={value!r} is not a "
                         f"quantization mode; expected one of "
                         f"{sorted(HIST_QUANTS)}")
    return value


def pow2_ceil(x: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= x (x > 0, f32), exactly: the JAX
    package's exp2(ceil(log2(x))) without the log's rounding."""
    mant, expo = torch.frexp(x)
    up = torch.ldexp(torch.ones_like(x), expo)
    return torch.where(mant == 0.5, x, up)


def int8_scale(stats: torch.Tensor) -> torch.Tensor:
    """Per-column int8 scale f32 [S]: max |stat| / 127, floored at the
    smallest normal f32 and snapped up to a power of two."""
    s = stats.abs().amax(dim=0) / 127.0
    return pow2_ceil(torch.clamp(s.float(), min=_F32_TINY))


def quantize_int8(stats: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(stats * (1 / scale)) clipped to +-127 (f32): the scale is a
    power of two, so the reciprocal multiply equals the divide."""
    return torch.clamp(torch.round(stats * (1.0 / scale)[None, :]),
                       -127.0, 127.0)


def split_bf16x2(stats: torch.Tensor) -> torch.Tensor:
    """bf16 [n, 2S]: high parts, then the residuals."""
    hi = stats.to(torch.bfloat16)
    lo = (stats - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo], dim=1)


# XLA's CPU reduction of a long axis (its tree-reduction rewrite): windows
# of REDUCE_WINDOW elements, each summed in order, level after level.
REDUCE_WINDOW = 32


def sum_rows_f32(x: torch.Tensor) -> torch.Tensor:
    """x f32 [n, S] summed over rows as XLA sums jnp.sum(x, axis=0) on
    the CPU, bit for bit: while more than 32 rows remain, pad the rows
    to a multiple of 32 (half the padding before them, the rest after)
    and add each window of 32 in order; then add the rest in order. The
    root totals then equal the JAX package's, so every right child's
    stats (parent - left) do too."""
    w = REDUCE_WINDOW
    while x.shape[0] > w:
        pad = -x.shape[0] % w
        x = torch.nn.functional.pad(x, (0, 0, pad // 2, pad - pad // 2))
        x = _sum_in_order(x.reshape(-1, w, x.shape[1]), 1)
    return _sum_in_order(x, 0)


def _sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """0 + x_0 + x_1 + ... along `dim`, one f32 rounding per add."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def prepare_stats_for_hist(stats: torch.Tensor, hist_quant: str
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                      torch.Tensor]:
    """Per-tree stats preparation: (the histogram operand, the int8 scale
    or None, the root totals [S] on the grid every layer's histograms
    sum). Totals are f32 sums in the JAX package's order (sum_rows_f32)."""
    if hist_quant == "int8":
        qscale = int8_scale(stats)
        stats_q = quantize_int8(stats, qscale)
        total = sum_rows_f32(stats_q) * qscale
        return stats_q.to(torch.int8), qscale, total
    total = sum_rows_f32(stats.float())
    if hist_quant == "bf16x2":
        return split_bf16x2(stats), None, total
    if hist_quant == "f32":
        return stats, None, total
    raise ValueError(f"histogram quant {hist_quant!r} is not one of "
                     f"{HIST_QUANTS}")


def finish(acc: torch.Tensor, op: torch.Tensor,
           quant_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel accumulator -> f32 [L, F, B, S]: folds bf16 halves,
    dequantizes int8 once."""
    if op.dtype == torch.bfloat16:
        S = op.shape[1] // 2
        return acc[..., :S] + acc[..., S:]
    if op.dtype == torch.int8:
        return acc.float() * quant_scale[None, None, None, :]
    return acc


def operand(stats: torch.Tensor, quant: str,
            quant_scale: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the kernel operand, the int8 scale or None) for `stats` under
    `quant`; already-transformed stats pass through."""
    if quant not in HIST_QUANTS:
        raise ValueError(f"histogram quant {quant!r} is not one of "
                         f"{HIST_QUANTS}")
    if quant == "int8":
        if stats.dtype == torch.int8:
            if quant_scale is None:
                raise ValueError("pre-quantized int8 stats require "
                                 "quant_scale")
            return stats, pow2_ceil(torch.clamp(quant_scale.float(),
                                                min=_F32_TINY))
        scale = (int8_scale(stats) if quant_scale is None else pow2_ceil(
            torch.clamp(quant_scale.float(), min=_F32_TINY)))
        return quantize_int8(stats, scale).to(torch.int8), scale
    if quant == "bf16x2" and stats.dtype != torch.bfloat16:
        return split_bf16x2(stats), None
    if stats.dtype != (torch.bfloat16 if quant == "bf16x2"
                       else torch.float32):
        raise ValueError(f"stats dtype {stats.dtype} does not match quant "
                         f"{quant!r}")
    return stats, None


def histogram(bins_t: torch.Tensor, slot: torch.Tensor, stats: torch.Tensor,
              num_slots: int, num_bins: int = 256, quant: str = "f32",
              quant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """hist f32 [num_slots, F, num_bins, S] (module docstring)."""
    op, scale = operand(stats, quant, quant_scale)
    acc = histogram_kernels.histogram(bins_t, slot, op, num_slots, num_bins)
    return finish(acc, op, scale)
