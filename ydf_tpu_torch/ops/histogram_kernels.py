"""Histogram kernels: wrappers, plain PyTorch versions and launch counts
(counterpart of ydf_tpu/ops/histogram_pallas.py).

  * `histogram` launches csrc/histogram.cu (replaces the TPU kernels
    `_hist_kernel` / `_hist_kernel_packed`);
  * `histogram_routed` launches csrc/histogram_routed.cu (replaces
    `_hist_routed_kernel`).

Both take the bin matrix feature-major, u8 `bins_t [F, n]` (the grower
keeps one such copy per training run), and return the accumulator type
of the stats: f32 for f32 and bf16 stats, int32 for int8 stats. The
bf16 fold and the int8 dequantize belong to the contract layer
(ops/histogram.py). Rows on the trash slot (slot >= num_slots) and bins
>= num_bins are dropped.

A CPU tensor runs the plain version (an `index_add_` over the fused
(slot, feature, bin) index, the analogue of the JAX package's
`_histogram_segment`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ydf_tpu_torch.utils import cuda_build

#: Launches of each CUDA kernel in this process (the wrappers add one per
#: launch; plain-version calls do not count).
LAUNCHES = {"histogram": 0, "histogram_routed": 0}
# The routed kernel's launch shape (`routed_launch_shape`,
# histogram_routed.cu): a block of ROUTED_THREADS threads routes a tile of
# as many rows, a warp for each of at most ROUTED_MAX_PAIRS (feature, hist
# slot) pairs adds them, and all its shared memory stays under
# ROUTED_SMEM_LIMIT bytes (the most a block may opt into on sm_90). Its
# 1024 threads may take all of an SM's registers: one block to an SM.
ROUTED_THREADS = 1024
ROUTED_TILE_ROWS = ROUTED_THREADS
ROUTED_MAX_PAIRS = ROUTED_THREADS // 32
ROUTED_SMEM_LIMIT = 232_448
# The root kernel's launch shape (`root_launch_shape`, histogram.cu): a
# block's sub-histogram (f64 cells for f32 stats, else 4-byte cells) and
# its one-byte tags take at most ROOT_SMEM_BUDGET bytes (its staged tile
# of 512 rows beside them keeps the block under 48 KB), a block has a
# warp per feature (at most 32), and the row chunks aim at ROOT_SM_WARPS
# resident warps on each of the card's SMS SMs.
ROOT_SMEM_BUDGET = 32 * 1024
ROOT_MAX_WARPS = 32
ROOT_SM_WARPS = 32
SMS = 132
TILE_ROWS = 512
ROWS_PER_LANE = 16
MAX_STAT_COLUMNS = 8
# Rows per step of the plain version (bounds its [rows, F, S] temporaries).
PLAIN_ROW_CHUNK = 1 << 16
_STATS_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class RouteTables(NamedTuple):
    """The previous layer's decisions, padded to L + 1 slots (slot L is
    the trash slot): the contract of the TPU kernel's tables."""

    do_split: torch.Tensor     # bool [L+1]
    route_f: torch.Tensor      # i32 [L+1] bins row the split reads
    go_left: torch.Tensor      # bool [L+1, B]
    left_id: torch.Tensor      # i32 [L+1]
    right_id: torch.Tensor     # i32 [L+1]
    split_rank: torch.Tensor   # i32 [L+1]
    hmap: torch.Tensor         # i32 [L+1] next hist slot of each new slot
    is_set: torch.Tensor       # bool [L+1]
    set_go_left: torch.Tensor  # u8 [n], or [1] without set features


def acc_dtype(stats: torch.Tensor) -> torch.dtype:
    return torch.int32 if stats.dtype == torch.int8 else torch.float32


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def routed_smem_bytes(Fb: int, Lb: int, B: int, Sq: int, L: int,
                      cell_bytes: int) -> int:
    """A routed block's shared memory as histogram_routed.cu lays it out:
    the pairs' cells (and one-byte tags for f64 cells), the tile's staged
    stats, list rows and bins, the tables (go_left as bits), each warp's
    count of each slot, the slot totals and list starts."""
    L1 = L + 1
    P = Fb * Lb
    cells = _align16(P * B * Sq * cell_bytes)
    tags = _align16(P * B) if cell_bytes == 8 else 0
    tile = (ROUTED_TILE_ROWS * Sq * 4 + ROUTED_TILE_ROWS * 2
            + _align16(Fb * ROUTED_TILE_ROWS))
    tables = _align16(L1 * 6 * 4 + L1 * (-(-B // 32)) * 4 + L1 * 2)
    return (cells + tags + tile + tables
            + (ROUTED_MAX_PAIRS * Lb + 2 * Lb + 1) * 4)


class RoutedShape(NamedTuple):
    """Launch shape of csrc/histogram_routed.cu: G feature groups (group g
    takes features [g*F//G, (g+1)*F//G), at most Fb), slot_blocks blocks
    of Lb hist slots, `chunks` row chunks of `rows` rows; a block's warp
    w < Fb * Lb owns the pair (feature w // Lb, slot w % Lb); `smem`
    bytes of shared memory a block."""

    G: int
    Fb: int
    Lb: int
    slot_blocks: int
    chunks: int
    rows: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.G * self.slot_blocks * self.chunks


def routed_launch_shape(n: int, F: int, Lh: int, B: int, Sq: int, L: int,
                        cell_bytes: int) -> RoutedShape:
    """Every hist slot in one block where the pairs allow (Lb = Lh up to
    32), then as many features as the pairs and the shared memory leave,
    in groups as even as F allows, so that a row is routed once per
    feature group; then row chunks until the grid holds one wave of
    blocks on the card's SMS SMs."""
    Lb = min(max(Lh, 1), ROUTED_MAX_PAIRS)
    Fb = min(F, ROUTED_MAX_PAIRS // Lb)

    def smem(fb, lb):
        return routed_smem_bytes(fb, lb, B, Sq, L, cell_bytes)

    while Fb > 1 and smem(Fb, Lb) > ROUTED_SMEM_LIMIT:
        Fb -= 1
    while Lb > 1 and smem(Fb, Lb) > ROUTED_SMEM_LIMIT:
        Lb -= 1
    G0 = -(-F // Fb)
    G = next((g for g in range(G0, 2 * G0 + 1) if F % g == 0), G0)
    Fb = -(-F // G)
    slot_blocks = -(-Lh // Lb) if Lh > 0 else 1
    wave = SMS // (G * slot_blocks)
    chunks = max(1, min(-(-n // ROUTED_TILE_ROWS), wave))
    rows = -(-max(-(-n // chunks), 1) // ROWS_PER_LANE) * ROWS_PER_LANE
    return RoutedShape(G, Fb, Lb, slot_blocks, max(1, -(-n // rows)), rows,
                       smem(Fb, Lb))


class RootShape(NamedTuple):
    """Launch shape of csrc/histogram.cu: G feature groups (group g takes
    features [g*F//G, (g+1)*F//G), at most Fb of them, one warp each),
    slot_blocks blocks of at most Lb slots, `chunks` row chunks of `rows`
    rows."""

    G: int
    Fb: int
    Lb: int
    slot_blocks: int
    chunks: int
    rows: int

    @property
    def blocks(self) -> int:
        return self.G * self.slot_blocks * self.chunks


def cell_stride(Sq: int) -> int:
    """Words a histogram cell takes in histogram.cu: three stats are
    padded to four (a 16-byte cell)."""
    return 4 if Sq == 3 else Sq


def root_cell_bytes(stats: torch.Tensor) -> int:
    """Bytes of a cell word in histogram.cu: f64 for f32 stats (summed
    exactly enough to round once), else 4."""
    return 8 if stats.dtype == torch.float32 else 4


def root_launch_shape(n: int, F: int, L: int, B: int, Sq: int,
                      cell_bytes: int = 4) -> RootShape:
    """Feature groups as even as F allows (a divisor of F when one is
    near), so that no block carries more features than another; slot
    blocks filling what the budget leaves; then row chunks (multiples of
    16 rows, at least one 512-row tile) until the grid holds about
    ROOT_SM_WARPS warps for each SM. `cell_bytes`: root_cell_bytes of
    the stats."""
    L = max(L, 1)
    # (slot, feature) sub-histograms: B cells and a one-byte tag each.
    pairs = max(1, ROOT_SMEM_BUDGET
                // (B * (cell_stride(Sq) * cell_bytes + 1)))
    Lb = min(L, pairs)
    Fb = min(F, max(1, pairs // Lb), ROOT_MAX_WARPS)
    G0 = -(-F // Fb)
    G = next((g for g in range(G0, 2 * G0 + 1) if F % g == 0), G0)
    Fb = -(-F // G)
    Lb = min(L, max(1, pairs // Fb))
    slot_blocks = -(-L // Lb)
    want = -(-SMS * ROOT_SM_WARPS // Fb)
    chunks = max(1, min(-(-n // TILE_ROWS), -(-want // (G * slot_blocks))))
    rows = -(-max(-(-n // chunks), 1) // ROWS_PER_LANE) * ROWS_PER_LANE
    return RootShape(G, Fb, Lb, slot_blocks, max(1, -(-n // rows)), rows)


def _check(bins_t, slot, stats, num_bins):
    if bins_t.dtype != torch.uint8 or bins_t.dim() != 2:
        raise ValueError(
            f"bins_t must be uint8 [F, n], got {bins_t.dtype} "
            f"{tuple(bins_t.shape)}"
        )
    n = bins_t.shape[1]
    if slot.dtype != torch.int32 or tuple(slot.shape) != (n,):
        raise ValueError(
            f"slot must be int32 [{n}], got {slot.dtype} {tuple(slot.shape)}"
        )
    if stats.dtype not in _STATS_KIND or stats.dim() != 2 or (
        stats.shape[0] != n
    ):
        raise ValueError(
            f"stats must be f32/bf16/int8 [{n}, S], got {stats.dtype} "
            f"{tuple(stats.shape)}"
        )
    if stats.shape[1] > MAX_STAT_COLUMNS:
        raise ValueError(
            f"at most {MAX_STAT_COLUMNS} stat columns, got {stats.shape[1]}"
        )
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in [1, 256], got {num_bins}")


def _check_card(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def histogram_plain(bins_t: torch.Tensor, slot: torch.Tensor,
                    stats: torch.Tensor, num_slots: int,
                    num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of csrc/histogram.cu: accumulator
    [L, F, B, Sq]. Float stats sum in f64 and round once to f32, so the
    plain version is the near-exact reference the kernel's f32 sums are
    held against; int8 stats sum exactly in int32."""
    _check(bins_t, slot, stats, num_bins)
    F, n = bins_t.shape
    L, B, Sq = num_slots, num_bins, stats.shape[1]
    dev = bins_t.device
    acc = stats.to(torch.int32 if stats.dtype == torch.int8
                   else torch.float64)
    out = torch.zeros(((L + 1) * F * B, Sq), dtype=acc.dtype, device=dev)
    live = (slot >= 0) & (slot < L)
    s = torch.where(live, slot, L).long()
    fidx = torch.arange(F, device=dev)[None, :]
    for r0 in range(0, n, PLAIN_ROW_CHUNK):
        b = bins_t[:, r0:r0 + PLAIN_ROW_CHUNK].t().long()  # [m, F]
        sc = s[r0:r0 + b.shape[0], None]
        idx = (sc * F + fidx) * B + b.clamp(max=B - 1)
        # Bins past the range are dropped like trash rows.
        idx = torch.where(b < B, idx, L * F * B)
        data = acc[r0:r0 + b.shape[0], None, :].expand(-1, F, Sq)
        out.index_add_(0, idx.reshape(-1), data.reshape(-1, Sq))
    return out.view(L + 1, F, B, Sq)[:L].to(acc_dtype(stats))


def histogram(bins_t: torch.Tensor, slot: torch.Tensor, stats: torch.Tensor,
              num_slots: int, num_bins: int) -> torch.Tensor:
    """Layer histogram accumulator [num_slots, F, num_bins, Sq] of
    bins_t u8 [F, n], slot i32 [n], stats f32/bf16/int8 [n, Sq]."""
    if bins_t.device.type == "cpu":
        return histogram_plain(bins_t, slot, stats, num_slots, num_bins)
    _check(bins_t, slot, stats, num_bins)
    _check_card(bins_t, slot, stats)
    F, n = bins_t.shape
    L, B, Sq = num_slots, num_bins, stats.shape[1]
    dev = bins_t.device
    if n == 0 or F == 0 or L == 0:
        return torch.zeros((L, F, B, Sq), dtype=acc_dtype(stats), device=dev)
    # The reduce pass writes every cell: no zero fill.
    out = torch.empty((L, F, B, Sq), dtype=acc_dtype(stats), device=dev)
    cell_bytes = root_cell_bytes(stats)
    shape = root_launch_shape(n, F, L, B, Sq, cell_bytes)
    partial = torch.empty(
        shape.chunks * out.numel(),
        dtype=torch.float64 if cell_bytes == 8 else out.dtype, device=dev)
    fn = cuda_build.entry_point("histogram", "ydf_histogram", 5, 11)
    with cuda_build.on_device(dev):
        timer = cuda_build.launch_timer("histogram")
        status = fn(
            bins_t.data_ptr(), slot.data_ptr(), stats.data_ptr(),
            partial.data_ptr(), out.data_ptr(), n, F, B, Sq, L,
            _STATS_KIND[stats.dtype], shape.G, shape.Fb, shape.Lb,
            shape.chunks, shape.rows, torch.cuda.current_stream().cuda_stream,
        )
        cuda_build.launch_done(timer)
    cuda_build.check_status(status, "histogram kernel")
    LAUNCHES["histogram"] += 1
    return out


def route_plain(bins_t: torch.Tensor, slot: torch.Tensor,
                leaf_id: torch.Tensor, tables: RouteTables
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One routing step of the previous layer's tables: (new_slot,
    new_leaf, hist_slot) i32 [n] — the JAX package's XLA routing chain
    (ydf_tpu/ops/grower.py:983-1010) on the padded [L+1] contract."""
    F, n = bins_t.shape
    L = tables.do_split.shape[0] - 1
    B = tables.go_left.shape[1]
    s = torch.where((slot >= 0) & (slot <= L), slot, L).long()
    split_e = tables.do_split[s]
    rf_e = tables.route_f.long().clamp(0, max(F - 1, 0))[s]
    bin_e = torch.gather(bins_t, 0, rf_e[None, :])[0].long()
    glb = tables.go_left.reshape(-1)
    go_left_e = (bin_e < B) & glb[s * B + bin_e.clamp(max=B - 1)]
    if tables.set_go_left.shape[0] == n:
        set_gl = tables.set_go_left != 0
    else:
        set_gl = torch.zeros(n, dtype=torch.bool, device=bins_t.device)
    go_left_e = torch.where(tables.is_set[s], set_gl, go_left_e)
    child = torch.where(go_left_e, tables.left_id[s], tables.right_id[s])
    new_leaf = torch.where(split_e, child, leaf_id)
    sr2 = 2 * tables.split_rank[s]
    new_slot = torch.where(split_e, torch.where(go_left_e, sr2, sr2 + 1), L)
    # Clamped as the TPU wrapper composes hmap (histogram_pallas.py:348):
    # at the last layer 2 * split_rank may pass L.
    hist_slot = tables.hmap[new_slot.long().clamp(0, L)]
    return new_slot.to(torch.int32), new_leaf.to(torch.int32), hist_slot


def histogram_routed_plain(bins_t, slot, leaf_id, tables: RouteTables,
                           stats, num_slots: int, num_bins: int):
    """Plain PyTorch version of csrc/histogram_routed.cu: (accumulator
    [num_slots, F, B, Sq], new_slot i32 [n], new_leaf i32 [n])."""
    new_slot, new_leaf, hist_slot = route_plain(bins_t, slot, leaf_id,
                                                tables)
    hist = histogram_plain(bins_t, hist_slot.to(torch.int32), stats,
                           num_slots, num_bins)
    return hist, new_slot, new_leaf


def _check_tables(tables: RouteTables, n: int, num_bins: int):
    L1 = tables.do_split.shape[0]
    want = {
        "do_split": (torch.bool, (L1,)), "route_f": (torch.int32, (L1,)),
        "go_left": (torch.bool, (L1, num_bins)),
        "left_id": (torch.int32, (L1,)), "right_id": (torch.int32, (L1,)),
        "split_rank": (torch.int32, (L1,)), "hmap": (torch.int32, (L1,)),
        "is_set": (torch.bool, (L1,)),
    }
    for name, (dtype, shape) in want.items():
        t = getattr(tables, name)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    sg = tables.set_go_left
    if sg.dtype != torch.uint8 or sg.dim() != 1 or sg.shape[0] not in (1, n):
        raise ValueError(
            f"set_go_left must be uint8 [{n}] or [1], got {sg.dtype} "
            f"{tuple(sg.shape)}"
        )


def histogram_routed(bins_t: torch.Tensor, slot: torch.Tensor,
                     leaf_id: torch.Tensor, tables: RouteTables,
                     stats: torch.Tensor, num_slots: int, num_bins: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused routing + histogram: (accumulator [num_slots, F, B, Sq],
    new_slot i32 [n], new_leaf i32 [n])."""
    n = bins_t.shape[1]
    _check(bins_t, slot, stats, num_bins)
    _check_tables(tables, n, num_bins)
    if leaf_id.dtype != torch.int32 or tuple(leaf_id.shape) != (n,):
        raise ValueError(f"leaf_id must be int32 [{n}]")
    if bins_t.device.type == "cpu":
        return histogram_routed_plain(bins_t, slot, leaf_id, tables, stats,
                                      num_slots, num_bins)
    _check_card(bins_t, slot, leaf_id, stats, *tables)
    F = bins_t.shape[0]
    L = tables.do_split.shape[0] - 1
    Lh, B, Sq = num_slots, num_bins, stats.shape[1]
    dev = bins_t.device
    new_slot = torch.empty(n, dtype=torch.int32, device=dev)
    new_leaf = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0 or F == 0:
        out = torch.zeros((Lh, F, B, Sq), dtype=acc_dtype(stats), device=dev)
        return out, new_slot, new_leaf
    # The reduce pass writes every cell: no zero fill.
    out = torch.empty((Lh, F, B, Sq), dtype=acc_dtype(stats), device=dev)
    # Float stats sum in f64 cells and partials (histogram_routed.cu).
    sum_dtype = torch.int32 if stats.dtype == torch.int8 else torch.float64
    shape = routed_launch_shape(n, F, Lh, B, Sq, L,
                                8 if sum_dtype == torch.float64 else 4)
    partial = torch.empty(shape.chunks * max(out.numel(), 1),
                          dtype=sum_dtype, device=dev)
    set_gl = tables.set_go_left if tables.set_go_left.shape[0] == n else None
    fn = cuda_build.entry_point("histogram_routed", "ydf_histogram_routed",
                                17, 12)
    with cuda_build.on_device(dev):
        # Named by hist slots, so that a path's time splits by layer.
        timer = cuda_build.launch_timer(f"histogram_routed/Lh={Lh}")
        status = fn(
            bins_t.data_ptr(), slot.data_ptr(), leaf_id.data_ptr(),
            tables.do_split.data_ptr(), tables.route_f.data_ptr(),
            tables.go_left.data_ptr(), tables.left_id.data_ptr(),
            tables.right_id.data_ptr(), tables.split_rank.data_ptr(),
            tables.hmap.data_ptr(), tables.is_set.data_ptr(),
            None if set_gl is None else set_gl.data_ptr(),
            stats.data_ptr(), partial.data_ptr(), out.data_ptr(),
            new_slot.data_ptr(), new_leaf.data_ptr(),
            n, F, B, Sq, L, Lh, _STATS_KIND[stats.dtype], shape.G, shape.Fb,
            shape.Lb, shape.chunks, shape.rows,
            torch.cuda.current_stream().cuda_stream,
        )
        cuda_build.launch_done(timer)
    cuda_build.check_status(status, "routed histogram kernel")
    LAUNCHES["histogram_routed"] += 1
    return out, new_slot, new_leaf

