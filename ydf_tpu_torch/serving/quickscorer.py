"""QuickScorer leaf-bitmask serving engine: host compile, CUDA kernel
wrapper and plain PyTorch version (counterpart of
ydf_tpu/serving/quickscorer.py).

Trees with <= 64 leaves compile to per-condition survivor bitmasks.
Scoring one example of one tree is then

    live = ~0
    for each condition (feature f, threshold thr, mask m) of the tree:
        if x[f] >= thr (or a categorical bitmap miss): live &= m
    exit leaf = lowest set bit of live   (leaves in left-to-right order)

and leaf values are summed in tree order, one f32 add per tree — the
order of the generic routed engine, so the scores are bit-identical.

The kernel (csrc/quickscorer.cu) replaces the TPU kernel
ydf_tpu/serving/quickscorer.py:_qs_kernel. It serves both engines: the
float one (QuickScorerEngine, raw values) and the 8-bit one
(BinnedQuickScorerEngine, the binner's bin ids with each threshold
replaced by its bin cut, in the same packed tables). It takes the input
feature-major, xT f32 [F, n], as the TPU engine does, and the model as
`pack_tables` lays it out: numerical conditions as 16-byte records and
categorical ones folded into one mask table for each (tree, feature), in
tree blocks that the kernel stages into shared memory. The plain version
reads the same packed tables.
"""

from __future__ import annotations

import sys
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ydf_tpu_torch.utils import cuda_build

MAX_LEAVES = 64
# Rows per step of the plain version (bounds its [T, rows] temporaries).
PLAIN_ROW_CHUNK = 1 << 17

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; plain-version calls do not count).
KERNEL_LAUNCHES = 0
#: Rows those launches scored (a path's launches weighted by their rows).
KERNEL_ROWS = 0


class QuickScorerModel(NamedTuple):
    """Host-compiled model (numpy): conditions sorted by tree, leaves in
    left-to-right order. Same fields as the JAX package's."""

    cond_feature: np.ndarray  # i32 [C] row of the feature in xT
    cond_thresh: np.ndarray   # f32 [C]
    cond_mask_lo: np.ndarray  # u32 [C] survivor bits 0..31 when triggered
    cond_mask_hi: np.ndarray  # u32 [C] survivor bits 32..63
    cond_tree: np.ndarray     # i32 [C] tree index
    cond_is_cat: np.ndarray   # i32 [C] 1 = categorical contains-condition
    cond_bitmap: np.ndarray   # u32 [C, W] go-LEFT category bitmap (W=0:
                              # no categorical condition)
    leaf_values: np.ndarray   # f32 [T, 64]
    num_trees: int


class _Unsupported(Exception):
    pass


def compile_forest(forest, num_numerical: int,
                   num_features: Optional[int] = None
                   ) -> Optional[QuickScorerModel]:
    """Forest → QuickScorerModel, or None if any tree is outside the
    envelope (more than 64 leaves, set / vector-sequence / oblique
    condition, multi-output leaves)."""
    f = forest.to_numpy()
    if f["oblique_weights"].size > 0 or f["leaf_value"].shape[-1] != 1:
        return None
    if f["vs_anchor"].size > 0:
        return None
    if f["is_set"][~f["is_leaf"]].any():
        return None
    T = f["feature"].shape[0]
    W = int(f["cat_mask"].shape[-1])

    cond_feature, cond_thresh = [], []
    cond_lo, cond_hi, cond_tree = [], [], []
    cond_is_cat, cond_bitmap = [], []
    leaf_values = np.zeros((T, MAX_LEAVES), np.float32)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        _compile_trees(
            f, T, cond_feature, cond_thresh, cond_lo, cond_hi, cond_tree,
            leaf_values, num_features or num_numerical,
            cond_is_cat, cond_bitmap, W,
        )
    except _Unsupported:
        return None
    finally:
        sys.setrecursionlimit(old_limit)

    return QuickScorerModel(
        cond_feature=np.asarray(cond_feature, np.int32),
        cond_thresh=np.asarray(cond_thresh, np.float32),
        cond_mask_lo=np.asarray(cond_lo, np.uint32),
        cond_mask_hi=np.asarray(cond_hi, np.uint32),
        cond_tree=np.asarray(cond_tree, np.int32),
        cond_is_cat=np.asarray(cond_is_cat, np.int32),
        cond_bitmap=(
            np.asarray(cond_bitmap, np.uint32).reshape(-1, W)
            if any(cond_is_cat)
            else np.zeros((len(cond_feature), 0), np.uint32)
        ),
        leaf_values=leaf_values,
        num_trees=T,
    )


def _compile_trees(f, T, cond_feature, cond_thresh, cond_lo, cond_hi,
                   cond_tree, leaf_values, num_features,
                   cond_is_cat, cond_bitmap, W):
    for t in range(T):
        # In-order leaf numbering + left-subtree leaf range of every
        # internal node (left child first: the left-to-right order the
        # lowest-set-bit exit needs).
        n_leaves = 0
        conds = []  # (feature, thresh, is_cat, bitmap, leaf_lo, leaf_hi)

        def visit(nid: int) -> tuple:
            nonlocal n_leaves
            if f["is_leaf"][t, nid]:
                idx = n_leaves
                n_leaves += 1
                if idx < MAX_LEAVES:  # over-budget trees are rejected below
                    leaf_values[t, idx] = f["leaf_value"][t, nid, 0]
                return idx, idx + 1
            llo, lhi = visit(int(f["left"][t, nid]))
            rlo, rhi = visit(int(f["right"][t, nid]))
            conds.append((
                int(f["feature"][t, nid]),
                float(f["threshold"][t, nid]),
                bool(f["is_cat"][t, nid]),
                f["cat_mask"][t, nid],
                llo,
                lhi,
            ))
            return llo, rhi

        visit(0)
        if n_leaves > MAX_LEAVES:
            raise _Unsupported
        for feat, thr, is_cat, bitmap, lo, hi in conds:
            if feat >= num_features:
                raise _Unsupported
            full = (1 << 64) - 1
            left_bits = ((1 << hi) - 1) ^ ((1 << lo) - 1)
            mask = full ^ left_bits  # survivors when the condition triggers
            cond_feature.append(feat)
            cond_thresh.append(thr)
            cond_lo.append(mask & 0xFFFFFFFF)
            cond_hi.append(mask >> 32)
            cond_tree.append(t)
            cond_is_cat.append(int(is_cat))
            cond_bitmap.append(
                np.asarray(bitmap, np.uint32)
                if is_cat
                else np.zeros((W,), np.uint32)
            )


# compile_forest walks every tree on the host; the registry's
# compatibility check and the engine build share one compile per forest.
# Keyed by forest identity, holding only weak references to its tensors.
_COMPILE_CACHE: dict = {}
_COMPILE_CACHE_CAP = 8


def compile_forest_cached(forest, num_numerical: int,
                          num_features: Optional[int] = None
                          ) -> Optional[QuickScorerModel]:
    key = (id(forest.feature), num_numerical, num_features)
    hit = _COMPILE_CACHE.get(key)
    if hit is not None and all(r() is a for r, a in zip(hit[0], forest)):
        return hit[1]
    qsm = compile_forest(forest, num_numerical, num_features=num_features)
    if len(_COMPILE_CACHE) >= _COMPILE_CACHE_CAP:
        _COMPILE_CACHE.pop(next(iter(_COMPILE_CACHE)))
    _COMPILE_CACHE[key] = (tuple(weakref.ref(a) for a in forest), qsm)
    return qsm


# --------------------------------------------------------------------- #
# Packed tables, launch shape, kernel wrapper, plain version
# --------------------------------------------------------------------- #

# A tree block (the records, leaf values and categorical mask tables the
# kernel stages into shared memory at once) takes at most this many bytes,
# unless one tree alone takes more.
TREE_BLOCK_BYTES = 20 * 1024
# The kernel's shared memory a block may take (csrc/quickscorer.cu
# kSmemLimit: two blocks on an SM), its threads, and the examples each
# thread scores (its K).
SMEM_LIMIT = 113 * 1024
MAX_THREADS = 256
EXAMPLES_PER_THREAD = 2
_REC_BYTES = 16


class PackedQuickScorer(NamedTuple):
    """A QuickScorerModel as the kernel reads it (numpy).

    Each tree's numerical conditions are 16-byte records (feature,
    threshold bits, mask lo, mask hi), sorted by feature. Its categorical
    conditions are folded, one group for each feature they test, into a
    mask table: entry v of the group is the AND of the masks of the
    group's conditions that code v triggers (entry 32 W: a code outside
    the bitmaps, which triggers them all). The AND of a tree's masks does
    not depend on their order or grouping, so the live mask, and the
    score, are those of the conditions one by one. A group is a 16-byte
    record too (feature, its table's first entry in the tree block, 0,
    0), after the tree's numerical records. Trees are grouped into tree
    blocks of at most `block_bytes`."""

    rec: np.ndarray         # u32 [R, 4]
    tree_off: np.ndarray    # i32 [T+1] tree t owns rec[off[t]:off[t+1]]
    num_end: np.ndarray     # i32 [T] end of tree t's numerical records
    block_tree: np.ndarray  # i32 [NB+1] first tree of each tree block
    block_mask: np.ndarray  # i32 [NB+1] first mask entry of each block
    masks: np.ndarray       # u32 [M, 2] (lo, hi) entries of the tables
    leaf_values: np.ndarray  # f32 [T, 64]
    codes: int              # 32 W: a table has codes + 1 entries
    cat_from: int           # first feature row a group reads
    buf_bytes: int          # bytes of the largest tree block


def _tree_bytes(records, groups, codes):
    """Bytes a tree takes in a tree block: its records, its leaf values,
    its groups' mask tables."""
    return records * _REC_BYTES + MAX_LEAVES * 4 + groups * (codes + 1) * 8


def fits_shared_memory(qsm: QuickScorerModel) -> bool:
    """Whether the kernel can stage the model's tree blocks, twice
    (double-buffered), in its shared memory: a block is at most
    TREE_BLOCK_BYTES or one tree, and a tree testing many categorical
    features of large vocabularies may not fit (such a model serves
    through the bank kernel)."""
    T = qsm.num_trees
    W = int(qsm.cond_bitmap.shape[1])
    cat = (qsm.cond_is_cat == 1) & (W > 0)
    pairs = np.unique(qsm.cond_tree[cat].astype(np.int64) * (1 << 32)
                      + qsm.cond_feature[cat])
    groups = np.bincount(pairs >> 32, minlength=T)
    records = np.bincount(qsm.cond_tree[~cat], minlength=T) + groups
    biggest = int(_tree_bytes(records, groups, 32 * W).max()) if T else 0
    return 2 * (-(-max(biggest, TREE_BLOCK_BYTES) // 16) * 16) <= SMEM_LIMIT


def pack_tables(qsm: QuickScorerModel,
                block_bytes: int = TREE_BLOCK_BYTES) -> PackedQuickScorer:
    T = qsm.num_trees
    tree = qsm.cond_tree
    C = tree.size
    if C and np.any(np.diff(tree) < 0):
        raise ValueError("QuickScorer conditions must be sorted by tree")
    W = int(qsm.cond_bitmap.shape[1])
    codes = 32 * W
    feature = qsm.cond_feature
    mask = (qsm.cond_mask_hi.astype(np.uint64) << np.uint64(32)) \
        | qsm.cond_mask_lo.astype(np.uint64)
    is_cat = (qsm.cond_is_cat == 1) if W > 0 else np.zeros(C, bool)

    # Numerical records, by tree then feature.
    num = np.flatnonzero(~is_cat)
    num = num[np.lexsort((num, feature[num], tree[num]))]
    # Categorical groups: one per (tree, feature), by tree then feature.
    cat = np.flatnonzero(is_cat)
    cat = cat[np.lexsort((cat, feature[cat], tree[cat]))]
    key = tree[cat].astype(np.int64) * (1 << 32) + feature[cat]
    first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if cat.size \
        else np.zeros(0, np.int64)
    g_tree = tree[cat[first]]
    g_feature = feature[cat[first]]
    tables = np.zeros((first.size, codes + 1), np.uint64)
    if cat.size:
        # Code v (bit v % 32 of word v // 32) triggers a condition when the
        # bit is clear; the last entry stands for every code outside.
        bits = np.unpackbits(
            np.ascontiguousarray(qsm.cond_bitmap[cat]).view(np.uint8),
            axis=1, bitorder="little").astype(bool)
        trig = np.concatenate([~bits, np.ones((cat.size, 1), bool)], axis=1)
        contrib = np.where(trig, mask[cat][:, None], ~np.uint64(0))
        tables = np.bitwise_and.reduceat(contrib, first, axis=0)

    n_num = np.bincount(tree[num], minlength=T)
    n_grp = np.bincount(g_tree, minlength=T)
    tree_off = np.zeros(T + 1, np.int64)
    np.cumsum(n_num + n_grp, out=tree_off[1:])
    num_end = tree_off[:-1] + n_num

    # Greedy tree blocks: a tree joins the open block while it fits.
    tree_bytes = _tree_bytes(n_num + n_grp, n_grp, codes)
    block_tree, used = [0], 0
    for t in range(T):
        if used and used + tree_bytes[t] > block_bytes:
            block_tree.append(t)
            used = 0
        used += int(tree_bytes[t])
    block_tree.append(T)
    block_tree = np.asarray(block_tree, np.int64)
    grp_off = np.zeros(T + 1, np.int64)
    np.cumsum(n_grp, out=grp_off[1:])
    block_mask = grp_off[block_tree] * (codes + 1)

    rec = np.zeros((int(tree_off[-1]), 4), np.uint32)
    # Each tree's records: its numerical ones, then its groups.
    num_pos = tree_off[tree[num]] + (
        np.arange(num.size) - np.repeat(np.cumsum(n_num) - n_num, n_num))
    rec[num_pos, 0] = feature[num]
    rec[num_pos, 1] = qsm.cond_thresh[num].view(np.uint32)
    rec[num_pos, 2] = qsm.cond_mask_lo[num]
    rec[num_pos, 3] = qsm.cond_mask_hi[num]
    g = np.arange(first.size)
    grp_pos = num_end[g_tree] + (g - grp_off[g_tree])
    block_of = np.repeat(np.arange(len(block_tree) - 1),
                         np.diff(block_tree))
    rec[grp_pos, 0] = g_feature
    rec[grp_pos, 1] = g * (codes + 1) - block_mask[block_of[g_tree]]
    cat_from = int(g_feature.min()) if g.size else 2**31 - 1
    if (feature[num] >= cat_from).any():
        raise ValueError("a numerical condition reads a categorical row")
    return PackedQuickScorer(
        rec=rec,
        tree_off=tree_off.astype(np.int32),
        num_end=num_end.astype(np.int32),
        block_tree=block_tree.astype(np.int32),
        block_mask=block_mask.astype(np.int32),
        masks=np.ascontiguousarray(tables.reshape(-1)).view(
            np.uint32).reshape(-1, 2),
        leaf_values=qsm.leaf_values,
        codes=codes,
        cat_from=cat_from,
        buf_bytes=-(-int(np.add.reduceat(tree_bytes, block_tree[:-1]).max())
                    // 16) * 16 if T else 0,
    )


class QuickScorerTables(NamedTuple):
    """PackedQuickScorer as tensors on one device. 32-bit unsigned words
    are held as int32 bit patterns."""

    rec: torch.Tensor         # i32 [R, 4]
    tree_off: torch.Tensor    # i32 [T+1]
    num_end: torch.Tensor     # i32 [T]
    block_tree: torch.Tensor  # i32 [NB+1]
    block_mask: torch.Tensor  # i32 [NB+1]
    masks: torch.Tensor       # i32 [M, 2]
    leaf_values: torch.Tensor  # f32 [T, 64]
    num_features: int         # rows of xT the conditions read
    codes: int
    cat_from: int
    buf_bytes: int


def make_tables(qsm: QuickScorerModel, device,
                block_bytes: int = TREE_BLOCK_BYTES) -> QuickScorerTables:
    p = pack_tables(qsm, block_bytes)

    def t(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(device)

    return QuickScorerTables(
        rec=t(p.rec), tree_off=t(p.tree_off), num_end=t(p.num_end),
        block_tree=t(p.block_tree), block_mask=t(p.block_mask),
        masks=t(p.masks), leaf_values=t(p.leaf_values),
        num_features=(int(qsm.cond_feature.max()) + 1
                      if qsm.cond_feature.size else 0),
        codes=p.codes, cat_from=p.cat_from, buf_bytes=p.buf_bytes,
    )


class LaunchShape(NamedTuple):
    threads: int   # a block's threads
    tile: bool     # the examples' rows staged in shared memory
    smem: int      # a block's shared memory, bytes

    @property
    def examples(self) -> int:
        return self.threads * EXAMPLES_PER_THREAD


def launch_shape(tables: QuickScorerTables) -> LaunchShape:
    """The widest block (MAX_THREADS threads down to 32) whose tile of
    num_features rows x threads * EXAMPLES_PER_THREAD examples fits
    SMEM_LIMIT beside the two tree-block buffers; with no such block, the
    rows are read from global memory. Raises when a tree block alone does
    not fit."""
    buffers = 2 * tables.buf_bytes
    if buffers > SMEM_LIMIT:
        raise ValueError(
            f"a QuickScorer tree block needs {buffers} bytes of shared "
            f"memory (limit {SMEM_LIMIT})")
    threads = MAX_THREADS
    while threads >= 32:
        tile = tables.num_features * threads * EXAMPLES_PER_THREAD * 4
        if buffers + tile <= SMEM_LIMIT:
            return LaunchShape(threads, True, buffers + tile)
        threads //= 2
    return LaunchShape(MAX_THREADS, False, buffers)


def _check_input(tables: QuickScorerTables, xT: torch.Tensor) -> None:
    if xT.dtype != torch.float32 or xT.dim() != 2:
        raise ValueError(
            f"xT must be float32 [F, n], got {xT.dtype} {tuple(xT.shape)}"
        )
    if xT.shape[0] < tables.num_features:
        raise ValueError(
            f"model reads feature row {tables.num_features - 1} but xT has "
            f"{xT.shape[0]} rows — pass the categorical columns too"
        )
    if xT.device != tables.leaf_values.device:
        raise ValueError(
            f"xT is on {xT.device}, the model on {tables.leaf_values.device}"
        )


def _ctz32(v: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of 32-bit values held in int64 (-1 for 0)."""
    lsb = (v & -v).double()
    return torch.frexp(lsb).exponent.long() - 1


def score_plain(tables: QuickScorerTables, xT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel over the same packed tables:
    f32 [n]. Records run slot by slot across all trees at once (slot j =
    the j-th numerical record, then the j-th group, of each tree); the
    32-bit mask halves are held in int64."""
    _check_input(tables, xT)
    n = xT.shape[1]
    dev = xT.device
    off = tables.tree_off.long()
    num_end = tables.num_end.long()
    T = off.numel() - 1
    n_num = num_end - off[:-1]
    n_grp = off[1:] - num_end
    R = tables.rec.shape[0]
    u32 = 0xFFFFFFFF
    rec = tables.rec.long() & u32
    thresh = tables.rec[:, 1].contiguous().view(torch.float32)
    mask_lo = tables.masks[:, 0].long() & u32
    mask_hi = tables.masks[:, 1].long() & u32
    # Each tree's first mask entry (its tree block's).
    nb = tables.block_tree.long().diff()
    mask_base = torch.repeat_interleave(tables.block_mask[:-1].long(), nb)
    # Leaf 64 (no survivor) reads 0, as the TPU kernel's empty one-hot.
    values = torch.cat(
        [tables.leaf_values, torch.zeros(T, 1, device=dev)], dim=1
    )
    tree_ids = torch.arange(T, device=dev)[:, None]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    num_max = int(n_num.max()) if T and R else 0
    grp_max = int(n_grp.max()) if T and R else 0
    for r0 in range(0, n, PLAIN_ROW_CHUNK):
        x = xT[:, r0:r0 + PLAIN_ROW_CHUNK]
        m = x.shape[1]
        live_lo = torch.full((T, m), u32, dtype=torch.long, device=dev)
        live_hi = torch.full((T, m), u32, dtype=torch.long, device=dev)
        for j in range(num_max):
            c = (off[:-1] + j).clamp(max=R - 1)       # [T]
            v = x[rec[c, 0]]                          # [T, m]
            trig = (v >= thresh[c][:, None]) & (j < n_num)[:, None]
            live_lo = torch.where(trig, live_lo & rec[c, 2][:, None],
                                  live_lo)
            live_hi = torch.where(trig, live_hi & rec[c, 3][:, None],
                                  live_hi)
        for j in range(grp_max):
            valid = j < n_grp                          # [T]
            c = (num_end + j).clamp(max=R - 1)
            code = x[rec[c, 0].clamp(max=x.shape[0] - 1)].to(torch.int32)
            idx = torch.where((code >= 0) & (code < tables.codes), code,
                              tables.codes).long()
            entry = torch.where(valid, mask_base + rec[c, 1], 0)[:, None]
            live_lo = torch.where(valid[:, None],
                                  live_lo & mask_lo[entry + idx], live_lo)
            live_hi = torch.where(valid[:, None],
                                  live_hi & mask_hi[entry + idx], live_hi)
        leaf = torch.where(
            live_lo != 0, _ctz32(live_lo),
            torch.where(live_hi != 0, 32 + _ctz32(live_hi), MAX_LEAVES),
        )
        vals = values[tree_ids, leaf]                 # [T, m]
        acc = torch.zeros(m, dtype=torch.float32, device=dev)
        for t in range(T):
            acc = acc + vals[t]
        out[r0:r0 + m] = acc
    return out


def score(tables: QuickScorerTables, xT: torch.Tensor) -> torch.Tensor:
    """Raw scores f32 [n] of xT f32 [F, n] (contiguous). A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel."""
    global KERNEL_LAUNCHES, KERNEL_ROWS
    if xT.device.type == "cpu":
        return score_plain(tables, xT)
    if xT.device.type != "cuda":
        raise ValueError(f"unsupported device {xT.device}")
    _check_input(tables, xT)
    if not xT.is_contiguous():
        raise ValueError("xT must be contiguous")
    n = xT.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=xT.device)
    if n == 0:
        return out
    shape = launch_shape(tables)
    fn = cuda_build.entry_point("quickscorer", "ydf_qs_score", 9, 8)
    with cuda_build.on_device(xT.device):
        timer = cuda_build.launch_timer(f"quickscorer/rows={n}")
        status = fn(
            xT.data_ptr(), tables.rec.data_ptr(), tables.tree_off.data_ptr(),
            tables.num_end.data_ptr(), tables.block_tree.data_ptr(),
            tables.block_mask.data_ptr(), tables.masks.data_ptr(),
            tables.leaf_values.data_ptr(), out.data_ptr(), n,
            tables.num_features, tables.block_tree.numel() - 1,
            tables.codes, tables.cat_from, tables.buf_bytes, shape.threads,
            int(shape.tile), torch.cuda.current_stream().cuda_stream,
        )
        cuda_build.launch_done(timer)
    cuda_build.check_status(status, "QuickScorer kernel")
    KERNEL_LAUNCHES += 1
    KERNEL_ROWS += n
    return out


# --------------------------------------------------------------------- #
# Engine
# --------------------------------------------------------------------- #


def feature_major(x_num: torch.Tensor, x_cat: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """(x_num f32 [n, Fn], x_cat i32 [n, Fc]) → xT f32 [Fn+Fc, n].
    Category codes ride the float rows (exact below 2^24)."""
    parts = [x_num.t().to(torch.float32)]
    if x_cat is not None and x_cat.shape[1] > 0:
        parts.append(x_cat.t().to(torch.float32))
    return torch.cat(parts, dim=0).contiguous()


class QuickScorerEngine:
    """Callable engine: (x_num f32 [n, Fn], x_cat i32 [n, Fc]) on the
    model's device → raw scores f32 [n]."""

    def __init__(self, qsm: QuickScorerModel, device):
        self.qsm = qsm
        self.tables = make_tables(qsm, device)

    def __call__(self, x_num: torch.Tensor,
                 x_cat: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.score_xT(feature_major(x_num, x_cat))

    def score_xT(self, xT: torch.Tensor) -> torch.Tensor:
        """Raw scores of an already feature-major input xT f32 [F, n]."""
        return score(self.tables, xT)


def build_quickscorer(model) -> Optional[QuickScorerEngine]:
    """QuickScorer engine on the model's device, or None outside the
    envelope (compile_forest's, and the kernel's shared memory)."""
    qsm = compile_forest_cached(
        model.forest, model.binner.num_numerical,
        num_features=model.binner.num_scalar,
    )
    if qsm is None or not fits_shared_memory(qsm):
        return None
    return QuickScorerEngine(qsm, model.forest.device)


class BinnedQuickScorerEngine:
    """The 8-bit engine (counterpart of the JAX package's
    BinnedQuickScorerEngine; reference 8bits_numerical_features.h): the
    same kernel over the binner's bin matrix. Each numerical condition's
    threshold is its bin cut (v >= boundaries[t] ⇔ bin(v) >= t + 1), and
    the bin ids go in as f32 feature values; categorical rows carry the
    category codes, as in the float engine."""

    def __init__(self, qsm: QuickScorerModel, bin_thresh: np.ndarray,
                 device):
        self.qsm = qsm._replace(cond_thresh=bin_thresh)
        self.tables = make_tables(self.qsm, device)

    def __call__(self, bins: torch.Tensor) -> torch.Tensor:
        """Raw scores f32 [n] of `Binner.transform`'s u8 [n, F] (the view
        of a contiguous feature-major [F, n], read as it lies)."""
        xT = bins.t()[:self.tables.num_features]
        return score(self.tables, xT.to(torch.float32))


def build_binned_quickscorer(model) -> Optional[BinnedQuickScorerEngine]:
    """The 8-bit engine over the model's own binner on the model's
    device, or None outside QuickScorer's envelope or for a serving-only
    binner (an imported model's +inf boundaries bin every value to 0)."""
    qsm = compile_forest_cached(
        model.forest, model.binner.num_numerical,
        num_features=model.binner.num_scalar,
    )
    if qsm is None or not fits_shared_memory(qsm):
        return None
    b = model.binner
    has_numerical_cond = bool((qsm.cond_is_cat == 0).any())
    if has_numerical_cond and not np.isfinite(b.boundaries).any():
        return None
    bin_thresh = np.zeros_like(qsm.cond_thresh)
    for c in range(len(qsm.cond_feature)):
        fi = int(qsm.cond_feature[c])
        if qsm.cond_is_cat[c]:
            continue  # categorical conditions use bitmaps, not thresholds
        if fi >= b.num_numerical:
            return None
        nb = int(b.feature_num_bins[fi]) - 1
        t = np.searchsorted(b.boundaries[fi, :nb], qsm.cond_thresh[c],
                            side="left")
        bin_thresh[c] = np.float32(t + 1)
    return BinnedQuickScorerEngine(qsm, bin_thresh, model.forest.device)
