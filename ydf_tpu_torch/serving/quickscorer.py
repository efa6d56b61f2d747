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
ydf_tpu/serving/quickscorer.py:_qs_kernel. It takes the input
feature-major, xT f32 [F, n], as the TPU engine does.
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
# Device tables, kernel wrapper, plain version
# --------------------------------------------------------------------- #


class QuickScorerTables(NamedTuple):
    """A QuickScorerModel as tensors on one device. 32-bit unsigned
    words are held as int32 bit patterns."""

    cond_feature: torch.Tensor  # i32 [C]
    cond_thresh: torch.Tensor   # f32 [C]
    cond_mask_lo: torch.Tensor  # i32 [C] (u32 bits)
    cond_mask_hi: torch.Tensor  # i32 [C] (u32 bits)
    cond_is_cat: torch.Tensor   # i32 [C]
    cond_bitmap: torch.Tensor   # i32 [C, W] (u32 bits)
    tree_offsets: torch.Tensor  # i32 [T+1]: tree t owns [off[t], off[t+1])
    leaf_values: torch.Tensor   # f32 [T, 64]
    num_features: int           # rows of xT the conditions read


def make_tables(qsm: QuickScorerModel, device) -> QuickScorerTables:
    T = qsm.num_trees
    tree = qsm.cond_tree
    if tree.size and np.any(np.diff(tree) < 0):
        raise ValueError("QuickScorer conditions must be sorted by tree")
    offsets = np.zeros(T + 1, np.int64)
    np.cumsum(np.bincount(tree, minlength=T), out=offsets[1:])

    def t(a, dtype=None):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(dtype) if dtype else a).to(device)

    return QuickScorerTables(
        cond_feature=t(qsm.cond_feature),
        cond_thresh=t(qsm.cond_thresh),
        cond_mask_lo=t(qsm.cond_mask_lo),
        cond_mask_hi=t(qsm.cond_mask_hi),
        cond_is_cat=t(qsm.cond_is_cat),
        cond_bitmap=t(qsm.cond_bitmap),
        tree_offsets=t(offsets, np.int32),
        leaf_values=t(qsm.leaf_values),
        num_features=int(qsm.cond_feature.max()) + 1 if tree.size else 0,
    )


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
    """Plain PyTorch version of the kernel: f32 [n]. Conditions run
    slot by slot across all trees at once (slot j = the j-th condition
    of each tree); the 32-bit mask halves are held in int64."""
    _check_input(tables, xT)
    n = xT.shape[1]
    dev = xT.device
    off = tables.tree_offsets.long()
    T = off.numel() - 1
    counts = off[1:] - off[:-1]
    C = tables.cond_feature.numel()
    W = tables.cond_bitmap.shape[1]
    u32 = 0xFFFFFFFF
    mlo = tables.cond_mask_lo.long() & u32
    mhi = tables.cond_mask_hi.long() & u32
    bitmap = tables.cond_bitmap.reshape(-1)
    # Leaf 64 (no survivor) reads 0, as the TPU kernel's empty one-hot.
    values = torch.cat(
        [tables.leaf_values, torch.zeros(T, 1, device=dev)], dim=1
    )
    tree_ids = torch.arange(T, device=dev)[:, None]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    cmax = int(counts.max()) if T and C else 0
    for r0 in range(0, n, PLAIN_ROW_CHUNK):
        x = xT[:, r0:r0 + PLAIN_ROW_CHUNK]
        m = x.shape[1]
        live_lo = torch.full((T, m), u32, dtype=torch.long, device=dev)
        live_hi = torch.full((T, m), u32, dtype=torch.long, device=dev)
        for j in range(cmax):
            valid = (j < counts)[:, None]             # [T, 1]
            c = (off[:-1] + j).clamp(max=C - 1)       # [T]
            v = x[tables.cond_feature[c].long()]      # [T, m]
            trig = v >= tables.cond_thresh[c][:, None]
            if W > 0:
                idx = v.to(torch.int32)
                w = idx >> 5
                inside = (w >= 0) & (w < W)
                word = bitmap[c[:, None] * W + w.clamp(0, W - 1).long()]
                bit = torch.where(inside, (word >> (idx & 31)) & 1, 0)
                trig = torch.where(
                    (tables.cond_is_cat[c] == 1)[:, None], bit == 0, trig
                )
            trig = trig & valid
            live_lo = torch.where(trig, live_lo & mlo[c][:, None], live_lo)
            live_hi = torch.where(trig, live_hi & mhi[c][:, None], live_hi)
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
    global KERNEL_LAUNCHES
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
    fn = cuda_build.entry_point("quickscorer", "ydf_qs_score", 10, 3)
    T = tables.leaf_values.shape[0]
    W = tables.cond_bitmap.shape[1]
    with torch.cuda.device(xT.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            xT.data_ptr(), tables.tree_offsets.data_ptr(),
            tables.cond_feature.data_ptr(), tables.cond_thresh.data_ptr(),
            tables.cond_mask_lo.data_ptr(), tables.cond_mask_hi.data_ptr(),
            tables.cond_is_cat.data_ptr(), tables.cond_bitmap.data_ptr(),
            tables.leaf_values.data_ptr(), out.data_ptr(), n, T, W, stream,
        )
    cuda_build.check_status(status, "QuickScorer kernel")
    KERNEL_LAUNCHES += 1
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
    envelope."""
    qsm = compile_forest_cached(
        model.forest, model.binner.num_numerical,
        num_features=model.binner.num_scalar,
    )
    if qsm is None:
        return None
    return QuickScorerEngine(qsm, model.forest.device)
