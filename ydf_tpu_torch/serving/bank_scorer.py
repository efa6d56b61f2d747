"""Data-bank serving engine for trees of any shape: node tables, CUDA
kernel wrapper and plain PyTorch version (counterpart of
ydf_tpu/serving/pallas_scorer.py, whose engine is named PallasBank there).

QuickScorer caps trees at 64 leaves; this engine walks the stacked node
tables directly. Per example and tree: start at the root, take up to
`max_depth` steps (stopping at a leaf, which equals the TPU kernel's
self-loop), each reading the node's feature, threshold or category mask
and going left or right; then add the leaf's value, one f32 add per tree
in tree order — bit-identical to the generic routed engine.

Categorical test (the TPU kernel's, kept as is): c = max(int(v), 0),
word = min(c >> 5, W - 1), go left iff bit (c & 31) of that word is set.

The kernel (csrc/bank_scorer.cu) replaces the TPU kernel
ydf_tpu/serving/pallas_scorer.py:_bank_kernel. Unlike the TPU tables
(all f32 payloads, build_tables there), the tables here are in native
types.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ydf_tpu_torch.serving.quickscorer import feature_major
from ydf_tpu_torch.utils import cuda_build

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; plain-version calls do not count).
KERNEL_LAUNCHES = 0
#: Rows those launches scored (a path's launches weighted by their rows).
KERNEL_ROWS = 0
# Rows per step of the plain version (bounds its [T, rows] temporaries).
PLAIN_ROW_CHUNK = 1 << 16


class BankTables(NamedTuple):
    """Node tables of a forest on one device, [T, N] each."""

    feature: torch.Tensor     # i32, clipped to >= 0 (leaves read row 0)
    thresh: torch.Tensor      # f32: v < thresh → left
    left: torch.Tensor        # i32
    right: torch.Tensor       # i32
    leaf_value: torch.Tensor  # f32, 0 at internal nodes
    is_cat: torch.Tensor      # u8
    is_leaf: torch.Tensor     # u8
    mask: torch.Tensor        # i32 [T, N, W] category words (u32 bits)
    max_depth: int
    num_features: int         # rows of xT the nodes read


def in_envelope(model) -> bool:
    """Single-accumulator forest of numerical/categorical nodes with
    encode-time imputation (no set, oblique or vector-sequence node)."""
    fo = model.forest
    return (
        model.binner.num_set == 0
        and model.binner.num_vs == 0
        and not model.native_missing
        and int(fo.leaf_value.shape[-1]) == 1
        and fo.oblique_weights.numel() == 0
        and fo.vs_anchor.numel() == 0
        and not bool((fo.is_set & ~fo.is_leaf).any())
    )


def build_tables(forest, max_depth: int, device) -> BankTables:
    """Forest → native-typed node tables on `device`. Raises on child
    or feature ids that would read outside the tables."""
    f = forest.to_numpy()
    T, N = f["feature"].shape
    internal = ~f["is_leaf"]
    for side in ("left", "right"):
        ids = f[side][internal]
        if ids.size and (ids.min() < 0 or ids.max() >= N):
            raise ValueError(f"forest has {side} child ids outside [0, {N})")
    feat = np.maximum(f["feature"], 0).astype(np.int32)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return BankTables(
        feature=t(feat, np.int32),
        thresh=t(f["threshold"], np.float32),
        left=t(np.where(internal, f["left"], 0), np.int32),
        right=t(np.where(internal, f["right"], 0), np.int32),
        leaf_value=t(
            np.where(f["is_leaf"], f["leaf_value"][..., 0], 0.0), np.float32
        ),
        is_cat=t(f["is_cat"], np.uint8),
        is_leaf=t(f["is_leaf"], np.uint8),
        mask=t(f["cat_mask"].view(np.int32), np.int32),
        max_depth=int(max_depth),
        num_features=int(feat[internal].max()) + 1 if internal.any() else 0,
    )


def _check_input(tables: BankTables, xT: torch.Tensor) -> None:
    if xT.dtype != torch.float32 or xT.dim() != 2:
        raise ValueError(
            f"xT must be float32 [F, n], got {xT.dtype} {tuple(xT.shape)}"
        )
    if xT.shape[0] < tables.num_features:
        raise ValueError(
            f"model reads {tables.num_features} feature rows but xT has "
            f"{xT.shape[0]} — pass the categorical columns too"
        )
    if xT.device != tables.feature.device:
        raise ValueError(
            f"xT is on {xT.device}, the model on {tables.feature.device}"
        )


def walk_plain(tables: BankTables, xT: torch.Tensor) -> torch.Tensor:
    """Leaf node id int64 [T, n] of every example in every tree: the
    walk of the kernel in plain PyTorch, all trees at once."""
    _check_input(tables, xT)
    T, N = tables.feature.shape
    W = tables.mask.shape[2]
    n = xT.shape[1]
    dev = xT.device
    base = (torch.arange(T, device=dev) * N)[:, None]      # [T, 1]
    feature = tables.feature.reshape(-1).long()
    thresh = tables.thresh.reshape(-1)
    left = tables.left.reshape(-1).long()
    right = tables.right.reshape(-1).long()
    is_cat = tables.is_cat.reshape(-1).bool()
    is_leaf = tables.is_leaf.reshape(-1).bool()
    mask = tables.mask.reshape(-1)
    node = torch.zeros((T, n), dtype=torch.long, device=dev)
    for _ in range(max(tables.max_depth, 0)):
        k = base + node
        v = torch.gather(xT, 0, feature[k])                 # [T, n]
        if W > 0:
            c = v.to(torch.int32).clamp(min=0)
            w = (c >> 5).clamp(max=W - 1)
            word = mask[k * W + w.long()]
            bit_set = ((word >> (c & 31)) & 1) == 1
        else:
            bit_set = torch.zeros_like(v, dtype=torch.bool)
        go_left = torch.where(is_cat[k], bit_set, v < thresh[k])
        nxt = torch.where(go_left, left[k], right[k])
        node = torch.where(is_leaf[k], node, nxt)
    return node


def score_plain(tables: BankTables, xT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 [n]."""
    T, N = tables.feature.shape
    n = xT.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=xT.device)
    base = (torch.arange(T, device=xT.device) * N)[:, None]
    leaf_value = tables.leaf_value.reshape(-1)
    for r0 in range(0, n, PLAIN_ROW_CHUNK):
        x = xT[:, r0:r0 + PLAIN_ROW_CHUNK]
        vals = leaf_value[base + walk_plain(tables, x)]      # [T, m]
        acc = torch.zeros(x.shape[1], dtype=torch.float32, device=xT.device)
        for t in range(T):
            acc = acc + vals[t]
        out[r0:r0 + x.shape[1]] = acc
    return out


def score(tables: BankTables, xT: torch.Tensor) -> torch.Tensor:
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
    fn = cuda_build.entry_point("bank_scorer", "ydf_bank_score", 10, 5)
    T, N = tables.feature.shape
    W = tables.mask.shape[2]
    with cuda_build.on_device(xT.device):
        timer = cuda_build.launch_timer("bank_scorer")
        status = fn(
            xT.data_ptr(), tables.feature.data_ptr(),
            tables.thresh.data_ptr(), tables.left.data_ptr(),
            tables.right.data_ptr(), tables.leaf_value.data_ptr(),
            tables.is_cat.data_ptr(), tables.is_leaf.data_ptr(),
            tables.mask.data_ptr(), out.data_ptr(),
            n, T, N, W, tables.max_depth,
            torch.cuda.current_stream().cuda_stream,
        )
        cuda_build.launch_done(timer)
    cuda_build.check_status(status, "bank kernel")
    KERNEL_LAUNCHES += 1
    KERNEL_ROWS += n
    return out


class BankScorerEngine:
    """Callable engine: (x_num f32 [n, Fn], x_cat i32 [n, Fc]) on the
    model's device → raw scores f32 [n]."""

    def __init__(self, tables: BankTables):
        self.tables = tables

    def __call__(self, x_num: torch.Tensor,
                 x_cat: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.score_xT(feature_major(x_num, x_cat))

    def score_xT(self, xT: torch.Tensor) -> torch.Tensor:
        """Raw scores of an already feature-major input xT f32 [F, n]."""
        return score(self.tables, xT)


def build_bank_scorer(model) -> Optional[BankScorerEngine]:
    """Bank engine on the model's device, or None outside the envelope."""
    if not in_envelope(model):
        return None
    return BankScorerEngine(
        build_tables(model.forest, model.max_depth, model.forest.device)
    )
