"""Data-bank serving engine for trees of any shape: host packing, CUDA
kernel wrapper and plain PyTorch version (counterpart of
ydf_tpu/serving/pallas_scorer.py, whose engine is named PallasBank there).

QuickScorer caps trees at 64 leaves; this engine walks the trees' nodes
directly. Per example and tree: start at the root, take up to `max_depth`
steps (stopping at a leaf, which equals the TPU kernel's self-loop), each
reading the node's feature, threshold or category mask and going left or
right; then add the leaf's value, one f32 add per tree in tree order —
bit-identical to the generic routed engine.

Categorical test (the TPU kernel's, kept as is): c = max(int(v), 0),
word = min(c >> 5, W - 1), go left iff bit (c & 31) of that word is set.

The kernel (csrc/bank_scorer.cu) replaces the TPU kernel
ydf_tpu/serving/pallas_scorer.py:_bank_kernel. It reads the model as
`pack_tables` lays it out, in one of two record layouts: narrow, one
8-byte record a reached node, for forests of trees whose ids fit 30 bits
(every model the learners grow); wide, one 16-byte record a node slot,
for any other forest the bank takes (a node reached twice, ids past 30
bits). Both store the mask words of categorical nodes only and group
trees into tree blocks that the kernel stages into shared memory. The
plain version reads the same packed tables.
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
PLAIN_ROW_CHUNK = 1 << 14

# A tree block (the trees the kernel stages into shared memory at once)
# takes at most this many bytes and trees. A tree larger than the bytes
# alone is a block of its own, which the kernel walks in global memory.
# 12 KB: two buffers and a 256-example tile of 32 features fit four
# blocks on an SM (20 KB fit three; 2.9077 against 3.2849 ms at gbt_d6,
# 0.8601 against 0.9623 at gbt_d8, 1,048,576 rows, on an H100 with
# scripts/time_redesigned_kernels.py bank). The kernel sizes its shared
# memory from the packing (csrc/bank_scorer.cu owns that layout).
TREE_BLOCK_BYTES = 12 * 1024
MAX_BLOCK_TREES = 64
# Below this many rows the kernel takes the split walk: a block scores
# 32 examples and its warps share out each tree block's trees, so a small
# batch spreads over more warps than one a thread. The crossover depends
# on the model (the split walk stages every tree block for each 32 rows,
# so its cost grows with the model's bytes; the per-thread walk's with
# its steps). 32,768 suits gbt_d6, which crosses between 32,768 and
# 65,536 rows; gbt_d8 crosses below 16,384 and is about 20% slower in
# the split walk at 16,384 rows (H100, scripts/time_redesigned_kernels.py
# bank).
SPLIT_BELOW_ROWS = 1 << 15
# The narrow record's meta word: bit 0 leaf, bit 1 categorical, the
# feature from bit 2, the left child's tree-local id above it (the right
# child is the next record). Feature and child bits share these 30 bits.
RECORD_BITS = 30
# The wide record: feature | categorical << 31, payload, left, right; a
# leaf's left is WIDE_LEAF.
WIDE_LEAF = 0xFFFFFFFF
_NEG_INF_BITS = np.float32(-np.inf).view(np.uint32)


class PackedBank(NamedTuple):
    """A forest as the kernel reads it (numpy).

    Each tree is a run of 32-bit words, 16-byte aligned: its records,
    then the mask words of its categorical nodes, W each. Narrow (`wide`
    false): the records of the nodes the walk reaches, in level order from
    the root, two words each (meta, payload). Wide: a record for every node
    slot at its own id, four words each (feature | categorical << 31,
    payload, left, right; left = WIDE_LEAF at a leaf). The payload is the
    threshold's bits (numerical node), the leaf value's bits (leaf), or
    the first mask word's tree-local index (categorical node). Node ids
    are tree-local, so a tree reads the same in shared or global memory.

    Packing keeps the walk's function: a categorical node with no mask
    words (W = 0, where every code goes right) becomes `v < -inf`, which
    is never true. Narrow: a node max_depth steps from the root becomes a
    leaf (value 0 unless it is one: the walk stops there and adds its 0),
    and nodes the walk cannot reach are left out. Wide: the walk counts
    its steps and adds 0 where it stops at an internal node."""

    words: np.ndarray       # u32 [U]
    tree_off: np.ndarray    # i32 [T+1] tree t = words[4 off[t]:4 off[t+1]]
    block_tree: np.ndarray  # i32 [NB+1] first tree of each tree block
    num_words: int          # W: mask words of a categorical node
    wide: bool              # the record layout
    child_shift: int        # narrow: the left child id's first bit in meta
    max_depth: int          # steps a walk takes at most
    num_features: int       # rows of xT the nodes read
    buf_bytes: int          # bytes of the largest staged tree block
    block_trees: int        # trees of the largest tree block


def _bits(count: int) -> int:
    """Bits of an id in [0, count)."""
    return max(int(count - 1).bit_length(), 1)


def record_bits_fit(num_features: int, num_nodes: int) -> bool:
    """Whether feature ids below num_features and node ids below
    num_nodes fit a narrow record's RECORD_BITS."""
    return _bits(num_features) + _bits(num_nodes) <= RECORD_BITS


def _level_order(f, max_depth):
    """Every node the walk reaches, level by level over all trees at
    once. Returns (tree, old id, new id, left child's new id or -1 where
    the walk stops, nodes a tree), sorted by tree then new id, or None
    when the walk reaches a node twice (the forest is not made of trees).
    New ids are level order, a node's two children adjacent."""
    T, N = f["feature"].shape
    internal = ~f["is_leaf"]
    tree = np.arange(T)
    old = np.zeros(T, np.int64)
    new = np.zeros(T, np.int64)
    count = np.ones(T, np.int64)
    parts = []
    for d in range(max_depth + 1):
        grow = internal[tree, old] if d < max_depth else np.zeros(
            tree.size, bool)
        child = np.full(tree.size, -1, np.int64)
        g_tree, g_old = tree[grow], old[grow]
        rank = np.arange(g_tree.size) - np.searchsorted(g_tree, g_tree)
        first = count[g_tree] + 2 * rank
        child[grow] = first
        parts.append((tree, old, new, child))
        if not grow.any():
            break
        count += 2 * np.bincount(g_tree, minlength=T)
        if (count > N).any():
            return None
        tree = np.repeat(g_tree, 2)
        old = np.stack([f["left"][g_tree, g_old], f["right"][g_tree, g_old]],
                       1).reshape(-1).astype(np.int64)
        new = np.stack([first, first + 1], 1).reshape(-1)
    tree, old, new, child = (np.concatenate(a) for a in zip(*parts))
    if np.unique(tree * N + old).size != tree.size:
        return None
    order = np.lexsort((new, tree))
    return tree[order], old[order], new[order], child[order], count


def _tree_blocks(tree_bytes, block_bytes):
    """Greedy tree blocks: a tree joins the open block while the block
    stays within block_bytes and MAX_BLOCK_TREES; a tree larger than
    block_bytes is a block alone. Returns (first tree of each block + T,
    bytes of the largest block within block_bytes)."""
    starts, used, trees, buf = [], 0, 0, 0
    for t, b in enumerate(tree_bytes.tolist()):
        if b > block_bytes or not trees or (
                used + b > block_bytes or trees == MAX_BLOCK_TREES):
            starts.append(t)
            used = trees = 0
        used += b
        trees += 1
        if used <= block_bytes:
            buf = max(buf, used)
    starts.append(len(tree_bytes))
    return np.asarray(starts, np.int64), buf


def _payload(f, tree, node, inner, W):
    """Payloads of nodes (tree, node) before mask offsets: thresholds
    (-inf for a categorical node with no mask words) where `inner`, else
    leaf values (0 at an internal node)."""
    leaf_value = np.where(f["is_leaf"], f["leaf_value"][..., 0], 0.0)
    payload = np.where(
        inner, f["threshold"].astype(np.float32)[tree, node].view(np.uint32),
        leaf_value.astype(np.float32)[tree, node].view(np.uint32))
    return np.where(inner & f["is_cat"][tree, node] & (W == 0),
                    _NEG_INF_BITS, payload)


def _narrow_words(f, feat, F, order):
    """Narrow records and mask words: (words, words a tree, child
    shift)."""
    T = f["feature"].shape[0]
    W = int(f["cat_mask"].shape[-1])
    tree, old, new, child, count = order
    shift = 2 + _bits(F)
    inner = child >= 0
    cat = inner & f["is_cat"][tree, old] & (W > 0)
    n_cat = np.bincount(tree[cat], minlength=T)
    tree_words = -(-(2 * count + W * n_cat) // 4) * 4
    start = 4 * np.r_[0, np.cumsum(tree_words // 4)][tree]
    words = np.zeros(int(tree_words.sum()), np.uint32)
    payload = _payload(f, tree, old, inner, W)
    ci = np.flatnonzero(cat)
    j = np.arange(ci.size) - np.searchsorted(tree[ci], tree[ci])
    mask_at = 2 * count[tree[ci]] + W * j
    payload[ci] = mask_at
    meta = np.where(
        inner, (child << shift) | (feat[tree, old] << 2) | (cat << 1), 1)
    words[start + 2 * new] = meta.astype(np.uint32)
    words[start + 2 * new + 1] = payload.astype(np.uint32)
    if ci.size:
        at = start[ci][:, None] + mask_at[:, None] + np.arange(W)
        words[at] = f["cat_mask"][tree[ci], old[ci]]
    return words, tree_words, shift


def _wide_words(f, feat):
    """Wide records (every node slot at its own id) and mask words:
    (words, words a tree)."""
    T, N = f["feature"].shape
    W = int(f["cat_mask"].shape[-1])
    inner = ~f["is_leaf"]
    cat = inner & f["is_cat"] & (W > 0)
    tree_words = -(-(4 * N + W * cat.sum(1)) // 4) * 4
    start = 4 * np.r_[0, np.cumsum(tree_words // 4)][:-1]
    words = np.zeros(int(tree_words.sum()), np.uint32)
    tree, node = np.meshgrid(np.arange(T), np.arange(N), indexing="ij")
    payload = _payload(f, tree, node, inner, W)
    mask_at = 4 * N + W * (np.cumsum(cat, 1) - cat)
    payload = np.where(cat, mask_at, payload)
    rec = np.stack([
        feat | (cat.astype(np.int64) << 31), payload,
        np.where(inner, f["left"], WIDE_LEAF),
        np.where(inner, f["right"], 0)], -1).astype(np.uint32)
    words[start[:, None] + np.arange(4 * N)] = rec.reshape(T, 4 * N)
    ti, ni = np.nonzero(cat)
    if ti.size:
        at = (start[ti] + mask_at[ti, ni])[:, None] + np.arange(W)
        words[at] = f["cat_mask"][ti, ni]
    return words, tree_words


def pack_tables(forest, max_depth: int) -> PackedBank:
    """Forest -> PackedBank: narrow records when the forest is made of
    trees whose feature and reached-node ids fit RECORD_BITS, else wide.
    Raises on child ids outside the node arrays."""
    f = forest.to_numpy()
    T, N = f["feature"].shape
    internal = ~f["is_leaf"]
    for side in ("left", "right"):
        ids = f[side][internal]
        if ids.size and (ids.min() < 0 or ids.max() >= N):
            raise ValueError(f"forest has {side} child ids outside [0, {N})")
    feat = np.maximum(f["feature"], 0).astype(np.int64)
    F = int(feat[internal].max()) + 1 if internal.any() else 0
    max_depth = max(int(max_depth), 0)
    order = _level_order(f, max_depth)
    wide = order is None or (T > 0 and not record_bits_fit(
        F, int(order[-1].max())))
    if wide:
        words, tree_words = _wide_words(f, feat)
        shift = 0
    else:
        words, tree_words, shift = _narrow_words(f, feat, F, order)
    tree_off = np.r_[0, np.cumsum(tree_words // 4)]
    block_tree, buf = _tree_blocks(4 * tree_words, TREE_BLOCK_BYTES)
    return PackedBank(
        words=words, tree_off=tree_off.astype(np.int32),
        block_tree=block_tree.astype(np.int32), num_words=int(
            f["cat_mask"].shape[-1]), wide=wide, child_shift=shift,
        max_depth=max_depth, num_features=F, buf_bytes=buf,
        block_trees=int(np.diff(block_tree).max(initial=0)))


class BankTables(NamedTuple):
    """PackedBank as tensors on one device (u32 words held as int32 bit
    patterns)."""

    words: torch.Tensor       # i32 [U]
    tree_off: torch.Tensor    # i32 [T+1], 16-byte units
    block_tree: torch.Tensor  # i32 [NB+1]
    num_words: int
    wide: bool
    child_shift: int
    max_depth: int
    num_features: int
    buf_bytes: int
    block_trees: int

    @property
    def num_trees(self) -> int:
        return self.tree_off.numel() - 1


def make_tables(forest, max_depth: int, device) -> BankTables:
    p = pack_tables(forest, max_depth)

    def t(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(device)

    return BankTables(**dict(p._asdict(), words=t(p.words),
                             tree_off=t(p.tree_off),
                             block_tree=t(p.block_tree)))


def in_envelope(model) -> bool:
    """Single-accumulator forest of numerical/categorical nodes with
    encode-time imputation (no set, oblique or vector-sequence node),
    served by a sum of its trees (a random forest's mean is not)."""
    fo = model.forest
    return (
        getattr(model, "combine", "sum") == "sum"
        and model.binner.num_set == 0
        and model.binner.num_vs == 0
        and not model.native_missing
        and int(fo.leaf_value.shape[-1]) == 1
        and fo.oblique_weights.numel() == 0
        and fo.vs_anchor.numel() == 0
        and not bool((fo.is_set & ~fo.is_leaf).any())
    )


def split_walk(n: int) -> bool:
    """Whether the kernel takes the split walk at n rows."""
    return n < SPLIT_BELOW_ROWS


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
    if xT.device != tables.words.device:
        raise ValueError(
            f"xT is on {xT.device}, the model on {tables.words.device}"
        )


def walk_plain(tables: BankTables, xT: torch.Tensor):
    """The walk of the kernel in plain PyTorch, all trees at once: the
    word index of the record each example's walk ends at in every tree (a
    leaf, or in the wide layout the internal node max_depth steps down)
    and the steps taken to it, int64 [T, n] each."""
    _check_input(tables, xT)
    T, n, W = tables.num_trees, xT.shape[1], tables.num_words
    dev = xT.device
    words = tables.words.long() & 0xFFFFFFFF
    base = (4 * tables.tree_off[:-1].long())[:, None]       # [T, 1]
    size = 4 if tables.wide else 2
    fmask = (1 << max(tables.child_shift - 2, 0)) - 1
    node = torch.zeros((T, n), dtype=torch.long, device=dev)
    steps = torch.zeros((T, n), dtype=torch.long, device=dev)
    while True:
        k = base + size * node
        meta = words[k]
        if tables.wide:
            left = words[k + 2]
            inner = (left != WIDE_LEAF) & (steps < tables.max_depth)
        else:
            inner = (meta & 1) == 0
        if not bool(inner.any()):
            return k, steps
        if tables.wide:
            feat, is_cat = meta & 0x7FFFFFFF, (meta >> 31) == 1
            right = words[k + 3]
        else:
            feat, is_cat = (meta >> 2) & fmask, (meta & 2) != 0
            left = meta >> tables.child_shift
            right = left + 1
        pay = words[k + 1]
        v = torch.gather(xT, 0, torch.where(inner, feat, 0))  # [T, n]
        go_left = v < pay.to(torch.int32).view(torch.float32)
        if W > 0:
            c = v.to(torch.int32).clamp(min=0)
            w = (c >> 5).clamp(max=W - 1)
            word = words[torch.where(inner & is_cat, base + pay + w, 0)]
            bit_set = ((word >> (c & 31)) & 1) == 1
            go_left = torch.where(is_cat, bit_set, go_left)
        node = torch.where(inner, torch.where(go_left, left, right), node)
        steps += inner


def leaf_values(tables: BankTables, rec: torch.Tensor) -> torch.Tensor:
    """f32 values of the records walk_plain ends at: a leaf's value, 0 at
    an internal node."""
    vals = tables.words[rec + 1].view(torch.float32)
    if tables.wide:
        leaf = tables.words[rec + 2] == -1  # WIDE_LEAF as an int32
        vals = torch.where(leaf, vals, torch.zeros_like(vals))
    return vals


def score_plain(tables: BankTables, xT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 [n]."""
    _check_input(tables, xT)
    n = xT.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=xT.device)
    for r0 in range(0, n, PLAIN_ROW_CHUNK):
        x = xT[:, r0:r0 + PLAIN_ROW_CHUNK]
        vals = leaf_values(tables, walk_plain(tables, x)[0])  # [T, m]
        acc = torch.zeros(x.shape[1], dtype=torch.float32, device=xT.device)
        for t in range(tables.num_trees):
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
    if tables.num_trees == 0:
        return out.zero_()
    fn = cuda_build.entry_point("bank_scorer", "ydf_bank_score", 5, 10)
    with cuda_build.on_device(xT.device):
        timer = cuda_build.launch_timer(f"bank_scorer/rows={n}")
        status = fn(
            xT.data_ptr(), tables.words.data_ptr(),
            tables.tree_off.data_ptr(), tables.block_tree.data_ptr(),
            out.data_ptr(), n, tables.num_features,
            tables.block_tree.numel() - 1, tables.block_trees,
            tables.num_words, int(tables.wide), tables.child_shift,
            tables.max_depth, tables.buf_bytes, int(split_walk(n)),
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
        make_tables(model.forest, model.max_depth, model.forest.device)
    )
