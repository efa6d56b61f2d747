"""The redesigned bank and vector-sequence kernels (csrc/bank_scorer.cu,
csrc/vector_sequence.cu): their host-side layouts held against the JAX
package, and the kernels against their plain versions on the card.

  * bank_scorer.pack_tables: the packed node records, narrow (one 8-byte
    record a reached node in level order) and wide (one 16-byte record a
    node slot), with the mask words of categorical nodes only, in tree
    blocks, read back to the same function: the plain version over them
    equals the JAX PallasBank in Pallas interpret mode bitwise, on the
    default GBT (gbt_d6), the depth-8 GBT (gbt_d8) and synthetic forests
    (chip_smoke.BANK_FORESTS: an unbalanced deep tree cut at max_depth, a
    tree larger than a shared tree block, numerical only with W = 0,
    categorical codes past the mask words and negative ones, ids past a
    narrow record's 30 bits, trees that share a subtree);
  * the block layout and the small-batch split threshold;
  * on the card (marked gpu): the bank kernel torch.equal to its plain
    version in both walks and both record layouts, at ragged row counts,
    on the fixtures and the synthetic forests, with trees walked in global
    memory; the vector-sequence kernel torch.equal to its plain version at
    the path shapes, ragged rows, D != 16, anchor kinds in any order, more
    than 32 anchors and values not 16-byte aligned.

On a machine with a card but without JAX (tests/conftest.py imports it):
    python -m pytest --noconftest -m gpu tests/test_torch_*.py
"""

import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import ydf_tpu as ydf
    from ydf_tpu.models.forest import Forest as JaxForest
    from ydf_tpu.serving import pallas_scorer as jax_bank
except ImportError:
    ydf = None

import chip_smoke
import ydf_tpu_torch
from ydf_tpu_torch.dataset.dataset import Dataset
from ydf_tpu_torch.ops import vector_sequence as vso
from ydf_tpu_torch.serving import bank_scorer as bank
from ydf_tpu_torch.serving.quickscorer import feature_major

torch.set_num_threads(1)
TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ydf_tpu_torch", "testdata")
FIXTURES = ("gbt_d6", "gbt_d8")
SYNTHETIC = tuple(chip_smoke.BANK_FORESTS)
# A tree block of a few hundred bytes: most trees are larger and are
# walked in global memory, the rest share ragged blocks.
SMALL_BLOCK = 700
# Shared memory of one H100 SM, bytes (a block reserves 1 KB of it).
SM_SMEM = 233_472


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def fixture_case(name, rows=256, seed=0):
    """The port's model of a fixture on the CPU and `rows` of its stored
    requests, encoded: (model, x_num, x_cat)."""
    pm = ydf_tpu_torch.load_model(os.path.join(TESTDATA, name),
                                  device="cpu")
    req = dict(np.load(os.path.join(TESTDATA, name, "requests.npz")))
    idx = np.random.default_rng(seed).integers(0, 1024, rows)
    x_num, x_cat = pm._encode_inputs(
        Dataset.from_data({k: v[idx] for k, v in req.items()}, pm.dataspec))
    return pm, x_num, x_cat


def synthetic_case(name, rows=300, seed=1):
    """(numpy forest arrays, port Forest, max_depth, x_num, x_cat)."""
    f = chip_smoke.bank_forest(name)
    x_num, x_cat = chip_smoke.bank_inputs(name, rows, seed=seed)
    return (f, ydf_tpu_torch.forest_from_jax(f),
            chip_smoke.BANK_FORESTS[name][-1], x_num, x_cat)


def xT_of(x_num, x_cat):
    return feature_major(torch.from_numpy(x_num), torch.from_numpy(x_cat))


def bitwise(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def pack(forest, max_depth, layout, device="cpu"):
    """make_tables with the narrow records where they fit, or the wide
    records ("wide": RECORD_BITS 0, so that no forest fits narrow)."""
    keep = bank.RECORD_BITS
    bank.RECORD_BITS = 0 if layout == "wide" else keep
    try:
        return bank.make_tables(forest, max_depth, device)
    finally:
        bank.RECORD_BITS = keep


def check_layout(tables, forest, max_depth):
    """The packed layout's invariants: trees 16-byte aligned; narrow
    records in level order (a node's children adjacent, after it, one
    level down), leaves flagged, no walk longer than max_depth; wide
    records at the node's own id with its children; categorical payloads
    inside the tree, after its records; tree blocks within
    TREE_BLOCK_BYTES and MAX_BLOCK_TREES, or one tree alone, buf_bytes
    the largest such block, block_trees the most trees a block."""
    words = tables.words.numpy().view(np.uint32)
    off = 4 * tables.tree_off.numpy().astype(np.int64)
    bt = tables.block_tree.numpy()
    T = tables.num_trees
    W = tables.num_words
    shift = tables.child_shift
    f = forest.to_numpy()
    assert off[0] == 0 and off[-1] == words.size
    assert bt[0] == 0 and bt[-1] == T and np.all(np.diff(bt) >= 1)
    for t in range(T):
        w = words[off[t]:off[t + 1]]
        if tables.wide:
            N = f["feature"].shape[1]
            rec = w[:4 * N].reshape(N, 4).astype(np.int64)
            leaf = rec[:, 2] == bank.WIDE_LEAF
            assert np.array_equal(leaf, f["is_leaf"][t])
            assert np.array_equal(rec[~leaf, 2], f["left"][t][~leaf])
            assert np.array_equal(rec[~leaf, 3], f["right"][t][~leaf])
            assert np.all((rec[~leaf, 0] & 0x7FFFFFFF) < tables.num_features)
            records = 2 * N  # in 8-byte units, as the narrow count
            cat = np.flatnonzero(rec[:, 0] >> 31)
            pay = rec[cat, 1]
        else:
            meta = w[0::2].astype(np.int64)
            depth = {0: 0}
            i = 0
            while i in depth:
                m = meta[i]
                if m & 1:
                    assert m == 1  # a leaf record carries no other bit
                else:
                    child = int(m >> shift)
                    assert child > i and child + 1 < len(meta)
                    depth[child] = depth[child + 1] = depth[i] + 1
                    assert depth[i] < max_depth
                    assert (m >> 2) & ((1 << (shift - 2)) - 1) < \
                        tables.num_features
                i += 1
            records = i
            assert records == len(depth)
            cat = np.flatnonzero((meta[:records] & 3) == 2)
            pay = w[2 * cat + 1].astype(np.int64)
        assert W > 0 or cat.size == 0
        assert np.all(pay >= 2 * records) and np.all(pay + W <= len(w))
        assert np.array_equal(np.sort(pay), 2 * records + W * np.arange(
            cat.size))
    bytes_of = 16 * np.diff(tables.tree_off.numpy().astype(np.int64))
    biggest = 0
    for b in range(len(bt) - 1):
        nbytes = int(bytes_of[bt[b]:bt[b + 1]].sum())
        assert bt[b + 1] - bt[b] <= bank.MAX_BLOCK_TREES
        assert nbytes <= bank.TREE_BLOCK_BYTES or bt[b + 1] - bt[b] == 1
        if nbytes <= bank.TREE_BLOCK_BYTES:
            biggest = max(biggest, nbytes)
    assert tables.buf_bytes == biggest and biggest % 16 == 0
    assert tables.block_trees == int(np.diff(bt).max())


# --------------------------------------------------------------------- #
# Packed bank tables, on the CPU
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("block_bytes", [bank.TREE_BLOCK_BYTES, SMALL_BLOCK])
@pytest.mark.parametrize("name", FIXTURES)
def test_packed_fixture_matches_jax_bank(monkeypatch, name, block_bytes,
                                         layout):
    """The default GBT and the depth-8 GBT: the plain version over the
    packed tables equals the JAX PallasBank in interpret mode bitwise, and
    the fixture's expected raw scores."""
    require_jax()
    monkeypatch.setattr(bank, "TREE_BLOCK_BYTES", block_bytes)
    m = ydf.load_model(os.path.join(TESTDATA, name))
    pm, x_num, x_cat = fixture_case(name)
    tables = pack(pm.forest, pm.max_depth, layout)
    assert tables.wide == (layout == "wide")
    check_layout(tables, pm.forest, pm.max_depth)
    want = np.asarray(jax_bank.build_pallas_scorer(m, interpret=True)(
        x_num, x_cat))
    got = bank.score_plain(tables, xT_of(x_num, x_cat)).numpy()
    assert bitwise(got, want)
    if block_bytes == SMALL_BLOCK:  # every tree is walked in global memory
        assert tables.buf_bytes == 0


@pytest.mark.parametrize("block_bytes", [bank.TREE_BLOCK_BYTES, SMALL_BLOCK])
@pytest.mark.parametrize("name", SYNTHETIC)
def test_synthetic_forest_matches_jax_bank(monkeypatch, name, block_bytes):
    """Shuffled node positions with junk nodes between them, deep chains
    cut at max_depth, W = 0 (held against one word of zeros), codes past
    the mask words and negative, ids past 30 bits, shared subtrees: the
    plain version over the packed tables equals the JAX PallasBank
    bitwise."""
    require_jax()
    monkeypatch.setattr(bank, "TREE_BLOCK_BYTES", block_bytes)
    f, forest, max_depth, x_num, x_cat = synthetic_case(
        name, rows=40 if name == "wide" else 300)
    tables = bank.make_tables(forest, max_depth, "cpu")
    check_layout(tables, forest, max_depth)
    Fn = chip_smoke.BANK_FORESTS[name][1]
    if f["cat_mask"].shape[-1] == 0:
        # The JAX kernel cannot take W = 0 (a block of width 0); one word
        # of zeros sends every code right, as W = 0 does.
        f = dict(f, cat_mask=np.zeros(f["is_cat"].shape + (1,), np.uint32))
    jt = jax_bank.build_tables(JaxForest.from_numpy(f))._replace(
        num_features=x_num.shape[1] + x_cat.shape[1])
    eng = jax_bank.PallasBankEngine(jt, Fn, max_depth, interpret=True)
    want = np.asarray(eng(x_num, x_cat))
    got = bank.score_plain(tables, xT_of(x_num, x_cat)).numpy()
    assert bitwise(got, want)


@pytest.mark.parametrize("name", SYNTHETIC)
def test_synthetic_forest_shapes(name):
    """What each synthetic forest is there to cover."""
    f, forest, max_depth, x_num, x_cat = synthetic_case(name, rows=40)
    tables = bank.make_tables(forest, max_depth, "cpu")
    _, steps = bank.walk_plain(tables, xT_of(x_num, x_cat))
    biggest = 16 * int(tables.tree_off.diff().max())
    assert tables.wide == (name in ("wide", "shared"))
    if name == "chain":  # some walks stop at max_depth, inside the tree
        assert int(steps.max()) == max_depth
        assert int(f["num_nodes"].max()) > 2 * max_depth
    if name in ("oversize", "wide"):
        assert biggest > bank.TREE_BLOCK_BYTES
        assert tables.block_tree.numel() - 1 >= 2
    else:
        assert biggest <= bank.TREE_BLOCK_BYTES
    if name == "numerical":  # W = 0 with categorical splits
        assert tables.num_words == 0
        assert bool((f["is_cat"] & ~f["is_leaf"]).any())
    if name == "mixed":  # codes past the words and negative ones
        W = chip_smoke.BANK_FORESTS[name][3]
        assert (x_cat < 0).any() and (x_cat >= 32 * W).any()
    if name == "wide":  # the ids need more than a narrow record's bits
        F = int(f["feature"][~f["is_leaf"]].max()) + 1
        assert not bank.record_bits_fit(F, int(f["num_nodes"].max()))
        assert bank.record_bits_fit(F, 1 << 14)
    if name == "shared":  # a node reached twice: not trees
        split = ~f["is_leaf"][:, 0]
        assert split.any()
        assert np.array_equal(f["left"][split, 0], f["right"][split, 0])


def test_walk_plain_counts_the_steps_to_each_leaf():
    """walk_plain's steps are the depth of the leaf record it ends at,
    and the leaf's payload is the routed engine's leaf value."""
    pm, x_num, x_cat = fixture_case("gbt_d8", rows=64)
    tables = bank.make_tables(pm.forest, pm.max_depth, "cpu")
    leaf, steps = bank.walk_plain(tables, xT_of(x_num, x_cat))
    words = tables.words.numpy().view(np.uint32)
    assert np.all(words[leaf.numpy()] == 1)
    assert int(steps.max()) <= pm.max_depth and int(steps.min()) >= 1
    from ydf_tpu_torch.ops.routing import route_tree_values

    nodes = route_tree_values(pm.forest, 3, torch.from_numpy(x_num),
                              torch.from_numpy(x_cat),
                              pm.binner.num_numerical, pm.max_depth)
    want = pm.forest.leaf_value[3, nodes, 0].numpy()
    assert bitwise(words[leaf[3].numpy() + 1].view(np.float32), want)


def test_wide_walk_stops_after_max_depth_steps():
    """The wide walk of the deep chains takes at most max_depth steps and
    adds 0 where it stops at an internal node: it ends where the narrow
    walk does, with the same values."""
    _, forest, max_depth, x_num, x_cat = synthetic_case("chain")
    xT = xT_of(x_num, x_cat)
    narrow = pack(forest, max_depth, "narrow")
    wide = pack(forest, max_depth, "wide")
    rec_n, steps_n = bank.walk_plain(narrow, xT)
    rec_w, steps_w = bank.walk_plain(wide, xT)
    assert torch.equal(steps_n, steps_w) and int(steps_w.max()) == max_depth
    stopped = wide.words[rec_w + 2] != -1
    assert bool(stopped.any())
    assert bool((bank.leaf_values(wide, rec_w)[stopped] == 0).all())
    assert bitwise(bank.leaf_values(wide, rec_w),
                   bank.leaf_values(narrow, rec_n))
    assert bitwise(bank.score_plain(wide, xT), bank.score_plain(narrow, xT))


def test_categorical_nodes_alone_store_mask_words():
    """The default GBT packs to one record a reached node plus W words a
    categorical split: 13,344 of its 18,427 splits are categorical."""
    pm, _, _ = fixture_case("gbt_d6", rows=1)
    f = pm.forest.to_numpy()
    p = bank.pack_tables(pm.forest, pm.max_depth)
    real = np.arange(f["feature"].shape[1]) < f["num_nodes"][:, None]
    internal = ~f["is_leaf"] & real
    cats = int((internal & f["is_cat"]).sum())
    assert (cats, int(internal.sum())) == (13_344, 18_427)
    W = p.num_words
    tree_words = 4 * np.diff(p.tree_off.astype(np.int64))
    need = 2 * int(real.sum()) + W * cats
    assert need <= tree_words.sum() < need + 4 * len(tree_words)
    assert p.buf_bytes <= bank.TREE_BLOCK_BYTES and not p.wide


def test_forest_that_is_not_a_tree_packs_wide():
    """A node reached twice (both root sides to one subtree) packs wide
    (the bank serves the forest; test_synthetic_forest_matches_jax_bank
    holds its walk against the JAX package's)."""
    f = chip_smoke.bank_forest("shared")
    p = bank.pack_tables(ydf_tpu_torch.forest_from_jax(f), 12)
    assert p.wide and p.child_shift == 0 and p.max_depth == 12


def test_ids_past_the_record_bits_pack_wide():
    """Feature and reached-node ids share a narrow record's 30 bits; a
    forest whose ids do not fit packs wide, whatever its node arrays'
    size (the check counts the nodes the walk reaches)."""
    assert bank.record_bits_fit(32, 511)
    assert bank.record_bits_fit(1 << 14, 1 << 16)
    assert not bank.record_bits_fit(1 << 15, 1 << 16)
    f = chip_smoke.bank_forest("mixed")
    assert not bank.pack_tables(ydf_tpu_torch.forest_from_jax(f), 12).wide
    node_arrays = ("feature", "threshold", "threshold_bin", "is_cat",
                   "is_set", "cat_mask", "left", "right", "is_leaf",
                   "na_left", "leaf_value", "cover")
    padded = dict(f, **{k: np.concatenate([f[k], np.zeros(
        (f[k].shape[0], 1 << 17) + f[k].shape[2:], f[k].dtype)], 1)
        for k in node_arrays})  # 2^17 more node slots, none reached
    assert not bank.pack_tables(
        ydf_tpu_torch.forest_from_jax(padded), 12).wide
    f["feature"][~f["is_leaf"]] += 1 << 22  # features past 2^22
    p = bank.pack_tables(ydf_tpu_torch.forest_from_jax(f), 12)
    assert p.wide and p.num_features > 1 << 22


@pytest.mark.parametrize("n", [1, 256, 1024, 4096, 32_767, 32_768,
                               65_536, 1 << 20])
@pytest.mark.parametrize("name", FIXTURES)
def test_bank_split_walk_and_blocks(name, n):
    """The split walk below SPLIT_BELOW_ROWS rows, one example a thread
    above; the two tree-block buffers and a 256-example tile of the 32
    features fit four blocks an SM (csrc/bank_scorer.cu's layout)."""
    pm, _, _ = fixture_case(name, rows=1)
    tables = bank.build_bank_scorer(pm).tables
    assert bank.split_walk(n) == (n < bank.SPLIT_BELOW_ROWS)
    assert tables.num_features == 32 and not tables.wide
    assert 4 * (2 * tables.buf_bytes + 32 * 256 * 4 + 1024) <= SM_SMEM
    assert tables.block_trees <= bank.MAX_BLOCK_TREES


# --------------------------------------------------------------------- #
# The vector-sequence launch shape, on the CPU
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [200_000, 1024, 1, 70_001])
def test_vs_launch_shape_fills_the_card(n):
    """A warp a row: every SM gets blocks at serve_vs's 1,024 rows and at
    train_vs's 200,000 (a grid-stride loop there), and no warp idles."""
    blocks = vso.vs_launch_shape(n)
    warps = blocks * vso.WARPS
    assert blocks <= vso.SMS * vso.BLOCKS_PER_SM
    assert warps < n + vso.WARPS  # no block without a row
    if n >= vso.SMS * vso.WARPS:
        assert blocks >= vso.SMS
    rows_per_warp = -(-n // warps)
    if n == 200_000:
        assert blocks == vso.SMS * vso.BLOCKS_PER_SM
        assert rows_per_warp == 48
    if n == 1024:
        assert blocks == 256 and rows_per_warp == 1


# --------------------------------------------------------------------- #
# On the card (skip without one)
# --------------------------------------------------------------------- #


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def check_bank_on_card(tables, xT):
    want = bank.score_plain(tables, xT)
    before = bank.KERNEL_LAUNCHES
    for walk, got in zip(("split", "per-thread"), chip_smoke.both_walks(
            lambda: bank.score(tables, xT))):
        torch.cuda.synchronize()
        assert torch.equal(got, want), walk
    assert bank.KERNEL_LAUNCHES == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("block_bytes", [bank.TREE_BLOCK_BYTES, SMALL_BLOCK])
@pytest.mark.parametrize("n", [1, 33, 4097, 70_001])
@pytest.mark.parametrize("name", FIXTURES)
def test_bank_kernel_equals_plain_on_card(monkeypatch, name, n, block_bytes,
                                          layout):
    """Both walks torch.equal to the plain version at ragged row counts,
    in both record layouts; with SMALL_BLOCK every tree is walked in
    global memory."""
    _need_card()
    monkeypatch.setattr(bank, "TREE_BLOCK_BYTES", block_bytes)
    pm, x_num, x_cat = fixture_case(name, rows=n, seed=n)
    tables = pack(pm.forest, pm.max_depth, layout, "cuda")
    check_bank_on_card(tables, xT_of(x_num, x_cat).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 257, 5000])
@pytest.mark.parametrize("name", SYNTHETIC)
def test_bank_kernel_synthetic_forests_on_card(name, n):
    """Deep chains, W = 0, codes past the words and negative, a tree
    larger than a tree block (walked in global memory), ids past a narrow
    record's bits and shared subtrees (wide records), a tile too wide for
    shared memory (xT read directly)."""
    _need_card()
    _, forest, max_depth, x_num, x_cat = synthetic_case(name, n, seed=n)
    tables = bank.make_tables(forest, max_depth, "cuda")
    xT = xT_of(x_num, x_cat).cuda()
    check_bank_on_card(tables, xT)
    wide = torch.cat([xT, torch.zeros(30_000, n, device="cuda")])
    check_bank_on_card(tables._replace(num_features=wide.shape[0]), wide)


def vs_case(n, L, D, A, seed, closer=None):
    values, lengths, anchors, is_closer = chip_smoke.vs_random_case(
        n, L, D, A, False, seed)
    if closer is not None:
        is_closer = torch.from_numpy(closer).to(is_closer.device)
    return values, lengths, anchors, is_closer


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1024, 4097, 200_000])
def test_vs_kernel_bitwise_at_the_path_shapes_on_card(n):
    """L = D = 16, 32 anchors (16 closer-than then 16 projected, as the
    learner draws them) and 16 anchors: torch.equal to the plain version,
    whose arithmetic is the kernel's."""
    _need_card()
    closer = np.arange(32) < 16
    for A, kinds in ((32, closer), (16, closer[8:24])):
        args = vs_case(n, 16, 16, A, seed=n, closer=kinds)
        before = vso.KERNEL_LAUNCHES
        got = vso.vs_scores(*args)
        torch.cuda.synchronize()
        assert vso.KERNEL_LAUNCHES == before + 1
        assert torch.equal(got, vso.vs_scores_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (333, 16, 16, 32, "shuffled"), (70, 16, 16, 33, "alternate"),
    (513, 9, 5, 1, "random"), (300, 7, 3, 70, "random"),
    (129, 40, 40, 32, "random"), (150, 40, 16, 32, "random"),
    (257, 20, 16, 48, "random"),
    (100, 3, 16, 32, "misaligned")])
def test_vs_kernel_ragged_on_card(case):
    """Ragged rows, D != 16 (the generic instantiation), anchor kinds in
    any order, more than 32 anchors (two passes), sequences longer than
    a warp's 32-vector chunk, and values not 16-byte aligned (D = 16
    read through the generic instantiation): torch.equal to plain
    (its arithmetic is the kernel's at every shape), empty rows
    -FLT_MAX."""
    _need_card()
    n, L, D, A, kinds = case
    rng = np.random.default_rng(n)
    closer = {"shuffled": rng.permutation(np.arange(A) < A // 2),
              "alternate": np.arange(A) % 2 == 0,
              "random": None, "misaligned": np.arange(A) >= A // 2}[kinds]
    args = vs_case(n, L, D, A, seed=n, closer=closer)
    if kinds == "misaligned":
        flat = torch.zeros(args[0].numel() + 1, device="cuda")
        flat[1:] = args[0].reshape(-1)
        values = flat[1:].view(args[0].shape)
        assert values.data_ptr() % 16 != 0
        args = (values,) + args[1:]
    chip_smoke.vs_check(args, f"case {case}")
