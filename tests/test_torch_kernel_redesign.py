"""The redesigned QuickScorer and fused route + histogram kernels
(csrc/quickscorer.cu, csrc/histogram_routed.cu): their host-side layouts
held against the JAX package, and the kernels against their plain
versions on the card.

  * pack_tables: the packed QuickScorer tables (tree blocks, 16-byte
    records, each tree's categorical conditions folded into one mask
    table for each feature) read back to the same function: the plain
    version over them equals the JAX QuickScorer in Pallas interpret mode
    bitwise, on the trained models of tests/test_torch_kernels.py and on
    synthetic forests with single-leaf trees, 64-leaf trees, a ragged
    last tree block, with and without categorical conditions;
  * routed_launch_shape at train_bench's and train_vs's shapes and every
    hist-slot count of their layers: the block fits shared memory, the
    chunks cover every row, the feature groups are balanced and the grid
    fills the card;
  * on the card (marked gpu): the QuickScorer kernel torch.equal to its
    plain version at ragged row counts on gbt_d6 and synthetic forests
    (one too wide for the shared tile), and the routed kernel at every
    hist-slot count with f32, bf16 and int8 stats, all-trash rows and the
    set-split override.

On a machine with a card but without JAX (tests/conftest.py imports it):
    python -m pytest --noconftest -m gpu tests/test_torch_*.py
"""

import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    from test_torch_kernels import encoded, make_queries, models  # noqa: F401

    from ydf_tpu.serving import quickscorer as jax_qs
except ImportError:
    jax_qs = None

    @pytest.fixture
    def models():
        pytest.skip("needs the JAX package, the reference")

import ydf_tpu_torch
from ydf_tpu_torch.ops import histogram_kernels as hk
from ydf_tpu_torch.serving import quickscorer as qs

torch.set_num_threads(1)
TESTDATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ydf_tpu_torch", "testdata")

# Synthetic forests: (trees, numerical features, categorical features,
# bitmap words, share of categorical conditions, leaf counts cycled over
# the trees; 0 = random in 2..64).
FORESTS = {
    "ragged": (37, 5, 2, 2, 0.3, (1, 64, 0, 0, 3)),
    "numerical": (23, 6, 0, 0, 0.0, (0, 64, 1)),
    "cat_heavy": (41, 3, 4, 8, 0.8, (0, 0, 64)),
    # Too many features for the kernel's shared tile: read from xT.
    "wide": (19, 500, 3, 1, 0.2, (0, 64)),
}
# A tree block of a few hundred bytes: many ragged tree blocks.
SMALL_BLOCK = 700
# Shared memory of one H100 SM, bytes (a block reserves 1 KB of it).
SM_SMEM = 233_472


def random_forest(name, seed=0):
    """A QuickScorerModel (the port's; the JAX package's has the same
    fields) of random trees, compiled as compile_forest does: conditions
    in post-order, leaves numbered left to right."""
    T, Fn, Fc, W, cat_share, leaf_counts = FORESTS[name]
    rng = np.random.default_rng(seed)
    feat, thr, lo_m, hi_m, tree_of, is_cat, bms = [], [], [], [], [], [], []
    leaf_values = np.zeros((T, qs.MAX_LEAVES), np.float32)
    full = (1 << 64) - 1
    for t in range(T):
        k = leaf_counts[t % len(leaf_counts)] or int(rng.integers(2, 65))
        nxt = [0]

        def build(k):
            if k == 1:
                leaf_values[t, nxt[0]] = rng.normal()
                nxt[0] += 1
                return nxt[0] - 1, nxt[0]
            kl = int(rng.integers(1, k))
            llo, lhi = build(kl)
            _, rhi = build(k - kl)
            cat = Fc > 0 and rng.uniform() < cat_share
            feat.append(Fn + int(rng.integers(0, Fc)) if cat
                        else int(rng.integers(0, Fn)))
            thr.append(np.float32(rng.normal()) if not cat else 0.0)
            mask = full ^ (((1 << lhi) - 1) ^ ((1 << llo) - 1))
            lo_m.append(mask & 0xFFFFFFFF)
            hi_m.append(mask >> 32)
            tree_of.append(t)
            is_cat.append(int(cat))
            bms.append(rng.integers(0, 2**32, W, dtype=np.uint64)
                       if cat else np.zeros(W, np.uint64))
            return llo, rhi

        build(k)
    C = len(feat)
    return qs.QuickScorerModel(
        cond_feature=np.asarray(feat, np.int32),
        cond_thresh=np.asarray(thr, np.float32),
        cond_mask_lo=np.asarray(lo_m, np.uint32),
        cond_mask_hi=np.asarray(hi_m, np.uint32),
        cond_tree=np.asarray(tree_of, np.int32),
        cond_is_cat=np.asarray(is_cat, np.int32),
        cond_bitmap=(np.asarray(bms, np.uint32).reshape(C, W) if W
                     else np.zeros((C, 0), np.uint32)),
        leaf_values=leaf_values,
        num_trees=T,
    )


def random_inputs(name, n, seed=1):
    """x_num f32 [n, Fn] with NaNs, x_cat i32 [n, Fc] with codes inside
    and outside the bitmaps (and -1, missing)."""
    _, Fn, Fc, W, _, _ = FORESTS[name]
    rng = np.random.default_rng(seed)
    x_num = rng.normal(size=(n, Fn)).astype(np.float32)
    x_num[rng.uniform(size=x_num.shape) < 0.05] = np.nan
    x_cat = rng.integers(-1, 32 * max(W, 1) + 5, (n, Fc)).astype(np.int32)
    return x_num, x_cat


def xT_of(x_num, x_cat):
    return qs.feature_major(torch.from_numpy(x_num), torch.from_numpy(x_cat))


def check_packed(qsm, tables, block_bytes):
    """The packed layout's invariants: 16-byte records, each tree's
    numerical records (sorted by feature) before its categorical groups
    (one per feature it tests, in feature order), each group's table of
    codes + 1 entries inside its tree block, tree blocks within their
    bytes (or one tree alone)."""
    T = qsm.num_trees
    rec = tables.rec.numpy().view(np.uint32)
    off = tables.tree_off.numpy()
    num_end = tables.num_end.numpy()
    bt = tables.block_tree.numpy()
    bm = tables.block_mask.numpy()
    W = qsm.cond_bitmap.shape[1]
    entries = tables.codes + 1
    assert tables.codes == 32 * W and rec.shape[1] * rec.itemsize == 16
    assert tables.masks.shape == (bm[-1], 2)
    assert bt[0] == 0 and bt[-1] == T and np.all(np.diff(bt) >= 1)
    is_cat = (qsm.cond_is_cat == 1) & (W > 0)
    for b in range(len(bt) - 1):
        t0, t1 = bt[b], bt[b + 1]
        nbytes = ((off[t1] - off[t0]) * 16 + (t1 - t0) * qs.MAX_LEAVES * 4
                  + (bm[b + 1] - bm[b]) * 8)
        assert nbytes <= block_bytes or t1 - t0 == 1
        assert nbytes <= tables.buf_bytes and tables.buf_bytes % 16 == 0
        for t in range(t0, t1):
            mine = qsm.cond_tree == t
            assert num_end[t] - off[t] == int((mine & ~is_cat).sum())
            groups = rec[num_end[t]:off[t + 1]]
            assert np.array_equal(groups[:, 0], np.unique(
                qsm.cond_feature[mine & is_cat]))
            assert np.all(np.diff(rec[off[t]:num_end[t], 0].astype(
                np.int64)) >= 0)
            assert np.all(groups[:, 1] + entries <= bm[b + 1] - bm[b])
            assert np.all(groups[:, 0] >= tables.cat_from)


def require_jax():
    if jax_qs is None:
        pytest.skip("needs the JAX package, the reference")


# --------------------------------------------------------------------- #
# Packed QuickScorer tables, on the CPU
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("block_bytes", [qs.TREE_BLOCK_BYTES, SMALL_BLOCK])
@pytest.mark.parametrize("name", ["num_d4", "mix_d6"])
def test_packed_tables_read_back_to_jax(models, name, block_bytes):
    """The trained models: the plain version over the packed tables equals
    the JAX QuickScorer in interpret mode bitwise."""
    require_jax()
    m, pm = models[name]
    qsm = qs.compile_forest(pm.forest, pm.binner.num_numerical,
                            num_features=pm.binner.num_scalar)
    tables = qs.make_tables(qsm, "cpu", block_bytes)
    check_packed(qsm, tables, block_bytes)
    if block_bytes == SMALL_BLOCK:
        assert tables.block_tree.numel() - 1 >= 3
    x_num, x_cat = encoded(m, make_queries(n=600))
    want = np.asarray(jax_qs.build_quickscorer(m, interpret=True)(x_num,
                                                                   x_cat))
    got = qs.score_plain(tables, xT_of(x_num, x_cat)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", [1, 31, 257])
@pytest.mark.parametrize("name", ["ragged", "numerical", "cat_heavy"])
def test_synthetic_forest_matches_jax(name, n):
    """Single-leaf trees, 64-leaf trees, a tree count that no tree block
    divides (small blocks make the last one ragged), categorical codes
    outside the bitmaps: the plain version over the packed tables equals
    the JAX QuickScorer bitwise."""
    require_jax()
    qsm = random_forest(name)
    Fn = FORESTS[name][1]
    tables = qs.make_tables(qsm, "cpu", SMALL_BLOCK)
    check_packed(qsm, tables, SMALL_BLOCK)
    x_num, x_cat = random_inputs(name, n)
    eng = jax_qs.QuickScorerEngine(jax_qs.QuickScorerModel(**qsm._asdict()),
                                   Fn, interpret=True)
    want = np.asarray(eng(x_num, x_cat if x_cat.shape[1] else None))
    got = qs.score_plain(tables, xT_of(x_num, x_cat)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", list(FORESTS))
def test_pack_tables_blocks_and_launch_shape(name):
    """Every tree in exactly one tree block, the last one ragged; the
    launch shape's tile fits the kernel's shared memory beside the two
    tree-block buffers (the wide forest reads xT instead)."""
    qsm = random_forest(name)
    for block_bytes in (qs.TREE_BLOCK_BYTES, SMALL_BLOCK):
        tables = qs.make_tables(qsm, "cpu", block_bytes)
        check_packed(qsm, tables, block_bytes)
        shape = qs.launch_shape(tables)
        assert shape.smem <= qs.SMEM_LIMIT
        assert 32 <= shape.threads <= qs.MAX_THREADS
        assert shape.threads % 32 == 0
        assert shape.tile == (name != "wide")
        if shape.tile:
            buffers = 2 * tables.buf_bytes
            assert shape.smem == buffers + (tables.num_features
                                            * shape.examples * 4)
    blocks = qs.make_tables(qsm, "cpu", SMALL_BLOCK).block_tree.numel() - 1
    assert blocks >= 3


def test_gbt_d6_packs_into_two_blocks_an_sm():
    """The default GBT's tables: its 300 trees in tree blocks whose two
    buffers and a 512-example tile of its 32 rows fit two blocks on an
    SM."""
    pm = ydf_tpu_torch.load_model(os.path.join(TESTDATA, "gbt_d6"),
                                  device="cpu")
    tables = qs.build_quickscorer(pm).tables
    shape = qs.launch_shape(tables)
    assert tables.num_features == 32 and tables.cat_from == 28
    assert shape.tile and shape.examples == 512
    assert 2 * (shape.smem + 1024) <= SM_SMEM


# --------------------------------------------------------------------- #
# routed_launch_shape, on the CPU
# --------------------------------------------------------------------- #

PATH_SHAPES = {"train_bench": (500_000, 28), "train_vs": (200_000, 36)}
B, SQ, L = 256, 3, 32


@pytest.mark.parametrize("cell_bytes", [8, 4])  # float stats; int8 stats
@pytest.mark.parametrize("Lh", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("path", list(PATH_SHAPES))
def test_routed_launch_shape_fills_the_card(path, Lh, cell_bytes):
    n, F = PATH_SHAPES[path]
    s = hk.routed_launch_shape(n, F, Lh, B, SQ, L, cell_bytes)
    # The block fits the shared memory it opts into, and a warp a pair.
    assert s.smem == hk.routed_smem_bytes(s.Fb, s.Lb, B, SQ, L, cell_bytes)
    assert s.smem <= hk.ROUTED_SMEM_LIMIT
    assert 1 <= s.Fb * s.Lb <= hk.ROUTED_MAX_PAIRS
    # Every hist slot in one block: a row is routed once per group.
    assert s.Lb == Lh and s.slot_blocks == 1
    # Feature groups of one size (F = 28 and 36 split evenly).
    sizes = [(g + 1) * F // s.G - g * F // s.G for g in range(s.G)]
    assert len(set(sizes)) == 1 and sizes[0] == s.Fb
    # One wave (a block an SM) that fills at least 90% of the card's SMs.
    assert 0.9 * hk.SMS <= s.blocks <= hk.SMS
    # Row chunks cover n, none empty, on 16-row boundaries.
    assert s.rows % hk.ROWS_PER_LANE == 0
    assert s.chunks * s.rows >= n > (s.chunks - 1) * s.rows


@pytest.mark.parametrize("n", [1, 1000, 70_001])
@pytest.mark.parametrize("F", [1, 5, 33])
@pytest.mark.parametrize("Lh", [0, 3, 40])
def test_routed_launch_shape_small_and_ragged(n, F, Lh):
    """Every shape the wrapper can ask for is one the kernel takes."""
    for Sq, cell in ((3, 8), (8, 8), (1, 4)):
        s = hk.routed_launch_shape(n, F, Lh, B, Sq, L, cell)
        assert s.smem <= hk.ROUTED_SMEM_LIMIT
        assert 1 <= s.Fb * s.Lb <= hk.ROUTED_MAX_PAIRS
        assert -(-F // s.G) <= s.Fb
        assert s.slot_blocks * s.Lb >= Lh
        assert s.chunks * s.rows >= n > (s.chunks - 1) * s.rows


# --------------------------------------------------------------------- #
# On the card (skip without one)
# --------------------------------------------------------------------- #


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _gbt_d6_xT(n):
    pm = ydf_tpu_torch.load_model(os.path.join(TESTDATA, "gbt_d6"))
    req = dict(np.load(os.path.join(TESTDATA, "gbt_d6", "requests.npz")))
    idx = np.random.default_rng(n).integers(0, 1024, n)
    from ydf_tpu_torch.dataset.dataset import Dataset

    x_num, x_cat = pm._encode_inputs(
        Dataset.from_data({k: v[idx] for k, v in req.items()}, pm.dataspec))
    return qs.build_quickscorer(pm).tables, xT_of(x_num, x_cat).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 257, 100_003])
@pytest.mark.parametrize("name", ["gbt_d6", "ragged", "cat_heavy", "wide"])
def test_quickscorer_kernel_equals_plain_on_card(name, n):
    """Bitwise equal to the plain version: the default GBT, a forest
    whose trees no tree block divides (small blocks), a categorical-heavy
    forest, and one too wide for the shared tile."""
    _need_card()
    if name == "gbt_d6":
        tables, xT = _gbt_d6_xT(n)
    else:
        qsm = random_forest(name)
        tables = qs.make_tables(qsm, "cuda", SMALL_BLOCK if name == "ragged"
                                else qs.TREE_BLOCK_BYTES)
        xT = xT_of(*random_inputs(name, n, seed=n)).cuda()
    before = qs.KERNEL_LAUNCHES
    got = qs.score(tables, xT)
    torch.cuda.synchronize()
    assert qs.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, qs.score_plain(tables, xT))


def routed_inputs(n, F, Lh, kind, seed, all_trash=False):
    """A fused layer at full width (L = 32): the previous layer's tables
    with a categorical-set split (its direction from set_go_left) among
    ten splits, rows on live and trash slots (all on the trash slot with
    all_trash), real-valued stats (integer-valued for int8), on the
    card."""
    rng = np.random.default_rng(seed)
    do_split = np.zeros(L + 1, bool)
    do_split[rng.choice(L, 10, replace=False)] = True
    split_rank = np.zeros(L + 1, np.int32)
    split_rank[do_split] = np.arange(10)
    hmap = (rng.integers(0, Lh, L + 1) if Lh else
            np.zeros(L + 1, np.int64)).astype(np.int32)
    hmap[rng.uniform(size=L + 1) < 0.3] = Lh  # some children not histogrammed
    hmap[L] = Lh
    is_set = np.zeros(L + 1, bool)
    is_set[np.flatnonzero(do_split)[0]] = True
    tables = hk.RouteTables(*(torch.from_numpy(a).cuda() for a in (
        do_split, rng.integers(0, F, L + 1).astype(np.int32),
        rng.uniform(size=(L + 1, B)) < 0.5,
        rng.integers(0, 60, L + 1).astype(np.int32),
        rng.integers(0, 60, L + 1).astype(np.int32), split_rank, hmap,
        is_set, rng.integers(0, 2, n).astype(np.uint8))))
    slot = np.full(n, L, np.int32) if all_trash else rng.integers(
        0, L + 1, n).astype(np.int32)
    if kind == "int8":
        stats = torch.from_numpy(rng.integers(-100, 101, (n, SQ)).astype(
            np.int8))
    else:
        stats = torch.from_numpy(rng.normal(size=(n, SQ)).astype(np.float32))
        if kind == "bf16":
            stats = stats.to(torch.bfloat16)
    return (torch.from_numpy(rng.integers(0, B, (F, n)).astype(
                np.uint8)).cuda(),
            torch.from_numpy(slot).cuda(),
            torch.from_numpy(rng.integers(0, 60, n).astype(np.int32)).cuda(),
            tables, stats.cuda(), Lh, B)


def check_routed(args, kind):
    before = hk.LAUNCHES["histogram_routed"]
    got = hk.histogram_routed(*args)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["histogram_routed"] == before + 1
    want = hk.histogram_routed_plain(*args)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[0].dtype == want[0].dtype
    if kind == "int8":
        assert torch.equal(got[0], want[0])
    else:
        abs_args = list(args)
        abs_args[4] = args[4].abs()
        mass = hk.histogram_routed_plain(*abs_args)[0]
        assert torch.all((got[0] - want[0]).abs() <= 1e-5 * mass + 1e-6)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("Lh", [0, 1, 2, 4, 8, 16])
def test_routed_kernel_every_layer_on_card(Lh, kind):
    """Every hist-slot count of the path's layers (and none), 70,001 rows
    at train_bench's width: new_slot and new_leaf torch.equal to plain,
    the histogram within 1e-5 x cell mass + 1e-6 (int8 bitwise)."""
    _need_card()
    got, want = check_routed(routed_inputs(70_001, 28, Lh, kind, seed=Lh),
                             kind)
    assert got[0].shape == (Lh, 28, B, SQ)
    if Lh:
        assert int((want[0] != 0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_routed_kernel_all_trash_rows_on_card(kind):
    """Every row on the trash slot: nothing is histogrammed, every row
    keeps its leaf and goes to slot L."""
    _need_card()
    args = routed_inputs(4097, 36, 16, kind, seed=9, all_trash=True)
    got, _ = check_routed(args, kind)
    assert int(got[0].abs().sum()) == 0
    assert bool((got[1] == L).all()) and torch.equal(got[2], args[2])


# --------------------------------------------------------------------- #
# The C entry points, on the CPU
# --------------------------------------------------------------------- #


def test_entry_points_match_their_c_signatures():
    """Every wrapper declares its C entry point with the pointer and int
    counts of the extern "C" signature in csrc/ (a mismatch makes ctypes
    refuse the call, or pass pointers as 32-bit ints, only on the card),
    and every extern "C" entry point in csrc/ has such a wrapper."""
    import re

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ydf_tpu_torch")
    calls = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                calls += re.findall(
                    r'entry_point\(\s*"(\w+)",\s*"(\w+)",\s*(\d+),\s*(\d+)\)',
                    src)
    assert len(calls) >= 6
    # Every C entry point in csrc/ has a wrapper that declares it.
    declared = {(name, symbol) for name, symbol, _, _ in calls}
    for f in os.listdir(os.path.join(root, "csrc")):
        src = open(os.path.join(root, "csrc", f)).read()
        for symbol in re.findall(r'extern "C" int (\w+)\(', src):
            assert (f[:-3], symbol) in declared, (f, symbol)
    for name, symbol, n_ptr, n_int in calls:
        src = open(os.path.join(root, "csrc", f"{name}.cu")).read()
        sig = re.search(r'extern "C" int ' + symbol + r'\((.*?)\)', src,
                        re.S).group(1)
        params = [p.strip() for p in sig.split(",")]
        assert params[-1] == "void* stream", (symbol, params[-1])
        ptrs = sum("*" in p for p in params[:-1])
        ints = sum(p.startswith("int ") for p in params[:-1])
        assert ptrs + ints == len(params) - 1, (symbol, params)
        assert (ptrs, ints) == (int(n_ptr), int(n_int)), (symbol, ptrs, ints)


def test_tree_too_big_for_shared_memory_serves_on_the_bank():
    """A tree testing many categorical features of large vocabularies
    does not fit the kernel's shared memory: QuickScorer refuses the
    model (fits_shared_memory), so the registry never picks it there."""
    qsm = random_forest("cat_heavy")
    assert qs.fits_shared_memory(qsm)
    T, C = qsm.num_trees, qsm.cond_feature.size
    big = qsm._replace(
        cond_feature=np.arange(C, dtype=np.int32) % 40,
        cond_is_cat=np.ones(C, np.int32),
        cond_bitmap=np.zeros((C, 64), np.uint32))
    assert not qs.fits_shared_memory(big)
    with pytest.raises(ValueError, match="shared"):
        qs.launch_shape(qs.make_tables(big, "cpu"))
