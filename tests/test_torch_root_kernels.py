"""The binning kernel's feature-major layout, the root histogram's
launch shape (csrc/binning.cu, csrc/histogram.cu) and the routed
kernel's f64 sums (csrc/histogram_routed.cu), held against the JAX
package where it has the function.

  * the plain binning's [n, F] bins are the view of a contiguous
    [F, n] and equal the JAX package's bin_columns_jit, bitwise (NaN,
    nb = 0, 1 and 255, ragged n);
  * root_launch_shape at train_bench's and train_vs's shapes and at
    L = 1, 16, 32, 100: a block's sub-histogram fits its budget, the
    grid fills the card, feature groups are balanced (the routed
    kernel's routed_launch_shape is held in
    tests/test_torch_kernel_redesign.py);
  * on the card (marked gpu): the root histogram on a pile-up case (12%
    of the rows in bin 0 of every feature) against its plain version,
    the binning kernel against its plain version, and the routed
    kernel's f32 results at most one ulp from the plain f64 sums.

On a machine with a card but without JAX (tests/conftest.py imports it):
    python -m pytest --noconftest -m gpu tests/test_torch_*.py
"""

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax.numpy as jnp

    from ydf_tpu.ops.binning_pallas import bin_columns_jit
except ImportError:
    bin_columns_jit = None

from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import Dataset
from ydf_tpu_torch.ops import binning as port_binning
from ydf_tpu_torch.ops import histogram_kernels as hk

torch.set_num_threads(1)

# (n, F) of the training paths: train_bench and train_vs (28 numerical
# features; 4 numerical + 32 vector-sequence candidate columns).
PATH_SHAPES = {"train_bench": (500_000, 28), "train_vs": (200_000, 36)}
B, SQ = 256, 3


def binning_case(n, nbs, seed):
    """values f32 [F, n] with NaNs, values on boundaries and +-inf;
    boundaries [F, 255] ascending, +inf past nbs[f]; feature 0 imputes
    NaN (its NaNs bin to nb)."""
    rng = np.random.default_rng(seed)
    F, max_b = len(nbs), 255
    nb = np.asarray(nbs, np.int32)
    bounds = np.full((F, max_b), np.inf, np.float32)
    for f in range(F):
        bounds[f, :nb[f]] = np.sort(rng.choice(
            np.linspace(-3, 3, 1021).astype(np.float32), nb[f],
            replace=False))
    values = rng.normal(size=(F, n)).astype(np.float32)
    pick = rng.integers(0, max_b, (F, n))
    edge = np.take_along_axis(bounds, pick, axis=1)
    on_edge = (rng.uniform(size=(F, n)) < 0.1) & np.isfinite(edge)
    values = np.where(on_edge, edge, values)
    values[rng.uniform(size=(F, n)) < 0.05] = np.nan
    values[:, :1] = np.inf
    values[:, -1:] = -np.inf
    impute = rng.normal(size=F).astype(np.float32)
    impute[0] = np.nan
    return values, bounds, nb, impute


NB_CASES = {"nb_0_1_255": [0, 1, 255, 17, 254], "all_255": [255] * 3,
            "all_0": [0, 0]}


@pytest.mark.parametrize("n", [1, 15, 17, 3001])
@pytest.mark.parametrize("nbs", list(NB_CASES))
def test_binning_is_feature_major_and_matches_jax(nbs, n):
    args = binning_case(n, NB_CASES[nbs], seed=n)
    t = [torch.from_numpy(a) for a in args]
    rows = port_binning.bin_columns(*t)
    cols = rows.t()
    assert cols.dtype == torch.uint8 and tuple(cols.shape) == (len(args[2]),
                                                               n)
    assert cols.is_contiguous()
    if bin_columns_jit is not None:
        want = np.asarray(bin_columns_jit(*(jnp.asarray(a) for a in args)))
        assert np.array_equal(rows.numpy(), want)
    # NaN on the NaN-imputing feature bins to its nb.
    assert (cols[0][torch.from_numpy(np.isnan(args[0][0]))]
            == int(args[2][0])).all()


def test_binner_transform_is_a_view_of_feature_major_bins():
    rng = np.random.default_rng(3)
    data = {f"x{i}": rng.normal(size=700).astype(np.float32)
            for i in range(3)}
    data["x1"][::7] = np.nan
    ds = Dataset.from_data(data)
    binner = Binner.fit(ds, list(data), num_bins=64)
    rows = binner.transform(ds, torch.device("cpu"))
    assert tuple(rows.shape) == (700, 3) and rows.t().is_contiguous()
    values = np.stack([data[f] for f in binner.feature_names])
    want = port_binning.bin_columns(*(torch.from_numpy(a) for a in (
        values, binner.boundaries, binner.feature_num_bins - 1,
        binner.impute_values)))
    assert torch.equal(rows, want)


def _smem_bytes(shape, B, Sq):
    """A block's shared memory as histogram.cu sizes it: sub-histogram
    and its one-byte tags, the staged tile's stats and slots (a padding
    word per lane)."""
    tile_words = lambda s: 32 * (hk.ROWS_PER_LANE * s + 1)  # noqa: E731
    return ((shape.Fb * shape.Lb * B * hk.cell_stride(Sq) + tile_words(Sq)
             + tile_words(1)) * 4 + shape.Fb * shape.Lb * B)


@pytest.mark.parametrize("L", [1, 16, 32, 100])
@pytest.mark.parametrize("path", list(PATH_SHAPES))
def test_root_launch_shape_fills_the_card_in_balanced_blocks(path, L):
    n, F = PATH_SHAPES[path]
    shape = hk.root_launch_shape(n, F, L, B, SQ)
    # A block's sub-histogram and tags fit the budget, the block 48 KB.
    assert (shape.Fb * shape.Lb * B * (hk.cell_stride(SQ) * 4 + 1)
            <= hk.ROOT_SMEM_BUDGET)
    assert _smem_bytes(shape, B, SQ) <= 48 * 1024
    assert 1 <= shape.Fb <= hk.ROOT_MAX_WARPS
    # At least 4 blocks and 32 warps for each of the 132 SMs.
    assert shape.blocks >= 4 * hk.SMS
    assert shape.blocks * shape.Fb >= 32 * hk.SMS
    # Feature groups all the same size (F = 28 and 36 split evenly), and
    # no group larger than a block's warps.
    sizes = [(g + 1) * F // shape.G - g * F // shape.G
             for g in range(shape.G)]
    assert len(set(sizes)) == 1 and sizes[0] == shape.Fb
    assert shape.slot_blocks * shape.Lb >= L
    assert (shape.slot_blocks - 1) * shape.Lb < L
    # Row chunks cover n, start on 16-row boundaries, none empty.
    assert shape.rows % hk.ROWS_PER_LANE == 0
    assert shape.chunks * shape.rows >= n > (shape.chunks - 1) * shape.rows


def test_root_launch_shape_at_the_paths_root_layer():
    """The root layer's shapes (L = 1): 28 features in 4 groups of 7 and
    36 in 6 of 6, not 32 + 4."""
    bench = hk.root_launch_shape(500_000, 28, 1, B, SQ)
    vs = hk.root_launch_shape(200_000, 36, 1, B, SQ)
    assert (bench.G, bench.Fb, bench.Lb) == (4, 7, 1)
    assert (vs.G, vs.Fb, vs.Lb) == (6, 6, 1)


@pytest.mark.parametrize("n", [1, 100, 4097, 70_001])
@pytest.mark.parametrize("F", [1, 5, 33])
@pytest.mark.parametrize("Sq", [1, 3, 6, 8])
def test_root_launch_shape_small_and_ragged(n, F, Sq):
    """Every shape the wrapper can ask for is one the kernel takes."""
    for L, Bn in ((1, 256), (7, 64), (100, 256)):
        shape = hk.root_launch_shape(n, F, L, Bn, Sq)
        assert _smem_bytes(shape, Bn, Sq) <= 48 * 1024
        assert -(-F // shape.G) <= shape.Fb <= hk.ROOT_MAX_WARPS
        sizes = [(g + 1) * F // shape.G - g * F // shape.G
                 for g in range(shape.G)]
        assert max(sizes) - min(sizes) <= 1
        assert shape.chunks * shape.rows >= n > (shape.chunks - 1) * shape.rows


# ---- on the card -------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def pileup_case(n, F, seed):
    """bins u8 [F, n] with 12% of the rows in bin 0 of every feature;
    integer-valued and real-valued f32 stats [n, 3]."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (F, n)).astype(np.uint8)
    bins[:, rng.uniform(size=n) < 0.12] = 0
    ints = rng.integers(-8, 9, (n, SQ)).astype(np.float32)
    real = rng.normal(size=(n, SQ)).astype(np.float32)
    return bins, ints, real


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_root_histogram_pileup_on_card(kind):
    """train_vs's root shape (F = 36, n = 200,000) with the empty-sequence
    pile-up in bin 0: integer-valued stats make every sum exact, so the
    kernel equals the plain version bitwise in each type."""
    _need_card()
    bins, ints, _ = pileup_case(200_000, 36, seed=4)
    bins_t = torch.from_numpy(bins).cuda()
    slot = torch.zeros(bins.shape[1], dtype=torch.int32, device="cuda")
    stats = torch.from_numpy(ints).cuda()
    stats = {"f32": stats, "bf16": stats.to(torch.bfloat16),
             "int8": stats.to(torch.int8)}[kind]
    before = hk.LAUNCHES["histogram"]
    got = hk.histogram(bins_t, slot, stats, 1, B)
    torch.cuda.synchronize()
    assert hk.LAUNCHES["histogram"] == before + 1
    want = hk.histogram_plain(bins_t, slot, stats, 1, B)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(want[0, :, 0, 0].abs().sum()) > 0


@pytest.mark.gpu
def test_root_histogram_pileup_f32_tolerance_on_card():
    """Real-valued f32 stats on the pile-up case: each cell within
    HIST_RTOL x (sum of |terms|) + HIST_ATOL of the f64 plain sum."""
    _need_card()
    bins, _, real = pileup_case(200_000, 36, seed=5)
    bins_t = torch.from_numpy(bins).cuda()
    slot = torch.zeros(bins.shape[1], dtype=torch.int32, device="cuda")
    stats = torch.from_numpy(real).cuda()
    got = hk.histogram(bins_t, slot, stats, 1, B)
    want = hk.histogram_plain(bins_t, slot, stats, 1, B)
    mass = hk.histogram_plain(bins_t, slot, stats.abs(), 1, B)
    assert torch.all((got - want).abs() <= 1e-5 * mass + 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("n", [3000, 200_000])
def test_routed_kernel_f64_sums_on_card(n, kind):
    """The routed kernel on real-valued stats (vs_small's 3,000 rows, one
    chunk; train_vs's 200,000): its f64 cells and partials round once to
    f32, so each cell is the plain version's f64 sum or one f32 ulp from
    it (when the two summation orders straddle a rounding boundary)."""
    _need_card()
    rng = np.random.default_rng(n)
    F, L, Lh = 36, 32, 16
    bins = rng.integers(0, B, (F, n)).astype(np.uint8)
    bins[:, rng.uniform(size=n) < 0.12] = 0
    do_split = np.zeros(L + 1, bool)
    do_split[:Lh] = True
    rank = np.where(do_split, np.arange(L + 1), 0).astype(np.int32)
    hmap = np.full(L + 1, Lh, np.int32)
    hmap[2 * np.arange(Lh)] = np.arange(Lh)
    cut = rng.integers(32, 224, L + 1)
    left = np.where(do_split, 31 + 2 * np.arange(L + 1), 127)
    tables = hk.RouteTables(*(torch.from_numpy(a).cuda() for a in (
        do_split, rng.integers(0, F, L + 1).astype(np.int32),
        np.arange(B)[None, :] <= cut[:, None], left.astype(np.int32),
        np.where(do_split, left + 1, 127).astype(np.int32), rank, hmap,
        np.zeros(L + 1, bool), np.zeros(1, np.uint8))))
    slot = torch.from_numpy(rng.integers(0, Lh, n).astype(np.int32)).cuda()
    leaf = torch.from_numpy(rng.integers(15, 31, n).astype(np.int32)).cuda()
    stats = torch.from_numpy(rng.normal(size=(n, SQ)).astype(
        np.float32)).cuda()
    if kind == "bf16":
        stats = stats.to(torch.bfloat16)
    args = (torch.from_numpy(bins).cuda(), slot, leaf, tables, stats, Lh, B)
    got = hk.histogram_routed(*args)
    want = hk.histogram_routed_plain(*args)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    h, w = got[0], want[0]
    assert h.dtype == torch.float32 and int((w != 0).sum()) > 0
    assert torch.all((h == w) | (h == torch.nextafter(w, h)))


@pytest.mark.gpu
@pytest.mark.parametrize("n, F", [(1, 28), (255, 28), (257, 28),
                                  (100_003, 28), (500_000, 28),
                                  (200_000, 4)])
def test_binning_feature_major_kernel_on_card(n, F):
    """The kernel against its plain version at ragged n and at the
    paths' shapes (train_bench 500,000 x 28, train_vs 200,000 x 4), its
    bins feature-major in memory."""
    _need_card()
    nbs = [255, 0, 1] + [int(v) for v in
                         np.random.default_rng(F).integers(0, 256, F - 3)]
    args = [torch.from_numpy(a).cuda()
            for a in binning_case(n, nbs[:F], seed=n)]
    before = port_binning.KERNEL_LAUNCHES
    got = port_binning.bin_columns(*args)
    torch.cuda.synchronize()
    assert port_binning.KERNEL_LAUNCHES == before + 1
    assert tuple(got.shape) == (n, F) and got.t().is_contiguous()
    assert torch.equal(got, port_binning.bin_columns_plain(*args))
