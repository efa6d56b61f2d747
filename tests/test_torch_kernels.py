"""ydf_tpu_torch kernels held against the JAX package.

The same seeded numpy inputs go through the JAX function and its port:
  * compile_forest (QuickScorer host compile): every array equal;
  * the QuickScorer plain version against the JAX engine in Pallas
    interpret mode (depth 4 numerical-only, depth 6 mixed categorical);
  * the bank plain version against the JAX PallasBank engine in interpret
    mode (depth 6, and depth 8 with more than 64 leaves);
  * the routed plain engine against ops/routing.py:forest_predict_values;
  * the histogram, routed-histogram and binning plain versions against
    histogram_pallas, histogram_routed_pallas and binning_pallas in
    interpret mode (and bin_columns_jit).
All raw-score comparisons are bitwise: every engine adds one f32 per tree
in tree order, so no tolerance applies. The histogram comparisons are
bitwise too: their stats are integer-valued (the JAX package's
test_histogram_pallas idiom), so every f32 sum is exact in any order.

Tests marked `gpu` run the CUDA kernels and skip without a card. On a
machine with a card but without JAX (tests/conftest.py imports it):
    python -m pytest --noconftest -m gpu tests/test_torch_*.py
"""

import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.config import Task
    from ydf_tpu.dataset.dataset import Dataset as JaxDataset
    from ydf_tpu.ops import histogram as jax_histogram
    from ydf_tpu.ops.binning_pallas import bin_columns_jit, binning_pallas
    from ydf_tpu.ops.histogram_pallas import (
        histogram_pallas,
        histogram_routed_pallas,
    )
    from ydf_tpu.ops.routing import forest_predict_values as jax_routed
    from ydf_tpu.serving import quickscorer as jax_qs
    from ydf_tpu.serving.pallas_scorer import build_pallas_scorer
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.ops import binning as port_binning
from ydf_tpu_torch.ops import histogram as port_histogram
from ydf_tpu_torch.ops import histogram_kernels
from ydf_tpu_torch.ops.histogram_kernels import RouteTables
from ydf_tpu_torch.ops.routing import forest_predict_values
from ydf_tpu_torch.serving import bank_scorer, quickscorer
from ydf_tpu_torch.utils import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The suite runs in parallel workers: one intra-op thread per worker keeps
# these tests from crowding the timing-sensitive tests of other files.
torch.set_num_threads(1)
TESTDATA = os.path.join(REPO, "ydf_tpu_torch", "testdata")


def make_data(n, seed):
    """3 numerical columns with NaNs, 2 categorical columns, and both a
    regression and a binary label."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    c0 = rng.integers(0, 6, n)
    c1 = rng.integers(0, 40, n)
    logit = (x[:, 0] - x[:, 1] * x[:, 2] + 1.5 * (c0 == 1)
             - 1.2 * (c0 == 3) + 0.1 * (c1 % 7))
    data = {
        "n0": np.where(rng.uniform(size=n) < 0.08, np.nan, x[:, 0]),
        "n1": x[:, 1],
        "n2": np.where(rng.uniform(size=n) < 0.08, np.nan, x[:, 2]),
        "c0": np.array([f"a{v}" for v in c0]),
        "c1": np.array([f"b{v}" for v in c1]),
    }
    data["n0"] = data["n0"].astype(np.float32)
    data["n2"] = data["n2"].astype(np.float32)
    y_reg = (logit + rng.normal(0, 0.3, n)).astype(np.float32)
    y_cls = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    return data, y_reg, y_cls


def make_queries(n=1500, seed=11):
    """Scoring inputs: NaNs, missing ("") and unseen categories."""
    data, _, _ = make_data(n, seed)
    rng = np.random.default_rng(seed + 1)
    for c in ("c0", "c1"):
        col = data[c].astype("<U8")
        col[rng.uniform(size=n) < 0.05] = "unseen"
        col[rng.uniform(size=n) < 0.03] = ""
        data[c] = col
    return data


MODEL_SPECS = {
    # name: (task, numerical only, num_trees, max_depth)
    "num_d4": ("CLASSIFICATION", True, 12, 4),
    "mix_d6": ("REGRESSION", False, 12, 6),
    "mix_d8": ("CLASSIFICATION", False, 10, 8),
}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """name → (JAX model, port model on the CPU): the port loads what
    the JAX package saved."""
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")
    data, y_reg, y_cls = make_data(3000, seed=3)
    out = {}
    for name, (task, num_only, trees, depth) in MODEL_SPECS.items():
        task = Task(task)
        d = dict(data)
        d["y"] = y_reg if task == Task.REGRESSION else y_cls
        kw = {"features": ["n0", "n1", "n2"]} if num_only else {}
        m = ydf.GradientBoostedTreesLearner(
            label="y", task=task, num_trees=trees, max_depth=depth,
            validation_ratio=0.0, early_stopping="NONE", **kw,
        ).train(d)
        path = str(tmp_path_factory.mktemp(name))
        m.save(path)
        out[name] = (m, ydf_tpu_torch.load_model(path, device="cpu"))
    return out


def encoded(m, data):
    """The JAX package's encoding of `data`: (x_num, x_cat) numpy."""
    x_num, x_cat, _ = m._encode_inputs(
        JaxDataset.from_data(data, dataspec=m.dataspec)
    )
    return x_num, x_cat


def port_xT(x_num, x_cat):
    return quickscorer.feature_major(
        torch.from_numpy(x_num), torch.from_numpy(x_cat)
    )


def jax_raw(m, x_num, x_cat):
    return np.asarray(jax_routed(
        m.forest, jnp.asarray(x_num), jnp.asarray(x_cat),
        num_numerical=m.binner.num_numerical, max_depth=m.max_depth,
        combine="sum",
    ))[:, 0]


@pytest.mark.parametrize("name", list(MODEL_SPECS))
def test_compile_forest_matches_jax(models, name):
    m, pm = models[name]
    want = jax_qs.compile_forest(
        m.forest, m.binner.num_numerical,
        num_features=m.binner.num_scalar,
    )
    got = quickscorer.compile_forest(
        pm.forest, pm.binner.num_numerical,
        num_features=pm.binner.num_scalar,
    )
    if name == "mix_d8":
        assert want is None and got is None, "depth 8 fits 64 leaves?"
        return
    assert want is not None and got is not None
    for field in want._fields:
        a, b = getattr(want, field), getattr(got, field)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert np.array_equal(a, b), field
        else:
            assert a == b, field
    if name == "mix_d6":
        assert want.cond_is_cat.any(), "no categorical condition: vacuous"
    else:
        assert want.cond_bitmap.shape[1] == 0


@pytest.mark.parametrize("name", ["num_d4", "mix_d6"])
def test_quickscorer_plain_matches_jax_interpret(models, name):
    m, pm = models[name]
    x_num, x_cat = encoded(m, make_queries())
    eng = jax_qs.build_quickscorer(m, interpret=True)
    want = np.asarray(eng(x_num, x_cat))
    port = quickscorer.build_quickscorer(pm)
    got = port(torch.from_numpy(x_num), torch.from_numpy(x_cat)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, jax_raw(m, x_num, x_cat))


@pytest.mark.parametrize("name", ["mix_d6", "mix_d8"])
def test_bank_plain_matches_jax_interpret(models, name):
    m, pm = models[name]
    if name == "mix_d8":
        f = m.forest.to_numpy()
        real = np.arange(f["feature"].shape[1]) < f["num_nodes"][:, None]
        assert (f["is_leaf"] & real).sum(1).max() > 64
    x_num, x_cat = encoded(m, make_queries(n=700))
    want = np.asarray(build_pallas_scorer(m, interpret=True)(x_num, x_cat))
    port = bank_scorer.build_bank_scorer(pm)
    got = port(torch.from_numpy(x_num), torch.from_numpy(x_cat)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, jax_raw(m, x_num, x_cat))


@pytest.mark.parametrize("name", list(MODEL_SPECS))
def test_routed_matches_jax_oracle(models, name):
    m, pm = models[name]
    x_num, x_cat = encoded(m, make_queries())
    got = forest_predict_values(
        pm.forest, torch.from_numpy(x_num), torch.from_numpy(x_cat),
        num_numerical=pm.binner.num_numerical, max_depth=pm.max_depth,
    )[:, 0].numpy()
    assert np.array_equal(got, jax_raw(m, x_num, x_cat))


def test_routed_missing_values_follow_na_left(models):
    """Native missing semantics (NaN numerical, -1 categorical): each
    node's na_left direction, as in the JAX oracle."""
    m, _ = models["mix_d6"]
    f = m.forest.to_numpy()
    rng = np.random.default_rng(5)
    f["na_left"] = rng.uniform(size=f["na_left"].shape) < 0.5
    from ydf_tpu.models.forest import Forest as JaxForest

    jf = JaxForest.from_numpy(f)
    pf = ydf_tpu_torch.forest_from_jax(f)
    x_num, x_cat = encoded(m, make_queries(n=800))
    x_num = x_num.copy()
    x_cat = x_cat.copy()
    x_num[rng.uniform(size=x_num.shape) < 0.2] = np.nan
    x_cat[rng.uniform(size=x_cat.shape) < 0.2] = -1
    want = np.asarray(jax_routed(
        jf, jnp.asarray(x_num), jnp.asarray(x_cat),
        num_numerical=m.binner.num_numerical, max_depth=m.max_depth,
    ))
    got = forest_predict_values(
        pf, torch.from_numpy(x_num), torch.from_numpy(x_cat),
        num_numerical=m.binner.num_numerical, max_depth=m.max_depth,
    ).numpy()
    assert np.array_equal(got, want)
    mean_want = np.asarray(jax_routed(
        jf, jnp.asarray(x_num), jnp.asarray(x_cat),
        num_numerical=m.binner.num_numerical, max_depth=m.max_depth,
        combine="mean",
    ))
    mean_got = forest_predict_values(
        pf, torch.from_numpy(x_num), torch.from_numpy(x_cat),
        num_numerical=m.binner.num_numerical, max_depth=m.max_depth,
        combine="mean",
    ).numpy()
    assert np.array_equal(mean_got, mean_want)


def test_routed_rejects_unported_node_kinds(models):
    """Set nodes, the last node kind the routed engine lacked, route as
    the JAX package's since ROADMAP item 14c: every split of a model
    turned into a set node, random packed sets, the same sums."""
    jm, pm = models["mix_d6"]
    f = pm.forest.to_numpy()
    f["is_set"] = ~f["is_leaf"]
    rng = np.random.default_rng(2)
    W = f["cat_mask"].shape[-1]
    x_set = rng.integers(0, 2**32, (64, 1, W), dtype=np.uint32)
    x_set[::3] = 0  # empty sets: every set node sends them left
    x_num = rng.normal(size=(64, 3)).astype(np.float32)
    x_cat = rng.integers(0, 4, (64, 2)).astype(np.int32)
    got = forest_predict_values(
        ydf_tpu_torch.forest_from_jax(f), torch.from_numpy(x_num),
        torch.from_numpy(x_cat), num_numerical=3, max_depth=6,
        x_set=torch.from_numpy(x_set.view(np.int32))).numpy()
    jf = jm.forest._replace(is_set=jnp.asarray(f["is_set"]))
    want = np.asarray(jax_routed(jf, jnp.asarray(x_num), jnp.asarray(x_cat),
                                 num_numerical=3, max_depth=6,
                                 x_set=jnp.asarray(x_set)))
    assert np.array_equal(got, want)


def test_wrappers_check_their_input(models):
    _, pm = models["mix_d6"]
    qs = quickscorer.build_quickscorer(pm)
    bank = bank_scorer.build_bank_scorer(pm)
    too_narrow = torch.zeros(3, 10)  # numericals only: no categorical rows
    for fn, tables in ((quickscorer.score, qs.tables),
                       (bank_scorer.score, bank.tables)):
        with pytest.raises(ValueError, match="categorical"):
            fn(tables, too_narrow)
        with pytest.raises(ValueError, match="float32"):
            fn(tables, torch.zeros(5, 10, dtype=torch.float64))
        assert fn(tables, torch.zeros(5, 0)).shape == (0,)


def test_build_raises_naming_nvcc_when_missing(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(cuda_build, "DEFAULT_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build_all(["quickscorer"], force=True)


# --------------------------------------------------------------------- #
# On the card (skip without one)
# --------------------------------------------------------------------- #


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gbt_d6", "gbt_d8"])
@pytest.mark.parametrize("rows", [1, 255, 257, 4096])
def test_kernels_match_plain_on_card(name, rows):
    """Each kernel is bitwise equal to its plain version, ragged last
    block included, on the committed full-width fixtures."""
    _need_card()
    pm = ydf_tpu_torch.load_model(os.path.join(TESTDATA, name))
    req = dict(np.load(os.path.join(TESTDATA, name, "requests.npz")))
    idx = np.random.default_rng(rows).integers(0, 1024, rows)
    from ydf_tpu_torch.dataset.dataset import Dataset

    x_num, x_cat = pm._encode_inputs(
        Dataset.from_data({k: v[idx] for k, v in req.items()}, pm.dataspec)
    )
    xT = port_xT(x_num, x_cat).cuda()
    engines = [(bank_scorer, bank_scorer.build_bank_scorer(pm).tables)]
    qs = quickscorer.build_quickscorer(pm)
    if qs is not None:
        engines.append((quickscorer, qs.tables))
    for mod, tables in engines:
        before = mod.KERNEL_LAUNCHES
        got = mod.score(tables, xT)
        torch.cuda.synchronize()
        assert mod.KERNEL_LAUNCHES == before + 1
        assert torch.equal(got, mod.score_plain(tables, xT))


@pytest.mark.gpu
def test_wrappers_on_card_raise_on_what_they_do_not_take():
    _need_card()
    pm = ydf_tpu_torch.load_model(os.path.join(TESTDATA, "gbt_d6"))
    qs = quickscorer.build_quickscorer(pm).tables
    bank = bank_scorer.build_bank_scorer(pm).tables
    F = pm.binner.num_scalar
    on_cpu = {
        quickscorer: qs._replace(leaf_values=qs.leaf_values.cpu()),
        bank_scorer: bank._replace(words=bank.words.cpu()),
    }
    for mod, tables in ((quickscorer, qs), (bank_scorer, bank)):
        with pytest.raises(ValueError, match="contiguous"):
            mod.score(tables, torch.zeros(64, F, device="cuda").t())
        with pytest.raises(ValueError, match="the model on cpu"):
            mod.score(on_cpu[mod], torch.zeros(F, 64, device="cuda"))
        n0 = mod.KERNEL_LAUNCHES
        empty = mod.score(tables, torch.zeros(F, 0, device="cuda"))
        assert empty.numel() == 0 and mod.KERNEL_LAUNCHES == n0


# --------------------------------------------------------------------- #
# Training kernels: histogram, fused route + histogram, binning
# --------------------------------------------------------------------- #

QUANTS = ("f32", "bf16x2", "int8")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def hist_case(n, F, L, B, S, seed):
    """bins u8 [n, F], slot i32 [n] over the live slots and the trash
    slot L, INTEGER-valued f32 stats [n, S]: every f32 sum is exact."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (n, F)).astype(np.uint8)
    slot = rng.integers(0, L + 1, n).astype(np.int32)
    stats = rng.integers(-8, 9, (n, S)).astype(np.float32)
    return bins, slot, stats


def routed_case(n, F, B, L, Lh, S, seed, identity_hmap=False):
    """One fused layer: the previous layer's padded [L+1] tables (three
    splits, one of them a categorical-set split whose direction comes
    from set_go_left), rows on live and trash slots, integer stats.
    The tables are numpy, in the JAX kernel's argument order."""
    rng = np.random.default_rng(seed)
    do_split = np.zeros(L + 1, bool)
    do_split[[0, 2, 5]] = True
    split_rank = np.zeros(L + 1, np.int32)
    split_rank[[0, 2, 5]] = [0, 1, 2]
    if identity_hmap:
        hmap = np.arange(L + 1, dtype=np.int32)
    else:
        hmap = rng.integers(0, Lh, L + 1).astype(np.int32)
        hmap[L] = Lh
    is_set = np.zeros(L + 1, bool)
    is_set[2] = True
    tables = (
        do_split, rng.integers(0, F, L + 1).astype(np.int32),
        rng.integers(0, 2, (L + 1, B)).astype(bool),
        rng.integers(0, 30, L + 1).astype(np.int32),
        rng.integers(0, 30, L + 1).astype(np.int32), split_rank, hmap,
        is_set, rng.integers(0, 2, n).astype(np.uint8),
    )
    slot = rng.integers(0, L + 1, n).astype(np.int32)
    leaf = rng.integers(0, 30, n).astype(np.int32)
    bins = rng.integers(0, B, (n, F)).astype(np.uint8)
    stats = rng.integers(-8, 9, (n, S)).astype(np.float32)
    return bins, slot, leaf, tables, stats


def port_tables(tables, device="cpu"):
    return RouteTables(*(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                         for t in tables))


def jax_array(t):
    """A torch tensor as a jax array (bf16 through its bit pattern)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def port_operand(stats, quant):
    """The port's operand and int8 scale for f32 stats (torch)."""
    return port_histogram.operand(torch.from_numpy(stats), quant, None)


def binning_case(n, F, max_b, seed):
    """values f32 [F, n] with NaNs, values sitting on boundaries and
    +-inf; ascending boundaries +inf padded past a per-feature count;
    one feature imputes NaN (its NaNs bin to nb)."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, max_b + 1, F).astype(np.int32)
    bounds = np.full((F, max_b), np.inf, np.float32)
    for f in range(F):
        bounds[f, : nb[f]] = np.sort(rng.choice(
            np.linspace(-3, 3, 4 * max_b), nb[f], replace=False))
    values = rng.normal(size=(F, n)).astype(np.float32)
    on_edge = rng.uniform(size=(F, n)) < 0.1
    pick = rng.integers(0, max_b, (F, n))
    edge_vals = np.take_along_axis(bounds, pick, axis=1)
    values = np.where(on_edge & np.isfinite(edge_vals), edge_vals, values)
    values[rng.uniform(size=(F, n)) < 0.05] = np.nan
    values[:, 0] = np.inf
    values[:, -1] = -np.inf
    impute = rng.normal(size=F).astype(np.float32)
    impute[0] = np.nan
    return values, bounds, nb, impute


@pytest.mark.parametrize("L", [1, 24, 96])  # 1, 24: the packed TPU body
@pytest.mark.parametrize("quant", QUANTS)
def test_histogram_plain_matches_pallas_interpret(quant, L):
    require_jax()
    n, F, B, S = 1531, 5, 64, 3
    bins, slot, stats = hist_case(n, F, L, B, S, seed=L)
    want = np.asarray(jax_histogram.histogram(
        jnp.asarray(bins), jnp.asarray(slot), jnp.asarray(stats),
        num_slots=L, num_bins=B, impl="pallas_interpret", quant=quant,
    ))
    got = port_histogram.histogram(
        torch.from_numpy(bins.T.copy()), torch.from_numpy(slot),
        torch.from_numpy(stats), num_slots=L, num_bins=B, quant=quant,
    ).numpy()
    assert got.shape == (L, F, B, S)
    assert np.array_equal(got, want)
    assert np.abs(want).sum() > 0


def test_histogram_int8_accumulator_matches_pallas():
    """The kernel layer itself: int8 stats accumulate into int32, bitwise
    against histogram_pallas's int32 output."""
    require_jax()
    bins, slot, stats = hist_case(2049, 4, 16, 32, 3, seed=7)
    q = np.clip(stats * 15, -127, 127).astype(np.int8)
    want = np.asarray(histogram_pallas(
        jnp.asarray(bins), jnp.asarray(slot), jnp.asarray(q), num_slots=16,
        num_bins=32, interpret=True))
    got = histogram_kernels.histogram(
        torch.from_numpy(bins.T.copy()), torch.from_numpy(slot),
        torch.from_numpy(q), 16, 32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("identity_hmap", [False, True])
@pytest.mark.parametrize("quant", QUANTS)
def test_routed_plain_matches_pallas_interpret(quant, identity_hmap):
    require_jax()
    n, F, B, L, S = 1300, 5, 32, 8, 3
    Lh = L if identity_hmap else 4
    bins, slot, leaf, tables, stats = routed_case(
        n, F, B, L, Lh, S, seed=3 + identity_hmap,
        identity_hmap=identity_hmap)
    op, scale = port_operand(stats, quant)
    want_h, want_s, want_l = histogram_routed_pallas(
        jnp.asarray(bins), jnp.asarray(slot), jnp.asarray(leaf),
        *(jnp.asarray(t) for t in tables), jax_array(op),
        num_slots=Lh, num_bins=B, chunk=256, interpret=True,
        quant_scale=None if scale is None else jax_array(scale),
    )
    from ydf_tpu_torch.ops.routing import route_histogram_fused

    got_h, got_s, got_l = route_histogram_fused(
        torch.from_numpy(bins.T.copy()), torch.from_numpy(slot),
        torch.from_numpy(leaf), port_tables(tables), op, num_slots=Lh,
        num_bins=B, quant_scale=scale,
    )
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(got_l.numpy(), np.asarray(want_l))
    assert np.array_equal(got_h.numpy(), np.asarray(want_h))
    assert np.abs(np.asarray(want_h)).sum() > 0


def test_binning_plain_matches_pallas_interpret():
    require_jax()
    values, bounds, nb, impute = binning_case(3001, 6, 31, seed=5)
    args = (jnp.asarray(values), jnp.asarray(bounds), jnp.asarray(nb),
            jnp.asarray(impute))
    want = np.asarray(binning_pallas(*args, interpret=True))
    assert np.array_equal(np.asarray(bin_columns_jit(*args)), want)
    got = port_binning.bin_columns(
        torch.from_numpy(values), torch.from_numpy(bounds),
        torch.from_numpy(nb), torch.from_numpy(impute)).numpy()
    assert got.dtype == np.uint8 and got.shape == (3001, 6)
    assert np.array_equal(got, want)
    assert (got[:, 0] == nb[0]).sum() > 0  # NaN impute -> nb


def test_training_wrappers_check_their_input():
    bins_t = torch.zeros((3, 10), dtype=torch.uint8)
    slot = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        histogram_kernels.histogram(bins_t, slot.long(), torch.zeros(10, 3),
                                    1, 8)
    with pytest.raises(ValueError, match="stat columns"):
        histogram_kernels.histogram(bins_t, slot, torch.zeros(10, 9), 1, 8)
    with pytest.raises(ValueError, match="float32"):
        port_binning.bin_columns(torch.zeros(3, 10, dtype=torch.float64),
                                 torch.zeros(3, 4), torch.zeros(
                                     3, dtype=torch.int32), torch.zeros(3))
    with pytest.raises(ValueError, match="quant"):
        port_histogram.histogram(bins_t, slot, torch.zeros(10, 3), 1, 8,
                                 quant="fp8")


# ---- on the card -------------------------------------------------------


def _card_stats(stats_np, kind, device):
    t = torch.from_numpy(stats_np).to(device)
    if kind == "int8":
        return t.to(torch.int8)
    if kind == "bf16":
        return t.to(torch.bfloat16)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("L", [1, 16, 32, 100])
@pytest.mark.parametrize("n", [1, 4097, 70001])
def test_histogram_kernel_matches_plain_on_card(n, L, kind):
    """Full width (28 features, 256 bins, 3 stats), ragged row counts;
    L = 100 takes several slot blocks. Integer-valued stats: every
    partial sum is exact, so the kernel equals the plain version
    bitwise in every type."""
    _need_card()
    bins, slot, stats = hist_case(n, 28, L, 256, 3, seed=n + L)
    bins_t = torch.from_numpy(bins.T.copy()).cuda()
    slot_t = torch.from_numpy(slot).cuda()
    st = _card_stats(stats, kind, "cuda")
    before = histogram_kernels.LAUNCHES["histogram"]
    got = histogram_kernels.histogram(bins_t, slot_t, st, L, 256)
    torch.cuda.synchronize()
    assert histogram_kernels.LAUNCHES["histogram"] == before + 1
    want = histogram_kernels.histogram_plain(bins_t, slot_t, st, L, 256)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_histogram_kernel_f32_tolerance_on_card():
    """Real-valued f32 stats at the bench's root-layer shape: shared
    atomics sum a block's rows in a varying order, so each cell may
    differ from the plain version by f32 rounding of a sum of n terms:
    |got - want| <= 1e-5 * (sum of |terms| in the cell) + 1e-6."""
    _need_card()
    n, F, B = 500_000, 28, 256
    rng = np.random.default_rng(1)
    bins_t = torch.from_numpy(rng.integers(0, B, (F, n)).astype(
        np.uint8)).cuda()
    slot = torch.zeros(n, dtype=torch.int32, device="cuda")
    stats = torch.from_numpy(rng.normal(size=(n, 3)).astype(
        np.float32)).cuda()
    got = histogram_kernels.histogram(bins_t, slot, stats, 1, B)
    want = histogram_kernels.histogram_plain(bins_t, slot, stats, 1, B)
    mass = histogram_kernels.histogram_plain(bins_t, slot, stats.abs(), 1,
                                             B)
    assert torch.all((got - want).abs() <= 1e-5 * mass + 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("identity_hmap", [False, True])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n", [1, 4097, 70001])
def test_routed_kernel_matches_plain_on_card(n, kind, identity_hmap):
    """The bench's deepest fused layer (L = 32, Lh = 16) at full width:
    new_slot, new_leaf and the histogram bitwise equal to the plain
    version (integer-valued stats)."""
    _need_card()
    L = 32
    Lh = L if identity_hmap else 16
    bins, slot, leaf, tables, stats = routed_case(
        n, 28, 256, L, Lh, 3, seed=n, identity_hmap=identity_hmap)
    args = (torch.from_numpy(bins.T.copy()).cuda(),
            torch.from_numpy(slot).cuda(), torch.from_numpy(leaf).cuda(),
            port_tables(tables, "cuda"), _card_stats(stats, kind, "cuda"))
    before = histogram_kernels.LAUNCHES["histogram_routed"]
    got = histogram_kernels.histogram_routed(*args, Lh, 256)
    torch.cuda.synchronize()
    assert histogram_kernels.LAUNCHES["histogram_routed"] == before + 1
    want = histogram_kernels.histogram_routed_plain(*args, Lh, 256)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
def test_binning_kernel_matches_plain_on_card(n):
    _need_card()
    values, bounds, nb, impute = binning_case(n, 28, 255, seed=n)
    args = [torch.from_numpy(a).cuda() for a in (values, bounds, nb, impute)]
    before = port_binning.KERNEL_LAUNCHES
    got = port_binning.bin_columns(*args)
    torch.cuda.synchronize()
    assert port_binning.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, port_binning.bin_columns_plain(*args))


@pytest.mark.gpu
def test_training_wrappers_on_card_raise_on_what_they_do_not_take():
    _need_card()
    bins_t = torch.zeros((3, 64), dtype=torch.uint8, device="cuda")
    slot = torch.zeros(64, dtype=torch.int32, device="cuda")
    stats = torch.zeros(64, 3, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        histogram_kernels.histogram(
            torch.zeros((64, 3), dtype=torch.uint8, device="cuda").t(),
            slot, stats, 1, 8)
    with pytest.raises(ValueError, match="cpu"):
        histogram_kernels.histogram(bins_t, slot.cpu(), stats, 1, 8)
    n0 = histogram_kernels.LAUNCHES["histogram"]
    out = histogram_kernels.histogram(bins_t[:, :0], slot[:0], stats[:0],
                                      1, 8)
    assert out.abs().sum() == 0
    assert histogram_kernels.LAUNCHES["histogram"] == n0
