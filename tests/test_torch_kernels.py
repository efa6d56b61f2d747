"""ydf_tpu_torch kernels held against the JAX package.

The same seeded numpy inputs go through the JAX function and its port:
  * compile_forest (QuickScorer host compile): every array equal;
  * the QuickScorer plain version against the JAX engine in Pallas
    interpret mode (depth 4 numerical-only, depth 6 mixed categorical);
  * the bank plain version against the JAX PallasBank engine in interpret
    mode (depth 6, and depth 8 with more than 64 leaves);
  * the routed plain engine against ops/routing.py:forest_predict_values.
All raw-score comparisons are bitwise: every engine adds one f32 per tree
in tree order, so no tolerance applies.

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
    from ydf_tpu.ops.routing import forest_predict_values as jax_routed
    from ydf_tpu.serving import quickscorer as jax_qs
    from ydf_tpu.serving.pallas_scorer import build_pallas_scorer
except ImportError:
    ydf = None

import ydf_tpu_torch
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
    _, pm = models["mix_d6"]
    f = pm.forest.to_numpy()
    f["is_set"] = ~f["is_leaf"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        forest_predict_values(
            ydf_tpu_torch.forest_from_jax(f), torch.zeros(4, 3),
            torch.zeros(4, 2, dtype=torch.int32), num_numerical=3,
            max_depth=6,
        )


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
        bank_scorer: bank._replace(feature=bank.feature.cpu()),
    }
    for mod, tables in ((quickscorer, qs), (bank_scorer, bank)):
        with pytest.raises(ValueError, match="contiguous"):
            mod.score(tables, torch.zeros(64, F, device="cuda").t())
        with pytest.raises(ValueError, match="the model on cpu"):
            mod.score(on_cpu[mod], torch.zeros(F, 64, device="cuda"))
        n0 = mod.KERNEL_LAUNCHES
        empty = mod.score(tables, torch.zeros(F, 0, device="cuda"))
        assert empty.numel() == 0 and mod.KERNEL_LAUNCHES == n0
