"""MHLD-oblique splits (ops/mhld.py and the GBT's loop) against the JAX
package: the row dots in XLA's order, the vector-matrix chain and the
whole make_mhld_W inside a lax.scan shaped like the JAX learner's
program, against what JAX computed on 8 cores (train_mhld/xla_order.npz:
XLA's dot order follows the core count); the subset masks, the LAPACK
steps of the solves and the norm against a live JAX, bitwise; and the small committed runs (ydf_tpu_torch/testdata/
train_mhld: binary, two attributes, three classes, subsample=0.5 and
GOSS on 20,000 rows) trained by the port, W, every tree and the
predictions equal by hash, with the host reads of each path; the
classification and monotone errors.
"""

import json
import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax
    import jax.numpy as jnp
    import ydf_tpu as ydf
except ImportError:
    ydf = None

import chip_smoke
import ydf_tpu_torch
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.ops import mhld
from ydf_tpu_torch.ops.histogram import sum_rows_f32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_MHLD = os.path.join(REPO, "ydf_tpu_torch", "testdata", "train_mhld")
torch.set_num_threads(1)
f32 = np.float32


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def bits(a):
    return np.asarray(a, f32).view(np.int32)


def fixture_script():
    """scripts/make_torch_port_fixtures.py as a module: the probes'
    inputs (mhld_dot_case, mhld_vdot_case, mhld_program_case)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_torch_port_fixtures",
        os.path.join(REPO, "scripts", "make_torch_port_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def xla_order():
    """What XLA's CPU computed for the probes, JAX on 8 cores
    (train_mhld/xla_order.npz; its dots' order follows the core count,
    so the tests hold the port against these and not a live jax.jit)."""
    return np.load(os.path.join(TRAIN_MHLD, "xla_order.npz"))


# ---- (a) the scatter sums ------------------------------------------------


@pytest.mark.parametrize("n,M", [(2700, 28), (3000, 28), (18000, 28),
                                 (18000, 2), (18000, 3)])
def test_row_dots_match_xla(n, M):
    """a^T b over the rows bitwise jax.jit(a.T @ b) on 8 cores
    (xla_order): Eigen's blocks of row chains and their sums (the entries
    past the last packet of the [3, 28] result add in another order)."""
    a, b = fixture_script().mhld_dot_case(n, M)
    got = mhld.contract_rows(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(bits(got), bits(xla_order()[f"dots_{n}_{M}"]))


@pytest.mark.parametrize("n", [2700, 18000])
def test_vector_dot_and_sums_match_xla(n):
    """w^T x (one fused multiply-add chain on the host) and the column
    sums (sum_rows_f32) bitwise jax.jit's on 8 cores (xla_order)."""
    w, x = fixture_script().mhld_vdot_case(n)
    want = xla_order()
    assert np.array_equal(bits(mhld.fma_chain(w, x)), bits(want[f"vdot_{n}"]))
    got = sum_rows_f32(torch.from_numpy(x))
    assert np.array_equal(bits(got), bits(want[f"colsum_{n}"]))


def test_flush_denormals_sets_only_ftz_and_daz():
    """The solves' MXCSR: FTZ and DAZ set inside the block, every other
    bit (the exception masks) as before, the old value back after it; a
    subnormal product flushes to zero inside only."""
    lib = mhld.host_library()
    before = lib.ydf_or_mxcsr(0)
    tiny = np.full(4, 1e-20, f32)  # its square is subnormal
    with mhld.flush_denormals():
        inside = lib.ydf_or_mxcsr(0)
        flushed = tiny * tiny * f32(1e8)
    assert lib.ydf_or_mxcsr(0) == before
    if before:  # x86: the register exists
        assert inside == before | mhld.FTZ_DAZ
        assert not flushed.any()
    assert (tiny * tiny * f32(1e8) > 0).all()


def test_regularizer_matches_the_learners_form():
    """reg = 1e-3 trace(SW) / Fn + 1e-6 as the learner's program computes
    it from a row-major SW: 8 lanes, halves, the rest in order, the
    constant folded and fused (finish_scatter's reg)."""
    require_jax()
    g = jax.jit(lambda SW: 1e-3 * jnp.trace(SW) / 28 + 1e-6)
    rng = np.random.default_rng(0)
    for _ in range(200):
        SW = (rng.normal(size=(28, 28)) * 10 ** rng.uniform(-3, 5)).astype(
            f32)
        _, _, reg = mhld.finish_scatter(
            np.zeros((2, 28), f32), SW, np.zeros(2, f32), f32(1),
            np.zeros(28, f32))
        assert bits(reg) == bits(g(SW))


# ---- (b) the masks; (c) the solves -------------------------------------


@pytest.mark.parametrize("max_attributes", [2, 3, 4, 9])
def test_subset_masks_match_jax(max_attributes):
    require_jax()
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    P, Fn = 28, 28
    smax = min(max(max_attributes, 2), Fn)
    sizes = 2 + (jnp.arange(P) % max(smax - 1, 1))

    def masks(k):
        def one(kk, size):
            scores = jax.random.uniform(kk, (Fn,))
            return scores >= jnp.sort(scores)[Fn - size]
        return jax.vmap(one)(jax.random.split(k, P), sizes)

    want = np.asarray(jax.vmap(masks)(keys))
    got = mhld.subset_masks(torch.from_numpy(
        np.asarray(keys).astype(np.int64)), P, Fn, max_attributes)
    assert np.array_equal(got.numpy(), want)


def test_lapack_steps_match_jnp_linalg():
    """Each step of the solve on the same masked inputs, bitwise the JAX
    package's jnp.linalg call (the same LAPACK, with subnormals flushed
    as XLA's runtime flushes them)."""
    require_jax()
    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 28)).astype(f32)
    SW = (X.T @ X).astype(f32)
    Y = rng.normal(size=(2, 28)).astype(f32)
    SB = (Y.T @ Y).astype(f32)
    reg = f32(0.05)
    chol = jax.jit(jnp.linalg.cholesky)
    tri = jax.jit(jax.scipy.linalg.solve_triangular,
                  static_argnames=("lower",))
    eigh = jax.jit(jnp.linalg.eigh)
    with mhld.flush_denormals():
        for _ in range(30):
            mf = (rng.random(28) < 0.15).astype(f32)
            mf[rng.integers(0, 28, 2)] = 1
            st = mhld.solve_steps(SW, SB, reg, mf)
            L = np.asarray(chol(st["SWp"]))
            assert np.array_equal(bits(st["L"]), bits(L))
            assert np.array_equal(bits(st["A"]),
                                  bits(tri(L, st["SBp"], lower=True)))
            M2 = np.asarray(tri(L, st["A"].T, lower=True)).T
            M2 = f32(0.5) * (M2 + M2.T)
            assert np.array_equal(bits(st["M2"]), bits(M2))
            v = np.asarray(eigh(M2)[1])[:, -1]
            assert np.array_equal(bits(st["v"]), bits(v))
            wp = np.asarray(tri(L.T, v, lower=False)) * mf
            assert np.array_equal(bits(st["wp"]), bits(wp))


def test_make_mhld_W_in_the_learners_program():
    """The whole of make_mhld_W inside a lax.scan over iterations (the
    JAX learner's program shape: the same fusions, so the norm's order
    is the learner's; run on 8 cores into xla_order) against the port's
    sums, scatter and solves on 18,000 rows, every projection of 6
    iterations bitwise, with constant and with changing row weights."""
    x, y, ws, keys = fixture_script().mhld_program_case()
    inp = mhld.MHLDInputs.make(x, torch.from_numpy(y.astype(f32)), 2, 28)
    masks = inp.masks(torch.from_numpy(keys))
    for i, w in enumerate(ws):
        want = xla_order()[f"program_{i}"]
        sc = inp.scatter(inp.sums(torch.from_numpy(w)).numpy())
        for t in range(6):
            got = inp.solve(sc, masks[t])
            assert np.array_equal(bits(got), bits(want[t])), t


@pytest.mark.parametrize("extra", [dict(task="REGRESSION"),
                                   dict(monotonic_constraints={"f0": 1})])
def test_errors_match_jax(extra):
    """MHLD takes classification only and no monotone constraint: the
    JAX package's ValueError, raised by train()."""
    require_jax()
    rng = np.random.default_rng(0)
    data = {"f0": rng.normal(size=200).astype(f32),
            "f1": rng.normal(size=200).astype(f32),
            "label": rng.integers(0, 2, 200)}
    kw = dict(label="label", split_axis="MHLD_OBLIQUE", num_trees=1,
              validation_ratio=0.0)
    msgs = []
    for mod, extra_kw in ((ydf, {}), (ydf_tpu_torch, {"device": "cpu"})):
        e = dict(extra)
        if "task" in e:
            e["task"] = mod.Task[e["task"]]
        with pytest.raises(ValueError) as err:
            mod.GradientBoostedTreesLearner(**kw, **e, **extra_kw).train(
                data)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---- the small committed runs -----------------------------------------


def fixture():
    with open(os.path.join(TRAIN_MHLD, "config.json")) as f:
        cfg = json.load(f)
    return cfg, np.load(os.path.join(TRAIN_MHLD, "expected.npz"))


SMALL = ["binary", "attributes2", "three_class", "subsample", "goss"]


@pytest.mark.parametrize("name", SMALL)
def test_small_run_matches_jax(name):
    """The port's train of a small run on the CPU: every projection W
    bitwise, every kept tree (node arrays with thresholds) and its
    boundaries by SHA-256, the kept count, the predictions bitwise; one
    host read before the loop when the row weights stay (the default),
    one a tree when they change (subsample, GOSS)."""
    cfg, exp = fixture()
    c = cfg["small"][name]
    train, test = chip_smoke.make_frame(
        cfg["small_rows"], cfg["small_test_rows"],
        classes=3 if name == "three_class" else 2)
    assert chip_smoke.frame_sha256(train) == c["train_sha256"]
    records, restore = chip_smoke.capture_returns(port_gbt, "boost")
    reads = port_gbt.HOST_READS
    try:
        m = ydf_tpu_torch.GradientBoostedTreesLearner(
            device="cpu", **c["learner"]).train(train)
    finally:
        restore()
    reads = port_gbt.HOST_READS - reads
    trained = m.training_logs["num_trees_trained"]
    assert (m.training_logs["num_trees"], trained) == (
        c["num_trees"], c["num_trees_trained"])
    assert reads == (trained if name in ("subsample", "goss") else 1), reads
    run = f"small_{name}/"
    fo = m.forest.to_numpy()
    K, T = m.num_trees_per_iter, fo["feature"].shape[0]
    W, bounds = (a.cpu().numpy() for a in records[0].obl_out)
    assert np.array_equal(bits(W[:T // K]), bits(exp[run + "oblique_weights"]))
    got = [bytes.fromhex(chip_smoke.tree_sha256(
        fo, t, fields=chip_smoke.TREE_HASH_FIELDS + ("threshold",)))
        for t in range(T)]
    assert got == [bytes(h) for h in exp[run + "tree_sha256"]]
    assert [bytes.fromhex(chip_smoke.array_sha256(b))
            for b in bounds[:T // K]] == [bytes(h) for h in
                                          exp[run + "bounds_sha256"]]
    preds = np.asarray(m.predict(test))
    assert chip_smoke.array_sha256(preds) == c["predictions_sha256"]


def test_fixed_weights_solve_only_the_iterations_that_run(monkeypatch):
    """With the row weights the same every iteration, each chunk's W is
    solved at its start: a deadline that stops the loop after its first
    chunk of 25 leaves 25 iterations solved of 60, one host read."""
    train, _ = chip_smoke.make_frame(3000, 100)
    solved = []
    solve = mhld.MHLDInputs.solve
    monkeypatch.setattr(mhld.MHLDInputs, "solve", lambda self, sc, m: (
        solved.append(m.shape), solve(self, sc, m))[1])
    reads = port_gbt.HOST_READS
    m = ydf_tpu_torch.GradientBoostedTreesLearner(
        device="cpu", label="label", split_axis="MHLD_OBLIQUE",
        num_trees=60, max_depth=3, validation_ratio=0.0,
        maximum_training_duration=1e-6).train(train)
    assert m.training_logs["num_trees_trained"] == 25
    assert solved == [(28, 28)] * 25
    assert port_gbt.HOST_READS - reads == 1


@pytest.mark.gpu
def test_mhld_on_card_equals_the_cpu_port():
    """On the card (the row dots as torch operations there, the solves
    on the host): the trees, W and predictions of the binary small run
    equal the CPU port's bitwise, with one host read before the loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    cfg, exp = fixture()
    c = cfg["small"]["binary"]
    train, test = chip_smoke.make_frame(cfg["small_rows"],
                                        cfg["small_test_rows"])
    m = ydf_tpu_torch.GradientBoostedTreesLearner(**c["learner"]).train(
        train)
    T = m.forest.num_trees
    assert np.array_equal(
        bits(m.forest.oblique_weights.cpu().numpy()[:, :, :28]),
        bits(exp["small_binary/oblique_weights"][:T]))
    assert chip_smoke.array_sha256(np.asarray(m.predict(test))) == (
        c["predictions_sha256"])
