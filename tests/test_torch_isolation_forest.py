"""The isolation forest on ydf_tpu_torch, held against the JAX package on
the CPU: the draws (jax.random.gumbel, jax.lax.top_k's indices), the
random split rule's gain, the path length, whole trains with every
default but the tree count (subsamples of 256 rows, depth 8), predict,
the anomaly-detection evaluation, save and load in either direction, and
the unported options.

Tolerances: everything bitwise (the gumbel draws, the gains as XLA's
CPU code computes them inside jax.jit, every node array and path length,
the scores; the counts a tree is grown on are exact in any order),
evaluate's AUC within 1e-12 (host float64 on the same scores).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.learners.isolation_forest import _avg_path_length_jnp
    from ydf_tpu.ops.split_rules import RandomSplitRule as JaxRandomSplitRule
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.learners import isolation_forest
from ydf_tpu_torch.ops import grower, histogram_kernels
from ydf_tpu_torch.ops.split_rules import RandomSplitRule
from ydf_tpu_torch.utils import prng
from test_torch_random_forest import (
    FOREST_FIELDS,
    assert_same_forest,
    make_frame,
    require_jax,
)

torch.set_num_threads(1)
ROWS = 6000
TREES = 60


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def torch_key(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("seed,shape", [
    (0, (7,)), (5, (3, 4, 256)), (2024, (16, 32, 64)), (99, (1, 1, 1)),
])
def test_gumbel_matches_jax(seed, shape):
    """prng.gumbel against jax.random.gumbel (mode "low"), bitwise, on
    split keys and the grower's layer shapes."""
    require_jax()
    key = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
    want = np.asarray(jax.random.gumbel(key, shape))
    got = prng.gumbel(torch_key(key), shape).numpy()
    assert np.array_equal(bits(got), bits(want))


def test_top_k_matches_lax_top_k_with_ties():
    """prng.top_k against jax.lax.top_k's indices: forced ties at the
    boundary and inside the set keep the lower index first (torch.topk
    orders ties arbitrarily); then on a uniform draw of 20,000 rows."""
    require_jax()
    x = np.array([1, 3, 3, 2, 3, 0, 2, 2, 5, 2, 3], np.float32)
    for k in range(1, len(x) + 1):
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
        got = prng.top_k(torch.from_numpy(x), k).numpy()
        assert np.array_equal(got, want), k
    key = jax.random.PRNGKey(4)
    u = jax.random.uniform(key, (20_000,))
    want = np.asarray(jax.lax.top_k(u, 256)[1])
    got = prng.top_k(prng.uniform(torch_key(key), (20_000,)), 256)
    assert np.array_equal(got.numpy(), want)


def random_gain_case(seed, Ld=16, F=12, B=256):
    """Left/right/parent counts [Ld, F, B, 1] of a layer (empty bins,
    slots with a single row), a log_gap with a feature disabled
    wholesale (-inf) and features of few cuts, and a gain key."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 3, (Ld, F, B, 1)).astype(np.float32)
    hist[:, :, rng.integers(0, B, 60)] = 0
    hist[0] = 0
    hist[0, :, 5] = 1  # one row: no valid cut
    left = np.cumsum(hist, axis=2)
    parent = left[:, 0, -1][:, None, None, :]
    right = parent - left
    log_gap = np.full((F, B), -np.inf, np.float32)
    for f in range(1, F):
        nb = int(rng.integers(1, B))
        b = np.sort(rng.normal(size=nb)) * 10 ** rng.uniform(-4, 4)
        gaps = np.diff(b, prepend=b[0] - (b[-1] - b[0] + 1e-6) / nb)
        log_gap[f, :nb] = np.log(np.maximum(gaps, 1e-12))
    log_gap[F - 1, :3] = 0.0  # a categorical feature's cuts
    key = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
    return left, right, np.broadcast_to(parent, left.shape).copy(), \
        log_gap, key


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_split_gain_matches_jax_jit(seed):
    """RandomSplitRule.gain against jax.jit of the JAX package's rule,
    bitwise, -inf included (a feature with no cut, slots with no valid
    cut): the logsumexp's exp, its windowed sum over 256 bins and log are
    XLA's."""
    require_jax()
    left, right, parent, log_gap, key = random_gain_case(seed)
    want = np.asarray(jax.jit(
        lambda a, b, c, k, g: JaxRandomSplitRule().gain(a, b, c, k, g))(
            left, right, parent, key, log_gap))
    got = RandomSplitRule().gain(
        torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(parent), torch_key(key),
        torch.from_numpy(log_gap)).numpy()
    assert np.isneginf(want).any() and np.isfinite(want).any()
    assert np.array_equal(bits(got), bits(want))


def test_path_length_matches_jax():
    """The leaf path length c(count) in f32 against jax.jit of
    _avg_path_length_jnp, bitwise, on 0 .. 600 rows and larger counts;
    the model's f64 c(n) against the JAX package's."""
    require_jax()
    from ydf_tpu.models.if_model import average_path_length as jax_c

    from ydf_tpu_torch.models.if_model import average_path_length

    counts = np.concatenate([np.arange(601), [1023, 4096, 65_537, 1e6]]
                            ).astype(np.float32)
    want = np.asarray(jax.jit(_avg_path_length_jnp)(counts))
    got = isolation_forest.avg_path_length_f32(
        torch.from_numpy(counts)).numpy()
    assert np.array_equal(bits(got), bits(want))
    n = np.arange(0, 5000)
    assert np.array_equal(average_path_length(n), jax_c(n))


def features_of(df):
    return df.drop(columns=["label"])


def train_pair(rows=ROWS, seed=1, **kw):
    require_jax()
    df = features_of(make_frame(rows, seed))
    kw = {"num_trees": TREES, **kw}
    jm = ydf.IsolationForestLearner(**kw).train(df)
    pm = ydf_tpu_torch.IsolationForestLearner(device="cpu", **kw).train(df)
    return df, jm, pm


@pytest.fixture(scope="module")
def default_pair():
    return train_pair()


def test_isolation_forest_grows_the_jax_trees(default_pair):
    """Every default but the tree count (256-row subsamples, depth 8,
    frontier 128, 511 nodes a tree) on 6,000 rows of six numerical
    columns (NaNs in one) and two categorical ones: every node array and
    path length bitwise."""
    df, jm, pm = default_pair
    assert_same_forest(jm, pm)
    f = pm.forest
    assert f.feature.shape == (TREES, 511) and pm.max_depth == 8
    assert pm.num_examples_per_tree == jm.num_examples_per_tree == 256
    assert bool((f.is_cat & ~f.is_leaf).any())
    # Every tree splits well past its first layers.
    assert int(f.num_nodes.min()) > 64


def test_predict_and_evaluate_match_jax(default_pair):
    """Scores on fresh rows bitwise; evaluate's AUC against a label of
    rows made anomalous, as the JAX package's (label column given)."""
    df, jm, pm = default_pair
    test = features_of(make_frame(2000, 9))
    want = np.asarray(jm.predict(test))
    got = pm.predict(test)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert pm.list_compatible_engines() == ["Routed"]
    test = test.copy()
    odd = np.arange(len(test)) % 10 == 0
    test.loc[odd, "x0"] = test.loc[odd, "x0"] * 8
    test["anomaly"] = odd.astype(np.int64)
    kw = dict(label="anomaly", num_trees=5)
    jl = ydf.IsolationForestLearner(**kw).train(test)
    pl = ydf_tpu_torch.IsolationForestLearner(device="cpu", **kw).train(test)
    assert_same_forest(jl, pl)
    je, pe = jl.evaluate(test), pl.evaluate(test)
    assert pe.metrics.keys() == je.metrics.keys() == {"auc"}
    assert abs(pe.metrics["auc"] - je.metrics["auc"]) <= 1e-12
    assert pe.num_examples == je.num_examples == len(test)


@pytest.mark.parametrize("kw", [
    dict(subsample_ratio=0.05, num_trees=8),
    dict(subsample_count=100, max_depth=5, num_trees=8),
    dict(subsample_count=10_000, num_trees=3),
])
def test_subsample_options_match_jax(kw):
    """subsample_ratio (300 rows), an explicit depth, and a subsample
    count above the rows (every row, in top-k order)."""
    _, jm, pm = train_pair(rows=6000, seed=2, **kw)
    assert_same_forest(jm, pm)
    assert pm.num_examples_per_tree == jm.num_examples_per_tree


def test_save_load_both_ways(default_pair, tmp_path):
    df, jm, pm = default_pair
    pm.save(str(tmp_path / "port"))
    jm.save(str(tmp_path / "jax"))
    back_jax = ydf.load_model(str(tmp_path / "port"))
    back_port = ydf_tpu_torch.load_model(str(tmp_path / "jax"), device="cpu")
    assert isinstance(back_port, ydf_tpu_torch.IsolationForestModel)
    assert back_port.num_examples_per_tree == 256
    head = df.iloc[:700]
    want = np.asarray(jm.predict(head))
    assert np.asarray(back_jax.predict(head)).tobytes() == want.tobytes()
    assert back_port.predict(head).tobytes() == want.tobytes()
    pf, bf = pm.forest.to_numpy(), back_port.forest.to_numpy()
    for f in FOREST_FIELDS:
        assert pf[f].tobytes() == bf[f].tobytes(), f


def test_unported_and_unknown_options_raise():
    # Sparse-oblique splits train (tests/test_torch_oblique.py); the JAX
    # package's isolation forest rejects MHLD.
    with pytest.raises(ValueError, match="split_axis"):
        ydf_tpu_torch.IsolationForestLearner(split_axis="MHLD_OBLIQUE",
                                             device="cpu")
    with pytest.raises(ValueError, match="split_axis"):
        ydf_tpu_torch.IsolationForestLearner(split_axis="DIAGONAL",
                                             device="cpu")


def test_learner_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ydf_tpu_torch.IsolationForestLearner()


def test_grower_needs_the_key_for_a_keyed_rule():
    bins_t = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="needs the tree's key"):
        grower.grow_tree(bins_t, torch.ones((8, 1)), rule=RandomSplitRule(),
                         max_depth=2, frontier=2, max_nodes=7, num_bins=64)


def test_loop_reads_nothing_on_the_host(monkeypatch):
    """Inside the tree loop every host read raises (the CPU stand-in of
    the card's sync debug mode): the subsample, the gumbel noise, the
    node depths and path lengths stay on the device."""
    df = features_of(make_frame(600, 3))
    banned = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
              "__float__")
    train_if = isolation_forest.train_if

    def guarded(*args, **kwargs):
        saved = {name: getattr(torch.Tensor, name) for name in banned}

        def refuse(name):
            def f(*a, **k):
                raise AssertionError(f"host read in the loop: {name}")
            return f

        for name in banned:
            setattr(torch.Tensor, name, refuse(name))
        try:
            return train_if(*args, **kwargs)
        finally:
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)

    monkeypatch.setattr(isolation_forest, "train_if", guarded)
    model = ydf_tpu_torch.IsolationForestLearner(
        num_trees=3, device="cpu").train(df)
    assert model.forest.num_trees == 3


@pytest.mark.gpu
def test_isolation_forest_on_card_matches_cpu_port():
    """The default forest (20 trees) on the card and on the CPU: the same
    trees and scores bitwise; one root and 7 routed launches a tree."""
    _need_card()
    df = features_of(make_frame(20_000, 13))
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    cm = ydf_tpu_torch.IsolationForestLearner(num_trees=20).train(df)
    assert histogram_kernels.LAUNCHES == {"histogram": 20,
                                          "histogram_routed": 20 * 7}
    pm = ydf_tpu_torch.IsolationForestLearner(num_trees=20,
                                              device="cpu").train(df)
    cf, pf = cm.forest.to_numpy(), pm.forest.to_numpy()
    for f in FOREST_FIELDS:
        assert cf[f].tobytes() == pf[f].tobytes(), f
    assert cm.predict(df).tobytes() == pm.predict(df).tobytes()


@pytest.mark.gpu
def test_histogram_kernels_at_one_stat_on_subsamples():
    """csrc/histogram.cu and csrc/histogram_routed.cu at the isolation
    forest's shapes, S = 1 on 256 rows (Lh 1 .. 64), on every layer of
    its first tree: torch.equal to the plain versions."""
    _need_card()
    df = features_of(make_frame(20_000, 17))
    captured = {"root": [], "routed": []}
    originals = (histogram_kernels.histogram,
                 histogram_kernels.histogram_routed)

    def root(*args):
        captured["root"].append(args)
        return originals[0](*args)

    def routed(*args):
        captured["routed"].append(args)
        return originals[1](*args)

    histogram_kernels.histogram = root
    histogram_kernels.histogram_routed = routed
    try:
        ydf_tpu_torch.IsolationForestLearner(num_trees=1).train(df)
    finally:
        (histogram_kernels.histogram,
         histogram_kernels.histogram_routed) = originals
    args = captured["root"][0]
    assert args[0].shape[1] == 256 and args[2].shape == (256, 1)
    got = originals[0](*args)
    want = histogram_kernels.histogram_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert [a[5] for a in captured["routed"]] == [1, 2, 4, 8, 16, 32, 64]
    for args in captured["routed"]:
        got = originals[1](*args)
        want = histogram_kernels.histogram_routed_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), args[5]
