"""The library's default GBT workflow on ydf_tpu_torch, held against the
JAX package: the validation split, categorical binner columns, the
grower's categorical candidates and decisions, route_tree_bins, the
chunked look-ahead early stopping, `train(data, valid=...)`, and the
committed train_default fixture's configuration.

Which JAX implementations the comparisons run against (named, never
"auto"): the learners use the JAX package's CPU path (the native
histogram and fused routing, as tests/test_torch_training.py says);
route_tree_bins is held against impl="xla"; scalar_candidates and
layer_decide are the JAX functions themselves.

Tolerances, and why:
  * the split, bins, ranks, routing masks and leaf ids: bitwise
    (integer);
  * candidate stats: exact, on integer-valued histograms;
  * the arithmetic that picks splits, bitwise: XLA's exp and log as the
    JAX package runs them on the CPU (learners/losses.py), its f32 sums
    and prefix sums (sum_rows_f32, prng.cumsum_f32);
  * end to end: the same trees, leaf values bitwise, the same kept and
    trained tree counts; the reported losses within rtol 1e-5 (they use
    torch's softplus and sums).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
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
    import ydf_tpu.learners.gbt as jax_gbt
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.dataset.binning import Binner as JaxBinner
    from ydf_tpu.dataset.dataset import Dataset as JaxDataset
    from ydf_tpu.ops import grower as jax_grower
    from ydf_tpu.ops.routing import route_tree_bins as jax_route_tree_bins
    from ydf_tpu.ops.split_rules import HessianGainRule as JaxRule
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task, TreeConfig
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import Dataset
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.learners.losses import BinomialLogLikelihood
from ydf_tpu_torch.ops import grower, histogram_kernels
from ydf_tpu_torch.ops.routing import route_tree_bins
from ydf_tpu_torch.ops.split_rules import HessianGainRule
from ydf_tpu_torch.utils import prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_DEFAULT = os.path.join(REPO, "ydf_tpu_torch", "testdata",
                             "train_default")
torch.set_num_threads(1)
NODE_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
               "right", "is_leaf", "num_nodes", "threshold")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def load_chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def make_frame(n, seed, vocabs=(5, 12, 40)):
    """The train_default recipe at a small size: 8 normal features (NaNs
    in f5), a binary label from a non-linear logit, and categorical
    string columns skewed towards the label."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    logit = (x[:, 0] - 0.5 * x[:, 1] + np.sin(2 * x[:, 2])
             + x[:, 3] * x[:, 4])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    data = {f"f{i}": x[:, i] for i in range(8)}
    r = np.random.default_rng(seed)
    for j, vocab in enumerate(vocabs):
        code = r.integers(0, vocab, n)
        skew = (y == 1) & (r.uniform(size=n) < 0.4)
        code = np.where(skew, code % max(vocab // 3, 1), code)
        data[f"c{j}"] = np.array([f"v{c}" for c in code])
    data["f5"] = np.where(r.uniform(size=n) < 0.03, np.nan,
                          data["f5"]).astype(np.float32)
    data["label"] = y
    return data


def fresh_frame(n, seed):
    """Fresh rows with unseen and missing categories."""
    d = make_frame(n, seed)
    r = np.random.default_rng(seed + 1)
    for j in range(3):
        col = d[f"c{j}"].astype("<U8")
        col[r.uniform(size=n) < 0.05] = "unseen"
        col[r.uniform(size=n) < 0.03] = ""
        d[f"c{j}"] = col
    return d




@pytest.fixture(scope="module")
def defaults():
    """(JAX model, port model trained on the CPU, port host reads, data):
    both learners with every default on 4,000 rows."""
    require_jax()
    data = make_frame(4000, 0)
    jm = ydf.GradientBoostedTreesLearner(label="label").train(data)
    reads = port_gbt.HOST_READS
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", device="cpu").train(data)
    return jm, pm, port_gbt.HOST_READS - reads, data


# ---- the arithmetic that picks splits ----------------------------------


def test_exp_log_sigmoid_match_xla_bitwise():
    """XLA's exp on the CPU bitwise below 88.37 (an exp past 2.4e38 may
    differ by a few ulps), jax.nn.sigmoid and the binomial gradients
    bitwise everywhere (subnormal results flushed to 0 as XLA does); its
    log on all but a few values in 10,000 (one ulp)."""
    require_jax()
    from ydf_tpu.learners.losses import BinomialLogLikelihood as JaxBinomial

    from ydf_tpu_torch.learners import losses

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=50_000) * 4,
                        rng.uniform(-120, 88.37, 5_000),
                        [-np.inf, np.inf]]).astype(np.float32)
    tx = torch.from_numpy(x)
    assert np.array_equal(losses.exp_f32(tx).numpy(),
                          np.asarray(jax.jit(jnp.exp)(x)))
    x = np.concatenate([x, rng.uniform(-120, 120, 5_000)]).astype(
        np.float32)
    tx = torch.from_numpy(x)
    assert np.array_equal(losses.sigmoid_f32(tx).numpy(),
                          np.asarray(jax.jit(jax.nn.sigmoid)(x)))
    y = (rng.uniform(size=x.size) < 0.4).astype(np.float32)
    jg, jh = jax.jit(lambda a, b: JaxBinomial().grad_hess(a, b[:, None]))(
        y, x)
    g, h = BinomialLogLikelihood().grad_hess(torch.from_numpy(y), tx)
    assert np.array_equal(g.numpy(), np.asarray(jg)[:, 0])
    assert np.array_equal(h.numpy(), np.asarray(jh)[:, 0])
    r = rng.uniform(1e-4, 50, 20_000).astype(np.float32)
    off = losses.log_f32(torch.from_numpy(r)).numpy() != np.asarray(
        jax.jit(jnp.log)(r))
    assert off.mean() < 1e-3
    for n in (7, 1000, 33_333):
        yy = (rng.uniform(size=n) < 0.43).astype(np.float32)
        w = np.ones(n, np.float32)
        want = jax.jit(lambda a, b: JaxBinomial().initial_predictions(
            a, b))(yy, w)
        got = BinomialLogLikelihood().initial_predictions(
            torch.from_numpy(yy), torch.from_numpy(w))
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("B", [32, 64, 256])
def test_sums_and_prefix_sums_match_xla_bitwise(B):
    require_jax()
    from ydf_tpu_torch.ops.histogram import sum_rows_f32

    rng = np.random.default_rng(B)
    hist = (rng.normal(size=(3, 4, B, 3))
            * rng.integers(1, 1000, (3, 4, B, 1))).astype(np.float32)
    want = jax.jit(lambda h: jnp.cumsum(h, axis=2))(hist)
    got = prng.cumsum_f32(torch.from_numpy(hist), 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for n in (1, 31, 33, 1025, 90_001):
        x = rng.normal(size=(n, 3)).astype(np.float32)
        want = jax.jit(lambda a: jnp.sum(a, axis=0))(x)
        assert np.array_equal(sum_rows_f32(torch.from_numpy(x)).numpy(),
                              np.asarray(want)), n


# ---- the validation split ----------------------------------------------


class _Captured(Exception):
    pass


@pytest.mark.parametrize("n,ratio", [
    (2, 0.1), (3, 0.9), (5, 0.1), (9, 0.05), (1000, 0.1), (1001, 0.25),
])
def test_validation_split_matches_jax(monkeypatch, n, ratio):
    """The rows each learner validates on, read from the labels it hands
    its boosting loop (regression labels = row numbers): equal, in order,
    to the JAX learner's; ratios that round to 0 rows still validate 1."""
    require_jax()
    rng = np.random.default_rng(n)
    data = {"x": rng.normal(size=n).astype(np.float32),
            "y": np.arange(n, dtype=np.float32)}

    def capture_jax(bins_tr, y_tr, w_tr, bins_va, y_va, w_va, **_):
        raise _Captured(np.asarray(y_tr), np.asarray(y_va))

    def capture_port(bins_t, labels, weights, *, valid=None, **_):
        raise _Captured(labels.numpy(), valid.labels.numpy())

    monkeypatch.setattr(jax_gbt, "_train_gbt", capture_jax)
    monkeypatch.setattr(port_gbt, "boost", capture_port)
    hp = dict(label="y", validation_ratio=ratio, random_seed=7)
    with pytest.raises(_Captured) as want:
        ydf.GradientBoostedTreesLearner(task=JaxTask.REGRESSION,
                                        **hp).train(data)
    with pytest.raises(_Captured) as got:
        ydf_tpu_torch.GradientBoostedTreesLearner(
            task=Task.REGRESSION, device="cpu", **hp).train(data)
    w_tr, w_va = want.value.args
    g_tr, g_va = got.value.args
    assert len(w_va) == min(max(int(n * ratio), 1), n - 1)
    assert np.array_equal(g_va, w_va) and np.array_equal(g_tr, w_tr)
    tr, va = port_gbt.split_validation(n, ratio, 7)
    assert np.array_equal(va, w_va.astype(np.int64))
    assert np.array_equal(tr, w_tr.astype(np.int64))


def test_validation_split_of_one_row_keeps_it_for_training():
    tr, va = port_gbt.split_validation(1, 0.1, 123456)
    assert tr.tolist() == [0] and va.size == 0


# ---- categorical binning -----------------------------------------------


def test_categorical_binner_columns_match_jax():
    """Vocabularies (min_vocab_frequency / max_vocab_count), the binner
    and the bin matrix, unseen and missing categories included, bitwise;
    codes past num_bins collapse to the out-of-vocabulary bin 0."""
    require_jax()
    data = make_frame(3000, 1, vocabs=(5, 12, 40, 300))
    fresh = fresh_frame(500, 2)
    fresh["c3"] = make_frame(500, 3, vocabs=(5, 12, 40, 300))["c3"]
    feats = [f"f{i}" for i in range(8)] + ["c0", "c1", "c2", "c3"]
    for kw in (dict(), dict(min_vocab_frequency=2, max_vocab_count=70)):
        jds = JaxDataset.from_data(data, label="label", **kw)
        pds = Dataset.from_data(data, label="label", **kw)
        assert [c.to_json() for c in pds.dataspec.columns] == [
            c.to_json() for c in jds.dataspec.columns]
        jb = JaxBinner.fit(jds, feats, num_bins=64)
        pb = Binner.fit(pds, feats, num_bins=64)
        assert pb.to_json() == jb.to_json()
        for d in (data, fresh):
            want = jb.transform(JaxDataset.from_data(d, dataspec=jds.dataspec),
                                impl="numpy")
            got = pb.transform(Dataset.from_data(d, dataspec=pds.dataspec),
                               torch.device("cpu"))
            assert got.t().is_contiguous()
            assert np.array_equal(got.numpy(), want)


# ---- the grower's categorical candidates and decisions -----------------


def candidate_hist(seed=3, Ld=3, Fn=2, Fc=3, B=32):
    """Integer-valued [Ld, Fn + Fc, B, 3] histograms of one row set per
    slot (every feature sums to the slot's totals). Each categorical
    feature uses a few bins, the rest empty, and two of its bins, 2 and
    12, hold copies of the same rows: equal sort keys."""
    rng = np.random.default_rng(seed)
    hist = np.zeros((Ld, Fn + Fc, B, 3), np.float32)
    for s in range(Ld):
        base = rng.integers(-3, 4, (300, 2)).astype(np.float32)
        base[:, 1] = np.abs(base[:, 1]) + 1
        dup = base[:40]
        rows = np.concatenate([base, dup])
        stats = np.concatenate([rows, np.ones((len(rows), 1), np.float32)],
                               axis=1)
        for f in range(Fn + Fc):
            if f < Fn:
                b = rng.integers(0, B, len(rows))
            else:
                b = rng.choice([0, 3, 5, 7, 11], len(rows))
                b[:40], b[300:] = 2, 12
                # Some signal: positive gradients favour bin 3.
                b[40:300] = np.where(base[40:, 0] > 1, 3, b[40:300])
            np.add.at(hist[s, f], b, stats)
    return hist


def test_scalar_candidates_and_layer_decide_match_jax():
    require_jax()
    Fn, Fc, B, L, N = 2, 3, 32, 4, 15
    hist = candidate_hist(Fn=Fn, Fc=Fc, B=B)
    Ld = hist.shape[0]
    want_left, want_ranks = jax_grower.scalar_candidates(
        jnp.asarray(hist), Fn=Fn, O=1, rule=JaxRule(), rule_ctx=None)
    got_left, got_ranks = grower.scalar_candidates(
        torch.from_numpy(hist), num_numerical=Fn, rule=HessianGainRule())
    want_ranks = np.asarray(want_ranks)[:, :, 0]  # one ordering
    assert np.array_equal(got_ranks.numpy(), want_ranks)
    assert np.array_equal(got_left.numpy(), np.asarray(want_left))
    parent = hist[:, 0].sum(axis=1)  # [Ld, S]
    kw = dict(L=L, B=B, N=N, min_examples=1, min_split_gain=1e-9,
              children_in_frontier=True)
    want = jax_grower.layer_decide(
        want_left, jnp.asarray(want_ranks)[:, :, None], None,
        jnp.asarray(parent), jnp.ones(Ld, bool), jnp.arange(Ld),
        jnp.asarray(Ld, jnp.int32), None, None, None, None,
        rule=JaxRule(), Fn=Fn, Fc=Fc, O=1, Fs=0, W=1,
        candidate_features=-1, num_valid_features=None, **kw)
    got = grower.layer_decide(
        got_left, got_ranks, torch.from_numpy(parent),
        torch.ones(Ld, dtype=torch.bool), torch.arange(Ld),
        torch.tensor(Ld, dtype=torch.int32), rule=HessianGainRule(),
        num_numerical=Fn, **kw)
    assert bool(np.asarray(want.is_cat_split).any())  # a categorical split
    for field in ("do_split", "is_cat_split", "best_f", "best_t",
                  "go_left_bins", "left_id", "right_id", "left_stats"):
        assert np.array_equal(getattr(got, field).numpy(),
                              np.asarray(getattr(want, field))), field


# ---- route_tree_bins ---------------------------------------------------


def test_route_tree_bins_matches_jax(defaults):
    """Every tree of the JAX default model (categorical and numerical
    nodes) routes fresh binned rows, unseen and missing categories
    included, to the same leaves as ydf_tpu's route_tree_bins (xla)."""
    jm, _, _, _ = defaults
    fresh = fresh_frame(700, 4)
    bins = jm.binner.transform(
        JaxDataset.from_data(fresh, dataspec=jm.dataspec), impl="numpy")
    bins_t = torch.from_numpy(np.ascontiguousarray(bins.T))
    f = jm.forest.to_numpy()
    assert (f["is_cat"] & ~f["is_leaf"]).any()
    for t in range(0, jm.forest.feature.shape[0], 5):
        tree = {k: f[k][t] for k in jax_grower.TreeArrays._fields
                if k in f}
        tree["leaf_stats"] = np.zeros((len(f["feature"][t]), 3), np.float32)
        want = jax_route_tree_bins(
            jax_grower.TreeArrays(**{k: jnp.asarray(v)
                                     for k, v in tree.items()}),
            jnp.asarray(bins), jm.max_depth, impl="xla")
        tree["cat_mask"] = tree["cat_mask"].view(np.int32)
        got = route_tree_bins(
            grower.TreeArrays(**{k: torch.from_numpy(np.array(v))
                                 for k, v in tree.items()}),
            bins_t, jm.max_depth)
        assert np.array_equal(got.numpy(), np.asarray(want)), t


# ---- training with every default ---------------------------------------


def test_default_train_stops_where_jax_stops(defaults):
    jm, pm, reads, _ = defaults
    jl, pl = jm.training_logs, pm.training_logs
    assert jl["num_trees_trained"] < 300  # the look-ahead stop fired
    assert pl["num_trees"] == jl["num_trees"]
    assert pl["num_trees_trained"] == jl["num_trees_trained"]
    assert pm.forest.feature.shape[0] == jl["num_trees"]
    # One host read a chunk of min(30, 25) trees.
    assert reads == -(-jl["num_trees_trained"] // 25)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(pl[key], jl[key], rtol=1e-5)
    assert [r["iteration"] for r in pl["iterations"]] == [
        r["iteration"] for r in jl["iterations"]]


def test_default_train_grows_the_jax_trees(defaults):
    """Tree 0 equal, categorical masks included (here every kept tree)."""
    jm, pm, _, _ = defaults
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    assert (jf["is_cat"][0] & ~jf["is_leaf"][0]).any()
    for field in NODE_FIELDS:
        assert jf[field].dtype == pf[field].dtype, field
        assert np.array_equal(pf[field][0], jf[field][0]), field
        assert np.array_equal(pf[field], jf[field]), field
    assert np.array_equal(pf["leaf_value"].view(np.int32),
                          jf["leaf_value"].view(np.int32))
    assert np.array_equal(pm.initial_predictions, jm.initial_predictions)
    fresh = fresh_frame(800, 6)
    np.testing.assert_allclose(pm.predict(fresh), jm.predict(fresh),
                               rtol=0, atol=1e-5)


def test_default_train_takes_a_dataframe(defaults):
    """A pandas DataFrame of numerical and string columns trains the same
    model as the dict of its columns."""
    pd = pytest.importorskip("pandas")
    _, pm, _, data = defaults
    dm = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", device="cpu").train(pd.DataFrame(data))
    df, pf = dm.forest.to_numpy(), pm.forest.to_numpy()
    for field in NODE_FIELDS + ("leaf_value",):
        assert np.array_equal(df[field], pf[field]), field


def test_explicit_validation_set_matches_jax():
    require_jax()
    data = make_frame(2000, 8)
    valid = fresh_frame(600, 9)
    hp = dict(label="label", num_trees=60,
              early_stopping_num_trees_look_ahead=10)
    jm = ydf.GradientBoostedTreesLearner(**hp).train(data, valid=valid)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        device="cpu", **hp).train(data, valid=valid)
    jl, pl = jm.training_logs, pm.training_logs
    assert jl["num_trees_trained"] < 60
    assert (pl["num_trees"], pl["num_trees_trained"]) == (
        jl["num_trees"], jl["num_trees_trained"])
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    for field in NODE_FIELDS:
        assert np.array_equal(pf[field][0], jf[field][0]), field
    for field in NODE_FIELDS:
        assert np.array_equal(pf[field], jf[field]), field
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(pl[key], jl[key], rtol=1e-5)


def test_vector_sequences_with_categoricals_and_validation():
    """Vector-sequence anchors join between the numerical and the
    categorical features, as in the JAX package ([num, anchors, cat] while
    growing, anchors after the binned features in the forest), and the
    validation rows are scored through the same anchors: the same anchors
    and trees, the same kept and trained counts, losses within rtol
    1e-5."""
    require_jax()
    smoke = load_chip_smoke()
    d = smoke.make_vs_data(2000, max_len=6, dim=4, noise=2, radius=2.4)
    rng = np.random.default_rng(0)
    d["c"] = np.array([f"k{v}" for v in np.where(
        d["label"] == 1, rng.integers(0, 4, 2000), rng.integers(0, 9, 2000))])
    hp = dict(label="label", num_trees=12, max_depth=4,
              early_stopping_num_trees_look_ahead=5)
    jm = ydf.GradientBoostedTreesLearner(**hp).train(d)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                   **hp).train(d)
    jl, pl = jm.training_logs, pm.training_logs
    assert (pl["num_trees"], pl["num_trees_trained"]) == (
        jl["num_trees"], jl["num_trees_trained"])
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    for field in ("vs_anchor", "vs_feat", "vs_is_closer"):
        assert np.array_equal(pf[field], jf[field]), field
    for field in NODE_FIELDS:
        assert np.array_equal(pf[field], jf[field]), field
    F = pm.binner.num_features
    assert pm.binner.feature_names[F - 1] == "c"
    split = ~pf["is_leaf"]
    assert (pf["feature"][split] >= F).any()  # anchors
    assert (pf["feature"][split] == F - 1).any()  # the categorical
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(pl[key], jl[key], rtol=1e-5)


def test_no_validation_keeps_the_old_path():
    """validation_ratio=0 and early_stopping="NONE" train every tree, with
    no validation loss and no host read."""
    data = make_frame(600, 10)
    reads = port_gbt.HOST_READS
    for hp in (dict(validation_ratio=0.0), dict(early_stopping="NONE")):
        m = ydf_tpu_torch.GradientBoostedTreesLearner(
            label="label", num_trees=4, device="cpu", **hp).train(data)
        assert m.training_logs["num_trees"] == 4
        assert m.training_logs["num_trees_trained"] == 4
        assert m.training_logs["valid_loss"] is None
    assert port_gbt.HOST_READS == reads


def tiny_boost_inputs(seed=11, n=3000, F=6, Fc=2):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 32, (F, n)).astype(np.uint8)
    bins[F - Fc:] = rng.integers(0, 7, (Fc, n))
    y = ((bins[0] > 15) ^ (bins[F - 1] % 3 == 0)
         ^ (rng.uniform(size=n) < 0.2)).astype(np.float32)
    return torch.from_numpy(bins), torch.from_numpy(y), F - Fc


@pytest.mark.parametrize("chunk", [1, 7])
def test_trees_do_not_depend_on_the_chunking(monkeypatch, chunk):
    """The same trees and losses in chunks of `chunk` trees as in one
    chunk; the chunks only decide where the loop may stop."""
    bins_t, y, Fn = tiny_boost_inputs()
    va_bins, va_y, _ = tiny_boost_inputs(seed=12, n=900)
    cfg = TreeConfig(max_depth=4, max_frontier=8, num_bins=32)
    valid = port_gbt.ValidSet(va_bins, va_y, torch.ones(900), None)
    kw = dict(loss_obj=BinomialLogLikelihood(), rule=HessianGainRule(),
              tree_cfg=cfg, num_trees=12, shrinkage=0.1, num_numerical=Fn,
              valid=valid)
    one = port_gbt.boost(bins_t, y, torch.ones(3000), **kw)
    reads = port_gbt.HOST_READS
    monkeypatch.setattr(port_gbt, "MAX_CHUNK_TREES", chunk)
    many = port_gbt.boost(bins_t, y, torch.ones(3000), lookahead=11, **kw)
    assert port_gbt.HOST_READS - reads == len(many.chunk_walls) == -(
        -12 // chunk)
    assert many.trees.is_cat.any()
    for a, b in zip(one.trees, many.trees):
        assert torch.equal(a, b)
    assert torch.equal(one.train_loss, many.train_loss)
    assert torch.equal(one.valid_loss, many.valid_loss)


def test_early_stop_hit():
    assert not port_gbt.early_stop_hit(np.array([3.0, 2, 1]), 2)
    assert port_gbt.early_stop_hit(np.array([3.0, 1, 2, 2]), 2)
    assert not port_gbt.early_stop_hit(np.array([3.0, 1, 2, 2]), 0)


# ---- the committed fixture and chip_smoke.py ---------------------------


def test_train_default_fixture_matches_chip_smoke_constants():
    """The committed fixture was written for the configuration, the
    generator and the frames chip_smoke.py's phase 8 uses."""
    smoke = load_chip_smoke()
    with open(os.path.join(TRAIN_DEFAULT, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["rows"] == smoke.DEFAULT_ROWS
    assert cfg["test_rows"] == smoke.DEFAULT_TEST_ROWS
    assert cfg["cat_seed"] == smoke.DEFAULT_CAT_SEED
    assert cfg["data_seed"] == smoke.DATA_SEED
    assert cfg["compare_rows"] == smoke.DEFAULT_COMPARE_ROWS
    assert cfg["learner"] == smoke.DEFAULT_HP
    assert cfg["generator"] == dict(
        features=smoke.TRAIN_FEATURES,
        cat_vocabs=list(smoke.DEFAULT_CAT_VOCABS),
        missing_features=list(smoke.DEFAULT_MISSING))
    assert set(cfg["jax_impls"]) == {"hist_impl", "route_impl",
                                     "update_uses_fma", "hist_quant"}
    assert cfg["num_trees"] < cfg["num_trees_trained"] <= 300
    exp = np.load(os.path.join(TRAIN_DEFAULT, "expected.npz"))
    assert exp["valid_loss"].shape == (cfg["num_trees_trained"],)
    assert int(np.argmin(exp["valid_loss"])) + 1 == cfg["num_trees"]
    size = sum(os.path.getsize(os.path.join(TRAIN_DEFAULT, f))
               for f in os.listdir(TRAIN_DEFAULT))
    assert size < 2 << 20


def test_chip_smoke_frame_matches_the_fixture_generator():
    """chip_smoke.py's copy of the generator gives the fixture script's
    rows (at a small size; the SHA-256 of the full frames is checked on
    the card)."""
    require_jax()
    import sys

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_torch_port_fixtures as fixtures
    finally:
        sys.path.pop(0)
    smoke = load_chip_smoke()
    want = fixtures.make_frame(smoke.DEFAULT_CAT_SEED, 2000, 400,
                               keep_label=True)
    got = smoke.make_frame(2000, 400)
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        assert smoke.frame_sha256(w) == smoke.frame_sha256(g)


def test_fixture_model_loads_and_scores_like_jax():
    """The JAX model of the fixture, loaded by the port on the CPU,
    scores the stored rows' recipe bitwise."""
    smoke = load_chip_smoke()
    exp = np.load(os.path.join(TRAIN_DEFAULT, "expected.npz"))
    m = ydf_tpu_torch.load_model(TRAIN_DEFAULT, device="cpu")
    _, test = smoke.make_frame(0, 1024)  # the same recipe, fresh rows
    raw = m._raw_scores(test, combine="sum")[:, 0]
    assert raw.shape == (1024,) and np.isfinite(raw).all()
    assert m.training_logs["num_trees"] == m.forest.feature.shape[0]
    assert exp["raw"].shape == (1024,)


# ---- on the card -------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.gpu
def test_routed_kernel_on_categorical_tables():
    """csrc/histogram_routed.cu against its plain version on tables whose
    go_left rows are not prefixes of bins (categorical splits): new_slot
    and new_leaf equal, the histogram within the routed kernel's
    tolerance (f64 sums, rounded once)."""
    _need_card()
    rng = np.random.default_rng(21)
    F, n, B, L, Lh = 12, 100_000, 64, 16, 8
    bins_t = torch.from_numpy(rng.integers(0, B, (F, n)).astype(
        np.uint8)).cuda()
    stats = torch.from_numpy(rng.normal(size=(n, 3)).astype(
        np.float32)).cuda()
    do_split = np.zeros(L + 1, bool)
    do_split[:Lh] = True
    small_left = rng.uniform(size=Lh) < 0.5
    hmap = np.full(L + 1, Lh, np.int32)
    hmap[2 * np.arange(Lh)] = np.where(small_left, np.arange(Lh), Lh)
    hmap[2 * np.arange(Lh) + 1] = np.where(small_left, Lh, np.arange(Lh))
    left_id = np.where(do_split, 31 + 2 * np.arange(L + 1), 127)
    tables = histogram_kernels.RouteTables(*(
        torch.from_numpy(a).cuda() for a in (
            do_split, rng.integers(0, F, L + 1).astype(np.int32),
            rng.uniform(size=(L + 1, B)) < 0.4, left_id.astype(np.int32),
            np.where(do_split, left_id + 1, 127).astype(np.int32),
            np.where(do_split, np.arange(L + 1), 0).astype(np.int32),
            hmap, np.zeros(L + 1, bool), np.zeros(1, np.uint8))))
    slot = torch.from_numpy(np.where(rng.uniform(size=n) < 0.05, L,
                                     rng.integers(0, Lh, n)).astype(
        np.int32)).cuda()
    leaf = torch.from_numpy(rng.integers(15, 31, n).astype(np.int32)).cuda()
    args = (bins_t, slot, leaf, tables, stats, Lh, B)
    got = histogram_kernels.histogram_routed(*args)
    want = histogram_kernels.histogram_routed_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_default_train_on_card_matches_cpu_port():
    """Every default on the card and on the CPU, same data: the same kept
    and trained counts and the same tree 0; losses within rtol 1e-4 (the
    card's histogram cells round once from f64, as the plain version's,
    but its leaf sums carry the root kernel's f32 adds)."""
    _need_card()
    data = make_frame(20_000, 13)
    reads = port_gbt.HOST_READS
    cm = ydf_tpu_torch.GradientBoostedTreesLearner(label="label").train(
        data)
    card_reads = port_gbt.HOST_READS - reads
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", device="cpu").train(data)
    cl, pl = cm.training_logs, pm.training_logs
    assert cm.device.type == "cuda"
    assert (cl["num_trees"], cl["num_trees_trained"]) == (
        pl["num_trees"], pl["num_trees_trained"])
    assert card_reads == -(-cl["num_trees_trained"] // 25)
    cf, pf = cm.forest.to_numpy(), pm.forest.to_numpy()
    for field in NODE_FIELDS:
        assert np.array_equal(cf[field][0], pf[field][0]), field
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(cl[key], pl[key], rtol=1e-4)
