"""The RANKING task on ydf_tpu_torch's GBT, held against the JAX package
on the CPU: query-group registration (build_group_rows, its truncation
warning), the LambdaMART-NDCG and XE-NDCG gradients, hessians and
losses against jax.jit of the JAX methods (ties, all-zero groups,
padding, truncation), the SELGB mask, the validation split by whole
query groups, small GBTs trained by both packages (default, XE-NDCG,
SELGB, an explicit valid=, truncated groups), JAX-saved ranking models,
save -> load with the model's metadata, and the ranking metrics.

Tolerance: bitwise (rows, gradients, hessians, losses, masks, node
arrays, leaf values, predictions) where the groups are longer than 32
rows; XLA's reduce of 32 or fewer terms fused with its producer is
vectorized in an order not identified (ROADMAP Queue 3), so at G <= 32
the gradients are held within 4 ulps (rtol 5e-7, atol 1e-7 times the
largest) and the losses within rtol 1e-6. Evaluation metrics within
1e-12 (host float64 on the same predictions).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import os
import warnings

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.learners import ranking_loss as jax_rank
    from ydf_tpu.metrics import metrics as jax_metrics
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.learners import ranking_loss
from ydf_tpu_torch.metrics import metrics
from test_torch_default_train import load_chip_smoke

torch.set_num_threads(1)
SMOKE = load_chip_smoke()
NODE_FIELDS = ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
               "right", "is_leaf", "num_nodes", "threshold", "leaf_value")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def rank_case(seed, groups, lo, hi, scores="normal"):
    """Relevances (MSLR's skew, one all-zero group), scores and group
    ids (shuffled, non-contiguous) of `groups` groups of lo..hi rows."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(lo, hi + 1, groups)
    g = np.repeat(rng.permutation(groups) * 7 + 3, sizes)
    rng.shuffle(g)
    n = len(g)
    y = rng.choice(5, size=n, p=SMOKE.RANK_SKEW).astype(np.float32)
    y[g == g[0]] = 0
    if scores == "zero":
        s = np.zeros(n, np.float32)
    elif scores == "ties":
        s = (rng.randint(0, 3, n) * 0.25).astype(np.float32)
    else:
        s = (rng.randn(n) * 2).astype(np.float32)
    return y, s, g


def jax_loss(cls, y, s, g, trunc, max_group=2048):
    rows, _ = jax_rank.build_group_rows(g, max_group)
    loss = cls(ndcg_truncation=trunc)
    loss.register_groups("train", len(y), rows)
    gh = jax.jit(lambda y, p: loss.grad_hess(y, p))(jnp.asarray(y),
                                                    jnp.asarray(s[:, None]))
    lo = jax.jit(lambda y, p: loss.loss(y, p, None))(jnp.asarray(y),
                                                     jnp.asarray(s[:, None]))
    return np.asarray(gh[0])[:, 0], np.asarray(gh[1])[:, 0], np.float32(lo)


def port_loss(cls, y, s, g, trunc, max_group=2048):
    rows, _ = ranking_loss.build_group_rows(g, max_group)
    loss = cls(ndcg_truncation=trunc)
    loss.register_groups("train", len(y), rows)
    yt, st = torch.from_numpy(y), torch.from_numpy(s)
    gr, hs = loss.grad_hess(yt, st)
    return gr.numpy(), hs.numpy(), loss.loss(yt, st, None).numpy()


def test_build_group_rows_matches_jax_and_warns_on_truncation():
    require_jax()
    _, _, g = rank_case(0, 25, 3, 60)
    for cap in (2048, 20):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            want, wG = jax_rank.build_group_rows(g, cap)
        with warnings.catch_warnings(record=True) as got_w:
            warnings.simplefilter("always")
            got, gG = ranking_loss.build_group_rows(g, cap)
        assert gG == wG and np.array_equal(got, want)
        assert [str(w.message) for w in got_w] == [
            str(w.message) for w in caught]
        assert bool(got_w) == (cap == 20)


CASES = {
    # name: (seed, groups, lo, hi, scores, truncation, max group); more
    # than 32 groups of more than 32 rows (the orders identified).
    "g40": (0, 40, 3, 40, "normal", 5, 2048),
    "g70_ties": (6, 36, 3, 70, "ties", 3, 2048),
    "g60_zero_scores": (5, 35, 3, 60, "zero", 5, 2048),
    "g100_trunc10": (3, 34, 30, 100, "normal", 10, 2048),
    "truncated_groups": (7, 40, 3, 120, "normal", 5, 64),
}


@pytest.mark.parametrize("cls", ["LambdaMartNdcg", "XeNdcg"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ranking_losses_bitwise_to_jax(cls, case):
    """grad_hess and loss of both losses against jax.jit of the JAX
    methods, bitwise, at groups longer than 32 rows: ties at iteration
    0's all-zero scores, tied scores, an all-zero-relevance group,
    padding, truncations 3 to 10 and groups cut at 64 rows."""
    require_jax()
    seed, groups, lo, hi, scores, trunc, cap = CASES[case]
    y, s, g = rank_case(seed, groups, lo, hi, scores)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_loss(getattr(jax_rank, cls), y, s, g, trunc, cap)
        got = port_loss(getattr(ranking_loss, cls), y, s, g, trunc, cap)
    for a, b in zip(got, want):
        assert np.array_equal(bits(a), bits(b)), case


@pytest.mark.parametrize("cls", ["LambdaMartNdcg", "XeNdcg"])
@pytest.mark.parametrize("hi,groups", [(12, 40), (28, 30), (40, 12)])
def test_ranking_losses_short_sums_within_tolerance(cls, hi, groups):
    """Groups of 12 rows (the orders identified), of 28 rows (XLA fuses
    the pair sums into vectorized reduces of an unidentified order) and
    12 groups of 40 rows: within 4 ulps of the largest value."""
    require_jax()
    y, s, g = rank_case(hi, groups, 3, hi)
    want = jax_loss(getattr(jax_rank, cls), y, s, g, 5)
    got = port_loss(getattr(ranking_loss, cls), y, s, g, 5)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=5e-7,
                                   atol=1e-7 * np.abs(b).max())
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


def test_group_chunks_change_no_value(monkeypatch):
    """The pair tensors formed for chunks of 7 groups give the one-batch
    gradients and hessians bitwise."""
    y, s, g = rank_case(9, 40, 3, 60)
    rows, G = ranking_loss.build_group_rows(g)
    out = []
    for chunk_bytes in (ranking_loss.GROUP_CHUNK_BYTES, G * G * 4 * 7):
        monkeypatch.setattr(ranking_loss, "GROUP_CHUNK_BYTES", chunk_bytes)
        loss = ranking_loss.LambdaMartNdcg()
        loss.register_groups("train", len(y), rows)
        out.append(loss.grad_hess(torch.from_numpy(y), torch.from_numpy(s)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_discounts_and_gains_replay_xla():
    """1 / log2(i + 2) with XLA's log (numpy's differs by an ulp at
    i = 4) and exp2(y) - 1 exact for relevance 0-4."""
    require_jax()
    G = 300
    want = np.asarray(jax.jit(lambda: 1.0 / jnp.log2(
        jnp.arange(G, dtype=jnp.float32) + 2.0))())
    got = ranking_loss.position_discounts(G, G, "cpu").numpy()
    assert np.array_equal(bits(got), bits(want))
    y = torch.arange(5, dtype=torch.float32)
    gains = ranking_loss.exp2_gains(y, torch.ones(5, dtype=torch.bool))
    assert gains.tolist() == [0.0, 1.0, 3.0, 7.0, 15.0]


def jax_selgb(rows, y, preds, ratio):
    """The JAX package's SELGB mask (ydf_tpu/learners/gbt.py:1165-1186),
    jitted, on rows [groups, G] padded with n."""
    n = preds.shape[0]

    def f(y_f, preds):
        pad = rows >= n
        s_g = jnp.where(pad, -jnp.inf, preds[rows.clip(0, n - 1)])
        pos_g = (y_f[rows.clip(0, n - 1)] > 0) & ~pad
        neg_g = ~pos_g & ~pad
        neg_score = jnp.where(neg_g, s_g, -jnp.inf)
        order = jnp.argsort(-neg_score, axis=1)
        rank = jnp.argsort(order, axis=1)
        n_neg = jnp.sum(neg_g, axis=1, keepdims=True)
        keep_neg = neg_g & (rank < jnp.ceil(ratio * n_neg))
        keep_g = pos_g | keep_neg
        mask = jnp.zeros((n + 1,), jnp.float32)
        mask = mask.at[jnp.where(pad, n, rows).reshape(-1)].set(
            keep_g.reshape(-1).astype(jnp.float32))
        return mask[:n]

    return np.asarray(jax.jit(f)(jnp.asarray(y), jnp.asarray(preds)))


@pytest.mark.parametrize("scores,ratio", [("zero", 0.01), ("ties", 0.3),
                                          ("normal", 0.1)])
def test_selgb_mask_matches_jax(scores, ratio):
    require_jax()
    y, s, g = rank_case(11, 15, 3, 90, scores)
    rows, _ = ranking_loss.build_group_rows(g, 64)
    rows = np.where(rows < 0, len(y), rows)
    want = jax_selgb(rows, y, s, ratio)
    got = port_gbt.selgb_mask(torch.from_numpy(rows), torch.from_numpy(y),
                              torch.from_numpy(s), ratio)
    assert np.array_equal(bits(got.numpy()), bits(want))
    assert 0 < want.sum() < len(y)


def rank_frames(seed=3, queries=40, docs=(3, 40)):
    train = SMOKE.make_rank_frame(queries, seed, docs, 8)
    test = SMOKE.make_rank_frame(15, seed + 1, docs, 8, first_query=queries)
    return train, test


def test_group_validation_split_matches_jax(monkeypatch):
    """The training and validation query groups each package registers
    (both capture build_group_rows's input)."""
    require_jax()
    import ydf_tpu.learners.ranking_loss as jr

    train, _ = rank_frames(queries=33)
    seen = {"jax": [], "port": []}
    jax_build, port_build = jr.build_group_rows, port_gbt.build_group_rows

    def capture(side, fn):
        def wrapped(groups, max_group_size=2048):
            seen[side].append(np.asarray(groups).copy())
            return fn(groups, max_group_size)
        return wrapped

    monkeypatch.setattr(jr, "build_group_rows", capture("jax", jax_build))
    monkeypatch.setattr(port_gbt, "build_group_rows",
                        capture("port", port_build))
    kw = dict(label="relevance", ranking_group="query", num_trees=3,
              validation_ratio=0.25, random_seed=17)
    ydf.GradientBoostedTreesLearner(task=JaxTask.RANKING, **kw).train(train)
    ydf_tpu_torch.GradientBoostedTreesLearner(
        task=Task.RANKING, device="cpu", **kw).train(train)
    assert len(seen["jax"]) == len(seen["port"]) == 2
    for a, b in zip(seen["jax"], seen["port"]):
        assert np.array_equal(a, b)
    va = seen["port"][1]
    assert len(np.unique(va)) == 8
    assert not set(np.unique(va)) & set(np.unique(seen["port"][0]))


def train_both(train, test, valid=None, **kw):
    kw = dict(dict(label="relevance", ranking_group="query",
                   num_trees=12), **kw)
    jm = ydf.GradientBoostedTreesLearner(task=JaxTask.RANKING, **kw).train(
        train, valid=valid)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        task=Task.RANKING, device="cpu", **kw).train(train, valid=valid)
    return jm, pm


def assert_same_model(jm, pm, test, metric_tol=1e-12):
    jf = {f: np.asarray(getattr(jm.forest, f)) for f in NODE_FIELDS}
    pf = pm.forest.to_numpy()
    for f in NODE_FIELDS:
        assert np.array_equal(bits(pf[f]), bits(jf[f])), f
    jl, pl = jm.training_logs, pm.training_logs
    assert (pl["num_trees"], pl["num_trees_trained"]) == (
        jl["num_trees"], jl["num_trees_trained"])
    for key in ("train_loss", "valid_loss"):
        if jl[key] is not None:
            assert np.array_equal(np.float32(pl[key]), np.float32(jl[key]))
    assert np.array_equal(bits(pm.predict(test)),
                          bits(np.asarray(jm.predict(test))))
    je, pe = jm.evaluate(test).metrics, pm.evaluate(test).metrics
    assert je.keys() == pe.keys()
    for k in je:
        assert abs(pe[k] - je[k]) <= metric_tol, k
    assert pm.extra_metadata == jm.extra_metadata


@pytest.mark.parametrize("option", ["default", "xe_ndcg", "selgb",
                                    "valid", "max_group"])
def test_small_ranking_gbts_match_jax(option):
    """Every tree, the kept count, the losses, the predictions and the
    evaluation of a small ranking GBT trained by both packages."""
    require_jax()
    train, test = rank_frames()
    valid = None
    kw = {}
    if option == "xe_ndcg":
        kw["loss"] = "XE_NDCG_MART"
    elif option == "selgb":
        kw["sampling_method"] = "SELGB"
        kw["selective_gradient_boosting_ratio"] = 0.2
    elif option == "valid":
        valid = SMOKE.make_rank_frame(10, 9, (3, 40), 8, first_query=500)
    elif option == "max_group":
        train, test = rank_frames(docs=(20, 60))
        kw["ranking_max_group_size"] = 40
        kw["ndcg_truncation"] = 3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm, pm = train_both(train, test, valid, **kw)
    assert_same_model(jm, pm, test)


def test_ranking_models_load_and_save_both_ways(tmp_path):
    """A JAX-saved ranking model loads in the port and predicts bitwise;
    the port's save keeps extra_metadata, so evaluate still reads the
    groups; the JAX package loads the port's save."""
    require_jax()
    train, test = rank_frames(seed=8)
    jm = ydf.GradientBoostedTreesLearner(
        label="relevance", task=JaxTask.RANKING, ranking_group="query",
        num_trees=6, ndcg_truncation=4).train(train)
    jm.save(str(tmp_path / "jax"))
    pm = ydf_tpu_torch.load_model(str(tmp_path / "jax"), device="cpu")
    assert pm.task == Task.RANKING
    assert pm.extra_metadata == {"ranking_group": "query",
                                 "ndcg_truncation": 4}
    want = np.asarray(jm.predict(test))
    assert np.array_equal(bits(pm.predict(test)), bits(want))
    pm.save(str(tmp_path / "port"))
    back = ydf_tpu_torch.load_model(str(tmp_path / "port"), device="cpu")
    assert back.extra_metadata == jm.extra_metadata
    ev, jev = back.evaluate(test).metrics, jm.evaluate(test).metrics
    assert set(ev) == {"ndcg@4", "mrr", "map@4"}
    assert all(abs(ev[k] - jev[k]) <= 1e-12 for k in jev)
    jback = ydf.load_model(str(tmp_path / "port"))
    assert np.array_equal(bits(np.asarray(jback.predict(test))), bits(want))


@pytest.mark.parametrize("ci", [False, True])
def test_ranking_metrics_match_jax(ci):
    """NDCG@k, MRR and MAP@k (and the bootstrap over query groups)
    against the JAX package's evaluate_predictions, within 1e-12."""
    require_jax()
    y, s, g = rank_case(4, 30, 3, 40, "ties")
    kw = dict(groups=g, ndcg_truncation=3, confidence_intervals=ci,
              num_bootstrap=40)
    want = jax_metrics.evaluate_predictions(JaxTask.RANKING, y, s, **kw)
    got = metrics.evaluate_predictions(Task.RANKING, y, s, **kw)
    assert got.metrics.keys() == want.metrics.keys()
    for k in want.metrics:
        assert abs(got.metrics[k] - want.metrics[k]) <= 1e-12
    if ci:
        for k, (lo, hi) in want.confidence_intervals.items():
            glo, ghi = got.confidence_intervals[k]
            assert abs(glo - lo) <= 1e-12 and abs(ghi - hi) <= 1e-12


def test_ranking_surface_errors():
    train, _ = rank_frames()
    with pytest.raises(ValueError, match="requires ranking_group"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="relevance", task=Task.RANKING, device="cpu",
            num_trees=1).train(train)
    with pytest.raises(ValueError, match="requires task=Task.RANKING"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="relevance", task=Task.REGRESSION, device="cpu",
            loss="LAMBDA_MART_NDCG", num_trees=1).train(train)
    with pytest.raises(ValueError, match="SELGB needs a ranking loss"):
        ydf_tpu_torch.GradientBoostedTreesLearner(
            label="relevance", task=Task.RANKING, ranking_group="query",
            loss="SQUARED_ERROR", sampling_method="SELGB", device="cpu",
            num_trees=1).train(train)
    # A ranking task takes a pointwise loss by name, without groups.
    m = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="relevance", task=Task.RANKING, ranking_group="query",
        loss="SQUARED_ERROR", device="cpu", num_trees=2).train(train)
    assert m.loss_name == "SQUARED_ERROR"
    spec = m.dataspec.column_by_name("query")
    assert spec.type.value == "HASH" and spec.vocabulary is None
    assert "query" not in m.binner.feature_names


@pytest.mark.gpu
@pytest.mark.parametrize("cls", ["LambdaMartNdcg", "XeNdcg"])
def test_ranking_losses_on_card_equal_cpu(cls):
    """The losses' plain PyTorch on the card: gradients, hessians and
    loss bitwise to the CPU's (XLA's arithmetic replayed in f64), with
    no host sync."""
    _need_card()
    y, s, g = rank_case(2, 60, 3, 200)
    rows, _ = ranking_loss.build_group_rows(g)
    out = []
    for dev in ("cpu", "cuda"):
        loss = getattr(ranking_loss, cls)()
        loss.register_groups("train", len(y), rows, dev)
        yt, st = torch.from_numpy(y).to(dev), torch.from_numpy(s).to(dev)
        if dev == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            gr, hs = loss.grad_hess(yt, st)
            lo = loss.loss(yt, st, None)
        finally:
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        out.append([t.cpu().numpy() for t in (gr, hs, lo)])
    for a, b in zip(*out):
        assert np.array_equal(bits(a), bits(b))


@pytest.mark.gpu
def test_small_ranking_gbt_on_card_equals_cpu():
    """A small SELGB ranking GBT on the card: every tree and the
    predictions bitwise to the CPU port's."""
    _need_card()
    train, test = rank_frames()
    kw = dict(label="relevance", task=Task.RANKING, ranking_group="query",
              num_trees=8, sampling_method="SELGB")
    cpu = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                    **kw).train(train)
    card = ydf_tpu_torch.GradientBoostedTreesLearner(device="cuda",
                                                     **kw).train(train)
    a, b = cpu.forest.to_numpy(), card.forest.to_numpy()
    for f in NODE_FIELDS:
        assert np.array_equal(bits(a[f]), bits(b[f])), f
    assert np.array_equal(bits(cpu.predict(test)), bits(card.predict(test)))
