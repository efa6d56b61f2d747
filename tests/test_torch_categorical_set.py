"""CATEGORICAL_SET columns on ydf_tpu_torch, held against the JAX package
on the CPU: tokenization and the item dictionary, the binner's set block
and its packed words, the per-item sums in XLA's dot order, the set
candidates (left stats, ranks in both orders, least ranks), the grower's
set splits (one informative item isolated from either end of the order),
routing with missing and unseen items, GBT, random forest and CART
trainings on a small set frame, and saves loaded by the other package.

The JAX side trains with its CPU defaults (the native histogram and
fused routing); stand-alone JAX functions pin hist_impl="native".
Tolerance: bitwise everywhere (dictionaries, words, per-item sums, ranks,
left stats, every node array, leaf values, predictions); evaluation
metrics within 1e-12 (host float64 on the same predictions).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax
    import jax.numpy as jnp

    import ydf_tpu as ydf
    from ydf_tpu.dataset import dataspec as jax_dataspec
    from ydf_tpu.dataset.binning import Binner as JaxBinner
    from ydf_tpu.dataset.dataset import Dataset as JaxDataset
    from ydf_tpu.ops import grower as jax_grower
    from ydf_tpu.ops.histogram import histogram as jax_histogram
    from ydf_tpu.ops.routing import route_tree_values as jax_route_values
    from ydf_tpu.ops.split_rules import HessianGainRule as JaxRule
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.dataset import dataspec
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import Dataset
from ydf_tpu_torch.ops import grower, histogram_kernels, segment_sum
from ydf_tpu_torch.ops.histogram_kernels import RouteTables
from ydf_tpu_torch.ops.routing import route_tree_values
from ydf_tpu_torch.ops.split_rules import HessianGainRule

torch.set_num_threads(1)
NODE_FIELDS = ("feature", "threshold_bin", "is_cat", "is_set", "cat_mask",
               "left", "right", "is_leaf", "num_nodes")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def set_frame(n, seed=5, vocabs=(30, 80), test=False):
    """A small train_sets frame: 6 normal features, "tags" (0-6 items a
    row) and "words" (0-20), Zipf-like item frequencies, a label from a
    logit with a "holds t2" and a "holds w5 and f0 > 0" term; 2% of the
    cells missing; with test, 5% of the cells gain an unseen item."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    cols = {}
    for name, vocab, most in (("tags", vocabs[0], 6),
                              ("words", vocabs[1], 20)):
        p = 1.0 / np.arange(1, vocab + 1) ** 1.1
        cells = np.empty(n, dtype=object)
        for i in range(n):
            k = rng.integers(0, most + 1)
            items = rng.choice(vocab, size=k, p=p / p.sum())
            cells[i] = [f"{name[0]}{v}" for v in sorted(set(items))]
        cols[name] = cells
    has_a = np.array(["t2" in c for c in cols["tags"]])
    has_b = np.array(["w5" in c for c in cols["words"]])
    logit = (x[:, 0] - 0.5 * x[:, 1] + np.sin(2 * x[:, 2]) + 1.5 * has_a
             - 1.0 * (has_b & (x[:, 0] > 0)))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    for cells in cols.values():
        for i in np.flatnonzero(rng.uniform(size=n) < 0.02):
            cells[i] = None
        if test:
            for i in np.flatnonzero(rng.uniform(size=n) < 0.05):
                if cells[i] is not None:
                    cells[i] = cells[i] + ["unseen"]
    data = {f"f{i}": x[:, i] for i in range(6)}
    data.update(cols, label=y)
    return data


def bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


# ---- dictionary and encoding -------------------------------------------


CELLS = [["a", "b"], ("b", "c"), {"c"}, np.array(["a", "d"]), "a b;c,d",
         "", "NA", None, float("nan"), [], "e", ["a", "a"], 7, [1, 2]]


def test_tokenize_matches_jax():
    require_jax()
    for cell in CELLS:
        assert (dataspec.tokenize_set_value(cell)
                == jax_dataspec.tokenize_set_value(cell)), cell


@pytest.mark.parametrize("min_freq,max_count", [(1, -1), (5, 2000),
                                                (3, 4)])
def test_set_dictionary_matches_jax(min_freq, max_count):
    require_jax()
    data = set_frame(600)
    col = np.array(CELLS * 10 + list(data["tags"]), dtype=object)
    kw = dict(min_vocab_frequency=min_freq, max_vocab_count=max_count,
              force_type=dataspec.ColumnType.CATEGORICAL_SET)
    got = dataspec.infer_column("s", col, **kw)
    want = jax_dataspec.infer_column(
        "s", col, min_vocab_frequency=min_freq, max_vocab_count=max_count,
        force_type=jax_dataspec.ColumnType.CATEGORICAL_SET)
    for field in ("vocabulary", "vocab_counts", "num_values",
                  "num_missing"):
        assert getattr(got, field) == getattr(want, field), field
    # Inferred from the cells, and through the JSON form.
    spec = dataspec.infer_dataspec({"s": col}, min_vocab_frequency=min_freq,
                                   max_vocab_count=max_count)
    back = dataspec.DataSpecification.from_json(spec.to_json())
    assert back.column_by_name("s").vocabulary == want.vocabulary
    assert back.column_by_name("s").type == \
        dataspec.ColumnType.CATEGORICAL_SET


def test_binner_set_block_and_words_match_jax():
    """Layout [numericals, categoricals, sets], the uncapped dictionary
    as feature_num_bins, set_width_words, and transform_sets' words on
    fresh rows with unseen items and missing cells; the encoder's
    missing mask."""
    require_jax()
    data = set_frame(1500)
    data["c"] = np.array(["x", "y", "z"] * 500)
    fresh = set_frame(400, seed=9, test=True)
    fresh["c"] = np.array(["x", "q"] * 200)
    ds = Dataset.from_data(data, label="label")
    jds = JaxDataset.from_data(data, label="label")
    feats = ["f0", "f1", "c", "tags", "words"]
    b = Binner.fit(ds, feats, num_bins=64)
    jb = JaxBinner.fit(jds, feats, num_bins=64)
    assert b.feature_names == jb.feature_names
    assert (b.num_numerical, b.num_set, b.num_scalar) == (
        jb.num_numerical, jb.num_set, jb.num_scalar)
    assert np.array_equal(b.feature_num_bins, jb.feature_num_bins)
    assert b.set_width_words == jb.set_width_words == 3
    for frame in (data, fresh):
        pds = Dataset.from_data(frame, dataspec=ds.dataspec)
        jfds = JaxDataset.from_data(frame, dataspec=jds.dataspec)
        got, want = b.transform_sets(pds), jb.transform_sets(jfds)
        assert got.dtype == want.dtype == np.uint32
        assert np.array_equal(got, want)
        assert np.array_equal(
            b.transform(pds, "cpu").numpy(),
            jb.transform(jfds, impl="numpy"))
        for name in ("tags", "words"):
            assert np.array_equal(
                pds.categorical_set_missing_mask(name),
                jfds.categorical_set_missing_mask(name))
    assert Binner.from_json(jb.to_json()).num_set == 2


# ---- the set candidates ------------------------------------------------


def packed_rows(n, Fs, Ws, rng, density=0.1):
    """Random packed set rows u32 [n, Fs, Ws]."""
    member = rng.uniform(size=(n, Fs, 32 * Ws)) < density
    shifts = np.arange(32, dtype=np.uint32)
    return (member.reshape(n, Fs, Ws, 32).astype(np.uint32)
            << shifts).sum(-1).astype(np.uint32)


def grad_stats(n, rng):
    g = rng.normal(size=n).astype(np.float32) * 0.3
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    return np.stack([g, h, np.ones(n, np.float32)], 1)


@pytest.mark.parametrize("n,Fs,Ws,Ld", [(3000, 2, 1, 4), (700, 1, 2, 2),
                                        (5000, 2, 3, 8), (1500, 1, 1, 2)])
def test_set_item_stats_match_the_xla_dot(n, Fs, Ws, Ld):
    """The per-item sums equal jax.jit of the JAX grower's einsum bitwise
    (blocks of rows in row order), while one f64 sum of each cell
    rounded once does not (the order matters at these shapes)."""
    require_jax()
    rng = np.random.default_rng(n + Ld)
    sets = packed_rows(n, Fs, Ws, rng)
    slot = rng.integers(0, Ld + 1, n).astype(np.int32)  # Ld: off-layer
    stats = grad_stats(n, rng)
    Vs = 32 * Ws

    @jax.jit
    def per_item(set_bits, slot, stats):
        shifts = jnp.arange(32, dtype=jnp.uint32)
        multi = (((set_bits[..., None] >> shifts) & jnp.uint32(1)) > 0
                 ).reshape(n, Fs, Vs)
        oh = (slot[:, None] == jnp.arange(Ld)).astype(jnp.float32)
        return jnp.einsum("nfv,nl,ns->lfvs", multi.astype(jnp.float32), oh,
                          stats)

    want = np.asarray(per_item(jnp.asarray(sets), jnp.asarray(slot),
                               jnp.asarray(stats)))
    members = grower.set_members(torch.from_numpy(sets.view(np.int32)))
    got = grower.set_item_stats(members, torch.from_numpy(slot),
                                torch.from_numpy(stats), Ld).numpy()
    assert np.array_equal(bits(got), bits(want))
    multi = ((sets[..., None] >> np.arange(32, dtype=np.uint32)) & 1
             ).reshape(n, Fs, Vs).astype(np.float64)
    oh = (slot[:, None] == np.arange(Ld)).astype(np.float64)
    f64 = np.einsum("nfv,nl,ns->lfvs", multi, oh,
                    stats.astype(np.float64)).astype(np.float32)
    if n > 1000:
        assert not np.array_equal(f64, want)


def jax_set_candidates(sets, slot, stats, parent, Ld, L, B):
    """The JAX grower's set-candidate block (ydf_tpu/ops/grower.py, the
    Fs > 0 branch of the layer loop) on its own, in jax.jit, with the
    native histogram: (left stats [Ld, 2 Fs, B, S], the two directions'
    ranks, the two directions' least ranks)."""
    n, Fs, Ws = sets.shape
    Vs = 32 * Ws
    Tc = min(Vs, B)
    rule = JaxRule()

    @jax.jit
    def run(set_bits, slot, stats, parent):
        shifts = jnp.arange(32, dtype=jnp.uint32)
        multi = (((set_bits[..., None] >> shifts) & jnp.uint32(1)) > 0
                 ).reshape(n, Fs, Vs)
        oh = (slot[:, None] == jnp.arange(Ld)).astype(jnp.float32)
        per_item = jnp.einsum("nfv,nl,ns->lfvs", multi.astype(jnp.float32),
                              oh, stats)
        skey = rule.cat_sort_key(per_item, None)
        present = per_item[..., -1] > 0
        out = []
        for dkey in (jnp.where(present, skey, jnp.inf),
                     jnp.where(present, -skey, jnp.inf)):
            sranks = jnp.argsort(jnp.argsort(dkey, axis=-1), axis=-1
                                 ).astype(jnp.int32)
            ranks_pad = jnp.concatenate(
                [sranks, jnp.full((L + 1 - Ld, Fs, Vs), Vs, jnp.int32)], 0)
            rms, hists = [], []
            for f in range(Fs):
                rs = ranks_pad[:, f][slot]
                rm = jnp.min(jnp.where(multi[:, f], rs, Vs), axis=1)
                rms.append(rm)
                in_cut = (rm < Tc).astype(jnp.float32)
                h = jax_histogram(
                    jnp.minimum(rm, Tc - 1)[:, None], slot,
                    stats * in_cut[:, None], num_slots=Ld, num_bins=Tc,
                    impl="native", quant="f32")
                hists.append(h[:, 0])
            left = parent[:, None, None, :] - jnp.cumsum(
                jnp.stack(hists, 1), axis=2)
            if Tc < B:
                left = jnp.pad(left, ((0, 0), (0, 0), (0, B - Tc), (0, 0)),
                               constant_values=-1.0)
            out.append((left, sranks, jnp.stack(rms, 1)))
        return (jnp.concatenate([out[0][0], out[1][0]], 1),
                (out[0][1], out[1][1]), (out[0][2], out[1][2]))

    return jax.tree.map(np.asarray, run(
        jnp.asarray(sets), jnp.asarray(slot), jnp.asarray(stats),
        jnp.asarray(parent)))


@pytest.mark.parametrize("Ws,B", [(2, 64), (1, 64), (3, 64)])
def test_set_candidates_match_jax(Ws, B):
    """left_set (parent minus the prefix histograms, -1 past Tc), the
    items' ranks in both orders and each row's least rank."""
    require_jax()
    rng = np.random.default_rng(Ws)
    n, Fs, Ld, L = 2500, 2, 4, 8
    sets = packed_rows(n, Fs, Ws, rng, density=0.15)
    slot = rng.integers(0, Ld, n).astype(np.int32)
    slot[rng.uniform(size=n) < 0.1] = L  # retired rows
    stats = grad_stats(n, rng)
    parent = np.stack([stats[slot == s].sum(0) for s in range(Ld)]
                      ).astype(np.float32)
    want_left, want_ranks, want_rm = jax_set_candidates(
        sets, slot, stats, parent, Ld, L, B)
    members = grower.set_members(torch.from_numpy(sets.view(np.int32)))
    left, ranks, rm = grower.set_candidates(
        members, torch.from_numpy(slot), torch.from_numpy(stats),
        torch.from_numpy(parent), rule=HessianGainRule(), Ld=Ld, L=L, B=B)
    assert np.array_equal(bits(left.numpy()), bits(want_left))
    for d in range(2):
        assert np.array_equal(ranks[d].numpy(), want_ranks[d])
        assert np.array_equal(rm[d].numpy(), want_rm[d])


def test_grower_set_splits_match_jax():
    """A depth-5 tree over 4 numerical and 2 set features, the fused
    routed layers carrying set splits: every node array, leaf stats and
    each row's leaf bitwise."""
    require_jax()
    rng = np.random.default_rng(3)
    n, F = 4000, 4
    bins = rng.integers(0, 64, (n, F)).astype(np.uint8)
    sets = packed_rows(n, 2, 2, rng, density=0.08)
    member = lambda f, v: ((sets[:, f, v >> 5] >> np.uint32(v & 31)) & 1
                           ).astype(bool)
    score = (bins[:, 0] / 32 - 1 + 1.5 * member(0, 3)
             - 1.0 * (member(1, 7) & (bins[:, 1] > 30)))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-score))).astype(np.float32)
    p = (1 / (1 + np.exp(-rng.normal(size=n) * 0.3))).astype(np.float32)
    stats = np.stack([p - y, p * (1 - p), np.ones(n, np.float32)], 1
                     ).astype(np.float32)
    kw = dict(max_depth=5, frontier=16, max_nodes=63, num_bins=64,
              min_examples=5)
    want = jax_grower.grow_tree(
        jnp.asarray(bins), jnp.asarray(stats), jax.random.PRNGKey(0),
        hist_impl="native", hist_quant="f32", hist_subtract=True,
        route_impl="native", route_fuse=True, rule=JaxRule(),
        num_numerical=F, set_bits=jnp.asarray(sets), **kw)
    got = grower.grow_tree(
        torch.from_numpy(bins.T.copy()), torch.from_numpy(stats),
        rule=HessianGainRule(), num_numerical=F,
        set_members=grower.set_members(torch.from_numpy(
            sets.view(np.int32))), **kw)
    wt = {k: np.asarray(v) for k, v in want.tree._asdict().items()}
    gt = {k: v.numpy() for k, v in got.tree._asdict().items()}
    gt["cat_mask"] = gt["cat_mask"].view(np.uint32)
    assert wt["is_set"].sum() >= 5
    for field in NODE_FIELDS + ("leaf_stats",):
        assert np.array_equal(gt[field], wt[field]), field
    assert np.array_equal(got.leaf_id.numpy(), np.asarray(want.leaf_id))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_grower_isolates_one_item_from_either_end(sign):
    """tests/test_categorical_set.py's single informative item: with the
    gradient's sign flipped the item sits at the other end of the order,
    and both packages split it off, bitwise."""
    require_jax()
    rng = np.random.RandomState(0)
    n = 1000
    member = rng.uniform(size=(n, 4)) < 0.4
    member[:, 0] = False
    packed = np.zeros((n, 1, 1), np.uint32)
    for v in range(4):
        packed[member[:, v], 0, 0] |= np.uint32(1) << v
    bins = rng.randint(0, 256, size=(n, 1)).astype(np.uint8)
    y = member[:, 1].astype(np.float32)
    g = sign * (0.5 - y)
    stats = np.stack([g, np.full(n, 0.25), np.ones(n)], 1).astype(np.float32)
    kw = dict(max_depth=1, frontier=4, max_nodes=8, num_bins=256,
              min_examples=1)
    want = jax_grower.grow_tree(
        jnp.asarray(bins), jnp.asarray(stats), jax.random.PRNGKey(0),
        hist_impl="native", rule=JaxRule(), num_numerical=1,
        set_bits=jnp.asarray(packed), **kw)
    got = grower.grow_tree(
        torch.from_numpy(bins.T.copy()), torch.from_numpy(stats),
        rule=HessianGainRule(), num_numerical=1,
        set_members=grower.set_members(torch.from_numpy(
            packed.view(np.int32))), **kw)
    gt = got.tree
    assert bool(gt.is_set[0]) and int(gt.feature[0]) == 1
    # Only item 1 is selected; rows holding it go right.
    assert int(gt.cat_mask[0, 0]) == 0b10
    for field in NODE_FIELDS:
        w = np.asarray(getattr(want.tree, field))
        g_ = getattr(gt, field).numpy()
        if field == "cat_mask":
            g_ = g_.view(np.uint32)
        assert np.array_equal(g_, w), field
    assert np.array_equal(got.leaf_id.numpy(), np.asarray(want.leaf_id))


# ---- learners, routing, saves ------------------------------------------


@pytest.fixture(scope="module")
def gbt_pair():
    """(JAX model, port model, train, fresh): the default GBT of each
    package on the same small set frame."""
    require_jax()
    train = set_frame(3000)
    fresh = set_frame(800, seed=11, test=True)
    jm = ydf.GradientBoostedTreesLearner(label="label").train(train)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", device="cpu").train(train)
    return jm, pm, train, fresh


def same_forests(jm, pm):
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    assert (jf["is_set"] & ~jf["is_leaf"]).sum() > 0
    for field in NODE_FIELDS + ("threshold",):
        assert np.array_equal(pf[field], jf[field]), field
    assert np.array_equal(bits(pf["leaf_value"]), bits(jf["leaf_value"]))


def test_gbt_with_sets_grows_the_jax_trees(gbt_pair):
    jm, pm, _, fresh = gbt_pair
    jl, pl = jm.training_logs, pm.training_logs
    assert pl["num_trees"] == jl["num_trees"]
    assert pl["num_trees_trained"] == jl["num_trees_trained"]
    same_forests(jm, pm)
    assert np.array_equal(bits(pm.predict(fresh)), bits(jm.predict(fresh)))
    je, pe = jm.evaluate(fresh).metrics, pm.evaluate(fresh).metrics
    for k, v in je.items():
        assert abs(pe[k] - v) <= 1e-12, k


@pytest.mark.parametrize("native_missing", [False, True])
def test_set_routing_matches_jax(gbt_pair, native_missing):
    """route_tree_values with packed sets, unseen items and missing
    cells (taking na_left when the missing mask is given), tree by tree,
    against the JAX routing."""
    jm, pm, _, fresh = gbt_pair
    ds = Dataset.from_data(fresh, dataspec=pm.dataspec)
    x_num, x_cat = pm._encode_inputs(ds)
    x_set = pm._encode_sets(ds)
    missing = pm._encode_set_missing(ds) if native_missing else None
    assert missing is None or missing.any()
    # Some nodes send missing sets left.
    forest = pm.forest._replace(na_left=torch.from_numpy(
        np.arange(pm.forest.na_left.numel()).reshape(
            pm.forest.na_left.shape) % 2 == 0))
    jtree_all = jm.forest._replace(na_left=jnp.asarray(
        forest.na_left.numpy()))
    for t in range(min(forest.num_trees, 6)):
        got = route_tree_values(
            forest, t, torch.from_numpy(x_num), torch.from_numpy(x_cat),
            pm.binner.num_numerical, pm.max_depth,
            x_set=torch.from_numpy(x_set.view(np.int32)),
            set_missing=None if missing is None
            else torch.from_numpy(missing)).numpy()
        jtree = jax.tree.map(lambda a: a[t], jtree_all)
        want = np.asarray(jax_route_values(
            jtree, jnp.asarray(x_num), jnp.asarray(x_cat),
            pm.binner.num_numerical, pm.max_depth,
            x_set=jnp.asarray(x_set),
            set_missing=None if missing is None else jnp.asarray(missing)))
        assert np.array_equal(got, want), t


def test_set_models_load_across_packages(gbt_pair, tmp_path):
    """A set model saved by either package loads in the other and
    predicts bitwise; the item dictionaries and num_set travel."""
    jm, pm, _, fresh = gbt_pair
    jm.save(str(tmp_path / "jax"))
    pm.save(str(tmp_path / "port"))
    from_jax = ydf_tpu_torch.load_model(str(tmp_path / "jax"), device="cpu")
    from_port = ydf.load_model(str(tmp_path / "port"))
    assert from_jax.binner.num_set == from_port.binner.num_set == 2
    assert (from_jax.dataspec.column_by_name("words").vocabulary
            == jm.dataspec.column_by_name("words").vocabulary)
    want = jm.predict(fresh)
    assert np.array_equal(bits(from_jax.predict(fresh)), bits(want))
    assert np.array_equal(bits(np.asarray(from_port.predict(fresh))),
                          bits(pm.predict(fresh)))
    assert from_jax.list_compatible_engines()[0] == "Routed"


@pytest.mark.parametrize("learner", ["rf", "cart"])
def test_rf_and_cart_with_sets_grow_the_jax_trees(learner):
    """The default random forest (5 trees) and CART (10% holdout,
    pruned) on the set frame: every node array, leaf values,
    probabilities and metrics; CART's holdout routes set nodes."""
    require_jax()
    train = set_frame(2500, seed=7)
    fresh = set_frame(600, seed=8, test=True)
    if learner == "rf":
        jm = ydf.RandomForestLearner(label="label", num_trees=5).train(train)
        pm = ydf_tpu_torch.RandomForestLearner(
            label="label", num_trees=5, device="cpu").train(train)
        for k, v in jm.oob_evaluation["metrics"].items():
            assert abs(pm.oob_evaluation["metrics"][k] - v) <= 1e-12, k
    else:
        jm = ydf.CartLearner(label="label").train(train)
        pm = ydf_tpu_torch.CartLearner(label="label",
                                       device="cpu").train(train)
        assert (pm.extra_metadata["num_pruned_nodes"]
                == jm.extra_metadata["num_pruned_nodes"])
    same_forests(jm, pm)
    assert np.array_equal(bits(pm.predict(fresh)),
                          bits(np.asarray(jm.predict(fresh))))
    je, pe = jm.evaluate(fresh).metrics, pm.evaluate(fresh).metrics
    for k, v in je.items():
        assert abs(pe[k] - v) <= 1e-12, k


def test_isolation_forest_skips_set_columns():
    """The isolation forest trains on the other columns, as the JAX
    package's (_supports_set_features = False)."""
    data = {k: v for k, v in set_frame(300).items() if k != "label"}
    m = ydf_tpu_torch.IsolationForestLearner(
        num_trees=2, device="cpu").train(data)
    assert m.binner.num_set == 0
    assert "tags" not in m.binner.feature_names


# ---- on the card -------------------------------------------------------


def set_route_case(n, F, B, L, Lh, seed):
    """One fused layer with set splits: the previous layer's [L+1] tables
    (four splits, two of them set splits whose rows' directions come
    from set_go_left), rows on live and trash slots, real-valued stats,
    on the card."""
    rng = np.random.default_rng(seed)
    do_split = np.zeros(L + 1, bool)
    do_split[[0, 1, 3, 6]] = True
    is_set = np.zeros(L + 1, bool)
    is_set[[1, 6]] = True
    split_rank = np.zeros(L + 1, np.int32)
    split_rank[[0, 1, 3, 6]] = np.arange(4)
    hmap = rng.integers(0, Lh + 1, L + 1).astype(np.int32)
    hmap[L] = Lh
    tables = RouteTables(*(torch.from_numpy(a).cuda() for a in (
        do_split, rng.integers(0, F, L + 1).astype(np.int32),
        rng.uniform(size=(L + 1, B)) < 0.5,
        rng.integers(1, 200, L + 1).astype(np.int32),
        rng.integers(1, 200, L + 1).astype(np.int32), split_rank, hmap,
        is_set, (rng.uniform(size=n) < 0.5).astype(np.uint8))))
    bins = torch.from_numpy(rng.integers(0, B, (F, n)).astype(np.uint8))
    slot = torch.from_numpy(rng.integers(0, L + 1, n).astype(np.int32))
    leaf = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32))
    stats = torch.from_numpy(grad_stats(n, rng))
    return bins.cuda(), slot.cuda(), leaf.cuda(), tables, stats.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("n,F,Lh", [(180_000, 28, 8), (4096, 30, 1),
                                    (45_000, 33, 16)])
def test_routed_kernel_set_tables_on_card(n, F, Lh):
    """csrc/histogram_routed.cu with is_set rows: new slots, leaves and
    the histogram torch.equal to the plain version, and a launch
    counted."""
    _need_card()
    bins, slot, leaf, tables, stats = set_route_case(n, F, 64, 32, Lh,
                                                     seed=n)
    before = histogram_kernels.LAUNCHES["histogram_routed"]
    got = histogram_kernels.histogram_routed(bins, slot, leaf, tables, stats,
                                             Lh, 64)
    torch.cuda.synchronize()
    assert histogram_kernels.LAUNCHES["histogram_routed"] == before + 1
    want = histogram_kernels.histogram_routed_plain(
        bins, slot, leaf, tables, stats, Lh, 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_set_prefix_histogram_on_card():
    """csrc/histogram.cu at the set prefix shape (F = 1, Ld slots, Tc
    bins) torch.equal to its plain version."""
    _need_card()
    rng = np.random.default_rng(4)
    n, Ld, Tc = 180_000, 32, 256
    rm = torch.from_numpy(rng.integers(0, Tc, (1, n)).astype(np.uint8))
    slot = torch.from_numpy(rng.integers(0, 33, n).astype(np.int32))
    stats = torch.from_numpy(grad_stats(n, rng))
    got = histogram_kernels.histogram(rm.cuda(), slot.cuda(), stats.cuda(),
                                      Ld, Tc)
    want = histogram_kernels.histogram_plain(rm.cuda(), slot.cuda(),
                                             stats.cuda(), Ld, Tc)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sums_add_each_run_in_order(seed):
    """ops/segment_sum.py's plain version: each run's values added in
    order from 0 (one f32 rounding an add) at its head, zeros elsewhere,
    against a Python loop."""
    rng = np.random.default_rng(seed)
    key = torch.from_numpy(np.sort(rng.integers(0, 500, 6000)))
    vals = torch.from_numpy(rng.normal(size=(6000, 3)).astype(np.float32))
    got = segment_sum.segment_sums(key, vals)
    k, v = key.numpy(), vals.numpy()
    want = np.zeros_like(v)
    i = 0
    while i < len(k):
        j, acc = i, np.zeros(3, np.float32)
        while j < len(k) and k[j] == k[i]:
            acc = (acc + v[j]).astype(np.float32)
            j += 1
        want[i] = acc
        i = j
    assert np.array_equal(bits(got.numpy()), bits(want))


@pytest.mark.gpu
def test_segment_sum_kernel_on_card():
    """csrc/segment_sum.cu torch.equal to its plain version on runs up
    to 2,000 long, a launch counted."""
    _need_card()
    rng = np.random.default_rng(7)
    key = torch.from_numpy(np.sort(np.concatenate([
        rng.integers(0, 100_000, 500_000), np.full(2000, 5)]))).cuda()
    vals = torch.from_numpy(rng.normal(size=(key.shape[0], 3)).astype(
        np.float32)).cuda()
    before = segment_sum.KERNEL_LAUNCHES
    got = segment_sum.segment_sums(key, vals)
    torch.cuda.synchronize()
    assert segment_sum.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, segment_sum.segment_sums_plain(key, vals))


def test_train_sets_fixture_matches_chip_smoke_constants():
    """The committed fixture is the configuration phase 13 drives, and
    chip_smoke.make_set_frame still writes its frames."""
    import json

    from test_torch_default_train import load_chip_smoke

    smoke = load_chip_smoke()
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ydf_tpu_torch", "testdata",
        "train_sets")
    with open(os.path.join(root, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["gbt"]["rows"], cfg["gbt"]["test_rows"]) == (
        smoke.SETS_GBT_ROWS, smoke.SETS_GBT_TEST_ROWS)
    assert (cfg["rf"]["rows"], cfg["rf"]["test_rows"],
            cfg["rf"]["fixture_trees"]) == (
        smoke.SETS_RF_ROWS, smoke.SETS_RF_TEST_ROWS,
        smoke.SETS_RF_FIXTURE_TREES)
    assert (cfg["cart"]["rows"], cfg["cart"]["test_rows"]) == (
        smoke.SETS_CART_ROWS, smoke.SETS_CART_TEST_ROWS)
    assert cfg["generator"] == dict(vocabs=list(smoke.SETS_VOCABS),
                                    item_a=smoke.SETS_ITEM_A,
                                    item_b=smoke.SETS_ITEM_B)
    train, test = smoke.make_set_frame(cfg["rf"]["rows"],
                                       cfg["rf"]["test_rows"])
    assert smoke.frame_sha256(train) == cfg["rf"]["train_sha256"]
    assert smoke.frame_sha256(test) == cfg["rf"]["test_sha256"]
    exp = np.load(os.path.join(root, "expected.npz"))
    assert exp["gbt/tree_sha256"].shape == (cfg["gbt"]["num_trees"], 32)
    assert exp["rf/tree_sha256"].shape == (cfg["rf"]["fixture_trees"], 32)


def test_set_features_alone_raise_naming_the_item():
    """Set features alone train since ROADMAP item 29 (below); what still
    raises is a frame with no feature at all, a ValueError in both
    packages (the JAX grower finds no candidate column, the port's
    grower says so), and the routed kernel's wrapper at F == 0, which
    the grower no longer calls there."""
    require_jax()
    data = {"label": set_frame(300)["label"]}
    for mod, extra in ((ydf, {}), (ydf_tpu_torch, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.GradientBoostedTreesLearner(
                label="label", num_trees=1, **extra).train(data)
    n = 40
    with pytest.raises(ValueError, match="F == 0"):
        histogram_kernels.histogram_routed(
            torch.zeros((0, n), dtype=torch.uint8),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32), RouteTables(
                do_split=torch.zeros(3, dtype=torch.bool),
                route_f=torch.zeros(3, dtype=torch.int32),
                go_left=torch.zeros((3, 32), dtype=torch.bool),
                left_id=torch.zeros(3, dtype=torch.int32),
                right_id=torch.zeros(3, dtype=torch.int32),
                split_rank=torch.zeros(3, dtype=torch.int32),
                hmap=torch.arange(3, dtype=torch.int32),
                is_set=torch.zeros(3, dtype=torch.bool),
                set_go_left=torch.zeros(1, dtype=torch.uint8)),
            torch.ones((n, 3)), 1, 32)


def sets_alone(frame):
    return {k: frame[k] for k in ("tags", "words", "label")}


@pytest.mark.parametrize("learner", ["gbt", "rf", "cart"])
def test_set_features_alone_grow_the_jax_trees(learner):
    """ROADMAP item 29: a frame whose only features are its two set
    columns. No histogram of scalar columns, no sibling subtraction; the
    rows are routed every layer by the plain chain (route_plain's
    all-right branch at F == 0, then the set tables). The GBT, the random
    forest (4 trees) and CART (pruned) equal the JAX package's, every
    node array, leaf values, predictions and metrics."""
    require_jax()
    train = sets_alone(set_frame(2500, seed=7))
    fresh = sets_alone(set_frame(600, seed=8, test=True))
    kw = {"gbt": dict(num_trees=8), "rf": dict(num_trees=4),
          "cart": {}}[learner]
    cls = {"gbt": "GradientBoostedTreesLearner",
           "rf": "RandomForestLearner", "cart": "CartLearner"}[learner]
    jm = getattr(ydf, cls)(label="label", **kw).train(train)
    before = dict(histogram_kernels.LAUNCHES)
    pm = getattr(ydf_tpu_torch, cls)(label="label", device="cpu",
                                     **kw).train(train)
    assert pm.binner.num_scalar == 0 and pm.binner.num_set == 2
    same_forests(jm, pm)
    assert np.array_equal(bits(pm.predict(fresh)),
                          bits(np.asarray(jm.predict(fresh))))
    je, pe = jm.evaluate(fresh).metrics, pm.evaluate(fresh).metrics
    for k, v in je.items():
        assert abs(pe[k] - v) <= 1e-12, k
    if learner == "cart":
        assert (pm.extra_metadata["num_pruned_nodes"]
                == jm.extra_metadata["num_pruned_nodes"])
    assert histogram_kernels.LAUNCHES == before  # CPU: no kernel


@pytest.mark.gpu
def test_set_features_alone_on_card_match_cpu():
    """The set-only GBT and random forest on the card equal the CPU
    port's; the card launches the run sums and the prefix histograms,
    and no routed kernel."""
    _need_card()
    train = sets_alone(set_frame(20_000, seed=7))
    fresh = sets_alone(set_frame(600, seed=8, test=True))
    for cls, kw in ((ydf_tpu_torch.GradientBoostedTreesLearner,
                     dict(num_trees=5)),
                    (ydf_tpu_torch.RandomForestLearner,
                     dict(num_trees=3))):
        before = dict(histogram_kernels.LAUNCHES)
        seg0 = segment_sum.KERNEL_LAUNCHES
        gm = cls(label="label", device="cuda", **kw).train(train)
        assert histogram_kernels.LAUNCHES["histogram_routed"] == \
            before["histogram_routed"]
        assert histogram_kernels.LAUNCHES["histogram"] > before["histogram"]
        assert segment_sum.KERNEL_LAUNCHES > seg0
        cm = cls(label="label", device="cpu", **kw).train(train)
        g, c = gm.forest.to_numpy(), cm.forest.to_numpy()
        for f in NODE_FIELDS:
            assert np.array_equal(g[f], c[f]), f
        assert np.array_equal(bits(gm.predict(fresh)),
                              bits(cm.predict(fresh)))


def test_train_sets_alone_fixture_matches_chip_smoke_constants():
    """The committed train_sets_alone fixture is the configuration phase
    15 drives: make_set_frame's two set columns and the label, at
    train_sets' sizes."""
    import json

    from test_torch_default_train import load_chip_smoke

    smoke = load_chip_smoke()
    with open(os.path.join(smoke.TRAIN_SETS_ALONE, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["columns"] == ["tags", "words", "label"]
    assert (cfg["gbt"]["rows"], cfg["rf"]["rows"], cfg["rf"]["fixture_trees"],
            cfg["cart"]["rows"]) == (
        smoke.SETS_GBT_ROWS, smoke.SETS_RF_ROWS, smoke.SETS_RF_FIXTURE_TREES,
        smoke.SETS_CART_ROWS)
    train, test = smoke.sets_alone_frame(cfg["rf"]["rows"],
                                         cfg["rf"]["test_rows"])
    assert sorted(train) == sorted(cfg["columns"])
    assert smoke.frame_sha256(train) == cfg["rf"]["train_sha256"]
    assert smoke.frame_sha256(test) == cfg["rf"]["test_sha256"]
