"""The NUMERICAL_VECTOR_SEQUENCE slice of ydf_tpu_torch held against the
JAX package: the anchor scores (plain version of
csrc/vector_sequence.cu), dataspec inference and the padded encoding,
the per-tree anchor candidates, GBT training end to end, and serving a
JAX-trained model.

Tolerances, and why:
  * scores against the JAX functions: rtol/atol 1e-4, as the JAX
    package's own oracle test (tests/test_vector_sequence.py:68); the
    -FLT_MAX sentinel bitwise. Against the XLA formulation at 32 and 16
    anchors the plain version is bitwise (it sums in XLA's CPU order);
  * anchors, boundaries and candidate bins: bitwise (the threefry draws,
    the quantiles and the searchsorted replicate jax's);
  * training: the same trees (features, threshold bins, children,
    thresholds) and losses within rtol 1e-5 (the sigmoid and the f32
    sums round differently in torch and XLA by an ulp or so);
  * serving: predictions within 1e-6 of the JAX package's.

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
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.dataset.binning import Binner as JaxBinner
    from ydf_tpu.dataset.dataset import Dataset as JaxDataset
    from ydf_tpu.learners import gbt as jax_gbt
    from ydf_tpu.ops import vector_sequence as jax_vs
except ImportError:
    ydf = None

import chip_smoke
import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.dataset.binning import Binner
from ydf_tpu_torch.dataset.dataset import Dataset
from ydf_tpu_torch.dataset.dataspec import ColumnType, infer_dataspec
from ydf_tpu_torch.learners import gbt as port_gbt
from ydf_tpu_torch.ops import vector_sequence as vs_ops

torch.set_num_threads(1)
STRUCTURE = ("feature", "threshold_bin", "left", "right", "is_leaf",
             "num_nodes", "threshold", "vs_anchor", "vs_feat",
             "vs_is_closer")
# vs_small: the train_vs task at a CPU test's size.
VS_SMALL = dict(max_len=6, dim=4, noise=2, radius=2.57)
HP = dict(num_trees=5, max_depth=4, validation_ratio=0.0,
          early_stopping="NONE")


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), np.asarray(b, np.float32).view(np.int32)
    return a.shape == b.shape and np.array_equal(a, b)


def vs_small(rows=3000, seed=0):
    return chip_smoke.make_vs_data(rows, seed=seed, **VS_SMALL)


def oracle_case(seed=0, n=200, L=9, D=5, A=12):
    """tests/test_vector_sequence.py:_oracle_case."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, L + 1, n).astype(np.int32)
    values = np.zeros((n, L, D), np.float32)
    for e in range(n):
        values[e, : lengths[e]] = rng.normal(size=(lengths[e], D))
    anchors = rng.normal(size=(A, D)).astype(np.float32)
    is_closer = rng.uniform(size=A) > 0.5
    return values, lengths, anchors, is_closer


def plain(values, lengths, anchors, is_closer, device="cpu"):
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    return vs_ops.vs_scores(t(values), t(lengths), t(anchors),
                            t(is_closer))


# ------------------------------------------------------------------ #
# Scores
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret", "oracle"])
def test_scores_match_jax(impl):
    require_jax()
    args = oracle_case()
    if impl == "oracle":
        want = jax_vs.vs_scores_oracle(*args)
    else:
        want = np.asarray(jax_vs.vs_scores(*args, impl=impl))
    got = plain(*args).numpy()
    m = want > -1e30
    np.testing.assert_allclose(got[m], want[m], rtol=1e-4, atol=1e-4)
    assert bitwise(got[~m], want[~m])
    assert (got[~m] == vs_ops.NEG_INF_SCORE).all()


@pytest.mark.parametrize("n,L,D,A", [(600, 6, 4, 32), (600, 16, 16, 32),
                                     (600, 6, 4, 16), (300, 5, 3, 32)])
def test_scores_bitwise_to_xla_at_the_paths_anchor_counts(n, L, D, A):
    require_jax()
    values, lengths, anchors, is_closer = oracle_case(n=n, L=L, D=D, A=A)
    want = jax.jit(lambda *a: jax_vs.vs_scores(*a, impl="xla"))(
        values, lengths, anchors, is_closer)
    assert bitwise(plain(values, lengths, anchors, is_closer), want)


def test_scores_all_empty_column():
    values = np.zeros((8, 4, 3), np.float32)
    lengths = np.zeros((8,), np.int32)
    anchors = np.ones((5, 3), np.float32)
    closer = np.array([True, False, True, False, True])
    out = plain(values, lengths, anchors, closer).numpy()
    assert (out == np.float32(-3.4028235e38)).all()


def test_score_tolerance_bounds_the_rounding():
    """The kernel-vs-plain bound M covers the difference between the
    plain version and the float64 oracle."""
    require_jax()
    args = oracle_case(n=300, L=7, D=16, A=32)
    got = plain(*args).numpy().astype(np.float64)
    exact = jax_vs.vs_scores_oracle(*args).astype(np.float64)
    M = vs_ops.score_tolerance(*(torch.from_numpy(a) for a in args[:3]))
    assert (np.abs(got - exact) <= 1e-5 * M.numpy() + 1e-6).all()


# ------------------------------------------------------------------ #
# Dataspec, encoding, binner
# ------------------------------------------------------------------ #


def test_dataspec_inference_matches_jax():
    require_jax()
    data = vs_small(500)
    spec = infer_dataspec(data, label="label")
    jspec = ydf.infer_dataspec(data, label="label")
    col, jcol = spec.column_by_name("seq"), jspec.column_by_name("seq")
    assert col.type == ColumnType.NUMERICAL_VECTOR_SEQUENCE
    assert jcol.type.value == col.type.value
    for field in ("vector_length", "min_num_vectors", "max_num_vectors",
                  "num_values", "num_missing"):
        assert getattr(col, field) == getattr(jcol, field), field
    assert col.vector_length == 4 and col.num_missing > 0


def test_set_column_is_not_a_vector_sequence():
    """Flat item lists infer as CATEGORICAL_SET, with the JAX package's
    item dictionary (ported since ROADMAP item 14c)."""
    require_jax()
    data = {"tags": [["a", "b"], ["b"], [], ["a", "c", "b"]] * 10}
    jspec = ydf.infer_dataspec(data, min_vocab_frequency=1)
    jcol = jspec.column_by_name("tags")
    assert jcol.type.value == "CATEGORICAL_SET"
    col = infer_dataspec(data, min_vocab_frequency=1).column_by_name("tags")
    assert col.type == ColumnType.CATEGORICAL_SET
    assert col.vocabulary == jcol.vocabulary
    assert col.vocab_counts == jcol.vocab_counts


def test_single_vectors_and_arrays_are_sequences():
    require_jax()
    data = {"v": [np.ones((2, 3), np.float32), None,
                  np.zeros((0, 3), np.float32), [[1.0, 2.0, 3.0]]] * 5}
    spec = infer_dataspec(data)
    jspec = ydf.infer_dataspec(data)
    assert spec.column_by_name("v").type == \
        ColumnType.NUMERICAL_VECTOR_SEQUENCE
    assert jspec.column_by_name("v").type.value == \
        "NUMERICAL_VECTOR_SEQUENCE"
    assert spec.column_by_name("v").num_missing == 5


@pytest.mark.parametrize("max_len", [0, 3])
def test_encoded_vector_sequence_matches_jax(max_len):
    require_jax()
    seqs = [np.ones((2, 3), np.float32), np.zeros((0, 3), np.float32),
            None, np.full((5, 3), 2.0, np.float32)]
    data = {"seq": seqs, "y": np.zeros(4)}
    got = Dataset.from_data(data).encoded_vector_sequence(
        "seq", max_len=max_len)
    want = JaxDataset.from_data(data).encoded_vector_sequence(
        "seq", max_len=max_len)
    for g, w in zip(got, want):
        assert bitwise(g, w)
    assert got[1].tolist() == ([2, 0, 0, 5] if not max_len else [2, 0, 0, 3])
    assert got[2].tolist() == [False, False, True, False]


def test_transform_vs_two_columns_matches_jax():
    """Two VS columns of D = 3 and 5: padding to the common Dmax and to
    max(training max length, batch max length)."""
    require_jax()
    rng = np.random.RandomState(4)

    def column(n, D, max_len):
        return [None if rng.uniform() < 0.1 else
                rng.normal(size=(rng.randint(0, max_len + 1), D)).astype(
                    np.float32) for _ in range(n)]

    train = {"a": column(40, 3, 4), "b": column(40, 5, 2),
             "x": rng.normal(size=40).astype(np.float32)}
    feats = ["x", "a", "b"]
    binner = Binner.fit(Dataset.from_data(train), feats, num_bins=32)
    jbinner = JaxBinner.fit(JaxDataset.from_data(train), feats, num_bins=32)
    for field in ("feature_names", "vs_names", "vs_dims", "vs_max_len"):
        assert getattr(binner, field) == getattr(jbinner, field), field
    serve = {"a": column(7, 3, 6), "b": column(7, 5, 1),
             "x": rng.normal(size=7).astype(np.float32)}
    for rows in (train, serve):
        got = binner.transform_vs(Dataset.from_data(
            rows, dataspec=infer_dataspec(train)))
        want = jbinner.transform_vs(JaxDataset.from_data(
            rows, dataspec=ydf.infer_dataspec(train)))
        for g, w in zip(got, want):
            assert bitwise(g, w)
    # A column absent from the batch is missing.
    got = binner.transform_vs(Dataset.from_data(
        {"a": serve["a"], "x": serve["x"]},
        dataspec=infer_dataspec(train)))
    assert got[2][:, 1].all() and (got[1][:, 1] == 0).all()


# ------------------------------------------------------------------ #
# Anchor candidates, training, serving
# ------------------------------------------------------------------ #


@pytest.fixture(scope="module")
def jax_runs():
    """kind -> (JAX model, the VS kwargs its learner passed to
    forest_from_stacked_trees, data): binomial at the default anchors,
    and squared error with closer-than disabled."""
    require_jax()
    data = vs_small()
    out = {}
    for kind, label, task, closer in (
        ("binomial", "label", Task.CLASSIFICATION, True),
        ("squared_error", "target", Task.REGRESSION, False),
    ):
        d = dict(data)
        if label == "target":
            d["target"] = (d.pop("label") * 2.0
                           + d["x0"] * 0.5).astype(np.float32)
        captured = {}
        original = jax_gbt.forest_from_stacked_trees

        def capture(*args, **kwargs):
            captured.update(kwargs)
            return original(*args, **kwargs)

        jax_gbt.forest_from_stacked_trees = capture
        try:
            jm = ydf.GradientBoostedTreesLearner(
                label=label, task=JaxTask(task.value),
                numerical_vector_sequence_enable_closer_than=closer,
                **HP).train(d)
        finally:
            jax_gbt.forest_from_stacked_trees = original
        out[kind] = (jm, {k: np.asarray(v) for k, v in captured.items()},
                     d, label, task, closer)
    return out


@pytest.fixture(scope="module")
def port_models(jax_runs):
    out = {}
    for kind, (_, _, d, label, task, closer) in jax_runs.items():
        out[kind] = ydf_tpu_torch.GradientBoostedTreesLearner(
            label=label, task=task, device="cpu",
            numerical_vector_sequence_enable_closer_than=closer,
            **HP).train(d)
    return out


@pytest.mark.parametrize("kind", ["binomial", "squared_error"])
def test_make_vs_projections_matches_the_jax_learner(jax_runs, kind):
    """Every tree's anchors and boundaries bitwise equal to the ones the
    JAX learner stored, and the candidate bins equal to the JAX
    package's binning of its own scores against them."""
    _, captured, d, label, _, closer = jax_runs[kind]
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(
        label=label, device="cpu",
        numerical_vector_sequence_enable_closer_than=closer, **HP)
    prep = learner._prepare(d)
    Ac, Ap = learner._vs_anchor_counts()
    vs = port_gbt.vs_inputs(prep["vs"], Ac, Ap, "cpu")
    B = prep["binner"].num_bins
    draws = port_gbt.vs_draws(learner.random_seed, HP["num_trees"], 1,
                              Ac + 2 * Ap, "cpu")
    qs = port_gbt.prng.linspace_f32(1.0 / B, 1.0 - 1.0 / B, B - 1)
    closer_mask = np.arange(Ac + Ap) < Ac
    for t in range(HP["num_trees"]):
        anchors, bnd, cols = port_gbt.make_vs_projections(
            vs, {k: v[t] for k, v in draws.items()}, qs)
        assert bitwise(anchors, captured["vs_anchors"][t]), t
        assert bitwise(bnd, captured["vs_boundaries"][t]), t
        jcols = jax.jit(lambda v, ln, a, b: jax.vmap(
            lambda bb, z: jnp.searchsorted(bb, z, side="right"))(
                b, jax_vs.vs_scores(v, ln, a, closer_mask, impl="xla").T))(
            vs.values[0].numpy(), vs.lengths[0].numpy(),
            captured["vs_anchors"][t], captured["vs_boundaries"][t])
        assert np.array_equal(cols.numpy(),
                              np.asarray(jcols).astype(np.uint8)), t


@pytest.mark.parametrize("kind", ["binomial", "squared_error"])
def test_vs_training_grows_the_same_trees(jax_runs, port_models, kind):
    jm = jax_runs[kind][0]
    jf, pf = jm.forest.to_numpy(), port_models[kind].forest.to_numpy()
    for field in STRUCTURE:
        assert bitwise(pf[field], jf[field]), field
    assert pf["vs_anchor"].shape[1] == (32 if kind == "binomial" else 16)
    np.testing.assert_allclose(
        port_models[kind].training_logs["train_loss"],
        jm.training_logs["train_loss"], rtol=1e-5)
    rows = vs_small(512, seed=3)
    np.testing.assert_allclose(port_models[kind].predict(rows),
                               jm.predict(rows), rtol=0, atol=1e-5)


def test_without_vs_features_the_trees_are_unchanged(jax_runs):
    """The key chain draws nothing the numerical path reads: without VS
    features the port grows the JAX package's trees bit for bit."""
    d = {k: v for k, v in jax_runs["binomial"][2].items() if k != "seq"}
    jm = ydf.GradientBoostedTreesLearner(label="label", **HP).train(d)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", device="cpu", **HP).train(d)
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    for field in STRUCTURE:
        assert bitwise(pf[field], jf[field]), field
    assert pf["vs_anchor"].size == 0


def test_serves_a_jax_trained_vs_model(jax_runs, tmp_path):
    jm, _, _, _, _, _ = jax_runs["binomial"]
    jm.save(str(tmp_path / "m"))
    pm = ydf_tpu_torch.load_model(str(tmp_path / "m"), device="cpu")
    assert pm.list_compatible_engines() == ["Routed"]
    rows = vs_small(700, seed=5)
    assert any(v is None for v in rows["seq"])
    np.testing.assert_allclose(pm.predict(rows), jm.predict(rows), rtol=0,
                               atol=1e-6)
    raw = pm._raw_scores(rows, combine="sum")[:, 0]
    assert bitwise(raw, jm._raw_scores(rows, combine="sum")[:, 0])
    # Missing predicts exactly like empty.
    missing = [i for i, v in enumerate(rows["seq"]) if v is None]
    emptied = dict(rows)
    emptied["seq"] = rows["seq"].copy()
    for i in missing:
        emptied["seq"][i] = np.zeros((0, VS_SMALL["dim"]), np.float32)
    assert bitwise(pm.predict(emptied), pm.predict(rows))
    for engine in ("QuickScorer", "BankScorer"):
        with pytest.raises(ValueError, match="not compatible"):
            pm.force_engine(engine)


def test_vs_model_needs_the_sequences():
    """A forest with VS nodes refuses to route without the sequences."""
    from ydf_tpu_torch.ops.routing import forest_predict_values

    pm = ydf_tpu_torch.GradientBoostedTreesLearner(
        label="label", device="cpu", num_trees=1, max_depth=2,
        validation_ratio=0.0, early_stopping="NONE").train(vs_small(300))
    x = torch.zeros((3, pm.binner.num_numerical))
    with pytest.raises(ValueError, match="x_vs_vals"):
        forest_predict_values(pm.forest, x, torch.zeros((3, 0),
                                                        dtype=torch.int32),
                              num_numerical=2, max_depth=2)


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #


@pytest.mark.gpu
@pytest.mark.parametrize("case", chip_smoke.vs_ragged_cases())
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    n, L, D, A, all_empty = case
    values, lengths, anchors, is_closer = oracle_case(n=n, L=L, D=D, A=A,
                                                      seed=n)
    if all_empty:
        lengths[:] = 0
    launched = vs_ops.KERNEL_LAUNCHES
    got = plain(values, lengths, anchors, is_closer, device="cuda")
    torch.cuda.synchronize()
    assert vs_ops.KERNEL_LAUNCHES == launched + 1
    want = plain(values, lengths, anchors, is_closer).numpy()
    got = got.cpu().numpy()
    empty = lengths == 0
    assert bitwise(got[empty], want[empty])
    M = vs_ops.score_tolerance(torch.from_numpy(values),
                               torch.from_numpy(lengths),
                               torch.from_numpy(anchors)).numpy()
    diff = np.abs(got.astype(np.float64) - want)
    assert (diff <= 1e-5 * M + 1e-6).all(), diff.max()


@pytest.mark.gpu
def test_card_training_equals_cpu_training():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    data = vs_small()
    hp = dict(label="label", **HP)
    launched = vs_ops.KERNEL_LAUNCHES
    cm = ydf_tpu_torch.GradientBoostedTreesLearner(device="cuda",
                                                   **hp).train(data)
    torch.cuda.synchronize()
    assert vs_ops.KERNEL_LAUNCHES - launched == HP["num_trees"]
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                   **hp).train(data)
    cf, pf = cm.forest.to_numpy(), pm.forest.to_numpy()
    assert bitwise(cf["vs_anchor"], pf["vs_anchor"])
    for field in ("feature", "threshold_bin", "left", "right", "is_leaf"):
        assert np.array_equal(cf[field], pf[field]), field
    np.testing.assert_allclose(cf["leaf_value"], pf["leaf_value"],
                               rtol=0, atol=2e-5)
    rows = vs_small(512, seed=3)
    served = vs_ops.KERNEL_LAUNCHES
    np.testing.assert_allclose(cm.predict(rows), pm.predict(rows), rtol=0,
                               atol=1e-5)
    assert vs_ops.KERNEL_LAUNCHES - served == HP["num_trees"]
