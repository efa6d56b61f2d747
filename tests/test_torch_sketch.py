"""The dataset cache's pass-1 summaries (dataset/sketch.py) against the
JAX package's: the exact dyadic sums, NumericSummary in its exact and
KLL modes and IngestPartial, through their wire forms, over several
chunkings and merge orders; and Binner.fit_from_summaries' boundaries.
The one deliberate difference, a numeric column's categorical keys, is
held too.
"""

import numpy as np
import pytest

try:  # The machine with the card has no JAX: only the gpu tests run there.
    from ydf_tpu.dataset import sketch as jsk
except ImportError:
    jsk = None

from ydf_tpu_torch.dataset import sketch as psk


def require_jax():
    if jsk is None:
        pytest.skip("needs the JAX package, the reference")


def same_wire(a, b):
    """Two wire dicts equal: numbers exactly (floats by bits, NaN to
    NaN), arrays bitwise, nested dicts and lists alike."""
    assert type(a) is type(b) or (isinstance(a, (list, tuple))
                                  and isinstance(b, (list, tuple)))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            same_wire(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_wire(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    elif isinstance(a, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes()
    else:
        assert a == b


def values(seed, n=5000):
    """float64 values with NaNs, +-0, infinities, repeats and wide
    exponents."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n) * np.exp2(rng.integers(-60, 60, n))
    v[rng.uniform(size=n) < 0.05] = np.nan
    v[::97] = 0.0
    v[1::97] = -0.0
    v[2::211] = np.round(v[2::211])
    v[3::499] = np.inf
    v[4::499] = -np.inf
    return v


def test_dyadic_sum_equals_the_jax_package():
    require_jax()
    for seed in range(3):
        v = values(seed)
        v = v[np.isfinite(v)]
        d = psk.dyadic_sum(v)
        assert d == jsk.dyadic_sum(v)
        parts = [psk.dyadic_sum(c) for c in np.array_split(v, 7)]
        acc = (0, 0)
        for p in parts[::-1]:
            acc = psk.dyadic_add(acc, p)
        assert acc == d
        assert psk.dyadic_to_float(d, len(v)) == jsk.dyadic_to_float(
            d, len(v))


@pytest.mark.parametrize("mode, k", [("exact", 4096), ("sketch", 64),
                                     ("sketch", 8)])
@pytest.mark.parametrize("chunks", [1, 3, 17])
def test_numeric_summary_equals_the_jax_package(mode, k, chunks):
    """update over `chunks` chunks, then merged in order and in reverse:
    every wire field equal, and the mean, weighted items and rank error;
    exact mode gives the same state for any chunking."""
    require_jax()
    v = values(7)
    pieces = np.array_split(v, chunks)
    for order in (pieces, pieces[::-1]):
        p, j = psk.NumericSummary(mode, k), jsk.NumericSummary(mode, k)
        for c in order:
            pc, jc = psk.NumericSummary(mode, k), jsk.NumericSummary(mode, k)
            pc.update(c)
            jc.update(c)
            p.merge(psk.NumericSummary.from_wire(pc.to_wire()))
            j.merge(jc)
        same_wire(p.to_wire(), j.to_wire())
        assert p.mean() == j.mean() or (np.isnan(p.mean())
                                        and np.isnan(j.mean()))
        same_wire(list(p.weighted_items()), list(j.weighted_items()))
        assert p.rank_error_bound() == j.rank_error_bound()
        assert p.distinct_exact() == j.distinct_exact()
    if mode == "exact":
        whole = psk.NumericSummary(mode, k)
        whole.update(v)
        same_wire(whole.to_wire(), p.to_wire())


def test_summary_rejects_bad_configs():
    with pytest.raises(ValueError, match="mode"):
        psk.NumericSummary("approx")
    with pytest.raises(ValueError, match="even int"):
        psk.NumericSummary("sketch", 7)
    with pytest.raises(ValueError, match="different configs"):
        psk.NumericSummary("exact").merge(psk.NumericSummary("sketch"))


def chunk(seed, n=400):
    """A chunk of a numerical column (NaNs and infinities, no integral
    value: those are keyed apart, see the test below), a categorical one
    with missing cells and a string label."""
    rng = np.random.default_rng(seed)
    cat = np.array([f"v{c}" for c in rng.integers(0, 9, n)], object)
    cat[rng.uniform(size=n) < 0.1] = ""
    x = rng.normal(size=n) * 10 + 0.5
    x[rng.uniform(size=n) < 0.05] = np.nan
    x[::97] = np.inf
    return {"x": x, "c": cat,
            "y": np.array(["yes", "no"], object)[rng.integers(0, 2, n)]}


@pytest.mark.parametrize("mode", ["exact", "sketch"])
def test_ingest_partial_equals_the_jax_package(mode):
    """Chunks observed, partials merged and sent through the wire form,
    a mixed column recounted: the same state in both packages."""
    require_jax()
    parts = {"port": psk.IngestPartial(mode, 16), "jax": jsk.IngestPartial(
        mode, 16)}
    mods = {"port": psk, "jax": jsk}
    for name, whole in parts.items():
        for s in range(4):
            one = mods[name].IngestPartial(mode, 16)
            c = chunk(s)
            if s == 2:  # "x" as text in one chunk: a mixed column
                c["x"] = np.array([f"{v:.2f}" for v in c["x"]], object)
            one.observe_chunk(c, frozenset({"y"}))
            whole.merge(type(one).from_wire(one.to_wire()))
        mixed = whole.mixed_columns()
        assert mixed == ["x"]
        whole.begin_recount(mixed)
        for s in range(4):
            c = chunk(s)
            if s == 2:
                c["x"] = np.array([f"{v:.2f}" for v in c["x"]], object)
            whole.observe_recount(c, mixed)
    same_wire(parts["port"].to_wire(), parts["jax"].to_wire())


def test_numeric_categories_keyed_as_encoding_keys_them():
    """A numeric column counted as categorical (a classification label
    the CSV loader returns as float64) is keyed as infer_column and
    Dataset.encoded_categorical key numbers: "0", "1", "2.5". The JAX
    package keys astype(str), "0.0", which its encoding never finds."""
    p = psk.IngestPartial()
    p.observe_chunk({"label": np.array([0.0, 1.0, 1.0, np.nan, 2.5])},
                    frozenset({"label"}))
    assert p.cat["label"] == {"0": 1, "1": 2, "2.5": 1}
    assert p.cat_missing["label"] == 1
    if jsk is not None:
        j = jsk.IngestPartial()
        j.observe_chunk({"label": np.array([0.0, 1.0, 1.0, np.nan, 2.5])},
                        frozenset({"label"}))
        assert j.cat["label"] == {"0.0": 1, "1.0": 2, "2.5": 1}
        j.observe_chunk({"label": np.array([0, 1])}, frozenset({"label"}))
        p.observe_chunk({"label": np.array([0, 1])}, frozenset({"label"}))
        assert j.cat["label"]["0"] == p.cat["label"]["0"] - 1 == 1


@pytest.mark.parametrize("mode, k", [("exact", 4096), ("sketch", 32)])
@pytest.mark.parametrize("num_bins", [64, 256])
def test_binner_fit_from_summaries_equals_the_jax_package(mode, k, num_bins):
    """Boundaries, imputation and bin counts bitwise, from summaries of
    a dense column, a low-cardinality one and an empty one."""
    require_jax()
    from ydf_tpu.dataset.binning import Binner as JaxBinner
    from ydf_tpu.dataset.dataspec import (Column as JaxColumn,
                                          ColumnType as JaxType,
                                          DataSpecification as JaxSpec)

    from ydf_tpu_torch.dataset.binning import Binner
    from ydf_tpu_torch.dataset.dataspec import DataSpecification

    rng = np.random.default_rng(3)
    cols = {"dense": rng.normal(size=20_000),
            "low": rng.integers(0, 9, 20_000).astype(np.float64),
            "empty": np.full(50, np.nan)}
    summaries = {}
    jcols = []
    for name, v in cols.items():
        s = psk.NumericSummary(mode, k)
        for c in np.array_split(v, 5):
            s.update(c)
        summaries[name] = s
        jcols.append(JaxColumn(name=name, type=JaxType.NUMERICAL,
                               mean=s.mean()))
    jspec = JaxSpec(columns=jcols)
    spec = DataSpecification.from_json(jspec.to_json())
    got = Binner.fit_from_summaries(spec, list(cols), num_bins, summaries)
    jsum = {n: jsk.NumericSummary.from_wire(s.to_wire())
            for n, s in summaries.items()}
    want = JaxBinner.fit_from_summaries(jspec, list(cols), num_bins, jsum)
    assert got.to_json() == want.to_json()
    assert np.array_equal(got.boundaries.view(np.uint32),
                          want.boundaries.view(np.uint32))
