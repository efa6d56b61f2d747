"""The row-wise example path of ydf_tpu_torch (dataset/example.py,
Dataset.from_examples, GenericModel.predict_example) held against the
JAX package's: the same rows give the same columns, encodings and
predictions, bitwise."""

import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import ydf_tpu as ydf
    from ydf_tpu.dataset import example as jax_example
    from ydf_tpu.dataset.dataset import Dataset as JaxDataset
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.dataset import example
from ydf_tpu_torch.dataset.dataset import Dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "ydf_tpu_torch", "testdata")
torch.set_num_threads(1)


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def bytes_equal(a, b):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def rows(n, seed):
    """Rows of gbt_d6's columns, seeded: some cells dropped (missing),
    some categories unseen, some numbers given as ints."""
    with np.load(os.path.join(TESTDATA, "gbt_d6", "requests.npz")) as z:
        cols = {k: z[k][:n] for k in z.files}
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ex = {}
        for k, v in cols.items():
            if rng.uniform() < 0.1:
                continue
            x = v[i].item()
            if (isinstance(x, float) and not np.isnan(x)
                    and rng.uniform() < 0.1):
                x = int(round(x))
            ex[k] = x
        out.append(ex)
    return out


def same_columns(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        if a[k].dtype == object:
            assert a[k].tolist() == b[k].tolist(), k
        else:
            assert bytes_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_examples_to_columns_matches_jax(seed):
    require_jax()
    ex = rows(40, seed)
    same_columns(example.examples_to_columns(ex),
                 jax_example.examples_to_columns(ex))


def test_columns_round_trip():
    ex = rows(30, 3)
    cols = example.examples_to_columns(ex)
    back = example.columns_to_examples(cols)
    assert len(back) == 30
    for a, b in zip(ex, back):
        # Missing cells (NaN, "") leave the row, as unset fields do.
        kept = {k: v for k, v in a.items()
                if v != "" and not (isinstance(v, float) and np.isnan(v))}
        assert set(kept) == set(b)
        for k, v in kept.items():
            assert b[k] == (float(v) if isinstance(v, int) else v)
    assert example.examples_to_columns([]) == {}
    assert example.columns_to_examples({}) == []
    if ydf is not None:
        assert back == jax_example.columns_to_examples(cols)


def test_from_examples_encodes_as_jax():
    require_jax()
    jm = ydf.load_model(os.path.join(TESTDATA, "gbt_d6"))
    pm = ydf_tpu_torch.load_model(os.path.join(TESTDATA, "gbt_d6"),
                                  device="cpu")
    ex = rows(50, 4)
    ds = Dataset.from_examples(ex, dataspec=pm.dataspec)
    jds = JaxDataset.from_examples(ex, dataspec=jm.dataspec)
    x_num, x_cat = pm._encode_inputs(ds)
    jx_num, jx_cat, _ = jm._encode_inputs(jds)
    assert bytes_equal(x_num, jx_num) and bytes_equal(x_cat, jx_cat)


@pytest.mark.parametrize("name", ["gbt_d6", "train_multiclass/model",
                                  "train_if/model", "ydf_format/gbt_d6"])
def test_predict_example_matches_jax(name):
    require_jax()
    d = os.path.join(TESTDATA, name)
    jm = ydf.load_model(d)
    pm = ydf_tpu_torch.load_model(d, device="cpu")
    # A row of one column: every other feature is missing.
    for ex in rows(6, 5) + [{"f3": 0.25}]:
        got = pm.predict_example(ex)
        assert bytes_equal(got, np.asarray(jm.predict_example(ex)))
    # One row scores as the same row of a batch.
    ex = rows(8, 6)
    batch = pm.predict(Dataset.from_examples(ex, dataspec=pm.dataspec))
    assert bytes_equal(pm.predict_example(ex[3]), batch[3])
