"""The 8-bit QuickScorer engine of ydf_tpu_torch
(serving/quickscorer.py:build_binned_quickscorer), the bin-id input of
csrc/quickscorer.cu: its plain version held bitwise against the JAX
package's build_binned_quickscorer in interpret mode, the float engine
and the routed oracle; its bin cuts against the JAX ones; its refusal of
a serving-only binner. The card runs the kernel in the gpu test."""

import os

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import ydf_tpu as ydf
    from ydf_tpu.dataset.dataset import Dataset as JaxDataset
    from ydf_tpu.serving import quickscorer as jax_qs
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.dataset.dataset import Dataset
from ydf_tpu_torch.serving import quickscorer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "ydf_tpu_torch", "testdata")
torch.set_num_threads(1)
#: JAX-saved GBTs inside QuickScorer's envelope.
MODELS = ["gbt_d6", "train_default"]


def require_jax():
    if ydf is None:
        pytest.skip("needs the JAX package, the reference")


def bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def load(name, device="cpu"):
    return ydf_tpu_torch.load_model(os.path.join(TESTDATA, name),
                                    device=device)


def requests(model, rows=256):
    with np.load(os.path.join(TESTDATA, "gbt_d6", "requests.npz")) as z:
        return {k: z[k][:rows] for k in z.files
                if k in model.binner.feature_names}


@pytest.mark.parametrize("name", MODELS)
def test_binned_matches_float_and_routed(name):
    m = load(name)
    bq = quickscorer.build_binned_quickscorer(m)
    assert bq is not None
    req = requests(m)
    ds = Dataset.from_data(req, dataspec=m.dataspec)
    bins = m.binner.transform(ds, "cpu")
    assert bins.t().is_contiguous()
    got = bq(bins)
    enc = m._encode(ds)
    flt = quickscorer.build_quickscorer(m)(enc["x_num"], enc["x_cat"])
    from ydf_tpu_torch.ops.routing import forest_predict_values

    routed = forest_predict_values(
        m.forest, enc["x_num"], enc["x_cat"],
        num_numerical=m.binner.num_numerical, max_depth=m.max_depth)[:, 0]
    assert bytes_equal(got.numpy(), flt.numpy())
    assert bytes_equal(got.numpy(), routed.numpy())


@pytest.mark.parametrize("name", ["gbt_d6", "train_default"])
def test_binned_matches_jax_interpret(name):
    """Cuts bitwise the JAX ones, scores bitwise the JAX engine's in
    interpret mode."""
    require_jax()
    d = os.path.join(TESTDATA, name)
    jm, pm = ydf.load_model(d), load(name)
    jb = jax_qs.build_binned_quickscorer(jm, interpret=True)
    pb = quickscorer.build_binned_quickscorer(pm)
    assert bytes_equal(pb.qsm.cond_thresh, jb._bin_thresh)
    req = requests(pm, rows=128)
    jds = JaxDataset.from_data(req, dataspec=jm.dataspec)
    jbins = np.asarray(jm.binner.transform(jds))[:, :jm.binner.num_scalar]
    _, jx_cat, _ = jm._encode_inputs(jds)
    want = np.asarray(jb(jbins, jx_cat))
    bins = pm.binner.transform(Dataset.from_data(req, dataspec=pm.dataspec),
                               "cpu")
    assert np.array_equal(bins.numpy(), jbins)
    assert bytes_equal(pb(bins).numpy(), want)


def test_serving_only_binner_refused():
    """An imported model's binner has +inf boundaries: no binned engine
    (as in the JAX package), nor a float one (native missing values)."""
    m = load("ydf_format/gbt_d6")
    assert not np.isfinite(m.binner.boundaries).any()
    assert quickscorer.build_binned_quickscorer(m) is None
    if ydf is not None:
        jm = ydf.load_model(os.path.join(TESTDATA, "ydf_format", "gbt_d6"))
        assert jax_qs.build_binned_quickscorer(jm, interpret=True) is None


def test_outside_envelope_refused():
    assert quickscorer.build_binned_quickscorer(load("gbt_d8")) is None


@pytest.mark.gpu
@pytest.mark.parametrize("name", MODELS)
def test_binned_kernel_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    m = load(name, device="cuda")
    req = requests(m, rows=1024)
    ds = Dataset.from_data(req, dataspec=m.dataspec)
    bins = m.binner.transform(ds, "cuda")
    bq = quickscorer.build_binned_quickscorer(m)
    launched = quickscorer.KERNEL_LAUNCHES
    got = bq(bins)
    assert quickscorer.KERNEL_LAUNCHES == launched + 1
    plain = quickscorer.score_plain(bq.tables, bins.t().float())
    assert torch.equal(got, plain)
    cpu = load(name)
    want = quickscorer.build_binned_quickscorer(cpu)(
        cpu.binner.transform(Dataset.from_data(req, dataspec=cpu.dataspec),
                             "cpu"))
    assert bytes_equal(got.cpu().numpy(), want.numpy())
