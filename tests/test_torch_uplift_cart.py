"""The uplift CART on ydf_tpu_torch, held against the JAX package on the
CPU: CartLearner(task=CATEGORICAL_UPLIFT) grows the JAX tree and prunes
it by the holdout's AUUC (prune_single_tree_uplift node for node on a
JAX-grown tree and holdout), its holdout metrics, predictions and
evaluation; a NUMERICAL_UPLIFT CART is not pruned.

Tolerances: trees, pruned counts and predictions bitwise; metrics within
1e-12 (host float64 on the same predictions).

Tests marked `gpu` need a card (run on one with
`python -m pytest --noconftest -m gpu tests/test_torch_*.py`).
"""

import tempfile

import numpy as np
import pytest
import torch

try:  # The machine with the card has no JAX: only the gpu tests run there.
    import jax  # noqa: F401

    import ydf_tpu as ydf
    from ydf_tpu.config import Task as JaxTask
    from ydf_tpu.learners import cart as jax_cart
except ImportError:
    ydf = None

import ydf_tpu_torch
from ydf_tpu_torch.config import Task
from ydf_tpu_torch.learners import cart
from test_torch_random_forest import (
    assert_same_forest,
    assert_same_metrics,
    require_jax,
)
from test_torch_uplift import _need_card, uplift_frame

torch.set_num_threads(1)


def capture_jax_cart(train, **kw):
    """The JAX uplift CART with its grown tree saved before the pruning:
    (JAX pruned model, the grown model's directory, the holdout)."""
    seen = {}
    original = jax_cart.prune_single_tree_uplift
    tmp = tempfile.mkdtemp()

    def prune(model, valid_data, **kwargs):
        model.save(tmp)
        seen["valid"] = dict(valid_data)
        return original(model, valid_data, **kwargs)

    jax_cart.prune_single_tree_uplift = prune
    try:
        jm = ydf.CartLearner(label="y", task=JaxTask.CATEGORICAL_UPLIFT,
                             uplift_treatment="treat", **kw).train(train)
    finally:
        jax_cart.prune_single_tree_uplift = original
    return jm, tmp, seen["valid"]


@pytest.fixture(scope="module")
def uplift_cart():
    require_jax()
    train, test = uplift_frame(4000, seed=2)
    jm, grown_dir, valid = capture_jax_cart(train, max_depth=12)
    pm = ydf_tpu_torch.CartLearner(
        label="y", task=Task.CATEGORICAL_UPLIFT, uplift_treatment="treat",
        max_depth=12, device="cpu").train(train)
    return train, test, jm, pm, grown_dir, valid


def test_uplift_cart_prunes_by_auuc_as_jax(uplift_cart):
    """The pruned tree node for node, the pruned count, the holdout's
    Qini and AUUC, predictions and evaluation."""
    train, test, jm, pm, _, _ = uplift_cart
    assert_same_forest(jm, pm)
    pruned = pm.extra_metadata["num_pruned_nodes"]
    assert pruned == jm.extra_metadata["num_pruned_nodes"] > 0
    assert_same_metrics(jm.oob_evaluation["metrics"],
                        pm.self_evaluation()["metrics"])
    assert pm.predict(test).tobytes() == np.asarray(jm.predict(test)).tobytes()
    assert_same_metrics(jm.evaluate(test).metrics, pm.evaluate(test).metrics)


def test_prune_single_tree_uplift_matches_jax(uplift_cart):
    """The port's AUUC pruning of the JAX-grown tree on the JAX holdout
    equals the JAX pruning node for node."""
    train, test, jm, _, grown_dir, valid = uplift_cart
    model = ydf_tpu_torch.load_model(grown_dir, device="cpu")
    n = cart.prune_single_tree_uplift(model, valid, weights_col=None,
                                      treatment_col="treat")
    assert n == jm.extra_metadata["num_pruned_nodes"]
    assert_same_forest(jm, model)


def test_numerical_uplift_cart_is_not_pruned():
    """A NUMERICAL_UPLIFT CART trains on every row, unpruned, as the JAX
    package's."""
    require_jax()
    train, test = uplift_frame(1500, numerical=True)
    kw = dict(label="y", uplift_treatment="treat", max_depth=5)
    jm = ydf.CartLearner(task=JaxTask.NUMERICAL_UPLIFT, **kw).train(train)
    pm = ydf_tpu_torch.CartLearner(task=Task.NUMERICAL_UPLIFT, device="cpu",
                                   **kw).train(train)
    assert_same_forest(jm, pm)
    assert "num_pruned_nodes" not in pm.extra_metadata
    assert pm.self_evaluation() is None


@pytest.mark.gpu
def test_uplift_cart_on_card_matches_cpu():
    _need_card()
    train, test = uplift_frame(6000, seed=2)
    kw = dict(label="y", task=Task.CATEGORICAL_UPLIFT,
              uplift_treatment="treat", max_depth=8)
    gm = ydf_tpu_torch.CartLearner(device="cuda", **kw).train(train)
    cm = ydf_tpu_torch.CartLearner(device="cpu", **kw).train(train)
    assert gm.extra_metadata == cm.extra_metadata
    assert gm.predict(test).tobytes() == cm.predict(test).tobytes()
