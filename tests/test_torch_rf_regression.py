"""The regression random forest on ydf_tpu_torch, held against the JAX
package on the CPU: RandomForestLearner(task=REGRESSION) with every
default at depth 16 (stats [y, y^2, 1] times the bootstrap counts, F/3
candidate features, variance-reduction gains), and a forest grown
without the bootstrap. Tolerances as tests/test_torch_random_forest.py
says: trees, leaf values and predictions bitwise (the f32 label sums of
a histogram cell are summed in f64 and rounded once by both packages),
metrics 1e-12.
"""

import pytest
import torch

try:  # The machine with the card has no JAX.
    import ydf_tpu as ydf
except ImportError:
    ydf = None

import ydf_tpu_torch
from test_torch_random_forest import (
    train_pair,
    assert_same_forest,
    check_forest,
    check_predict,
    make_frame,
    require_jax,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def regression():
    return train_pair("regression")


def test_regression_forest_grows_the_jax_trees(regression):
    check_forest(*regression)


def test_regression_predict_and_evaluate_match_jax(regression):
    check_predict(regression[1], regression[2], "regression")


def test_without_bootstrap_or_oob():
    """bootstrap_training_dataset=False grows every tree on all rows
    (no out-of-bag evaluation), as the JAX package does."""
    require_jax()
    df = make_frame(800, 4)
    kw = dict(label="label", num_trees=3, max_depth=8,
              bootstrap_training_dataset=False)
    jm = ydf.RandomForestLearner(**kw).train(df)
    pm = ydf_tpu_torch.RandomForestLearner(device="cpu", **kw).train(df)
    assert_same_forest(jm, pm)
    assert jm.oob_evaluation is None and pm.self_evaluation() is None
