"""How far the port's vector-sequence training drifts from the JAX
package's when the anchor dots are summed in another order.

The port sums a dot in `dot_lanes(A, D)` interleaved chains of fused
multiply-adds (ydf_tpu_torch/ops/vector_sequence.py), the order of XLA's
CPU dot at the default anchor counts. This script trains vs_small (the
train_vs task at 3,000 rows, sequences of up to 6 vectors of 4, 5 trees,
depth 4; tests/test_torch_vector_sequence.py) on both packages on the
CPU, once with that order and once with a single chain in increasing d,
and prints for each: the per-tree VS boundaries that differ from the JAX
learner's, the split nodes whose feature or bin differ, and the ulps
between VS thresholds of equal nodes.

  JAX_PLATFORMS=cpu python scripts/vs_dot_order_drift.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import ydf_tpu as ydf  # noqa: E402
import ydf_tpu_torch  # noqa: E402
from ydf_tpu.learners import gbt as jax_gbt  # noqa: E402
from ydf_tpu_torch.learners import gbt as port_gbt  # noqa: E402
from ydf_tpu_torch.ops import vector_sequence as vso  # noqa: E402

HP = dict(label="label", num_trees=5, max_depth=4, validation_ratio=0.0,
          early_stopping="NONE")


def jax_run(data):
    captured = {}
    original = jax_gbt.forest_from_stacked_trees

    def capture(*args, **kwargs):
        captured.update(kwargs)
        return original(*args, **kwargs)

    jax_gbt.forest_from_stacked_trees = capture
    try:
        model = ydf.GradientBoostedTreesLearner(**HP).train(data)
    finally:
        jax_gbt.forest_from_stacked_trees = original
    return model, np.asarray(captured["vs_boundaries"])


def drift(data, jm, jax_bnd):
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu", **HP)
    prep = learner._prepare(data)
    Ac, Ap = learner._vs_anchor_counts()
    vs = port_gbt.vs_inputs(prep["vs"], Ac, Ap, "cpu")
    B = prep["binner"].num_bins
    draws = port_gbt.vs_draws(learner.random_seed, HP["num_trees"], 1,
                              Ac + 2 * Ap, "cpu")
    qs = port_gbt.prng.linspace_f32(1.0 / B, 1.0 - 1.0 / B, B - 1)
    bnd = np.stack([port_gbt.make_vs_projections(
        vs, {k: v[t] for k, v in draws.items()}, qs)[1].numpy()
        for t in range(HP["num_trees"])])
    b_ulps = chip_smoke.ulps_apart(bnd, jax_bnd)
    pm = ydf_tpu_torch.GradientBoostedTreesLearner(device="cpu",
                                                   **HP).train(data)
    jf, pf = jm.forest.to_numpy(), pm.forest.to_numpy()
    split = ~jf["is_leaf"] | ~pf["is_leaf"]
    differ = split & ((pf["feature"] != jf["feature"])
                      | (pf["threshold_bin"] != jf["threshold_bin"])
                      | (pf["is_leaf"] != jf["is_leaf"]))
    same = (~differ & split & ~pf["is_leaf"]
            & (pf["feature"] >= pm.binner.num_numerical))
    t_ulps = chip_smoke.ulps_apart(pf["threshold"][same],
                                   jf["threshold"][same])
    return (f"boundaries differing {int((b_ulps > 0).sum())} of "
            f"{b_ulps.size} (max {int(b_ulps.max())} ulps); split nodes "
            f"differing {int(differ.sum())} of {int(split.sum())}; VS "
            f"thresholds of equal nodes: {int((t_ulps > 0).sum())} of "
            f"{t_ulps.size} differ, max {int(t_ulps.max())} ulps")


def main():
    data = chip_smoke.make_vs_data(3000, max_len=6, dim=4, noise=2,
                                   radius=2.57)
    jm, jax_bnd = jax_run(data)
    print(f"XLA's order (dot_lanes(32, 4) = {vso.dot_lanes(32, 4)}): "
          f"{drift(data, jm, jax_bnd)}")
    vso.dot_lanes = lambda num_anchors, dim: 1
    print(f"one chain in increasing d: {drift(data, jm, jax_bnd)}")


if __name__ == "__main__":
    main()
