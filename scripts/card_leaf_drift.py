"""How far the card's leaf values drift from the CPU port's, and which
histogram kernel moves them.

Trains vs_small (the train_vs task at 3,000 rows, sequences of up to 6
vectors of 4, 5 trees, depth 4: tests/test_torch_vector_sequence.py's
test_card_training_equals_cpu_training) on the CPU, then on the card
three times: with both histogram kernels, with the root kernel swapped
for its plain version (f64 sums), and with both swapped. For each it
prints the largest |card - CPU| leaf value (the test allows 2e-5), where
it is, and whether the splits are equal. The plain versions on the card
are the CPU port's arithmetic; what moves with a kernel is its
summation order (the root kernel's f32 sums, the routed kernel's f64
ones).

    python3 scripts/card_leaf_drift.py     # needs one CUDA card and nvcc
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import ydf_tpu_torch  # noqa: E402
from ydf_tpu_torch.ops import histogram_kernels as hk  # noqa: E402

# tests/test_torch_vector_sequence.py's VS_SMALL and HP.
VS_SMALL = dict(max_len=6, dim=4, noise=2, radius=2.57)
HP = dict(label="label", num_trees=5, max_depth=4, validation_ratio=0.0,
          early_stopping="NONE")
SPLITS = ("feature", "threshold_bin", "left", "right", "is_leaf")


def train(device):
    return ydf_tpu_torch.GradientBoostedTreesLearner(
        device=device, **HP).train(
        chip_smoke.make_vs_data(3000, seed=0, **VS_SMALL)).forest.to_numpy()


def main():
    if not torch.cuda.is_available():
        print("card_leaf_drift: CUDA is not available", file=sys.stderr)
        return 1
    cpu = train("cpu")
    kernels = (hk.histogram, hk.histogram_routed)
    runs = (("both kernels", kernels),
            ("plain root, routed kernel",
             (hk.histogram_plain, hk.histogram_routed)),
            ("plain root, plain routed",
             (hk.histogram_plain, hk.histogram_routed_plain)))
    print(chip_smoke.nvidia_smi_line())
    try:
        for name, (root, routed) in runs:
            hk.histogram, hk.histogram_routed = root, routed
            card = train("cuda")
            diff = np.abs(card["leaf_value"].astype(np.float64)
                          - cpu["leaf_value"])
            diff = np.where(np.isnan(diff), 0.0, diff)
            at = np.unravel_index(int(diff.argmax()), diff.shape)
            same = all(np.array_equal(card[f], cpu[f]) for f in SPLITS)
            print(f"{name}: max |card - CPU| leaf value {diff.max():.4g} "
                  f"(tree {at[0]}, node {at[1]}: card "
                  f"{card['leaf_value'][at]:.8g}, CPU "
                  f"{cpu['leaf_value'][at]:.8g}); leaves over 2e-5: "
                  f"{int((diff > 2e-5).sum())}; splits equal: {same}")
    finally:
        hk.histogram, hk.histogram_routed = kernels
    return 0


if __name__ == "__main__":
    sys.exit(main())
