"""Writes the serving fixtures of the PyTorch/CUDA port.

The JAX package trains two GBT models and saves them with its own
`model.save`; the port reads them with its own loader
(`ydf_tpu_torch.load_model`). Each model directory under
`ydf_tpu_torch/testdata/` holds:

  model.json, forest.npz  the JAX package's saved model;
  requests.npz            1024 held-out rows (numerical columns f32,
                          categorical columns numpy unicode arrays, with
                          NaNs, missing "" and unseen categories);
  expected.npz            the JAX package's raw scores and predictions
                          on those rows (CPU).

Models:
  gbt_d6  the library default: 300 trees, max_depth=6 (QuickScorer)
  gbt_d8  50 trees, max_depth=8 (more than 64 leaves: the bank engine)

Data: the 28 numerical columns of bench.make_data plus 4 seeded
categorical columns with vocabularies of 5, 12, 40 and 200, drawn so
that they carry some signal about the label.

Run from the repo root:  python scripts/make_torch_port_fixtures.py
"""

import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "ydf_tpu_torch", "testdata")

TRAIN_ROWS = 20_000
REQUEST_ROWS = 1024
CAT_VOCABS = (5, 12, 40, 200)
MODELS = {"gbt_d6": dict(num_trees=300, max_depth=6),
          "gbt_d8": dict(num_trees=50, max_depth=8)}


def make_frame(seed: int = 7):
    """(train columns, request columns): numerical f32, categorical
    unicode, binary int label on the train side only."""
    import bench

    data, _, y = bench.make_data(TRAIN_ROWS + REQUEST_ROWS, 28)
    rng = np.random.default_rng(seed)
    n = len(y)
    for j, vocab in enumerate(CAT_VOCABS):
        code = rng.integers(0, vocab, n)
        # Positive rows favour the lower third of the vocabulary.
        skew = (y == 1) & (rng.uniform(size=n) < 0.4)
        code = np.where(skew, code % max(vocab // 3, 1), code)
        data[f"c{j}"] = np.array([f"v{c}" for c in code])
    for i in (0, 5, 11):
        miss = rng.uniform(size=n) < 0.03
        data[f"f{i}"] = np.where(miss, np.nan, data[f"f{i}"]).astype(
            np.float32
        )
    train = {k: v[:TRAIN_ROWS] for k, v in data.items()}
    req = {k: v[TRAIN_ROWS:].copy() for k, v in data.items() if k != "label"}
    # Unseen and missing categories in the requests.
    for j in range(len(CAT_VOCABS)):
        col = req[f"c{j}"].astype("<U8")
        col[rng.uniform(size=REQUEST_ROWS) < 0.05] = "unseen"
        col[rng.uniform(size=REQUEST_ROWS) < 0.03] = ""
        req[f"c{j}"] = col
    return train, req


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import ydf_tpu as ydf

    train, req = make_frame()
    for name, hp in MODELS.items():
        d = os.path.join(OUT, name)
        if os.path.isdir(d):
            shutil.rmtree(d)
        m = ydf.GradientBoostedTreesLearner(
            label="label", validation_ratio=0.0, early_stopping="NONE", **hp
        ).train(train)
        m.save(d)
        np.savez_compressed(os.path.join(d, "requests.npz"), **req)
        raw = m._raw_scores(req, combine="sum")[:, 0]
        pred = m.predict(req)
        np.savez_compressed(
            os.path.join(d, "expected.npz"), raw=raw, predictions=pred
        )
        size = sum(
            os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
        )
        print(f"{name}: {m.num_trees()} trees, {size} bytes")


if __name__ == "__main__":
    main()
