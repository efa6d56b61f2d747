"""Writes the fixtures of the PyTorch/CUDA port: two serving models and
the training run of the bench configuration.

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

Training fixture `train_bench/`: the JAX package trains the bench's
GBT (`bench.py:run_bench`: 500,000 rows x 28 features of
`bench.make_data`, 20 trees, depth 6, no validation split) on the CPU,
with its default implementations, which config.json records. It holds:

  config.json    the configuration (rows, features, learner arguments,
                 data and request seeds), the JAX implementations used,
                 the classes, and the SHA-256 of the JAX bin matrix
                 (u8 [500000, 28], too large to commit);
  binner.json    the JAX Binner.to_json() (boundaries, imputation);
  forest.npz     the JAX forest arrays;
  expected.npz   initial prediction, per-iteration train loss, and raw
                 scores and predictions on 1024 fresh rows drawn with
                 numpy RandomState(1).

Training fixture `train_vs/`: the JAX package trains its GBT at the
default vector-sequence anchor counts (16 closer-than, 16
projected-more-than per tree) on chip_smoke.make_vs_data (200,000 rows:
a sequence column "seq" of up to 16 vectors of 16, four noise columns,
numpy RandomState(0)), 20 trees, depth 6, no validation split, on the
CPU. It holds:

  config.json    the configuration (rows, the generator's constants,
                 learner arguments, seeds), the JAX version, its
                 jax_threefry_partitionable flag and the implementations
                 used, the classes;
  model.json, forest.npz  the JAX package's saved model (the serving
                 fixture; forest.npz carries each tree's anchors);
  expected.npz   initial prediction, per-iteration train loss, and raw
                 scores and predictions on 1024 fresh rows
                 (make_vs_data with seed 1: missing and empty sequences
                 included).

Run from the repo root:  python scripts/make_torch_port_fixtures.py
(~4 minutes on a CPU; `--only train_bench`, `--only train_vs` or
`--only serving` for one part).
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


TRAIN_BENCH = dict(
    rows=500_000, features=28, data_seed=0, request_rows=1024,
    request_seed=1,
    learner=dict(label="label", num_trees=20, max_depth=6,
                 validation_ratio=0.0, early_stopping="NONE"),
)


def write_train_bench():
    import hashlib
    import json

    import jax

    import bench
    import ydf_tpu as ydf
    from ydf_tpu.dataset.dataset import Dataset
    from ydf_tpu.ops.histogram import resolve_hist_impl, resolve_hist_quant
    from ydf_tpu.ops.routing_native import (
        resolve_route_impl,
        update_uses_fma,
    )

    cfg = TRAIN_BENCH
    d = os.path.join(OUT, "train_bench")
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    assert cfg["data_seed"] == 0  # bench.make_data's RandomState(0)
    data, _, _ = bench.make_data(cfg["rows"], cfg["features"])
    m = ydf.GradientBoostedTreesLearner(**cfg["learner"]).train(data)
    bins = m.binner.transform(Dataset.from_data(data, dataspec=m.dataspec))
    x, _ = bench.synth_higgs_chunk(
        np.random.RandomState(cfg["request_seed"]), cfg["request_rows"],
        cfg["features"])
    req = {f"f{i}": x[:, i] for i in range(cfg["features"])}
    out = dict(cfg)
    out["jax_impls"] = {
        "hist_impl": resolve_hist_impl("auto"),
        "hist_quant": resolve_hist_quant(None),
        "route_impl": resolve_route_impl(None),
        "update_uses_fma": bool(update_uses_fma()),
    }
    out["jax_version"] = jax.__version__
    out["classes"] = m.classes
    out["bins_sha256"] = hashlib.sha256(
        np.ascontiguousarray(bins).tobytes()).hexdigest()
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    with open(os.path.join(d, "binner.json"), "w") as f:
        json.dump(m.binner.to_json(), f)
    np.savez_compressed(os.path.join(d, "forest.npz"),
                        **m.forest.to_numpy())
    np.savez_compressed(
        os.path.join(d, "expected.npz"),
        initial_predictions=np.asarray(m.initial_predictions, np.float32),
        train_loss=np.asarray(m.training_logs["train_loss"], np.float32),
        raw=m._raw_scores(req, combine="sum")[:, 0],
        predictions=m.predict(req),
    )
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    print(f"train_bench: {m.num_trees()} trees, {size} bytes, "
          f"{out['jax_impls']}")


TRAIN_VS = dict(
    rows=200_000, data_seed=0, request_rows=1024, request_seed=1,
    learner=dict(label="label", num_trees=20, max_depth=6,
                 validation_ratio=0.0, early_stopping="NONE"),
)


def write_train_vs():
    import json

    import jax

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.ops.histogram import resolve_hist_impl, resolve_hist_quant
    from ydf_tpu.ops.routing_native import (
        resolve_route_impl,
        update_uses_fma,
    )

    cfg = dict(TRAIN_VS)
    cfg["generator"] = dict(max_len=chip_smoke.VS_MAX_LEN,
                            dim=chip_smoke.VS_DIM, noise=chip_smoke.VS_NOISE,
                            radius=chip_smoke.VS_RADIUS)
    d = os.path.join(OUT, "train_vs")
    if os.path.isdir(d):
        shutil.rmtree(d)
    data = chip_smoke.make_vs_data(cfg["rows"], seed=cfg["data_seed"])
    m = ydf.GradientBoostedTreesLearner(**cfg["learner"]).train(data)
    m.save(d)
    req = chip_smoke.make_vs_data(cfg["request_rows"],
                                  seed=cfg["request_seed"])
    del req["label"]
    out = dict(cfg)
    out["jax_impls"] = {
        "hist_impl": resolve_hist_impl("auto"),
        "hist_quant": resolve_hist_quant(None),
        "route_impl": resolve_route_impl(None),
        "update_uses_fma": bool(update_uses_fma()),
        "vs_scores": "xla",
    }
    out["jax_version"] = jax.__version__
    out["jax_threefry_partitionable"] = bool(
        jax.config.jax_threefry_partitionable)
    out["classes"] = m.classes
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    np.savez_compressed(
        os.path.join(d, "expected.npz"),
        initial_predictions=np.asarray(m.initial_predictions, np.float32),
        train_loss=np.asarray(m.training_logs["train_loss"], np.float32),
        raw=m._raw_scores(req, combine="sum")[:, 0],
        predictions=m.predict(req),
    )
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    print(f"train_vs: {m.num_trees()} trees, {size} bytes, "
          f"{out['jax_impls']}")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    only = sys.argv[sys.argv.index("--only") + 1] if (
        "--only" in sys.argv) else None
    if only in (None, "train_bench"):
        write_train_bench()
    if only in (None, "train_vs"):
        write_train_vs()
    if only not in (None, "serving"):
        return
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
