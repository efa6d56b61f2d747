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

Training fixture `train_default/`: the JAX package's
`GradientBoostedTreesLearner(label="label")` with every default (the
10% validation split, look-ahead early stopping, categorical splits) on
make_frame's recipe at 500,000 training rows (the 28 numerical columns,
NaNs in f0, f5, f11, categorical c0-c3) on the CPU, and its model
evaluated on 100,000 fresh rows of the same generator (labels kept,
unseen and missing categories injected). It holds:

  config.json    the configuration (rows, seeds, the generator's
                 constants, learner arguments), the JAX version and
                 implementations used, the classes, the SHA-256 of the
                 train and test frames (chip_smoke.frame_sha256), of the
                 JAX bin matrix (u8 [500000, 32]) and of the validation
                 rows (int64, the JAX learner's split expression),
                 num_trees / num_trees_trained, and the JAX evaluate()
                 metrics on all 100,000 test rows;
  model.json, forest.npz  the JAX package's saved model;
  expected.npz   initial prediction, the per-iteration train and
                 validation losses (every trained iteration), and raw
                 scores and predictions on the first 1,024 test rows.

Run from the repo root:  python scripts/make_torch_port_fixtures.py
(~6 minutes on a CPU; `--only train_bench`, `--only train_vs`,
`--only train_default` or `--only serving` for one part).
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


def make_frame(seed: int = 7, train_rows: int = TRAIN_ROWS,
               request_rows: int = REQUEST_ROWS, keep_label: bool = False):
    """(train columns, request columns): numerical f32, categorical
    unicode, binary int label on the train side (and on the request side
    with keep_label)."""
    import bench

    data, _, y = bench.make_data(train_rows + request_rows, 28)
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
    train = {k: v[:train_rows] for k, v in data.items()}
    req = {k: v[train_rows:].copy() for k, v in data.items()
           if keep_label or k != "label"}
    # Unseen and missing categories in the requests.
    for j in range(len(CAT_VOCABS)):
        col = req[f"c{j}"].astype("<U8")
        col[rng.uniform(size=request_rows) < 0.05] = "unseen"
        col[rng.uniform(size=request_rows) < 0.03] = ""
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


TRAIN_DEFAULT = dict(
    rows=500_000, test_rows=100_000, data_seed=0, cat_seed=7,
    compare_rows=1024, learner=dict(label="label"),
)


def write_train_default():
    import hashlib
    import json

    import jax

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.dataset.dataset import Dataset
    from ydf_tpu.ops.histogram import resolve_hist_impl, resolve_hist_quant
    from ydf_tpu.ops.routing_native import (
        resolve_route_impl,
        update_uses_fma,
    )

    cfg = dict(TRAIN_DEFAULT)
    assert cfg["data_seed"] == 0  # bench.make_data's RandomState(0)
    cfg["generator"] = dict(features=28, cat_vocabs=list(CAT_VOCABS),
                            missing_features=[0, 5, 11])
    d = os.path.join(OUT, "train_default")
    if os.path.isdir(d):
        shutil.rmtree(d)
    train, test = make_frame(cfg["cat_seed"], cfg["rows"], cfg["test_rows"],
                             keep_label=True)
    m = ydf.GradientBoostedTreesLearner(**cfg["learner"]).train(train)
    m.save(d)
    bins = m.binner.transform(Dataset.from_data(train, dataspec=m.dataspec))
    # The JAX learner's split (ydf_tpu/learners/gbt.py:421-423).
    perm = np.random.RandomState(123456).permutation(cfg["rows"])
    va_idx = perm[:min(max(int(cfg["rows"] * 0.1), 1), cfg["rows"] - 1)]
    ev = m.evaluate(test)
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    out = dict(cfg)
    out["jax_impls"] = {
        "hist_impl": resolve_hist_impl("auto"),
        "hist_quant": resolve_hist_quant(None),
        "route_impl": resolve_route_impl(None),
        "update_uses_fma": bool(update_uses_fma()),
    }
    out["jax_version"] = jax.__version__
    out["classes"] = m.classes
    out["train_sha256"] = chip_smoke.frame_sha256(train)
    out["test_sha256"] = chip_smoke.frame_sha256(test)
    out["bins_sha256"] = hashlib.sha256(
        np.ascontiguousarray(bins).tobytes()).hexdigest()
    out["valid_idx_sha256"] = hashlib.sha256(
        np.ascontiguousarray(va_idx, np.int64).tobytes()).hexdigest()
    out["num_trees"] = m.training_logs["num_trees"]
    out["num_trees_trained"] = m.training_logs["num_trees_trained"]
    out["jax_evaluate"] = dict(ev.metrics)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    logs = m.training_logs["iterations"]
    np.savez_compressed(
        os.path.join(d, "expected.npz"),
        initial_predictions=np.asarray(m.initial_predictions, np.float32),
        train_loss=np.array([r["train_loss"] for r in logs], np.float32),
        valid_loss=np.array([r["valid_loss"] for r in logs], np.float32),
        raw=m._raw_scores(head, combine="sum")[:, 0],
        predictions=m.predict(head),
    )
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    print(f"train_default: {out['num_trees']} of {out['num_trees_trained']} "
          f"trees, {size} bytes, {out['jax_impls']}, {ev.metrics}")


TRAIN_RF = dict(
    rows=50_000, test_rows=10_000, cat_seed=7, compare_rows=1024,
    learner=dict(label="label"), small_trees=3, seed=123456,
)


def write_train_rf():
    import json
    import time

    import jax
    import jax.numpy as jnp

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.config import TreeConfig, resolve_max_frontier
    from ydf_tpu.dataset.dataset import Dataset
    from ydf_tpu.ops.histogram import resolve_hist_impl, resolve_hist_quant
    from ydf_tpu.ops.routing_native import resolve_route_impl

    cfg = dict(TRAIN_RF)
    cfg["generator"] = dict(features=28, cat_vocabs=list(CAT_VOCABS),
                            missing_features=[0, 5, 11])
    d = os.path.join(OUT, "train_rf")
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    train, test = make_frame(cfg["cat_seed"], cfg["rows"], cfg["test_rows"],
                             keep_label=True)
    t0 = time.perf_counter()
    m = ydf.RandomForestLearner(**cfg["learner"]).train(train)
    train_s = time.perf_counter() - t0
    small = ydf.RandomForestLearner(num_trees=cfg["small_trees"],
                                    **cfg["learner"]).train(train)
    small.save(os.path.join(d, "rf_small"))
    fo = {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}
    T, n = fo["feature"].shape[0], cfg["rows"]
    F = m.binner.num_features
    depth = m.max_depth
    seed = cfg["seed"]

    # The bootstrap counts of every tree (random_forest.py:644-651).
    @jax.jit
    def counts(ts):
        def one(t):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            return jax.random.poisson(jax.random.split(key, 4)[0], 1.0, (n,))
        return jax.vmap(one)(ts)

    boot = np.concatenate([np.asarray(counts(jnp.arange(t, min(t + 50, T))))
                           for t in range(0, T, 50)]).astype(np.int32)
    # Tree 0's candidate-feature masks, layer by layer (grower.py:726 and
    # :251-285: uniform scores, kept when >= the k-th largest).
    cand = max(int(np.ceil(np.sqrt(F))), 1)
    L = TreeConfig(max_depth=depth, max_frontier=resolve_max_frontier(
        "auto", n, 5)).frontier
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 0),
                           4)[1]
    masks = []
    for dd in range(depth):
        key, _, k_feat = jax.random.split(jax.random.fold_in(key, dd), 3)
        base = jax.random.uniform(k_feat, (min(2 ** dd, L), F))
        kth = jax.lax.top_k(base, cand)[0][:, -1]
        masks.append(np.asarray(base >= kth[:, None]))
    bins = m.binner.transform(Dataset.from_data(train, dataspec=m.dataspec))
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    ev = m.evaluate(test)
    out = dict(cfg)
    out["jax_impls"] = {
        "hist_impl": resolve_hist_impl("auto"),
        "hist_quant": resolve_hist_quant(None),
        "route_impl": resolve_route_impl(None),
    }
    out["jax_version"] = jax.__version__
    out["jax_train_s_cpu"] = train_s
    out["classes"] = m.classes
    out["num_trees"] = T
    out["frontier"] = L
    out["max_nodes"] = int(fo["feature"].shape[1])
    out["candidate_features"] = cand
    out["num_features"] = F
    out["knuth_steps"] = int(boot.max()) + 1
    out["train_sha256"] = chip_smoke.frame_sha256(train)
    out["test_sha256"] = chip_smoke.frame_sha256(test)
    out["bins_sha256"] = chip_smoke.array_sha256(np.asarray(bins))
    out["oob_evaluation"] = m.oob_evaluation
    out["jax_evaluate"] = dict(ev.metrics)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)

    def digest(h):
        return np.frombuffer(bytes.fromhex(h), np.uint8)

    np.savez_compressed(
        os.path.join(d, "expected.npz"),
        boot_sha256=np.stack([digest(chip_smoke.array_sha256(b))
                              for b in boot]),
        mask_sha256=np.stack([digest(chip_smoke.array_sha256(mk))
                              for mk in masks]),
        mask_kept=np.array([mk.sum() for mk in masks], np.int64),
        tree_sha256=np.stack([digest(chip_smoke.tree_sha256(fo, t))
                              for t in range(T)]),
        layer_sha256=np.stack([
            np.stack([digest(h) for h in chip_smoke.layer_sha256s(
                fo, t, depth)]) for t in range(T)]),
        num_nodes=fo["num_nodes"].astype(np.int32),
        proba=np.asarray(m.predict(head), np.float32),
        small_proba=np.asarray(small.predict(head), np.float32),
    )
    size = sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)
    print(f"train_rf: {T} trees in {train_s:.1f} s, {size} bytes, "
          f"{out['jax_impls']}, oob {m.oob_evaluation['metrics']}, "
          f"evaluate {ev.metrics}")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    only = sys.argv[sys.argv.index("--only") + 1] if (
        "--only" in sys.argv) else None
    if only in (None, "train_bench"):
        write_train_bench()
    if only in (None, "train_vs"):
        write_train_vs()
    if only in (None, "train_default"):
        write_train_default()
    if only in (None, "train_rf"):
        write_train_rf()
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
