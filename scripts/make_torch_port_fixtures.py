"""Writes the fixtures of the PyTorch/CUDA port: two serving models and
the JAX package's training runs the port is held against.

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

Training fixture `train_multiclass/`: the JAX package's default learner
on the three-class variant of make_frame (classes=3: the generator's
logit plus logistic noise cut at CLASS_CUTS), 200,000 training rows and
50,000 to evaluate. Its config.json adds `update_form`, how XLA lowered
the K > 1 prediction update in every class column, read from the dump
of the boosting programs this script asks XLA for (`update_forms`, with
objdump); expected.npz holds the losses, a SHA-256 per tree, the
probabilities on 1,024 rows, and model/ the JAX model (the first
small_iterations iterations if the whole would pass max_bytes).

Training fixture `train_gbt_options/`: one 20,000-row, 30-iteration
configuration per ported option (TRAIN_GBT_OPTIONS), each with its tree
hashes, kept count, losses and predictions on 1,024 rows.

Training fixture `train_cart/`: the JAX `CartLearner(label="label")`
with every default on make_frame's 500,000 rows (10% held out for
pruning), evaluated on 100,000 fresh rows: config.json holds the
holdout's and the bins' SHA-256, the grown and pruned trees' hashes,
the pruned node count, the holdout and evaluate metrics and a 20,000-row
regression CART's results; model/ the pruned JAX model; expected.npz the
grown tree's arrays (captured by wrapping the JAX prune_single_tree),
the probabilities on 1,024 rows and the regression predictions.

Training fixture `train_if/`: the JAX `IsolationForestLearner()` with
every default on the same rows' 32 feature columns, scoring 100,000
fresh rows of which 1% are made anomalous (chip_smoke.if_test_frame):
config.json holds the bins' and scores' SHA-256 and the AUC;
expected.npz every tree's subsample (sorted rows) and node-array hashes,
tree 0's arrays and the first 1,024 scores; model/ the JAX model (a
3-tree one if the whole passes max_bytes).

Training fixture `train_oblique/`: the JAX package's learners with
split_axis="SPARSE_OBLIQUE" and every other default, on the frames of
train_default (GBT, CART), train_rf (random forest) and train_if
(isolation forest). config.json holds, per learner, the configuration,
the frames' and bins' SHA-256, the projection count, the kept and
trained tree counts and the evaluation; expected.npz every tree's
node-array hash (chip_smoke.tree_sha256) and a hash of its thresholds,
every tree's projections (W, small and sparse) and a hash of its
boundaries (captured from the JAX training loop), tree 0's boundaries,
and predictions or scores (the GBT's and the isolation forest's on
every test row by SHA-256, the first 1,024 in full, with the GBT's
first 1,024 test rows themselves); gbt_model/ the JAX GBT (the serving
fixture). The random forest grows `fixture_trees`
trees (trees are independent, so they are the first trees of any
longer forest). JAX predictions come from its Routed engine
(force_engine), the engine the port serves oblique forests with. The
writer refuses to run under another jax than 0.9.0, the version whose
XLA dot and reduce orders ydf_tpu_torch/ops/oblique.py replays.

Training fixtures `train_monotone/`, `train_dart/` and `train_sets/`
(config.json and expected.npz: per-tree SHA-256 of the node arrays and
leaf values (with is_set for sets), node counts, losses, the kept and
trained counts, the first 1,024 predictions in full and all of them by
SHA-256, the evaluation): the default GBT with monotonic_constraints
{f0: +1, f1: -1, f2: +1} on train_default's frame, plus a 3-class and a
SPARSE_OBLIQUE monotone run at 20,000 rows and 30 iterations; the
default GBT with dart_dropout=0.1 on 100,000 rows; and
chip_smoke.make_set_frame (two CATEGORICAL_SET columns) under the
default GBT (200,000 rows), random forest (20,000 rows, its first 50
trees) and CART (100,000 rows; grown and pruned tree hashes). These
refuse to run under another jax than 0.9.0 too (the per-item einsum's
and DART's dot orders).

Training fixtures `train_uplift/`, `train_honest/`, `train_sets_alone/`
and `train_multitasker/` (the same layout, plus the frames' and bins'
SHA-256 and CART's grown and pruned hashes and pruned count): the uplift
random forest (its first 50 trees), the uplift CART and a NUMERICAL_UPLIFT
forest on chip_smoke.make_uplift_frame; the honest forest on train_rf's
frame and an honest regression; the GBT, random forest and CART on
chip_smoke.sets_alone_frame (set columns only); the multitasker's two
GBTs (its JAX directory in model/). rf_small/ and cart_model/ hold JAX
models for the load tests.

Fixture `ydf_format/` (at most 4 MB): the JAX package's
`export_ydf_model` of gbt_d6 (gbt_d6/), of train_multiclass/model
(multiclass/), of train_if/model (if/) and of train_uplift/rf_small
(uplift_rf/), and of train_uplift/cart_model written under the file
prefix "cart_" (prefixed/); config.json with each model's source, its
request file and the SHA-256 of every exported file (the export of the
prefixed model's source, which writes no prefix, for prefixed/);
uplift_requests.npz (the first 1,024 test rows of
chip_smoke.make_uplift_frame; the other models read gbt_d6's
requests.npz); expected.npz with the predictions and predict_leaves
(u8 or u16) of the JAX package's `load_ydf_model` of each directory on
those rows.

Run from the repo root:  python scripts/make_torch_port_fixtures.py
(~70 minutes on a CPU, train_rf and the set fixtures most of it;
`--only train_bench`, `--only train_vs`, `--only train_default`,
`--only train_rf`, `--only train_multiclass`, `--only
train_gbt_options`, `--only train_cart` (~1 min), `--only train_if`
(~1.5 min), `--only train_oblique` (~15 min), `--only forest_cuts`
(~8 min: the JAX results of the random and isolation forests
chip_smoke.py cuts short, beside train_rf's, train_if's and
train_oblique's full runs), `--only train_monotone`
(~1.5 min), `--only train_dart` (~15 s), `--only train_sets` (~12 min),
`--only train_uplift` (~4 min), `--only train_honest` (~7.5 min),
`--only train_sets_alone` (~11 min), `--only train_multitasker` (~1
min), `--only ydf_format` (~10 s), `--only train_mhld` (~25 min),
`--only mhld_order` (~10 s), `--only train_dist` or `--only serving` for one part).

Fixture `train_mhld/xla_order.npz` (`--only mhld_order`, also written
by `--only train_mhld`): what XLA's CPU computes for the row dots a^T b
(`dots_{n}_{M}`), the vector-matrix dot w^T x and the column sums
(`vdot_{n}`, `colsum_{n}`) on MHLD_DOTS' and MHLD_VDOTS' inputs, and the
JAX learner's make_mhld_W inside a lax.scan over six iterations
(`program_{i}` for the row weights mhld_program_case gives), the
references of tests/test_torch_mhld.py. XLA's CPU dots shard their rows
by its thread count, so the script runs JAX on XLA_CPU_THREADS cores
(the count that wrote every MHLD fixture) and refuses a host with fewer.
"""

import json
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


#: Cuts of the three-class label: the generator's logit plus logistic
#: noise, below -0.8 -> class 0, below 0.8 -> class 1, else class 2
#: (each class 25-40% of the rows).
CLASS_CUTS = (-0.8, 0.8)


def logit_class_label(x, seed: int):
    """The three-class variant's label (int64) of bench.make_data's
    features x [n, 28]: its logit (computed in float64) plus logistic
    noise drawn from default_rng([seed, 3]), cut at CLASS_CUTS."""
    xd = x.astype(np.float64)
    logit = (xd[:, 0] - 0.5 * xd[:, 1] + np.sin(2 * xd[:, 2])
             + xd[:, 3] * xd[:, 4])
    noise = np.random.default_rng([seed, 3]).logistic(size=len(x))
    return np.digitize(logit + noise, CLASS_CUTS).astype(np.int64)


def make_frame(seed: int = 7, train_rows: int = TRAIN_ROWS,
               request_rows: int = REQUEST_ROWS, keep_label: bool = False,
               classes: int = 2):
    """(train columns, request columns): numerical f32, categorical
    unicode, an int label on the train side (and on the request side
    with keep_label): bench.make_data's binary label, or with classes=3
    logit_class_label. The binary frame's bytes do not depend on the
    variant."""
    import bench

    data, x, y = bench.make_data(train_rows + request_rows, 28)
    if classes == 3:
        y = logit_class_label(x, seed)
        data["label"] = y
    elif classes != 2:
        raise ValueError(f"classes must be 2 or 3, got {classes}")
    rng = np.random.default_rng(seed)
    n = len(y)
    for j, vocab in enumerate(CAT_VOCABS):
        code = rng.integers(0, vocab, n)
        third = max(vocab // 3, 1)
        if classes == 2:
            # Positive rows favour the lower third of the vocabulary.
            skew = (y == 1) & (rng.uniform(size=n) < 0.4)
            code = np.where(skew, code % third, code)
        else:
            # Classes 1 and 2 favour the lower and middle thirds.
            skew = (y > 0) & (rng.uniform(size=n) < 0.4)
            code = np.where(skew, code % third + (y - 1) * third, code)
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


def update_forms(dump_dir: str, num_classes: int, shrinkage: float):
    """How XLA lowered the multiclass boosting programs' prediction
    updates, from an XLA dump (XLA_FLAGS=--xla_dump_to): every fusion of
    a boosting program (module `run` or `run_chunk`) that scales leaf
    values by the shrinkage and gathers them, with its rows and the
    fused multiply-add instructions in its machine code (objdump).
    Returns (one form a class column: "unfused" when no such fusion
    holds a fused multiply-add, the fusions)."""
    import re
    import subprocess

    shr = str(np.float32(shrinkage))  # as HLO prints an f32 constant
    fusions = []
    for hlo in sorted(os.listdir(dump_dir)):
        if not re.search(r"jit_run(_chunk)?\.cpu_after_optimizations\.txt$",
                         hlo):
            continue
        mod = hlo.split(".cpu_after")[0]
        text = open(os.path.join(dump_dir, hlo)).read()
        for comp in re.split(r"\n(?=%?[\w.\-]+ \(.*\) -> .* \{)", text):
            name = comp.split(" ", 1)[0].lstrip("%")
            root = re.search(r"ROOT %\S+ = f32\[(\d+),(\d+)\]", comp)
            if (f"constant({shr})" not in comp or "gather(" not in comp
                    or root is None or int(root.group(2)) != num_classes):
                continue
            call = re.search(r"%(\S+) = \S+ fusion\([^\n]*calls=%"
                             + re.escape(name) + r"[,\s]", text)
            obj = os.path.join(dump_dir, f"{mod}.obj-file.{call.group(1)}"
                               "_kernel_module.o")
            asm = subprocess.run(["objdump", "-d", obj], capture_output=True,
                                 text=True, check=True).stdout
            fusions.append({
                "module": mod, "fusion": call.group(1),
                "rows": int(root.group(1)),
                "fma": len(re.findall(r"\bvfn?m(add|sub)", asm)),
            })
    if not fusions:
        raise RuntimeError(f"no prediction-update fusion in {dump_dir}")
    if any(f["fma"] for f in fusions):
        raise RuntimeError(f"a fused multiply-add in an update: {fusions}")
    return ["unfused"] * num_classes, fusions


TRAIN_MULTICLASS = dict(
    rows=200_000, test_rows=50_000, data_seed=0, cat_seed=7, classes=3,
    compare_rows=1024, learner=dict(label="label"), full_iterations=10,
    small_iterations=30, max_bytes=2_000_000,
)


def write_train_multiclass():
    """train_multiclass/: the JAX default learner on the three-class
    frame (make_frame(classes=3)), with the update form read from the
    XLA dump this script asks for (XLA_FLAGS, set in main)."""
    import copy
    import json
    import time

    import jax

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.dataset.dataset import Dataset
    from ydf_tpu.models.forest import Forest
    from ydf_tpu.ops.histogram import resolve_hist_impl, resolve_hist_quant
    from ydf_tpu.ops.routing_native import resolve_route_impl

    cfg = dict(TRAIN_MULTICLASS)
    cfg["generator"] = dict(features=28, cat_vocabs=list(CAT_VOCABS),
                            missing_features=[0, 5, 11],
                            class_cuts=list(CLASS_CUTS))
    d = os.path.join(OUT, "train_multiclass")
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    train, test = make_frame(cfg["cat_seed"], cfg["rows"], cfg["test_rows"],
                             keep_label=True, classes=3)
    dump = DUMP_DIR
    for f in os.listdir(dump):
        os.remove(os.path.join(dump, f))
    t0 = time.perf_counter()
    m = ydf.GradientBoostedTreesLearner(**cfg["learner"]).train(train)
    train_s = time.perf_counter() - t0
    K = m.num_trees_per_iter
    forms, fusions = update_forms(dump, K, 0.1)
    fo = {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}
    T = fo["feature"].shape[0]
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    ev = m.evaluate(test)
    # The whole model when the directory stays under max_bytes, else the
    # first small_iterations iterations.
    m.save(os.path.join(d, "model"))
    served = m
    if sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
           os.walk(d) for f in fs) > cfg["max_bytes"] * 0.8:
        shutil.rmtree(os.path.join(d, "model"))
        served = copy.copy(m)
        served.forest = Forest.from_numpy(
            {f: a[:cfg["small_iterations"] * K] for f, a in fo.items()})
        served._dim_forests = None
        served._qs_cache = {}
        served.training_logs = {}
        served.save(os.path.join(d, "model"))
    bins = m.binner.transform(Dataset.from_data(train, dataspec=m.dataspec))
    perm = np.random.RandomState(123456).permutation(cfg["rows"])
    va_idx = perm[:min(max(int(cfg["rows"] * 0.1), 1), cfg["rows"] - 1)]
    out = dict(cfg)
    out["jax_impls"] = {
        "hist_impl": resolve_hist_impl("auto"),
        "hist_quant": resolve_hist_quant(None),
        "route_impl": "xla (the JAX learner's choice for K > 1)",
        "route_impl_env": resolve_route_impl(None),
    }
    out["update_form"] = forms
    out["update_fusions"] = fusions
    out["jax_version"] = jax.__version__
    out["jax_train_s_cpu"] = train_s
    out["classes"] = m.classes
    out["class_fractions"] = (np.bincount(train["label"], minlength=3)
                              / cfg["rows"]).tolist()
    out["num_trees_per_iter"] = K
    out["model_iterations"] = served.forest.feature.shape[0] // K
    out["train_sha256"] = chip_smoke.frame_sha256(train)
    out["test_sha256"] = chip_smoke.frame_sha256(test)
    out["bins_sha256"] = chip_smoke.array_sha256(np.asarray(bins))
    out["valid_idx_sha256"] = chip_smoke.array_sha256(
        va_idx.astype(np.int64))
    out["num_trees"] = m.training_logs["num_trees"]
    out["num_trees_trained"] = m.training_logs["num_trees_trained"]
    out["jax_evaluate"] = dict(ev.metrics)
    out["jax_confusion"] = np.asarray(ev.confusion).tolist()
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    logs = m.training_logs["iterations"]

    def digest(h):
        return np.frombuffer(bytes.fromhex(h), np.uint8)

    np.savez_compressed(
        os.path.join(d, "expected.npz"),
        initial_predictions=np.asarray(m.initial_predictions, np.float32),
        train_loss=np.array([r["train_loss"] for r in logs], np.float32),
        valid_loss=np.array([r["valid_loss"] for r in logs], np.float32),
        tree_sha256=np.stack([digest(chip_smoke.tree_sha256(fo, t))
                              for t in range(T)]),
        num_nodes=fo["num_nodes"].astype(np.int32),
        proba=np.asarray(m.predict(head), np.float32),
        model_proba=np.asarray(served.predict(head), np.float32),
    )
    size = sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)
    assert size < cfg["max_bytes"], size
    print(f"train_multiclass: {out['num_trees']} of "
          f"{out['num_trees_trained']} iterations in {train_s:.1f} s, "
          f"{size} bytes, model {out['model_iterations']} iterations, "
          f"classes {out['class_fractions']}, update {forms} "
          f"({len(fusions)} fusions), evaluate {ev.metrics}")


#: train_gbt_options/: one small configuration per option the learner
#: ports beyond the defaults, each on `frame` ("binary", "three_class" or
#: "poisson"/"laplace": regression labels from the binary frame's logit).
TRAIN_GBT_OPTIONS = dict(
    rows=20_000, test_rows=1024, cat_seed=7, num_trees=30,
    configs={
        "poisson": dict(frame="poisson", task="REGRESSION",
                        learner=dict(loss="POISSON")),
        "mae": dict(frame="laplace", task="REGRESSION",
                    learner=dict(loss="MEAN_AVERAGE_ERROR")),
        "focal": dict(frame="binary", learner=dict(
            loss="BINARY_FOCAL_LOSS")),
        "subsample": dict(frame="binary", learner=dict(subsample=0.8)),
        "goss": dict(frame="binary", learner=dict(sampling_method="GOSS")),
        "candidates": dict(frame="binary", learner=dict(
            num_candidate_attributes_ratio=0.5)),
        "three_class": dict(frame="three_class", learner=dict(
            subsample=0.8, num_candidate_attributes_ratio=0.5)),
    },
)


def options_frame(kind: str, seed: int, rows: int, test_rows: int):
    """(train, test) of a train_gbt_options configuration: make_frame
    (binary or three classes), or the binary frame with a regression
    label from the generator's logit (float64): "poisson" draws counts
    with rate exp(0.3 logit), "laplace" adds Laplace noise; both draws
    from default_rng([seed, 5])."""
    import bench

    classes = 3 if kind == "three_class" else 2
    train, test = make_frame(seed, rows, test_rows, keep_label=True,
                             classes=classes)
    if kind in ("poisson", "laplace"):
        _, x, _ = bench.make_data(rows + test_rows, 28)
        xd = x.astype(np.float64)
        logit = (xd[:, 0] - 0.5 * xd[:, 1] + np.sin(2 * xd[:, 2])
                 + xd[:, 3] * xd[:, 4])
        rng = np.random.default_rng([seed, 5])
        if kind == "poisson":
            y = rng.poisson(np.exp(0.3 * logit)).astype(np.float32)
        else:
            y = (logit + rng.laplace(size=len(logit))).astype(np.float32)
        train["label"], test["label"] = y[:rows], y[rows:]
    return train, test


def write_train_gbt_options():
    import json

    import jax

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.config import Task

    cfg = TRAIN_GBT_OPTIONS
    d = os.path.join(OUT, "train_gbt_options")
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    out = dict(cfg, jax_version=jax.__version__, results={})
    arrays = {}

    def digest(h):
        return np.frombuffer(bytes.fromhex(h), np.uint8)

    for name, c in cfg["configs"].items():
        train, test = options_frame(c["frame"], cfg["cat_seed"], cfg["rows"],
                                    cfg["test_rows"])
        m = ydf.GradientBoostedTreesLearner(
            label="label", num_trees=cfg["num_trees"],
            task=Task[c.get("task", "CLASSIFICATION")],
            **c["learner"]).train(train)
        fo = {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}
        out["results"][name] = {
            "train_sha256": chip_smoke.frame_sha256(train),
            "test_sha256": chip_smoke.frame_sha256(test),
            "num_trees": m.training_logs["num_trees"],
            "num_trees_trained": m.training_logs["num_trees_trained"],
            "num_trees_per_iter": m.num_trees_per_iter,
            "classes": m.classes,
        }
        arrays[f"{name}/tree_sha256"] = np.stack([
            digest(chip_smoke.tree_sha256(fo, t))
            for t in range(fo["feature"].shape[0])])
        arrays[f"{name}/initial_predictions"] = np.asarray(
            m.initial_predictions, np.float32)
        arrays[f"{name}/train_loss"] = np.asarray(
            m.training_logs["train_loss"], np.float32)
        arrays[f"{name}/valid_loss"] = np.asarray(
            m.training_logs["valid_loss"], np.float32)
        arrays[f"{name}/predictions"] = np.asarray(m.predict(test),
                                                   np.float32)
        print(f"train_gbt_options/{name}: {out['results'][name]}")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    np.savez_compressed(os.path.join(d, "expected.npz"), **arrays)


TRAIN_CART = dict(
    rows=500_000, test_rows=100_000, cat_seed=7, compare_rows=1024,
    learner=dict(label="label"), seed=123456, validation_ratio=0.1,
    regression=dict(frame="laplace", rows=20_000, test_rows=1024),
)


def capture_unpruned(cart_module, captured, name="prune_single_tree"):
    """Wraps cart_module's pruning function `name` so that each call
    records the grown tree's arrays (forest fields, numpy) in `captured`
    before it prunes; returns the original function."""
    original = getattr(cart_module, name)

    def prune(model, valid_data, **kwargs):
        captured.append({f: np.array(getattr(model.forest, f))
                         for f in model.forest._fields})
        return original(model, valid_data, **kwargs)

    setattr(cart_module, name, prune)
    return original


def write_train_cart():
    """train_cart/: the JAX CartLearner(label="label") with every default
    on make_frame (500,000 rows, 10% held out), its grown tree before
    pruning and the pruned model, and a small regression CART."""
    import json
    import time

    import jax

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.config import Task
    from ydf_tpu.dataset.dataset import Dataset
    from ydf_tpu.learners import cart

    cfg = dict(TRAIN_CART)
    cfg["generator"] = dict(features=28, cat_vocabs=list(CAT_VOCABS),
                            missing_features=[0, 5, 11])
    d = os.path.join(OUT, "train_cart")
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    train, test = make_frame(cfg["cat_seed"], cfg["rows"], cfg["test_rows"],
                             keep_label=True)
    captured = []
    original = capture_unpruned(cart, captured)
    try:
        t0 = time.perf_counter()
        m = ydf.CartLearner(**cfg["learner"]).train(train)
        train_s = time.perf_counter() - t0
        rc = cfg["regression"]
        rtrain, rtest = options_frame(rc["frame"], cfg["cat_seed"],
                                      rc["rows"], rc["test_rows"])
        mr = ydf.CartLearner(task=Task.REGRESSION,
                             **cfg["learner"]).train(rtrain)
    finally:
        cart.prune_single_tree = original
    grown, rgrown = captured
    m.save(os.path.join(d, "model"))
    # The learner's holdout (ydf_tpu/learners/cart.py:76-78).
    mask = np.random.RandomState(cfg["seed"]).uniform(size=cfg["rows"]) \
        < cfg["validation_ratio"]
    bins = m.binner.transform(Dataset.from_data(
        {k: v[~mask] for k, v in train.items()}, dataspec=m.dataspec))
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    fo = {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}
    fr = {f: np.asarray(getattr(mr.forest, f)) for f in mr.forest._fields}
    ev = m.evaluate(test)
    out = dict(cfg)
    out["jax_version"] = jax.__version__
    out["jax_train_s_cpu"] = train_s
    out["classes"] = m.classes
    out["train_sha256"] = chip_smoke.frame_sha256(train)
    out["test_sha256"] = chip_smoke.frame_sha256(test)
    out["holdout_sha256"] = chip_smoke.array_sha256(mask)
    out["holdout_rows"] = int(mask.sum())
    out["bins_sha256"] = chip_smoke.array_sha256(np.asarray(bins))
    out["max_nodes"] = int(fo["feature"].shape[1])
    out["num_pruned_nodes"] = m.extra_metadata["num_pruned_nodes"]
    out["grown_sha256"] = chip_smoke.tree_sha256(grown, 0)
    out["grown_num_nodes"] = int(grown["num_nodes"][0])
    out["pruned_sha256"] = chip_smoke.tree_sha256(fo, 0)
    out["oob_evaluation"] = m.oob_evaluation
    out["jax_evaluate"] = dict(ev.metrics)
    out["regression_result"] = {
        "train_sha256": chip_smoke.frame_sha256(rtrain),
        "test_sha256": chip_smoke.frame_sha256(rtest),
        "num_pruned_nodes": mr.extra_metadata["num_pruned_nodes"],
        "grown_sha256": chip_smoke.tree_sha256(rgrown, 0),
        "pruned_sha256": chip_smoke.tree_sha256(fr, 0),
        "oob_evaluation": mr.oob_evaluation,
    }
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    np.savez_compressed(
        os.path.join(d, "expected.npz"),
        proba=np.asarray(m.predict(head), np.float32),
        regression_predictions=np.asarray(mr.predict(rtest), np.float32),
        **{f"grown/{k}": v for k, v in grown.items()},
    )
    size = sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)
    print(f"train_cart: {out['grown_num_nodes']} nodes grown, "
          f"{out['num_pruned_nodes']} pruned in {train_s:.1f} s, {size} "
          f"bytes, holdout {m.oob_evaluation['metrics']}, evaluate "
          f"{ev.metrics}; regression {out['regression_result']}")


TRAIN_IF = dict(
    rows=500_000, test_rows=100_000, cat_seed=7, compare_rows=1024,
    learner={}, seed=123456, small_trees=3, max_bytes=1_000_000,
)


def write_train_if():
    """train_if/: the JAX IsolationForestLearner() with every default on
    make_frame's 32 feature columns (500,000 rows, the label dropped),
    scored on 100,000 fresh rows, 1% of them made anomalous
    (chip_smoke.if_test_frame)."""
    import json
    import time

    import jax
    import jax.numpy as jnp

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.dataset.dataset import Dataset
    from ydf_tpu.metrics.metrics import roc_auc

    cfg = dict(TRAIN_IF)
    cfg["generator"] = dict(features=28, cat_vocabs=list(CAT_VOCABS),
                            missing_features=[0, 5, 11],
                            anomaly=chip_smoke.IF_ANOMALY)
    d = os.path.join(OUT, "train_if")
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    train, test = make_frame(cfg["cat_seed"], cfg["rows"], cfg["test_rows"],
                             keep_label=True)
    feats = {k: v for k, v in train.items() if k != "label"}
    test_x, anomalous = chip_smoke.if_test_frame(test)
    t0 = time.perf_counter()
    m = ydf.IsolationForestLearner(**cfg["learner"]).train(feats)
    train_s = time.perf_counter() - t0
    fo = {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}
    T = fo["feature"].shape[0]
    n, sub = cfg["rows"], m.num_examples_per_tree

    # Each tree's rows (isolation_forest.py:253-258), as sorted sets.
    @jax.jit
    def rows(ts):
        def one(t):
            key = jax.random.fold_in(jax.random.PRNGKey(cfg["seed"]), t)
            k_samp = jax.random.split(key, 3)[0]
            return jax.lax.top_k(jax.random.uniform(k_samp, (n,)), sub)[1]
        return jax.vmap(one)(ts)

    idx = np.sort(np.concatenate([np.asarray(rows(jnp.arange(
        t, min(t + 50, T)))) for t in range(0, T, 50)]), axis=1)
    scores = np.asarray(m.predict(test_x))
    head = {k: v[:cfg["compare_rows"]] for k, v in test_x.items()}
    m.save(os.path.join(d, "model"))
    served = m
    if sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
           os.walk(d) for f in fs) > cfg["max_bytes"]:
        shutil.rmtree(os.path.join(d, "model"))
        served = ydf.IsolationForestLearner(
            num_trees=cfg["small_trees"], **cfg["learner"]).train(feats)
        served.save(os.path.join(d, "model"))
    bins = m.binner.transform(Dataset.from_data(feats, dataspec=m.dataspec))
    out = dict(cfg)
    out["jax_version"] = jax.__version__
    out["jax_train_s_cpu"] = train_s
    out["num_trees"] = T
    out["subsample"] = sub
    out["max_depth"] = m.max_depth
    out["max_nodes"] = int(fo["feature"].shape[1])
    out["model_trees"] = int(served.forest.feature.shape[0])
    out["train_sha256"] = chip_smoke.frame_sha256(feats)
    out["test_sha256"] = chip_smoke.frame_sha256(test_x)
    out["bins_sha256"] = chip_smoke.array_sha256(np.asarray(bins))
    out["scores_sha256"] = chip_smoke.array_sha256(scores)
    out["anomalies"] = int(anomalous.sum())
    out["auc"] = roc_auc(anomalous, scores)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)

    def digest(h):
        return np.frombuffer(bytes.fromhex(h), np.uint8)

    np.savez_compressed(
        os.path.join(d, "expected.npz"),
        subsample_sha256=np.stack([digest(chip_smoke.array_sha256(
            r.astype(np.int64))) for r in idx]),
        tree_sha256=np.stack([digest(chip_smoke.tree_sha256(fo, t))
                              for t in range(T)]),
        num_nodes=fo["num_nodes"].astype(np.int32),
        scores=scores[:cfg["compare_rows"]],
        model_scores=np.asarray(served.predict(head)),
        **{f"tree0/{k}": v[:1] for k, v in fo.items()},
    )
    size = sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)
    assert size < cfg["max_bytes"], size
    print(f"train_if: {T} trees in {train_s:.1f} s, {size} bytes, model "
          f"{out['model_trees']} trees, AUC {out['auc']:.6f} on "
          f"{out['anomalies']} anomalies of {cfg['test_rows']}")


def write_forest_cuts():
    """The forests chip_smoke.py grows cut short, to keep it inside its
    time limit: train_rf's random forest (phase 9, chip_smoke.RF_TREES
    trees) and the isolation forests of train_if/ and train_oblique/
    (phases 11 and 12, chip_smoke.IF_TREES trees). The JAX package's
    results of each cut forest are added beside the full run, which
    stays as it is: the random forest's out-of-bag evaluation, evaluate
    metrics and probabilities; an isolation forest's scores (SHA-256,
    the first compare_rows) and AUC. config.json gains "cut" (in
    train_oblique, under "iforest"), expected.npz "cut/..." (in
    train_oblique, "iforest_cut/scores"). A cut forest is the full run's
    first trees (tree t draws from fold_in(seed, t)): asserted tree by
    tree."""
    import json

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.metrics.metrics import roc_auc

    d = os.path.join(OUT, "train_rf")
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    T = chip_smoke.RF_TREES
    train, test = make_frame(cfg["cat_seed"], cfg["rows"], cfg["test_rows"],
                             keep_label=True)
    assert chip_smoke.frame_sha256(train) == cfg["train_sha256"]
    m = ydf.RandomForestLearner(num_trees=T, **cfg["learner"]).train(train)
    fo = {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}
    exp = dict(np.load(os.path.join(d, "expected.npz")))
    assert all(chip_smoke.tree_sha256(fo, t) == exp["tree_sha256"][t]
               .tobytes().hex() for t in range(T)), "RF: not the prefix"
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    cfg["cut"] = dict(num_trees=T, oob_evaluation=m.oob_evaluation,
                      jax_evaluate=dict(m.evaluate(test).metrics))
    exp["cut/proba"] = np.asarray(m.predict(head), np.float32)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1, sort_keys=True)
    np.savez_compressed(os.path.join(d, "expected.npz"), **exp)
    print(f"train_rf: the first {T} trees, oob "
          f"{m.oob_evaluation['metrics']}", flush=True)

    T = chip_smoke.IF_TREES
    for name, part, prefix, key in (
            ("train_if", None, "", "cut/scores"),
            ("train_oblique", "iforest", "iforest/", "iforest_cut/scores")):
        d = os.path.join(OUT, name)
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
        c = cfg if part is None else cfg[part]
        train, test = make_frame(cfg["cat_seed"], c["rows"], c["test_rows"],
                                 keep_label=True)
        feats = {k: v for k, v in train.items() if k != "label"}
        test_x, anomalous = chip_smoke.if_test_frame(test)
        assert chip_smoke.frame_sha256(feats) == c["train_sha256"], name
        m = ydf.IsolationForestLearner(num_trees=T, **c["learner"]).train(
            feats)
        fo = {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}
        exp = dict(np.load(os.path.join(d, "expected.npz")))
        want = exp[f"{prefix}tree_sha256"]
        assert all(chip_smoke.tree_sha256(fo, t) == want[t].tobytes().hex()
                   for t in range(T)), f"{name}: not the full run's prefix"
        scores = np.asarray(m.predict(test_x))
        c["cut"] = dict(num_trees=T,
                        scores_sha256=chip_smoke.array_sha256(scores),
                        auc=roc_auc(anomalous, scores))
        exp[key] = scores[:cfg["compare_rows"]]
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1, sort_keys=True)
        np.savez_compressed(os.path.join(d, "expected.npz"), **exp)
        print(f"{name}: the first {T} trees' scores, AUC "
              f"{c['cut']['auc']:.6f}", flush=True)


TRAIN_OBLIQUE = dict(
    jax_version="0.9.0", cat_seed=7, compare_rows=1024, seed=123456,
    gbt=dict(rows=500_000, test_rows=100_000,
             learner=dict(label="label", split_axis="SPARSE_OBLIQUE")),
    rf=dict(rows=50_000, test_rows=10_000, fixture_trees=50,
            learner=dict(label="label", split_axis="SPARSE_OBLIQUE")),
    cart=dict(rows=500_000, test_rows=100_000, validation_ratio=0.1,
              learner=dict(label="label", split_axis="SPARSE_OBLIQUE")),
    iforest=dict(rows=500_000, test_rows=100_000,
                 learner=dict(split_axis="SPARSE_OBLIQUE")),
)


def write_train_oblique():
    """train_oblique/: the JAX GBT, random forest, CART and isolation
    forest with sparse-oblique splits (module docstring)."""
    import json
    import time

    import jax

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.dataset.dataset import Dataset
    from ydf_tpu.learners import cart as jax_cart
    from ydf_tpu.learners import gbt as jax_gbt
    from ydf_tpu.learners import isolation_forest as jax_if
    from ydf_tpu.learners import random_forest as jax_rf
    from ydf_tpu.metrics.metrics import roc_auc
    from ydf_tpu.ops.histogram import resolve_hist_impl, resolve_hist_quant
    from ydf_tpu.ops.routing_native import resolve_route_impl

    cfg = json.loads(json.dumps(TRAIN_OBLIQUE))
    if jax.__version__ != cfg["jax_version"]:
        raise SystemExit(
            f"train_oblique needs jax {cfg['jax_version']} (the XLA dot and "
            f"reduce orders ops/oblique.py replays), not {jax.__version__}")
    gen = dict(features=28, cat_vocabs=list(CAT_VOCABS),
               missing_features=[0, 5, 11])
    d = os.path.join(OUT, "train_oblique")
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    out = dict(cfg)
    out["generator"] = gen
    out["jax_impls"] = {
        "hist_impl": resolve_hist_impl("auto"),
        "hist_quant": resolve_hist_quant(None),
        "route_impl": resolve_route_impl(None),
    }
    arrays = {}

    def digest(h):
        return np.frombuffer(bytes.fromhex(h), np.uint8)

    def forest_np(m):
        return {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}

    def tree_digests(prefix, fo, W, bounds):
        """Per tree: node arrays, thresholds, projections and boundaries;
        the projections in full, tree 0's boundaries in full."""
        T = fo["feature"].shape[0]
        arrays[f"{prefix}/tree_sha256"] = np.stack(
            [digest(chip_smoke.tree_sha256(fo, t)) for t in range(T)])
        arrays[f"{prefix}/threshold_sha256"] = np.stack(
            [digest(chip_smoke.array_sha256(fo["threshold"][t]))
             for t in range(T)])
        arrays[f"{prefix}/bounds_sha256"] = np.stack(
            [digest(chip_smoke.array_sha256(b)) for b in bounds])
        arrays[f"{prefix}/oblique_weights"] = np.asarray(W, np.float32)
        arrays[f"{prefix}/bounds0"] = np.asarray(bounds[0], np.float32)
        arrays[f"{prefix}/num_nodes"] = fo["num_nodes"].astype(np.int32)

    def sized(frame_rows, test_rows):
        train, test = make_frame(cfg["cat_seed"], frame_rows, test_rows,
                                 keep_label=True)
        return train, test

    # -- GBT: train_default's frame, every default but the split axis -- #
    c = out["gbt"]
    train, test = sized(c["rows"], c["test_rows"])
    logs, restore = chip_smoke.capture_returns(jax_gbt, "_train_gbt")
    try:
        t0 = time.perf_counter()
        m = ydf.GradientBoostedTreesLearner(**c["learner"]).train(train)
        c["jax_train_s_cpu"] = time.perf_counter() - t0
    finally:
        restore()
    m.force_engine("Routed")
    m.save(os.path.join(d, "gbt_model"))
    fo = forest_np(m)
    K, T = m.num_trees_per_iter, fo["feature"].shape[0]
    run_logs = logs[0][2]
    W = np.asarray(run_logs["oblique_w"])[:T // K]
    bounds = np.asarray(run_logs["oblique_b"])[:T // K]
    tree_digests("gbt", fo, W, bounds)
    bins = m.binner.transform(Dataset.from_data(train, dataspec=m.dataspec))
    preds = np.asarray(m.predict(test))
    ev = m.evaluate(test)
    c.update(
        train_sha256=chip_smoke.frame_sha256(train),
        test_sha256=chip_smoke.frame_sha256(test),
        bins_sha256=chip_smoke.array_sha256(np.asarray(bins)),
        num_projections=int(W.shape[1]), classes=m.classes,
        num_trees=m.training_logs["num_trees"],
        num_trees_trained=m.training_logs["num_trees_trained"],
        predictions_sha256=chip_smoke.array_sha256(preds),
        jax_evaluate=dict(ev.metrics),
    )
    il = m.training_logs["iterations"]
    arrays["gbt/train_loss"] = np.array([r["train_loss"] for r in il],
                                        np.float32)
    arrays["gbt/valid_loss"] = np.array([r["valid_loss"] for r in il],
                                        np.float32)
    arrays["gbt/predictions"] = preds[:cfg["compare_rows"]]
    # The serving fixture's requests: the first test rows, as they are.
    arrays.update({f"gbt_head/{k}": v[:cfg["compare_rows"]]
                   for k, v in test.items()})
    print(f"train_oblique gbt: {c['num_trees']} of {c['num_trees_trained']}"
          f" trees in {c['jax_train_s_cpu']:.1f} s, P {c['num_projections']}"
          f", {ev.metrics}", flush=True)

    # -- CART: the same frame, 10% held out for pruning ----------------- #
    c = out["cart"]
    grown = []
    orig_prune = capture_unpruned(jax_cart, grown)
    rf_runs, restore = chip_smoke.capture_returns(jax_rf, "_train_rf")
    try:
        t0 = time.perf_counter()
        m = ydf.CartLearner(**c["learner"]).train(train)
        c["jax_train_s_cpu"] = time.perf_counter() - t0
    finally:
        jax_cart.prune_single_tree = orig_prune
        restore()
    fo = forest_np(m)
    (_, W, bounds), _, _, _ = rf_runs[0]
    tree_digests("cart", fo, W, bounds)
    mask = np.random.RandomState(cfg["seed"]).uniform(size=c["rows"]) \
        < c["validation_ratio"]
    ev = m.evaluate(test)
    c.update(
        holdout_sha256=chip_smoke.array_sha256(mask),
        num_projections=int(np.asarray(W).shape[1]),
        grown_sha256=chip_smoke.tree_sha256(grown[0], 0),
        grown_threshold_sha256=chip_smoke.array_sha256(
            grown[0]["threshold"][0]),
        grown_num_nodes=int(grown[0]["num_nodes"][0]),
        pruned_sha256=chip_smoke.tree_sha256(fo, 0),
        pruned_threshold_sha256=chip_smoke.array_sha256(fo["threshold"][0]),
        num_pruned_nodes=m.extra_metadata["num_pruned_nodes"],
        oob_evaluation=m.oob_evaluation, jax_evaluate=dict(ev.metrics),
    )
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    arrays["cart/proba"] = np.asarray(m.predict(head), np.float32)
    print(f"train_oblique cart: {c['grown_num_nodes']} nodes grown, "
          f"{c['num_pruned_nodes']} pruned in {c['jax_train_s_cpu']:.1f} s, "
          f"{ev.metrics}", flush=True)

    # -- isolation forest: the same rows' 32 feature columns ------------ #
    c = out["iforest"]
    feats = {k: v for k, v in train.items() if k != "label"}
    test_x, anomalous = chip_smoke.if_test_frame(test)
    if_runs, restore = chip_smoke.capture_returns(jax_if, "_train_if")
    try:
        t0 = time.perf_counter()
        m = ydf.IsolationForestLearner(**c["learner"]).train(feats)
        c["jax_train_s_cpu"] = time.perf_counter() - t0
    finally:
        restore()
    fo = forest_np(m)
    _, _, (W, bounds) = if_runs[0]
    tree_digests("iforest", fo, W, bounds)
    scores = np.asarray(m.predict(test_x))
    c.update(
        train_sha256=chip_smoke.frame_sha256(feats),
        test_sha256=chip_smoke.frame_sha256(test_x),
        num_trees=int(fo["feature"].shape[0]), max_depth=m.max_depth,
        num_projections=int(np.asarray(W).shape[1]),
        scores_sha256=chip_smoke.array_sha256(scores),
        anomalies=int(anomalous.sum()), auc=roc_auc(anomalous, scores),
    )
    arrays["iforest/scores"] = scores[:cfg["compare_rows"]]
    print(f"train_oblique if: {c['num_trees']} trees in "
          f"{c['jax_train_s_cpu']:.1f} s, AUC {c['auc']:.6f}", flush=True)

    # -- random forest: train_rf's frame, fixture_trees trees ----------- #
    c = out["rf"]
    train, test = sized(c["rows"], c["test_rows"])
    rf_runs, restore = chip_smoke.capture_returns(jax_rf, "_train_rf")
    try:
        t0 = time.perf_counter()
        m = ydf.RandomForestLearner(num_trees=c["fixture_trees"],
                                    **c["learner"]).train(train)
        c["jax_train_s_cpu"] = time.perf_counter() - t0
    finally:
        restore()
    fo = forest_np(m)
    (_, W, bounds), _, _, _ = rf_runs[0]
    tree_digests("rf", fo, W, bounds)
    bins = m.binner.transform(Dataset.from_data(train, dataspec=m.dataspec))
    ev = m.evaluate(test)
    c.update(
        train_sha256=chip_smoke.frame_sha256(train),
        test_sha256=chip_smoke.frame_sha256(test),
        bins_sha256=chip_smoke.array_sha256(np.asarray(bins)),
        num_projections=int(np.asarray(W).shape[1]),
        oob_evaluation=m.oob_evaluation, jax_evaluate=dict(ev.metrics),
    )
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    arrays["rf/proba"] = np.asarray(m.predict(head), np.float32)
    print(f"train_oblique rf: {c['fixture_trees']} trees in "
          f"{c['jax_train_s_cpu']:.1f} s, {ev.metrics}", flush=True)

    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    np.savez_compressed(os.path.join(d, "expected.npz"), **arrays)
    size = sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)
    print(f"train_oblique: {size} bytes")


def _gbt_run(m, test, compare_rows, fields, nan_canonical=False):
    """(config entries, arrays) of a trained JAX GBT on its test frame:
    per-tree hashes of `fields` (with nan_canonical, every NaN hashed as
    chip_smoke.canonical_nan writes it), the kept and trained counts,
    the losses, the predictions (all hashed, the first compare_rows in
    full) and the evaluation."""
    import chip_smoke

    fo = {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}
    if nan_canonical:
        fo = chip_smoke.canonical_nan(fo)
    T = fo["feature"].shape[0]
    preds = np.asarray(m.predict(test))
    ev = m.evaluate(test)
    il = m.training_logs["iterations"]
    cfg = dict(
        num_trees=m.training_logs["num_trees"],
        num_trees_trained=m.training_logs["num_trees_trained"],
        predictions_sha256=chip_smoke.array_sha256(preds),
        jax_evaluate=dict(ev.metrics), classes=m.classes,
        train_sha256=None, test_sha256=chip_smoke.frame_sha256(test),
    )
    arrays = dict(
        tree_sha256=np.stack([np.frombuffer(bytes.fromhex(
            chip_smoke.tree_sha256(fo, t, fields=fields)), np.uint8)
            for t in range(T)]),
        num_nodes=fo["num_nodes"].astype(np.int32),
        train_loss=np.array([r["train_loss"] for r in il], np.float32),
        valid_loss=np.array([r["valid_loss"] for r in il], np.float32),
        predictions=preds[:compare_rows],
        initial_predictions=np.asarray(m.initial_predictions, np.float32),
    )
    return cfg, arrays


def _write_runs(name, out, runs):
    """Writes <name>/config.json and expected.npz (each run's arrays
    under "<run>/<array>")."""
    import json

    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    arrays = {f"{run}/{k}": v for run, a in runs.items() for k, v in a.items()}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    np.savez_compressed(os.path.join(d, "expected.npz"), **arrays)
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    print(f"{name}: {size} bytes", flush=True)


def _jax_header(cfg):
    """The JAX version check and the implementations the runs used."""
    import jax

    from ydf_tpu.ops.histogram import resolve_hist_impl, resolve_hist_quant
    from ydf_tpu.ops.routing_native import resolve_route_impl

    if jax.__version__ != cfg["jax_version"]:
        raise SystemExit(
            f"this fixture needs jax {cfg['jax_version']} (the XLA orders "
            f"the port replays), not {jax.__version__}")
    return {"hist_impl": resolve_hist_impl("auto"),
            "hist_quant": resolve_hist_quant(None),
            "route_impl": resolve_route_impl(None)}


TRAIN_MONOTONE = dict(
    jax_version="0.9.0", cat_seed=7, compare_rows=1024,
    constraints={"f0": 1, "f1": -1, "f2": 1},
    gbt=dict(rows=500_000, test_rows=100_000, learner=dict(label="label")),
    three_class=dict(frame="three_class", rows=20_000, test_rows=1024,
                     learner=dict(label="label", num_trees=30)),
    oblique=dict(frame="binary", rows=20_000, test_rows=1024,
                 learner=dict(label="label", num_trees=30,
                              split_axis="SPARSE_OBLIQUE")),
)


def write_train_monotone():
    """train_monotone/: the JAX GBT with monotonic_constraints on
    train_default's frame with every other default, a three-class run
    and a SPARSE_OBLIQUE run at 20,000 rows and 30 iterations."""
    import json
    import time

    import chip_smoke
    import ydf_tpu as ydf

    cfg = json.loads(json.dumps(TRAIN_MONOTONE))
    cfg["jax_impls"] = _jax_header(cfg)
    runs = {}
    for run in ("gbt", "three_class", "oblique"):
        c = cfg[run]
        if run == "gbt":
            train, test = make_frame(cfg["cat_seed"], c["rows"],
                                     c["test_rows"], keep_label=True)
        else:
            train, test = options_frame(c["frame"], cfg["cat_seed"],
                                        c["rows"], c["test_rows"])
        t0 = time.perf_counter()
        m = ydf.GradientBoostedTreesLearner(
            monotonic_constraints=cfg["constraints"],
            **c["learner"]).train(train)
        c["jax_train_s_cpu"] = time.perf_counter() - t0
        if run == "oblique":
            m.force_engine("Routed")
        got, runs[run] = _gbt_run(m, test, cfg["compare_rows"],
                                  chip_smoke.TREE_HASH_FIELDS)
        got["train_sha256"] = chip_smoke.frame_sha256(train)
        c.update(got)
        print(f"train_monotone {run}: {c['num_trees']} of "
              f"{c['num_trees_trained']} in {c['jax_train_s_cpu']:.1f} s",
              flush=True)
    _write_runs("train_monotone", cfg, runs)


TRAIN_DART = dict(
    jax_version="0.9.0", cat_seed=7, compare_rows=1024,
    gbt=dict(rows=100_000, test_rows=20_000,
             learner=dict(label="label", dart_dropout=0.1)),
)


def write_train_dart():
    """train_dart/: the JAX GBT with dart_dropout=0.1 and every other
    default (300 trees, the validation split, the look-ahead stop) on
    100,000 rows of train_default's frame."""
    import json
    import time

    import chip_smoke
    import ydf_tpu as ydf

    cfg = json.loads(json.dumps(TRAIN_DART))
    cfg["jax_impls"] = _jax_header(cfg)
    c = cfg["gbt"]
    train, test = make_frame(cfg["cat_seed"], c["rows"], c["test_rows"],
                             keep_label=True)
    t0 = time.perf_counter()
    m = ydf.GradientBoostedTreesLearner(**c["learner"]).train(train)
    c["jax_train_s_cpu"] = time.perf_counter() - t0
    got, arrays = _gbt_run(m, test, cfg["compare_rows"],
                           chip_smoke.TREE_HASH_FIELDS)
    got["train_sha256"] = chip_smoke.frame_sha256(train)
    c.update(got)
    print(f"train_dart: {c['num_trees']} of {c['num_trees_trained']} in "
          f"{c['jax_train_s_cpu']:.1f} s", flush=True)
    _write_runs("train_dart", cfg, {"gbt": arrays})


TRAIN_SETS = dict(
    jax_version="0.9.0", cat_seed=7, compare_rows=1024,
    gbt=dict(rows=200_000, test_rows=20_000, learner=dict(label="label")),
    rf=dict(rows=20_000, test_rows=5_000, fixture_trees=50,
            learner=dict(label="label")),
    cart=dict(rows=100_000, test_rows=20_000, validation_ratio=0.1,
              seed=123456, learner=dict(label="label")),
)


def write_train_sets():
    """train_sets/: the JAX GBT, random forest (its first fixture_trees
    trees) and CART with every default on chip_smoke.make_set_frame
    (make_frame plus two CATEGORICAL_SET columns)."""
    import json
    import time

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.learners import cart as jax_cart

    cfg = json.loads(json.dumps(TRAIN_SETS))
    cfg["jax_impls"] = _jax_header(cfg)
    cfg["generator"] = dict(vocabs=list(chip_smoke.SETS_VOCABS),
                            item_a=chip_smoke.SETS_ITEM_A,
                            item_b=chip_smoke.SETS_ITEM_B)
    fields = chip_smoke.SET_TREE_HASH_FIELDS
    runs = {}
    c = cfg["gbt"]
    train, test = chip_smoke.make_set_frame(c["rows"], c["test_rows"],
                                            cfg["cat_seed"])
    t0 = time.perf_counter()
    m = ydf.GradientBoostedTreesLearner(**c["learner"]).train(train)
    c["jax_train_s_cpu"] = time.perf_counter() - t0
    got, runs["gbt"] = _gbt_run(m, test, cfg["compare_rows"], fields)
    got["train_sha256"] = chip_smoke.frame_sha256(train)
    got["set_vocab_sizes"] = [
        len(m.dataspec.column_by_name(k).vocabulary)
        for k in ("tags", "words")]
    c.update(got)
    print(f"train_sets gbt: {c['num_trees']} of {c['num_trees_trained']} "
          f"in {c['jax_train_s_cpu']:.1f} s, {c['jax_evaluate']}", flush=True)

    def forest_np(m):
        return {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}

    c = cfg["rf"]
    train, test = chip_smoke.make_set_frame(c["rows"], c["test_rows"],
                                            cfg["cat_seed"])
    t0 = time.perf_counter()
    m = ydf.RandomForestLearner(num_trees=c["fixture_trees"],
                                **c["learner"]).train(train)
    c["jax_train_s_cpu"] = time.perf_counter() - t0
    fo = forest_np(m)
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    c.update(train_sha256=chip_smoke.frame_sha256(train),
             test_sha256=chip_smoke.frame_sha256(test),
             oob_evaluation=m.oob_evaluation,
             jax_evaluate=dict(m.evaluate(test).metrics))
    runs["rf"] = dict(
        tree_sha256=np.stack([np.frombuffer(bytes.fromhex(
            chip_smoke.tree_sha256(fo, t, fields=fields)), np.uint8)
            for t in range(fo["feature"].shape[0])]),
        num_nodes=fo["num_nodes"].astype(np.int32),
        proba=np.asarray(m.predict(head), np.float32))
    print(f"train_sets rf: {c['fixture_trees']} trees in "
          f"{c['jax_train_s_cpu']:.1f} s", flush=True)

    c = cfg["cart"]
    train, test = chip_smoke.make_set_frame(c["rows"], c["test_rows"],
                                            cfg["cat_seed"])
    grown = []
    orig_prune = capture_unpruned(jax_cart, grown)
    try:
        t0 = time.perf_counter()
        m = ydf.CartLearner(**c["learner"]).train(train)
        c["jax_train_s_cpu"] = time.perf_counter() - t0
    finally:
        jax_cart.prune_single_tree = orig_prune
    fo = forest_np(m)
    mask = np.random.RandomState(c["seed"]).uniform(size=c["rows"]) \
        < c["validation_ratio"]
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    c.update(
        train_sha256=chip_smoke.frame_sha256(train),
        test_sha256=chip_smoke.frame_sha256(test),
        holdout_sha256=chip_smoke.array_sha256(mask),
        grown_sha256=chip_smoke.tree_sha256(grown[0], 0, fields=fields),
        grown_num_nodes=int(grown[0]["num_nodes"][0]),
        pruned_sha256=chip_smoke.tree_sha256(fo, 0, fields=fields),
        num_pruned_nodes=m.extra_metadata["num_pruned_nodes"],
        oob_evaluation=m.oob_evaluation,
        jax_evaluate=dict(m.evaluate(test).metrics))
    runs["cart"] = dict(proba=np.asarray(m.predict(head), np.float32))
    print(f"train_sets cart: {c['grown_num_nodes']} nodes grown, "
          f"{c['num_pruned_nodes']} pruned in {c['jax_train_s_cpu']:.1f} s",
          flush=True)
    _write_runs("train_sets", cfg, runs)


TRAIN_RANKING = dict(
    jax_version="0.9.0", compare_rows=1024, queries=2_000,
    test_queries=500, docs=[20, 200], features=136, seed=21, test_seed=22,
    learner=dict(label="relevance", ranking_group="query"),
)
TRAIN_SURVIVAL = dict(
    jax_version="0.9.0", compare_rows=1024, rows=200_000, test_rows=50_000,
    cat_seed=7, learner=dict(label="time", label_event_observed="event"),
)
#: train_rank_options/: 20,000-row, 30-iteration ranking and survival
#: configurations ("rank": make_rank_frame with `queries` of `docs`
#: documents and 24 features; "surv": make_surv_frame).
TRAIN_RANK_OPTIONS = dict(
    jax_version="0.9.0", compare_rows=1024, num_trees=30,
    configs={
        "xe_ndcg": dict(frame="rank", queries=180, docs=[20, 200],
                        learner=dict(loss="XE_NDCG_MART")),
        "selgb": dict(frame="rank", queries=180, docs=[20, 200],
                      learner=dict(sampling_method="SELGB")),
        "max_group_64": dict(frame="rank", queries=285, docs=[20, 120],
                             learner=dict(ranking_max_group_size=64)),
        "cox_entry": dict(frame="surv", rows=20_000, entry=True,
                          learner=dict(label_entry_age="entry")),
        "cox_weights": dict(frame="surv", rows=20_000, weights=True,
                            learner=dict(weights="w")),
    },
)


def _task_run(name, cfg, c, train, test, task):
    """Trains the JAX GBT of one ranking or survival configuration and
    returns (config entries, arrays): _gbt_run's plus the frames' and
    the bins' SHA-256, the training seconds and the raw scores."""
    import hashlib
    import time

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.config import Task
    from ydf_tpu.dataset.dataset import Dataset

    t0 = time.perf_counter()
    m = ydf.GradientBoostedTreesLearner(
        task=Task[task], **c["learner"]).train(train)
    c["jax_train_s_cpu"] = time.perf_counter() - t0
    got, arrays = _gbt_run(m, test, cfg["compare_rows"],
                           chip_smoke.TREE_HASH_FIELDS, nan_canonical=True)
    got["train_sha256"] = chip_smoke.frame_sha256(train)
    bins = m.binner.transform(Dataset.from_data(train, dataspec=m.dataspec))
    got["bins_sha256"] = hashlib.sha256(
        np.ascontiguousarray(bins).tobytes()).hexdigest()
    got["extra_metadata"] = m.extra_metadata
    c.update(got)
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    arrays["raw"] = m._raw_scores(head, combine="sum")[:, 0]
    print(f"{name}: {c['num_trees']} of {c['num_trees_trained']} trees in "
          f"{c['jax_train_s_cpu']:.1f} s, {got['jax_evaluate']}", flush=True)
    return m, arrays


def write_train_ranking():
    """train_ranking/: the JAX GBT with task=RANKING, ranking_group=
    "query" and every other default on chip_smoke.make_rank_frame (2,000
    queries of 20-200 documents, 136 features: ~218,000 rows), evaluated
    on 500 fresh queries; config.json adds the validation rows' SHA-256
    (whole query groups) and model/ holds the JAX model."""
    import hashlib
    import json

    import chip_smoke

    cfg = json.loads(json.dumps(TRAIN_RANKING))
    cfg["jax_impls"] = _jax_header(cfg)
    train, test = chip_smoke.rank_frames(
        cfg["queries"], tuple(cfg["docs"]), cfg["features"],
        cfg["test_queries"], cfg["seed"], cfg["test_seed"])
    m, arrays = _task_run("train_ranking", cfg, cfg, train, test, "RANKING")
    groups = train["query"]
    uniq = np.unique(groups)
    nvg = min(max(int(len(uniq) * 0.1), 1), len(uniq) - 1)
    gperm = np.random.RandomState(123456).permutation(len(uniq))
    va_idx = np.flatnonzero(np.isin(groups, uniq[gperm[:nvg]]))
    cfg["valid_idx_sha256"] = hashlib.sha256(
        np.ascontiguousarray(va_idx, np.int64).tobytes()).hexdigest()
    _write_runs("train_ranking", cfg, {"gbt": arrays})
    m.save(os.path.join(OUT, "train_ranking", "model"))


def write_train_survival():
    """train_survival/: the JAX GBT with task=SURVIVAL_ANALYSIS,
    label_event_observed="event" and every other default on
    chip_smoke.make_surv_frame (200,000 rows of make_frame's 32 columns,
    ~31% censored), evaluated on 50,000 fresh rows; model/ holds the JAX
    model."""
    import hashlib
    import json

    import chip_smoke

    cfg = json.loads(json.dumps(TRAIN_SURVIVAL))
    cfg["jax_impls"] = _jax_header(cfg)
    train, test = chip_smoke.make_surv_frame(cfg["rows"], cfg["test_rows"],
                                             cfg["cat_seed"])
    m, arrays = _task_run("train_survival", cfg, cfg, train, test,
                          "SURVIVAL_ANALYSIS")
    perm = np.random.RandomState(123456).permutation(cfg["rows"])
    va_idx = perm[:min(max(int(cfg["rows"] * 0.1), 1), cfg["rows"] - 1)]
    cfg["valid_idx_sha256"] = hashlib.sha256(
        np.ascontiguousarray(va_idx, np.int64).tobytes()).hexdigest()
    _write_runs("train_survival", cfg, {"gbt": arrays})
    m.save(os.path.join(OUT, "train_survival", "model"))


def write_train_rank_options():
    """train_rank_options/: TRAIN_RANK_OPTIONS's configurations, each
    with its tree hashes, kept count, losses, raw scores and
    evaluation."""
    import json
    import warnings

    import chip_smoke

    cfg = json.loads(json.dumps(TRAIN_RANK_OPTIONS))
    cfg["jax_impls"] = _jax_header(cfg)
    runs = {}
    for name, c in cfg["configs"].items():
        if c["frame"] == "rank":
            train, test = chip_smoke.rank_frames(c["queries"],
                                                 tuple(c["docs"]), 24)
            c["learner"].update(label="relevance", ranking_group="query",
                                num_trees=cfg["num_trees"])
            task = "RANKING"
        else:
            train, test = chip_smoke.make_surv_frame(
                c["rows"], cfg["compare_rows"], entry=c.get("entry", False),
                weights=c.get("weights", False))
            c["learner"].update(label="time", label_event_observed="event",
                                num_trees=cfg["num_trees"])
            task = "SURVIVAL_ANALYSIS"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, runs[name] = _task_run(f"train_rank_options/{name}", cfg, c,
                                      train, test, task)
        c["warnings"] = [str(w.message) for w in caught
                         if "max_group_size" in str(w.message)]
    _write_runs("train_rank_options", cfg, runs)


TRAIN_UPLIFT = dict(
    jax_version="0.9.0", compare_rows=1024, small_trees=3,
    rf=dict(rows=50_000, test_rows=10_000, fixture_trees=50,
            learner=dict(label="y", uplift_treatment="treat")),
    cart=dict(rows=100_000, test_rows=10_000, validation_ratio=0.1,
              seed=123456,
              learner=dict(label="y", uplift_treatment="treat")),
    numerical=dict(rows=20_000, test_rows=5_000, num_trees=30,
                   learner=dict(label="y", uplift_treatment="treat")),
)


def _digests(hexes):
    """Hex SHA-256 strings -> u8 [k, 32]."""
    return np.stack([np.frombuffer(bytes.fromhex(h), np.uint8)
                     for h in hexes])


def _forest_run(m, test, compare_rows, fields, T=None):
    """(config entries, arrays) of a trained JAX random forest or CART
    on its test frame: the frame's and the bins' SHA-256 are added by the
    caller; here the per-tree hashes of `fields` and node counts of the
    first T trees, the predictions (all hashed, the first compare_rows
    in full), the evaluation and the self-evaluation."""
    import chip_smoke

    fo = {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}
    T = fo["feature"].shape[0] if T is None else T
    preds = np.asarray(m.predict(test))
    cfg = dict(
        num_trees=int(fo["feature"].shape[0]),
        predictions_sha256=chip_smoke.array_sha256(preds),
        jax_evaluate=dict(m.evaluate(test).metrics),
        oob_evaluation=m.oob_evaluation, classes=m.classes,
        extra_metadata=m.extra_metadata,
        test_sha256=chip_smoke.frame_sha256(test),
    )
    arrays = dict(
        tree_sha256=_digests(chip_smoke.tree_sha256(fo, t, fields=fields)
                             for t in range(T)),
        num_nodes=fo["num_nodes"][:T].astype(np.int32),
        predictions=preds[:compare_rows],
    )
    return cfg, arrays


def _bins_sha256(m, train):
    import chip_smoke
    from ydf_tpu.dataset.dataset import Dataset

    return chip_smoke.array_sha256(np.asarray(m.binner.transform(
        Dataset.from_data(train, dataspec=m.dataspec))))


def _cart_run(cfg, c, train, test, learner_kwargs, fields, task=None):
    """The JAX CartLearner on (train, test) with its grown tree captured
    before either pruning: (model, config entries, arrays)."""
    import time

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.learners import cart as jax_cart

    grown = []
    originals = (capture_unpruned(jax_cart, grown),
                 capture_unpruned(jax_cart, grown,
                                  "prune_single_tree_uplift"))
    try:
        t0 = time.perf_counter()
        kw = dict(learner_kwargs) if task is None else dict(
            learner_kwargs, task=task)
        m = ydf.CartLearner(**kw).train(train)
        c["jax_train_s_cpu"] = time.perf_counter() - t0
    finally:
        (jax_cart.prune_single_tree,
         jax_cart.prune_single_tree_uplift) = originals
    got, arrays = _forest_run(m, test, cfg["compare_rows"], fields)
    fo = {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields}
    mask = np.random.RandomState(c["seed"]).uniform(size=c["rows"]) \
        < c["validation_ratio"]
    got.update(
        train_sha256=chip_smoke.frame_sha256(train),
        holdout_sha256=chip_smoke.array_sha256(mask),
        grown_sha256=chip_smoke.tree_sha256(grown[0], 0, fields=fields),
        grown_num_nodes=int(grown[0]["num_nodes"][0]),
        pruned_sha256=chip_smoke.tree_sha256(fo, 0, fields=fields),
        num_pruned_nodes=m.extra_metadata["num_pruned_nodes"])
    c.update(got)
    return m, arrays


def write_train_uplift():
    """train_uplift/: on chip_smoke.make_uplift_frame (sim_pte's shape),
    the JAX RandomForestLearner(task=CATEGORICAL_UPLIFT,
    uplift_treatment="treat") with every other default (its first
    fixture_trees trees; trees are independent, so they are the first
    trees of the 300-tree forest), the CATEGORICAL_UPLIFT CartLearner
    (AUUC pruning on a 10% holdout) and a 30-tree NUMERICAL_UPLIFT forest
    with a float outcome; rf_small/ and cart_model/ hold the JAX models
    (the forest's first small_trees trees). ~4 min on 8 CPU threads (the
    50-tree forest 118 s, CART 22 s, the numerical forest 63 s)."""
    import time

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.config import Task

    cfg = json.loads(json.dumps(TRAIN_UPLIFT))
    cfg["jax_impls"] = _jax_header(cfg)
    cfg["generator"] = dict(features=chip_smoke.UPLIFT_FEATURES,
                            seed=chip_smoke.UPLIFT_SEED)
    d = os.path.join(OUT, "train_uplift")
    if os.path.isdir(d):
        shutil.rmtree(d)
    fields = chip_smoke.TREE_HASH_FIELDS
    runs = {}
    c = cfg["rf"]
    train, test = chip_smoke.make_uplift_frame(c["rows"], c["test_rows"])
    hp = dict(c["learner"], task=Task.CATEGORICAL_UPLIFT)
    t0 = time.perf_counter()
    m = ydf.RandomForestLearner(num_trees=c["fixture_trees"],
                                **hp).train(train)
    c["jax_train_s_cpu"] = time.perf_counter() - t0
    got, runs["rf"] = _forest_run(m, test, cfg["compare_rows"], fields)
    got.update(train_sha256=chip_smoke.frame_sha256(train),
               bins_sha256=_bins_sha256(m, train))
    c.update(got)
    small = ydf.RandomForestLearner(num_trees=cfg["small_trees"],
                                    **hp).train(train)
    small.save(os.path.join(d, "rf_small"))
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    runs["rf"]["small_predictions"] = np.asarray(small.predict(head))
    c["small_evaluate"] = dict(small.evaluate(test).metrics)
    print(f"train_uplift rf: {c['fixture_trees']} trees in "
          f"{c['jax_train_s_cpu']:.1f} s, {c['jax_evaluate']}", flush=True)

    c = cfg["cart"]
    train, test = chip_smoke.make_uplift_frame(c["rows"], c["test_rows"])
    m, runs["cart"] = _cart_run(cfg, c, train, test, c["learner"], fields,
                                Task.CATEGORICAL_UPLIFT)
    m.save(os.path.join(d, "cart_model"))
    print(f"train_uplift cart: {c['grown_num_nodes']} nodes grown, "
          f"{c['num_pruned_nodes']} pruned in {c['jax_train_s_cpu']:.1f} s, "
          f"{c['jax_evaluate']}", flush=True)

    c = cfg["numerical"]
    train, test = chip_smoke.make_uplift_frame(c["rows"], c["test_rows"],
                                               numerical=True)
    t0 = time.perf_counter()
    m = ydf.RandomForestLearner(num_trees=c["num_trees"],
                                task=Task.NUMERICAL_UPLIFT,
                                **c["learner"]).train(train)
    c["jax_train_s_cpu"] = time.perf_counter() - t0
    got, runs["numerical"] = _forest_run(m, test, cfg["compare_rows"],
                                         fields)
    got.update(train_sha256=chip_smoke.frame_sha256(train))
    c.update(got)
    print(f"train_uplift numerical: {c['num_trees']} trees in "
          f"{c['jax_train_s_cpu']:.1f} s, {c['jax_evaluate']}", flush=True)
    _write_runs("train_uplift", cfg, runs)


TRAIN_HONEST = dict(
    jax_version="0.9.0", cat_seed=7, compare_rows=1024, small_trees=3,
    rf=dict(rows=50_000, test_rows=10_000, fixture_trees=50,
            learner=dict(label="label", honest=True)),
    regression=dict(rows=20_000, test_rows=5_000, num_trees=30,
                    learner=dict(label="target", honest=True)),
)


def write_train_honest():
    """train_honest/: the JAX RandomForestLearner(honest=True) with every
    other default on train_rf's frame (make_frame, its first
    fixture_trees trees; rf_small/ the JAX model of its first
    small_trees) and a 30-tree honest regression forest on
    chip_smoke.multitask_target of a 20,000-row frame (float leaf stats
    re-estimated in row order). ~7.5 min on 8 CPU threads (212 s and
    203 s)."""
    import time

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.config import Task

    cfg = json.loads(json.dumps(TRAIN_HONEST))
    cfg["jax_impls"] = _jax_header(cfg)
    d = os.path.join(OUT, "train_honest")
    if os.path.isdir(d):
        shutil.rmtree(d)
    fields = chip_smoke.TREE_HASH_FIELDS
    runs = {}
    c = cfg["rf"]
    train, test = chip_smoke.make_frame(c["rows"], c["test_rows"],
                                        cfg["cat_seed"])
    t0 = time.perf_counter()
    m = ydf.RandomForestLearner(num_trees=c["fixture_trees"],
                                **c["learner"]).train(train)
    c["jax_train_s_cpu"] = time.perf_counter() - t0
    got, runs["rf"] = _forest_run(m, test, cfg["compare_rows"], fields)
    got.update(train_sha256=chip_smoke.frame_sha256(train),
               bins_sha256=_bins_sha256(m, train))
    c.update(got)
    small = ydf.RandomForestLearner(num_trees=cfg["small_trees"],
                                    **c["learner"]).train(train)
    small.save(os.path.join(d, "rf_small"))
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    runs["rf"]["small_predictions"] = np.asarray(small.predict(head))
    print(f"train_honest rf: {c['fixture_trees']} trees in "
          f"{c['jax_train_s_cpu']:.1f} s, oob {c['oob_evaluation']}",
          flush=True)

    c = cfg["regression"]
    train, test = chip_smoke.make_frame(c["rows"], c["test_rows"],
                                        cfg["cat_seed"])
    train["target"] = chip_smoke.multitask_target(train)
    test["target"] = chip_smoke.multitask_target(test)
    t0 = time.perf_counter()
    m = ydf.RandomForestLearner(num_trees=c["num_trees"],
                                task=Task.REGRESSION,
                                **c["learner"]).train(train)
    c["jax_train_s_cpu"] = time.perf_counter() - t0
    got, runs["regression"] = _forest_run(m, test, cfg["compare_rows"],
                                          fields)
    got.update(train_sha256=chip_smoke.frame_sha256(train))
    c.update(got)
    print(f"train_honest regression: {c['num_trees']} trees in "
          f"{c['jax_train_s_cpu']:.1f} s, {c['jax_evaluate']}", flush=True)
    _write_runs("train_honest", cfg, runs)


TRAIN_SETS_ALONE = dict(
    jax_version="0.9.0", cat_seed=7, compare_rows=1024,
    columns=["tags", "words", "label"],
    gbt=dict(rows=200_000, test_rows=20_000, learner=dict(label="label")),
    rf=dict(rows=20_000, test_rows=5_000, fixture_trees=50,
            learner=dict(label="label")),
    cart=dict(rows=100_000, test_rows=20_000, validation_ratio=0.1,
              seed=123456, learner=dict(label="label")),
)


def write_train_sets_alone():
    """train_sets_alone/: the JAX GBT, random forest (its first
    fixture_trees trees) and CART with every default on
    chip_smoke.sets_alone_frame (make_set_frame's two CATEGORICAL_SET
    columns and the label only: no scalar feature). ~11 min on 8 CPU
    threads (the GBT 137 s, the RF and CART the rest)."""
    import time

    import chip_smoke
    import ydf_tpu as ydf

    cfg = json.loads(json.dumps(TRAIN_SETS_ALONE))
    cfg["jax_impls"] = _jax_header(cfg)
    fields = chip_smoke.SET_TREE_HASH_FIELDS
    runs = {}
    c = cfg["gbt"]
    train, test = chip_smoke.sets_alone_frame(c["rows"], c["test_rows"],
                                              cfg["cat_seed"])
    t0 = time.perf_counter()
    m = ydf.GradientBoostedTreesLearner(**c["learner"]).train(train)
    c["jax_train_s_cpu"] = time.perf_counter() - t0
    got, runs["gbt"] = _gbt_run(m, test, cfg["compare_rows"], fields)
    got["train_sha256"] = chip_smoke.frame_sha256(train)
    c.update(got)
    print(f"train_sets_alone gbt: {c['num_trees']} of "
          f"{c['num_trees_trained']} in {c['jax_train_s_cpu']:.1f} s, "
          f"{c['jax_evaluate']}", flush=True)

    c = cfg["rf"]
    train, test = chip_smoke.sets_alone_frame(c["rows"], c["test_rows"],
                                              cfg["cat_seed"])
    t0 = time.perf_counter()
    m = ydf.RandomForestLearner(num_trees=c["fixture_trees"],
                                **c["learner"]).train(train)
    c["jax_train_s_cpu"] = time.perf_counter() - t0
    got, runs["rf"] = _forest_run(m, test, cfg["compare_rows"], fields)
    got["train_sha256"] = chip_smoke.frame_sha256(train)
    c.update(got)
    print(f"train_sets_alone rf: {c['fixture_trees']} trees in "
          f"{c['jax_train_s_cpu']:.1f} s", flush=True)

    c = cfg["cart"]
    train, test = chip_smoke.sets_alone_frame(c["rows"], c["test_rows"],
                                              cfg["cat_seed"])
    _, runs["cart"] = _cart_run(cfg, c, train, test, c["learner"], fields)
    print(f"train_sets_alone cart: {c['grown_num_nodes']} nodes grown, "
          f"{c['num_pruned_nodes']} pruned in {c['jax_train_s_cpu']:.1f} s",
          flush=True)
    _write_runs("train_sets_alone", cfg, runs)


TRAIN_MULTITASKER = dict(
    jax_version="0.9.0", cat_seed=7, compare_rows=1024, rows=100_000,
    test_rows=20_000,
    tasks=[{"label": "label"}, {"label": "target", "task": "REGRESSION"}],
)


def write_train_multitasker():
    """train_multitasker/: the JAX MultitaskerLearner with the default
    GBT base on make_frame plus chip_smoke.multitask_target: the binary
    label and the regression target; model/ holds its directory
    (multitasker.txt, task_label/, task_target/). ~1 min on 8 CPU
    threads (48 s)."""
    import time

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.config import Task

    cfg = json.loads(json.dumps(TRAIN_MULTITASKER))
    cfg["jax_impls"] = _jax_header(cfg)
    d = os.path.join(OUT, "train_multitasker")
    if os.path.isdir(d):
        shutil.rmtree(d)
    train, test = chip_smoke.make_frame(cfg["rows"], cfg["test_rows"],
                                        cfg["cat_seed"])
    train["target"] = chip_smoke.multitask_target(train)
    test["target"] = chip_smoke.multitask_target(test)
    tasks = [dict(t, task=Task[t.get("task", "CLASSIFICATION")])
             for t in cfg["tasks"]]
    t0 = time.perf_counter()
    m = ydf.MultitaskerLearner(tasks=tasks).train(train)
    cfg["jax_train_s_cpu"] = time.perf_counter() - t0
    cfg.update(train_sha256=chip_smoke.frame_sha256(train),
               test_sha256=chip_smoke.frame_sha256(test), models={})
    runs = {}
    for label, sub in m.models.items():
        got, runs[label] = _gbt_run(sub, test, cfg["compare_rows"],
                                    chip_smoke.TREE_HASH_FIELDS)
        cfg["models"][label] = got
    m.save(os.path.join(d, "model"))
    print(f"train_multitasker: {cfg['jax_train_s_cpu']:.1f} s, " + "; ".join(
        f"{k}: {v['num_trees']} trees, {v['jax_evaluate']}"
        for k, v in cfg["models"].items()), flush=True)
    _write_runs("train_multitasker", cfg, runs)


#: ydf_format/'s models: directory -> (source under OUT, request file
#: under OUT, file prefix).
YDF_FORMAT = {
    "gbt_d6": ("gbt_d6", "gbt_d6/requests.npz", ""),
    "multiclass": ("train_multiclass/model", "gbt_d6/requests.npz", ""),
    "if": ("train_if/model", "gbt_d6/requests.npz", ""),
    "uplift_rf": ("train_uplift/rf_small",
                  "ydf_format/uplift_requests.npz", ""),
    "prefixed": ("train_uplift/cart_model",
                 "ydf_format/uplift_requests.npz", "cart_"),
}


def write_ydf_format():
    """ydf_format/: the JAX package's YDF-format exports of five fixture
    models, their files' SHA-256 and the JAX importer's predictions and
    leaves on 1,024 rows."""
    import hashlib
    import tempfile

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.models.ydf_format import export_ydf_model, load_ydf_model

    d = os.path.join(OUT, "ydf_format")
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.makedirs(d)
    _, test = chip_smoke.make_uplift_frame(chip_smoke.UPLIFT_ROWS,
                                           chip_smoke.UPLIFT_TEST_ROWS)
    np.savez_compressed(os.path.join(d, "uplift_requests.npz"),
                        **{k: v[:REQUEST_ROWS] for k, v in test.items()})
    cfg = dict(jax_version=__import__("jax").__version__,
               request_rows=REQUEST_ROWS, models={})
    expected = {}
    for name, (src, requests, prefix) in YDF_FORMAT.items():
        model = ydf.load_model(os.path.join(OUT, src))
        out = os.path.join(d, name)
        with tempfile.TemporaryDirectory() as tmp:
            export_ydf_model(model, tmp)
            files = {}
            for fname in sorted(os.listdir(tmp)):
                with open(os.path.join(tmp, fname), "rb") as f:
                    files[fname] = hashlib.sha256(f.read()).hexdigest()
                os.makedirs(out, exist_ok=True)
                shutil.copyfile(os.path.join(tmp, fname),
                                os.path.join(out, prefix + fname))
        with np.load(os.path.join(OUT, requests)) as z:
            req = {k: z[k] for k in z.files}
        imported = load_ydf_model(out)
        expected[f"{name}/predictions"] = np.asarray(imported.predict(req))
        # Leaf ids in the narrowest unsigned type that holds them (the
        # fixture's size); compared by value.
        leaves = np.asarray(imported.predict_leaves(req))
        expected[f"{name}/leaves"] = leaves.astype(
            np.uint8 if leaves.max() < 256 else np.uint16)
        cfg["models"][name] = dict(source=src, requests=requests,
                                   prefix=prefix, sha256=files)
        print(f"ydf_format/{name}: {len(files)} files, "
              f"{sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))}"
              " bytes", flush=True)
    np.savez_compressed(os.path.join(d, "expected.npz"), **expected)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)


TRAIN_CACHE = dict(
    rows=500_000, test_rows=100_000, shards=4, chunk_rows=65_536,
    big_chunk_rows=500_000, learner=dict(label="label"), compare_rows=1024,
    # The TFRecord and Avro files hold the test rows' head: the Python
    # record writer takes about 90 s for all 100,000 rows on a CPU.
    record_rows=4_096,
    # The small runs the CPU tests repeat: the forests at depth 6 (the
    # port's plain PyTorch grower takes about 60 s a depth-16 forest of 5
    # trees on one CPU thread).
    small=dict(rows=3_000, test_rows=500, shards=2, chunk_rows=1_024,
               trees=5),
)


def _check_parse(files):
    """The JAX package's CSV loader and pandas parse every column of
    `files` to the same values (floats to the same bits)."""
    import pandas as pd

    from ydf_tpu.dataset import native_csv

    for f in files:
        a = native_csv.read_csv(f)
        b = pd.read_csv(f)
        for k, v in a.items():
            w = b[k].to_numpy()
            if v.dtype.kind == "f":
                assert np.array_equal(v.view(np.int64),
                                      w.astype(np.float64).view(np.int64)), (
                    f, k)
            else:
                assert [x for x in v.tolist()] == [
                    "" if isinstance(x, float) else x for x in w.tolist()], (
                    f, k)


#: The small runs of train_cache/: (create_dataset_cache arguments,
#: learner, learner arguments).
SMALL_CACHE_RUNS = {
    "gbt": (dict(label="label"), "GradientBoostedTreesLearner",
            dict(label="label")),
    "rf_weights": (dict(label="label", weights="w"), "RandomForestLearner",
                   dict(label="label", weights="w", max_depth=6)),
    "uplift": (dict(label="label", task="NUMERICAL_UPLIFT",
                    uplift_treatment="treat"), "RandomForestLearner",
               dict(label="label", task="NUMERICAL_UPLIFT",
                    uplift_treatment="treat", max_depth=6)),
    "cart": (dict(label="label"), "CartLearner",
             dict(label="label", validation_ratio=0.0, max_depth=6)),
    "if": (dict(label="label"), "IsolationForestLearner",
           dict(label="label", num_trees=2)),
    "oblique": (dict(label="label", store_raw_numerical=True),
                "GradientBoostedTreesLearner",
                dict(label="label", split_axis="SPARSE_OBLIQUE")),
}


def _jax_run(m, test, compare_rows):
    """The per-tree hashes (a NaN as chip_smoke.canonical_nan writes it),
    node counts and predictions of a trained JAX model, with the GBT's
    losses and counts."""
    import chip_smoke

    fo = chip_smoke.canonical_nan(
        {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields})
    T = fo["feature"].shape[0]
    preds = np.asarray(m.predict(test))
    cfg = dict(num_trees=T, predictions_sha256=chip_smoke.array_sha256(preds))
    arrays = dict(
        tree_sha256=_digests(chip_smoke.tree_sha256(fo, t) for t in range(T)),
        num_nodes=fo["num_nodes"].astype(np.int32),
        predictions=preds[:compare_rows],
    )
    logs = getattr(m, "training_logs", None) or {}
    if logs.get("iterations"):
        cfg["num_trees_kept"] = logs["num_trees"]
        cfg["num_trees_trained"] = logs["num_trees_trained"]
        arrays["train_loss"] = np.array(
            [r["train_loss"] for r in logs["iterations"]], np.float32)
        arrays["valid_loss"] = np.array(
            [np.nan if r["valid_loss"] is None else r["valid_loss"]
             for r in logs["iterations"]], np.float32)
    return cfg, arrays


def write_train_cache():
    """train_cache/: the JAX package's dataset cache of chip_smoke's
    phase-17 CSV shards and its default GBT trained from it, plus the
    small runs the CPU tests load."""
    import gzip
    import tempfile

    import pandas as pd

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.config import Task
    from ydf_tpu.dataset.cache import create_dataset_cache
    from ydf_tpu.dataset.tfrecord import write_tfrecord_columns

    cfg = dict(TRAIN_CACHE, jax_version=__import__("jax").__version__,
               cat_seed=chip_smoke.DEFAULT_CAT_SEED,
               data_seed=chip_smoke.DATA_SEED)
    # With pandas installed the JAX package streams the CSV shards
    # through pandas' chunked reader; without it, through its native
    # loader, which gives an integer label the classes "0.0" / "1.0"
    # that its label encoding never finds (ROADMAP Queue 3). These runs
    # use pandas, on files both readers parse to the same bits.
    cfg["jax_csv_reader"] = f"pandas {pd.__version__} (chunked)"
    out = os.path.join(OUT, "train_cache")
    if os.path.isdir(out):
        shutil.rmtree(out)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        train, test = chip_smoke.make_frame(cfg["rows"], cfg["test_rows"])
        names = chip_smoke.write_csv_shards(tmp, train, test, cfg["shards"])
        paths = [os.path.join(tmp, n) for n in names]
        cfg["csv_sha256"] = {n: chip_smoke.file_sha256(p) for n, p in zip(names, paths)}
        _check_parse(paths)
        src = f"csv:{tmp}/train-*.csv"
        c = create_dataset_cache(src, os.path.join(tmp, "c"),
                                 chunk_rows=cfg["chunk_rows"], label="label")
        cfg["cache"] = chip_smoke.cache_record(c)
        big = create_dataset_cache(src, os.path.join(tmp, "big"),
                                   chunk_rows=cfg["big_chunk_rows"],
                                   label="label")
        assert chip_smoke.cache_record(big) == cfg["cache"], "chunking changed a byte"
        sk = create_dataset_cache(src, os.path.join(tmp, "sk"),
                                  chunk_rows=cfg["chunk_rows"],
                                  label="label", boundaries="sketch")
        cfg["sketch_cache"] = chip_smoke.cache_record(sk)
        m = ydf.GradientBoostedTreesLearner(**cfg["learner"]).train(c)
        n = c.num_rows
        perm = np.random.RandomState(123456).permutation(n)
        va_idx = perm[:min(max(int(n * 0.1), 1), n - 1)]
        cfg["valid_idx_sha256"] = chip_smoke.array_sha256(
            va_idx.astype(np.int64))
        head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
        run_cfg, runs["full"] = _jax_run(m, head, cfg["compare_rows"])
        runs["full"]["initial_predictions"] = np.asarray(
            m.initial_predictions, np.float32)
        cfg["full"] = run_cfg
        cfg["full"]["jax_evaluate"] = dict(
            m.evaluate(os.path.join(tmp, "test.csv")).metrics)
        tf = os.path.join(tmp, "test.tfrecord.gz")
        write_tfrecord_columns(tf, {k: v[:cfg["record_rows"]]
                                    for k, v in test.items()},
                               compressed=True)
        with gzip.open(tf, "rb") as f:
            cfg["tfrecord_records_sha256"] = __import__("hashlib").sha256(
                f.read()).hexdigest()
        print(f"train_cache full: {run_cfg}", flush=True)

        # The small runs.
        sm = cfg["small"]
        strain, stest = chip_smoke.cache_frames(sm["rows"],
                                                sm["test_rows"])
        d = os.path.join(tmp, "small")
        os.makedirs(d)
        names = chip_smoke.write_csv_shards(d, strain, stest, sm["shards"])
        sp = [os.path.join(d, n) for n in names]
        _check_parse(sp)
        cfg["small"]["csv_sha256"] = {n: chip_smoke.file_sha256(p)
                                      for n, p in zip(names, sp)}
        cfg["small"]["runs"] = {}
        for name, (ckw, learner, lkw) in SMALL_CACHE_RUNS.items():
            args = dict(lkw)
            if learner != "CartLearner":
                args.setdefault("num_trees", sm["trees"])
            ckw, hp = dict(ckw), dict(args)
            if "task" in ckw:
                ckw["task"] = Task[ckw["task"]]
                hp["task"] = Task[hp["task"]]
            c = create_dataset_cache(f"csv:{d}/train-*.csv",
                                     os.path.join(d, f"c_{name}"),
                                     chunk_rows=sm["chunk_rows"], **ckw)
            m = getattr(ydf, learner)(**hp).train(c)
            rc, runs[name] = _jax_run(m, stest, sm["test_rows"])
            rc["cache"] = chip_smoke.cache_record(c)
            rc.update(cache_args=SMALL_CACHE_RUNS[name][0], learner=learner,
                      learner_args=args)
            cfg["small"]["runs"][name] = rc
            print(f"train_cache small {name}: {rc['num_trees']} trees",
                  flush=True)
    _write_runs("train_cache", cfg, runs)


TRAIN_DIST = dict(
    rows=500_000, test_rows=100_000, feature_shards=2, workers=2,
    learner=dict(label="label", validation_ratio=0.0, num_trees=50),
    compare_rows=1024,
)


def write_train_dist():
    """train_dist/: the JAX package's feature-parallel distributed GBT
    (two in-process workers on this machine's CPU) on phase 17's
    chip_smoke.cache_frames train frame at full width, from a cache
    built with feature_shards=2: the default GBT with validation_ratio=
    0.0 and 50 trees. It is first held tree by tree against the JAX
    package's single-machine GBT from the same cache. Records every
    tree's hash (a NaN as chip_smoke.canonical_nan writes it), the node
    counts, the losses, the test rows' predictions (all hashed, the
    first compare_rows in full), their raw scores and evaluate's
    metrics."""
    import socket
    import tempfile
    import time

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.dataset.cache import create_dataset_cache
    from ydf_tpu.parallel.worker_service import WorkerPool, start_worker

    cfg = dict(TRAIN_DIST, jax_version=__import__("jax").__version__,
               cat_seed=chip_smoke.DEFAULT_CAT_SEED,
               data_seed=chip_smoke.DATA_SEED)
    out = os.path.join(OUT, "train_dist")
    if os.path.isdir(out):
        shutil.rmtree(out)
    train, test = chip_smoke.cache_frames(cfg["rows"], cfg["test_rows"])
    cfg["train_sha256"] = chip_smoke.frame_sha256(train)
    cfg["test_sha256"] = chip_smoke.frame_sha256(test)
    ports = []
    for _ in range(cfg["workers"]):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            ports.append(sk.getsockname()[1])
    for p in ports:
        start_worker(p, blocking=False)
    addrs = [f"127.0.0.1:{p}" for p in ports]
    with tempfile.TemporaryDirectory() as tmp:
        c = create_dataset_cache(train, os.path.join(tmp, "c"),
                                 label="label",
                                 feature_shards=cfg["feature_shards"])
        cfg["cache"] = chip_smoke.cache_record(c)
        t0 = time.perf_counter()
        single = ydf.GradientBoostedTreesLearner(**cfg["learner"]).train(c)
        t1 = time.perf_counter()
        m = ydf.GradientBoostedTreesLearner(
            distributed_workers=addrs, **cfg["learner"]).train(c)
        t2 = time.perf_counter()
        cfg["jax_single_s_cpu"], cfg["jax_dist_s_cpu"] = t1 - t0, t2 - t1
    WorkerPool(addrs).shutdown_all()
    fo = chip_smoke.canonical_nan(
        {f: np.asarray(getattr(m.forest, f)) for f in m.forest._fields})
    fs = chip_smoke.canonical_nan(
        {f: np.asarray(getattr(single.forest, f))
         for f in single.forest._fields})
    T = fo["feature"].shape[0]
    hashes = chip_smoke.forest_hashes(fo)
    bad = [t for t, h in enumerate(chip_smoke.forest_hashes(fs))
           if h != hashes[t]]
    assert not bad, f"JAX distributed trees {bad[:10]} != single-machine"
    preds = np.asarray(m.predict(test))
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    cfg.update(
        num_trees=T, predictions_sha256=chip_smoke.array_sha256(preds),
        jax_evaluate=dict(m.evaluate(test).metrics),
        distributed={k: v for k, v in m.training_logs["distributed"].items()
                     if k in ("workers", "feature_shards", "hist_quant",
                              "reduce_bytes", "stats_bytes")})
    arrays = dict(
        tree_sha256=np.stack([np.frombuffer(bytes.fromhex(h), np.uint8)
                              for h in hashes]),
        num_nodes=fo["num_nodes"].astype(np.int32),
        train_loss=np.asarray(m.training_logs["train_loss"], np.float32),
        predictions=preds[:cfg["compare_rows"]],
        raw=np.asarray(m._raw_scores(head, combine="sum")[:, 0]),
        initial_predictions=np.asarray(m.initial_predictions, np.float32),
    )
    _write_runs("train_dist", cfg, {"run": arrays})
    print(f"train_dist: {T} trees, == single-machine; single "
          f"{cfg['jax_single_s_cpu']:.1f} s, distributed "
          f"{cfg['jax_dist_s_cpu']:.1f} s", flush=True)


TRAIN_DISCRETIZED = dict(
    rows=200_000, test_rows=50_000, learner=dict(
        label="label", discretize_numerical_columns=True),
    compare_rows=1024,
    small=dict(rows=3_000, test_rows=500, trees=5),
)

#: The small discretized runs: (learner, its arguments).
SMALL_DISCRETIZED_RUNS = {
    "gbt": ("GradientBoostedTreesLearner", dict(num_trees=5)),
    "gbt_256": ("GradientBoostedTreesLearner",
                dict(num_trees=5, num_bins=256)),
    "gbt_bins_40": ("GradientBoostedTreesLearner",
                    dict(num_trees=5, num_discretized_numerical_bins=40)),
    "rf": ("RandomForestLearner", dict(num_trees=5, max_depth=6)),
    "cart": ("CartLearner", dict(max_depth=6)),
    "if": ("IsolationForestLearner", dict(num_trees=2)),
}


def write_train_discretized():
    """train_discretized/: the JAX package's default GBT with
    discretize_numerical_columns=True on make_frame (chip_smoke's phase
    17), its YDF export's SHA-256s, and the small runs of all four
    learners the CPU tests load."""
    import tempfile

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.models.ydf_format import export_ydf_model

    cfg = dict(TRAIN_DISCRETIZED, jax_version=__import__("jax").__version__)
    out = os.path.join(OUT, "train_discretized")
    if os.path.isdir(out):
        shutil.rmtree(out)
    runs = {}

    def export_sha(m):
        with tempfile.TemporaryDirectory() as tmp:
            export_ydf_model(m, tmp)
            return {f: chip_smoke.file_sha256(os.path.join(tmp, f))
                    for f in sorted(os.listdir(tmp))}

    train, test = chip_smoke.make_frame(cfg["rows"], cfg["test_rows"])
    m = ydf.GradientBoostedTreesLearner(**cfg["learner"]).train(train)
    head = {k: v[:cfg["compare_rows"]] for k, v in test.items()}
    cfg["full"], runs["full"] = _jax_run(m, head, cfg["compare_rows"])
    cfg["full"]["test_predictions_sha256"] = chip_smoke.array_sha256(
        np.asarray(m.predict(test)))
    cfg["full"]["export_sha256"] = export_sha(m)
    print(f"train_discretized full: {cfg['full']['num_trees']} trees",
          flush=True)
    sm = cfg["small"]
    strain, stest = chip_smoke.make_frame(sm["rows"], sm["test_rows"])
    cfg["small"]["runs"] = {}
    for name, (learner, kw) in SMALL_DISCRETIZED_RUNS.items():
        m = getattr(ydf, learner)(**dict(cfg["learner"], **kw)).train(strain)
        rc, runs[name] = _jax_run(m, stest, sm["test_rows"])
        if learner == "GradientBoostedTreesLearner":
            rc["export_sha256"] = export_sha(m)
        rc.update(learner=learner, learner_args=dict(cfg["learner"], **kw))
        cfg["small"]["runs"][name] = rc
        print(f"train_discretized small {name}: {rc['num_trees']} trees",
              flush=True)
    _write_runs("train_discretized", cfg, runs)


#: Where main() asks XLA to dump the boosting programs (for
#: write_train_multiclass's update_forms); removed afterwards.
DUMP_DIR = None


#: The cores JAX runs on when MHLD fixtures are written: XLA's CPU dot
#: splits its rows into one block a thread (ops/mhld.py:ROW_BLOCKS).
XLA_CPU_THREADS = 8
#: The XLA-order probes of ops/mhld.py: a^T b at (rows, M) and w^T x
#: and the column sums at rows; make_mhld_W's program on
#: MHLD_PROGRAM_ROWS rows, six iterations.
MHLD_DOTS = ((2700, 28), (3000, 28), (18000, 28), (18000, 2), (18000, 3))
MHLD_VDOTS = (2700, 18000)
MHLD_PROGRAM_ROWS = 18000


def pin_xla_cpu_threads():
    """Runs this process on XLA_CPU_THREADS cores, before JAX starts
    its CPU client (which sizes its thread pool by the affinity)."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < XLA_CPU_THREADS:
        raise SystemExit(f"the MHLD fixtures need {XLA_CPU_THREADS} cores "
                         f"(XLA's dot order follows them); this host has "
                         f"{len(cores)}")
    os.sched_setaffinity(0, cores[:XLA_CPU_THREADS])


def mhld_dot_case(n, M):
    """(a f32 [n, M], b f32 [n, 28]) of the row-dot probe."""
    rng = np.random.default_rng(n + M)
    return (rng.normal(size=(n, M)).astype(np.float32),
            rng.normal(size=(n, 28)).astype(np.float32))


def mhld_vdot_case(n):
    """(w f32 [n] with 30% zeros, x f32 [n, 28]) of the vector-dot
    probe."""
    rng = np.random.default_rng(n)
    w = (rng.random(n) < 0.7).astype(np.float32) * np.float32(2.5)
    return w, rng.normal(size=(n, 28)).astype(np.float32)


def mhld_program_case():
    """(x f32 [n, 28] with three feature scales, y int32 [n], the row
    weights [all ones, a Bernoulli(0.5) draw], the port's six
    iterations' k_proj int64 [6, 2]) of the make_mhld_W program."""
    import torch  # noqa: F401  (the port's key chain)

    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.utils import prng

    n = MHLD_PROGRAM_ROWS
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(n, 28)) * rng.choice([0.1, 1, 10], size=28)
         ).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.int32)
    ws = [np.ones(n, np.float32),
          prng.bernoulli(prng.prng_key(3), 0.5, (n,)).numpy().astype(
              np.float32)]
    keys = port_gbt.iteration_keys(7, 6, 1, False, "cpu",
                                   with_oblique=True).proj.numpy()
    return x, y, ws, keys


def jax_make_mhld_W(x_tr_raw, y_tr, w_eff, k_proj, P, num_label_classes,
                    mhld_max_attributes):
    """The JAX package's make_mhld_W (ydf_tpu/learners/gbt.py:1196-1253)
    as a function of its closure's values."""
    import jax
    import jax.numpy as jnp

    Fn = x_tr_raw.shape[1]
    C = max(num_label_classes, 2)
    oh = jax.nn.one_hot(y_tr.astype(jnp.int32), C, dtype=jnp.float32)
    cw = oh * w_eff[:, None]
    n_c = cw.sum(0)
    tot = jnp.maximum(w_eff.sum(), 1e-12)
    mu_c = (cw.T @ x_tr_raw) / jnp.maximum(n_c, 1e-12)[:, None]
    mu = (w_eff @ x_tr_raw) / tot
    Sxx = (x_tr_raw * w_eff[:, None]).T @ x_tr_raw
    SW = Sxx - (mu_c.T * n_c[None, :]) @ mu_c
    d = mu_c - mu[None, :]
    SB = (d.T * n_c[None, :]) @ d
    smax = min(max(mhld_max_attributes, 2), Fn)
    sizes = 2 + (jnp.arange(P) % max(smax - 1, 1))
    k_sub = jax.random.split(k_proj, P)

    def subset_mask(kk, size):
        scores = jax.random.uniform(kk, (Fn,))
        kth = jnp.sort(scores)[Fn - size]
        return scores >= kth

    masks = jax.vmap(subset_mask)(k_sub, sizes)
    reg = 1e-3 * jnp.trace(SW) / Fn + 1e-6

    def solve_one(m):
        mf = m.astype(jnp.float32)
        MM = mf[:, None] * mf[None, :]
        SWp = SW * MM + jnp.diag(1.0 - mf) + reg * jnp.eye(Fn)
        SBp = SB * MM
        L = jnp.linalg.cholesky(SWp)
        A = jax.scipy.linalg.solve_triangular(L, SBp, lower=True)
        M2 = jax.scipy.linalg.solve_triangular(L, A.T, lower=True).T
        M2 = 0.5 * (M2 + M2.T)
        _, evecs = jnp.linalg.eigh(M2)
        v = evecs[:, -1]
        wp = jax.scipy.linalg.solve_triangular(L.T, v, lower=False) * mf
        return (wp / jnp.maximum(jnp.linalg.norm(wp), 1e-12)).astype(
            jnp.float32)

    return jax.vmap(solve_one)(masks)


def write_mhld_order(d):
    """train_mhld/xla_order.npz (module docstring)."""
    import jax

    out = {}
    dot = jax.jit(lambda a, b: a.T @ b)
    for n, M in MHLD_DOTS:
        out[f"dots_{n}_{M}"] = np.asarray(dot(*mhld_dot_case(n, M)))
    for n in MHLD_VDOTS:
        w, x = mhld_vdot_case(n)
        out[f"vdot_{n}"] = np.asarray(jax.jit(lambda w, x: w @ x)(w, x))
        out[f"colsum_{n}"] = np.asarray(jax.jit(lambda x: x.sum(0))(x))
    x, y, ws, keys = mhld_program_case()

    # The arrays are arguments: closure constants would be folded into
    # another program.
    @jax.jit
    def program(x, y, w, ks):
        def step(c, k):
            return c, jax_make_mhld_W(x, y, w, k, 28, 2, 4)
        return jax.lax.scan(step, 0, ks)[1]

    for i, w in enumerate(ws):
        out[f"program_{i}"] = np.asarray(
            program(x, y, w, keys.astype(np.uint32)))
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(os.path.join(d, "xla_order.npz"), **out)
    print(f"train_mhld/xla_order.npz: {sorted(out)}", flush=True)


TRAIN_MHLD = dict(
    jax_version="0.9.0", cat_seed=7, compare_rows=1024,
    gbt=dict(rows=500_000, test_rows=100_000,
             learner=dict(label="label", split_axis="MHLD_OBLIQUE")),
    # Small runs for the CPU tests: 20,000 rows (18,000 after the
    # validation split: the row dots' order is identified there, not at
    # 2,700 rows for two classes, ops/mhld.py), depth 4, a few trees.
    small_rows=20_000, small_test_rows=2_000,
    small=dict(
        binary=dict(label="label", split_axis="MHLD_OBLIQUE",
                    num_trees=12, max_depth=4),
        attributes2=dict(label="label", split_axis="MHLD_OBLIQUE",
                         num_trees=8, max_depth=4,
                         mhld_oblique_max_num_attributes=2),
        three_class=dict(label="label", split_axis="MHLD_OBLIQUE",
                         num_trees=6, max_depth=4,
                         mhld_oblique_max_num_attributes=3),
        subsample=dict(label="label", split_axis="MHLD_OBLIQUE",
                       num_trees=12, max_depth=4, subsample=0.5),
        goss=dict(label="label", split_axis="MHLD_OBLIQUE", num_trees=12,
                  max_depth=4, sampling_method="GOSS"),
    ),
)


def _mhld_run(m, train, test, compare_rows, W, bounds):
    """(config entries, arrays) of a trained JAX MHLD GBT: _gbt_run's
    per-tree hashes (node arrays with thresholds) and predictions, each
    kept tree's projections W [28, 28] in full, its boundaries by
    SHA-256 and iteration 0's in full."""
    import chip_smoke

    got, arrays = _gbt_run(m, test, compare_rows,
                           chip_smoke.TREE_HASH_FIELDS + ("threshold",))
    got["train_sha256"] = chip_smoke.frame_sha256(train)
    T = got["num_trees"]
    arrays["oblique_weights"] = np.asarray(W, np.float32)[:T]
    arrays["bounds_sha256"] = np.stack(
        [np.frombuffer(bytes.fromhex(chip_smoke.array_sha256(b)), np.uint8)
         for b in np.asarray(bounds, np.float32)[:T]])
    arrays["bounds0"] = np.asarray(bounds, np.float32)[0]
    return got, arrays


def write_train_mhld():
    """train_mhld/: the JAX GBT with split_axis="MHLD_OBLIQUE" and every
    other default on train_default's frame (500,000 + 100,000 rows; 28
    projections an iteration from LDA), and TRAIN_MHLD's small runs on
    20,000 rows of it (binary, mhld_oblique_max_num_attributes=2, the
    three-class frame with 3, subsample=0.5 and GOSS: the row weights
    change between iterations)."""
    import time

    import chip_smoke
    import ydf_tpu as ydf
    from ydf_tpu.learners import gbt as jax_gbt

    cfg = json.loads(json.dumps(TRAIN_MHLD))
    cfg["jax_impls"] = _jax_header(cfg)
    d = os.path.join(OUT, "train_mhld")
    if os.path.isdir(d):
        shutil.rmtree(d)
    runs = {}

    def train_run(name, c, hp, rows, test_rows, classes=2):
        train, test = make_frame(cfg["cat_seed"], rows, test_rows,
                                 keep_label=True, classes=classes)
        logs, restore = chip_smoke.capture_returns(jax_gbt, "_train_gbt")
        try:
            t0 = time.perf_counter()
            m = ydf.GradientBoostedTreesLearner(**hp).train(train)
            c["jax_train_s_cpu"] = time.perf_counter() - t0
        finally:
            restore()
        m.force_engine("Routed")
        run_logs = logs[0][2]
        got, runs[name] = _mhld_run(m, train, test, cfg["compare_rows"],
                                    run_logs["oblique_w"],
                                    run_logs["oblique_b"])
        c.update(got)
        print(f"train_mhld {name}: {c['num_trees']} of "
              f"{c['num_trees_trained']} in {c['jax_train_s_cpu']:.1f} s",
              flush=True)

    small = {}
    for name, hp in cfg["small"].items():
        small[name] = {"learner": hp}
        train_run(f"small_{name}", small[name], hp, cfg["small_rows"],
                  cfg["small_test_rows"],
                  classes=3 if name == "three_class" else 2)
    cfg["small"] = small
    c = cfg["gbt"]
    train_run("gbt", c, c["learner"], c["rows"], c["test_rows"])
    _write_runs("train_mhld", cfg, runs)
    write_mhld_order(d)


def main():
    import tempfile

    global DUMP_DIR
    only = sys.argv[sys.argv.index("--only") + 1] if (
        "--only" in sys.argv) else None
    if only in (None, "train_multiclass"):
        # Before JAX starts its backend: the dump is read after the
        # multiclass training (update_forms).
        DUMP_DIR = tempfile.mkdtemp(prefix="xla_dump_")
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + f" --xla_dump_to={DUMP_DIR}"
            " --xla_dump_hlo_module_re=.*jit_run.*").strip()
    if only in (None, "train_mhld", "mhld_order"):
        pin_xla_cpu_threads()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if only in (None, "train_bench"):
        write_train_bench()
    if only in (None, "train_vs"):
        write_train_vs()
    if only in (None, "train_default"):
        write_train_default()
    if only in (None, "train_rf"):
        write_train_rf()
    if only in (None, "train_multiclass"):
        try:
            write_train_multiclass()
        finally:
            shutil.rmtree(DUMP_DIR, ignore_errors=True)
    if only in (None, "train_gbt_options"):
        write_train_gbt_options()
    if only in (None, "train_cart"):
        write_train_cart()
    if only in (None, "train_if"):
        write_train_if()
    if only in (None, "train_oblique"):
        write_train_oblique()
    if only in (None, "forest_cuts"):
        write_forest_cuts()
    if only in (None, "train_monotone"):
        write_train_monotone()
    if only in (None, "train_dart"):
        write_train_dart()
    if only in (None, "train_sets"):
        write_train_sets()
    if only in (None, "train_ranking"):
        write_train_ranking()
    if only in (None, "train_survival"):
        write_train_survival()
    if only in (None, "train_rank_options"):
        write_train_rank_options()
    if only in (None, "train_uplift"):
        write_train_uplift()
    if only in (None, "train_honest"):
        write_train_honest()
    if only in (None, "train_sets_alone"):
        write_train_sets_alone()
    if only in (None, "train_multitasker"):
        write_train_multitasker()
    if only in (None, "ydf_format"):
        write_ydf_format()
    if only in (None, "train_cache"):
        write_train_cache()
    if only in (None, "train_discretized"):
        write_train_discretized()
    if only in (None, "train_mhld"):
        write_train_mhld()
    if only in (None, "train_dist"):
        write_train_dist()
    if only == "mhld_order":
        write_mhld_order(os.path.join(OUT, "train_mhld"))
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
