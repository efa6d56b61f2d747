"""Chip smoke of ydf_tpu_torch, the PyTorch/CUDA port: builds its CUDA
kernels, checks each against its plain PyTorch version at full width,
serves the committed fixture models through `load_model(...).predict`
on the card, trains the bench GBT on the card through
`GradientBoostedTreesLearner(...).train`, times each kernel, and prints
one JSON summary.

    python3 chip_smoke.py        # needs one CUDA card and nvcc

Phases (one line each; any failure is an uncaught exception):
  1 device    card name, count, nvidia-smi name and power limit
  2 build     nvcc for sm_90a (all five sources in parallel), seconds,
              ptxas registers / shared memory
  3 kernels   each serving kernel == its plain version (torch.equal) on
              4096 rows of the 300-tree default GBT (QuickScorer,
              BankScorer) and the 50-tree depth-8 GBT (BankScorer)
  4 predict   load_model + predict on the stored rows == the JAX
              package's expected.npz (raw bitwise, predictions 1e-6)
  5 serve     requests of 1 .. 1,048,576 rows; then the path's kernel
              timed alone with CUDA events at 1,048,576 rows
  6 train     the bench GBT (500,000 rows x 28 features, 20 trees,
              depth 6) trained on the card: each training kernel against
              its plain version at the path's shapes, then the training
              itself held against the JAX package's run (the committed
              ydf_tpu_torch/testdata/train_bench fixture), then one more
              training under torch.profiler (device time, idle share of
              the boosting loop), then each training kernel timed with
              CUDA events

Phases 4-5 run once per serving path: gbt_d6 with the registry's choice
(QuickScorer), gbt_d6 with BankScorer forced, and gbt_d8 (BankScorer);
phase 6 is the training path. The launch counters are set to 0 just
before each path and read just after it; phase 3, the comparisons and
the timing launches do not count. The `kernels` line has one entry per
(kernel, path).
Exits non-zero without a result when CUDA is absent.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(HERE, "ydf_tpu_torch", "testdata")
SERVE_BATCHES = (1, 256, 4096, 65_536, 1_048_576)
TIMING_ROWS = 1_048_576
COMPARE_ROWS = 4096
# Card peaks used for bound_ms (NVIDIA H100 SXM data sheet, at 700 W):
# HBM bandwidth, and the 32-bit rate outside the tensor cores, the
# nearest listed rate for compare / bitwise / add work.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
TRAIN_BENCH = os.path.join(TESTDATA, "train_bench")
DEVICE = "cuda"
# The training path: bench.py's run_bench configuration (bench.py:1778).
TRAIN_ROWS = 500_000
TRAIN_FEATURES = 28
DATA_SEED = 0
TRAIN_HP = dict(label="label", num_trees=20, max_depth=6,
                validation_ratio=0.0, early_stopping="NONE")
TRAIN_REQUEST_ROWS = 1024
REQUEST_SEED = 1
# Tolerances against the JAX package's run. The port's f32 histograms sum
# rows in another order (shared-memory atomics) than the JAX package's
# f64 block partials, so near-tie splits may flip in late trees; the
# first tree's splits must be equal.
TRAIN_LOSS_RTOL = 1e-3
RAW_SCORE_ATOL = 0.05
RAW_SCORE_MEAN_ATOL = 1e-3
# f32 histogram cells: |kernel - plain| <= HIST_RTOL * (sum of |terms|)
# + HIST_ATOL (the order of the shared-memory atomics varies by run).
HIST_RTOL = 1e-5
HIST_ATOL = 1e-6


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def draw_requests(req, rows, rng):
    """`rows` rows drawn from the stored requests, numerical columns
    with seeded noise (NaNs stay NaN)."""
    idx = rng.integers(0, len(next(iter(req.values()))), rows)
    out = {}
    for k, v in req.items():
        col = v[idx]
        if col.dtype == np.float32:
            col = col + rng.normal(0, 0.05, rows).astype(np.float32)
        out[k] = col
    return out


def synth_higgs_chunk(rng, rows, features):
    """bench.py:synth_higgs_chunk: the bench's synthetic Higgs-shaped
    rows (features f32 normal, a binary label from a non-linear logit)."""
    x = rng.normal(size=(rows, features)).astype(np.float32)
    logit = x[:, 0] - 0.5 * x[:, 1] + np.sin(2 * x[:, 2]) + x[:, 3] * x[:, 4]
    y = (rng.uniform(size=rows) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    return x, y


def make_data(rows, features):
    """bench.py:make_data: columns f0.. and the int label."""
    x, y = synth_higgs_chunk(np.random.RandomState(DATA_SEED), rows,
                             features)
    data = {f"f{i}": x[:, i] for i in range(features)}
    data["label"] = y
    return data


def encoded_xT(model, data):
    """The engines' input: xT f32 [F, n] on the model's device."""
    import torch

    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.serving.quickscorer import feature_major

    x_num, x_cat = model._encode_inputs(
        Dataset.from_data(data, model.dataspec)
    )
    dev = model.device
    return feature_major(torch.from_numpy(x_num).to(dev),
                         torch.from_numpy(x_cat).to(dev))


def time_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def table_bytes(tables):
    return sum(t.numel() * t.element_size() for t in tables
               if hasattr(t, "element_size"))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import ydf_tpu_torch
    from ydf_tpu_torch.ops.routing import forest_predict_values
    from ydf_tpu_torch.serving import bank_scorer, quickscorer
    from ydf_tpu_torch.utils import cuda_build

    # -- 1 device ------------------------------------------------------ #
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log("1 device", f"{kind}; count={count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    print(smi, flush=True)

    # -- 2 build ------------------------------------------------------- #
    sources = ["quickscorer", "bank_scorer", "histogram", "histogram_routed",
               "binning"]
    secs = cuda_build.build_all(sources, force=True)
    ptxas = []
    for name, text in cuda_build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                ptxas.append(f"{name}: {line.strip()}")
    log("2 build", f"nvcc sm_90a, {len(sources)} sources in parallel, "
        f"{secs:.2f} s; " + " | ".join(ptxas))

    # -- 3 kernels against plain, at full width ------------------------ #
    rng = np.random.default_rng(0)
    paths = {m: os.path.join(TESTDATA, m) for m in ("gbt_d6", "gbt_d8")}
    req = {m: dict(np.load(os.path.join(p, "requests.npz")))
           for m, p in paths.items()}
    m6 = ydf_tpu_torch.load_model(paths["gbt_d6"])
    m8 = ydf_tpu_torch.load_model(paths["gbt_d8"])
    qs6 = quickscorer.build_quickscorer(m6)
    bank6 = bank_scorer.build_bank_scorer(m6)
    bank8 = bank_scorer.build_bank_scorer(m8)
    assert qs6 is not None and bank6 is not None and bank8 is not None
    assert quickscorer.build_quickscorer(m8) is None, "d8 fits QuickScorer?"
    # One main path per (kernel, model): (summary name, model key, forced
    # engine or None for the registry's choice, kernel module, tables,
    # the same model's bank tables (they count the least work), source,
    # TPU kernel replaced).
    main_paths = (
        ("quickscorer/gbt_d6", "gbt_d6", None, quickscorer, qs6.tables,
         bank6.tables, "ydf_tpu_torch/csrc/quickscorer.cu",
         "ydf_tpu/serving/quickscorer.py:232"),
        ("bank_scorer/gbt_d6/forced", "gbt_d6", "BankScorer", bank_scorer,
         bank6.tables, bank6.tables, "ydf_tpu_torch/csrc/bank_scorer.cu",
         "ydf_tpu/serving/pallas_scorer.py:118"),
        ("bank_scorer/gbt_d8", "gbt_d8", None, bank_scorer, bank8.tables,
         bank8.tables, "ydf_tpu_torch/csrc/bank_scorer.cu",
         "ydf_tpu/serving/pallas_scorer.py:118"),
    )
    models = {"gbt_d6": m6, "gbt_d8": m8}
    max_err = {}
    for label, model_key, _, mod, tables, _, _, _ in main_paths:
        model = models[model_key]
        xT = encoded_xT(model, draw_requests(req[model_key], COMPARE_ROWS,
                                             rng))
        got = mod.score(tables, xT)
        torch.cuda.synchronize()
        want = mod.score_plain(tables, xT)
        F = model.binner.num_numerical
        oracle = forest_predict_values(
            model.forest, xT[:F].t().contiguous(),
            xT[F:].t().to(torch.int32).contiguous(),
            num_numerical=F, max_depth=model.max_depth,
        )[:, 0]
        max_err[label] = float((got - want).abs().max())
        assert torch.equal(got, want), (
            f"{label}: kernel != plain ({max_err[label]})")
        assert torch.equal(got, oracle), f"{label}: kernel != routed oracle"
        log("3 kernels", f"{label}: {COMPARE_ROWS} rows, "
            f"{model.forest.feature.shape[0]} trees, torch.equal to plain "
            "and to the routed oracle")

    # -- 4-5 main paths: load, predict, serve; then time the kernel ----- #
    counters = (quickscorer, bank_scorer)
    kernels = []
    for (label, name, forced, mod, tables, walk_tables, src,
         replaces) in main_paths:
        model = ydf_tpu_torch.load_model(paths[name])
        model.force_engine(forced)
        for c in counters:
            c.KERNEL_LAUNCHES = 0
        drive_path(model, name, forced, req[name], paths[name], rng)
        launches = {c.__name__: c.KERNEL_LAUNCHES for c in counters}
        for c in counters:
            want_used = c is mod
            assert (launches[c.__name__] > 0) == want_used, (
                f"{label}: launches {launches}")
        log("4-5 launches", f"{label}: {launches[mod.__name__]} launches "
            f"of {mod.__name__.rsplit('.', 1)[-1]} on this path, none of "
            "the other kernel")

        xT = encoded_xT(model, draw_requests(req[name], TIMING_ROWS, rng))
        t = measure(mod, tables, walk_tables, xT)
        max_err[label] = max(max_err[label], t["max_abs_err"])
        log("5 timing", f"{label} at {xT.shape[1]} rows x "
            f"{xT.shape[0]} features: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}; {t['detail']}), {smi}")
        kernels.append({
            "name": label, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[mod.__name__],
            "max_abs_err": max_err[label], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    torch.cuda.synchronize()
    kernels.extend(train_path(smi, serving=counters))
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


def drive_path(model, name, forced, stored, path, rng):
    """One main path through the user's entry points: predict on the
    stored rows against the JAX package's expected.npz, serving batches
    of every size in SERVE_BATCHES, and a stage split of the largest."""
    import torch

    engine = forced or "auto"
    exp = np.load(os.path.join(path, "expected.npz"))
    raw = model._raw_scores(stored, combine="sum")[:, 0]
    pred = model.predict(stored)
    assert np.array_equal(raw.view(np.int32), exp["raw"].view(np.int32)), (
        f"{name} {engine}: raw scores differ from JAX "
        f"(max {np.abs(raw - exp['raw']).max()})")
    np.testing.assert_allclose(pred, exp["predictions"], rtol=0, atol=1e-6)
    log("4 predict", f"{name} engine={engine}: {len(raw)} rows, raw bitwise "
        f"== JAX, predictions within 1e-6 "
        f"(max {np.abs(pred - exp['predictions']).max():.3g})")

    walls = []
    for rows in SERVE_BATCHES:
        batch = draw_requests(stored, rows, rng)
        t0 = time.perf_counter()
        pred = model.predict(batch)
        torch.cuda.synchronize()
        walls.append(f"{rows}:{(time.perf_counter() - t0) * 1e3:.3f}ms")
        assert pred.shape == (rows,) and np.isfinite(pred).all()
        if rows == COMPARE_ROWS:
            model.force_engine("Routed")
            routed = model.predict(batch)
            model.force_engine(forced)
            assert np.array_equal(pred, routed), f"{name} {engine}: != Routed"
    log("5 serve", f"{name} engine={engine} predict host wall (rows:ms) "
        + " ".join(walls))
    stages = predict_stages(model, draw_requests(stored, SERVE_BATCHES[-1],
                                                 rng))
    log("5 stages", f"{name} engine={engine} predict of {SERVE_BATCHES[-1]} "
        "rows, ms: " + " ".join(f"{k}={v:.3f}" for k, v in stages.items()))


def predict_stages(model, data):
    """Host-clock split of one predict (each stage ends in a
    synchronize): dataset wrap + host encoding, copy to the card,
    feature-major assembly, engine, copy back."""
    import torch

    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.serving.quickscorer import feature_major

    marks = [("start", time.perf_counter())]

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    x_num, x_cat = model._encode_inputs(Dataset.from_data(data,
                                                          model.dataspec))
    mark("encode")
    xn = torch.from_numpy(x_num).to(model.device)
    xc = torch.from_numpy(x_cat).to(model.device)
    mark("h2d")
    eng = model._fast_engine()
    xT = feature_major(xn, xc)
    mark("assemble")
    out = eng.score_xT(xT)
    mark("kernel")
    out.cpu().numpy()
    mark("d2h")
    return {name: (t - marks[i][1]) * 1e3
            for i, (name, t) in enumerate(marks[1:])}


def measure(mod, tables, walk_tables, xT, reps=20):
    """Kernel time (CUDA events, after warm-up), the plain version's
    time (once), their max abs difference, and the bound: the larger of
    bytes moved (inputs read once, output written once) over HBM
    bandwidth and the function's least work on these rows over the
    card's 32-bit scalar rate. The least work is the same for both
    kernels: the walk down each tree to the leaf this data reaches (a
    compare and a select per step, counted on `walk_tables`, the same
    model's bank tables) and one add per tree."""
    import torch

    from ydf_tpu_torch.serving import bank_scorer

    n = xT.shape[1]
    for _ in range(3):
        got = mod.score(tables, xT)
    torch.cuda.synchronize()
    ms = time_ms(lambda: mod.score(tables, xT), reps=reps)
    plain_ms = time_ms(lambda: mod.score_plain(tables, xT), reps=1)
    want = mod.score_plain(tables, xT)
    assert torch.equal(got, want), f"{mod.__name__} at {n} rows: != plain"
    nbytes = xT.numel() * 4 + table_bytes(tables) + n * 4
    T = walk_tables.feature.shape[0]
    depth = node_depths(walk_tables)
    steps = 0
    chunk = bank_scorer.PLAIN_ROW_CHUNK
    for r0 in range(0, n, chunk):
        leaves = bank_scorer.walk_plain(walk_tables, xT[:, r0:r0 + chunk])
        steps += int(depth.gather(1, leaves).sum())
    ops = 2 * steps + n * T
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms,
        "max_abs_err": float((got - want).abs().max()),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "detail": f"{nbytes} bytes -> {bytes_ms:.4f} ms, {ops} ops -> "
                  f"{ops_ms:.4f} ms",
    }


def node_depths(tables):
    """int64 [T, N] depth of every node reachable from the root."""
    import torch

    left = tables.left.cpu().numpy()
    right = tables.right.cpu().numpy()
    is_leaf = tables.is_leaf.cpu().numpy().astype(bool)
    depth = np.zeros(left.shape, np.int64)
    for t in range(left.shape[0]):
        stack = [0]
        while stack:
            k = stack.pop()
            if not is_leaf[t, k]:
                for c in (left[t, k], right[t, k]):
                    depth[t, c] = depth[t, k] + 1
                    stack.append(c)
    return torch.from_numpy(depth).to(tables.left.device)


# --------------------------------------------------------------------- #
# 6 train: the bench GBT trained on the card
# --------------------------------------------------------------------- #


def train_path(smi, serving):
    """Phase 6: returns the three training kernels' `kernels` entries."""
    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.ops import binning, histogram_kernels
    from ydf_tpu_torch.utils import cuda_build

    with open(os.path.join(TRAIN_BENCH, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["features"], cfg["learner"], cfg["data_seed"]) \
        == (TRAIN_ROWS, TRAIN_FEATURES, TRAIN_HP, DATA_SEED), cfg
    with open(os.path.join(TRAIN_BENCH, "binner.json")) as f:
        jax_binner = ydf_tpu_torch.binner_from_jax(json.load(f))
    jax_forest = dict(np.load(os.path.join(TRAIN_BENCH, "forest.npz")))
    exp = np.load(os.path.join(TRAIN_BENCH, "expected.npz"))
    t0 = time.perf_counter()
    data = make_data(TRAIN_ROWS, TRAIN_FEATURES)
    log("6 train", f"data {TRAIN_ROWS} x {TRAIN_FEATURES} (numpy "
        f"RandomState({DATA_SEED})) in {time.perf_counter() - t0:.2f} s; "
        f"JAX fixture impls {cfg['jax_impls']}")

    # -- 6a each training kernel against its plain version ------------- #
    inp = train_inputs(data, jax_binner)
    got = binning.bin_columns(*inp["binning"])
    torch.cuda.synchronize()
    assert torch.equal(got, binning.bin_columns_plain(*inp["binning"])), (
        "binning kernel != plain")
    assert sha256(got) == cfg["bins_sha256"], "bins != the JAX package's"
    log("6 kernels", f"binning {TRAIN_ROWS} x {TRAIN_FEATURES}: torch.equal "
        "to plain; SHA-256 of the bin matrix == the JAX package's")
    err = {"binning": 0.0}
    err["histogram"] = hist_check(
        histogram_kernels.histogram(*inp["root"]),
        histogram_kernels.histogram_plain(*inp["root"]),
        histogram_kernels.histogram_plain(*abs_stats(inp["root"], 2)),
        "root histogram")
    got = histogram_kernels.histogram_routed(*inp["routed"])
    want = histogram_kernels.histogram_routed_plain(*inp["routed"])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), (
        "routed kernel: new_slot / new_leaf != plain")
    err["histogram_routed"] = hist_check(
        got[0], want[0],
        histogram_kernels.histogram_routed_plain(
            *abs_stats(inp["routed"], 4))[0],
        "routed histogram")
    log("6 kernels", f"root histogram (L=1) and routed layer (L=32, Lh=16) "
        f"at {TRAIN_ROWS} rows: within {HIST_RTOL} x cell mass + "
        f"{HIST_ATOL} of plain (max abs {err['histogram']:.3g}, "
        f"{err['histogram_routed']:.3g}); new_slot, new_leaf torch.equal")

    # -- 6b the main path: train on the card -------------------------- #
    counted = {"histogram": None, "histogram_routed": None,
               "binning": None}
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    binning.KERNEL_LAUNCHES = 0
    for c in serving:
        c.KERNEL_LAUNCHES = 0
    cuda_build.LAUNCH_EVENTS = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **TRAIN_HP)
    model = learner.train(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    counted.update(histogram_kernels.LAUNCHES)
    counted["binning"] = binning.KERNEL_LAUNCHES
    serving_launches = {c.__name__: c.KERNEL_LAUNCHES for c in serving}
    T, depth = TRAIN_HP["num_trees"], TRAIN_HP["max_depth"]
    assert counted["histogram"] == T, counted
    assert counted["histogram_routed"] == T * (depth - 1), counted
    assert counted["binning"] >= 1, counted
    assert not any(serving_launches.values()), serving_launches
    kernel_ms = {k: 0.0 for k in counted}
    for name, start, end in events:
        kernel_ms[name] += start.elapsed_time(end)
    boost_ms = learner.last_timings["boost_s"] * 1e3
    log("6 launches", f"train_bench: {counted} launches; serving kernels "
        f"{serving_launches}")
    log("6 train", f"GradientBoostedTreesLearner(**{TRAIN_HP}).train: wall "
        f"{wall * 1e3:.1f} ms (host clock, ends in synchronize); stages "
        + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                   learner.last_timings.items())
        + "; kernel time (CUDA events) "
        + " ".join(f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f", sum {sum(kernel_ms.values()):.3f} ms = "
        f"{100 * sum(kernel_ms.values()) / (wall * 1e3):.2f}% of the wall, "
        f"{100 * (kernel_ms['histogram'] + kernel_ms['histogram_routed']) / boost_ms:.2f}% "
        f"of the boosting loop ({boost_ms:.1f} ms); {smi}")

    # -- 6c against the JAX package's run ------------------------------ #
    assert model.binner.boundaries.tobytes() == \
        jax_binner.boundaries.tobytes(), "boundaries != the JAX package's"
    from ydf_tpu_torch.dataset.dataset import Dataset

    bins = model.binner.transform(
        Dataset.from_data(data, dataspec=model.dataspec), model.device)
    assert sha256(bins) == cfg["bins_sha256"], "bins != the JAX package's"
    pf = model.forest.to_numpy()
    for field in ("feature", "threshold_bin", "left", "right", "is_leaf",
                  "num_nodes"):
        assert np.array_equal(pf[field][0], jax_forest[field][0]), (
            f"tree 0 {field} != the JAX package's")
    split = ~jax_forest["is_leaf"] | ~pf["is_leaf"]
    differ = split & ((pf["feature"] != jax_forest["feature"])
                      | (pf["threshold_bin"] != jax_forest["threshold_bin"])
                      | (pf["is_leaf"] != jax_forest["is_leaf"]))
    per_tree = differ.sum(axis=1)
    loss = np.asarray(model.training_logs["train_loss"], np.float32)
    loss_rel = np.abs(loss / exp["train_loss"] - 1)
    assert loss.shape == exp["train_loss"].shape
    assert loss_rel[-1] <= TRAIN_LOSS_RTOL, (loss[-1], exp["train_loss"][-1])
    x, _ = synth_higgs_chunk(np.random.RandomState(REQUEST_SEED),
                             TRAIN_REQUEST_ROWS, TRAIN_FEATURES)
    req = {f"f{i}": x[:, i] for i in range(TRAIN_FEATURES)}
    raw = model._raw_scores(req, combine="sum")[:, 0] \
        + model.initial_predictions[0]
    raw_exp = exp["raw"] + exp["initial_predictions"][0]
    pred = model.predict(req)
    served = {c.__name__.rsplit(".", 1)[-1]: c.KERNEL_LAUNCHES
              for c in serving}
    assert sum(served.values()) > 0, "predict did not reach a serving kernel"
    assert raw.shape == raw_exp.shape and np.isfinite(raw).all()
    raw_err = np.abs(raw - raw_exp)
    assert raw_err.max() <= RAW_SCORE_ATOL, raw_err.max()
    assert raw_err.mean() <= RAW_SCORE_MEAN_ATOL, raw_err.mean()
    assert np.all((pred >= 0) & (pred <= 1))
    log("6 vs JAX", f"boundaries and bins bitwise == JAX; tree 0 == JAX; "
        f"split nodes differing from JAX over {T} trees: "
        f"{int(per_tree.sum())} (per tree {per_tree.tolist()}); final "
        f"train loss {loss[-1]:.7f} vs {exp['train_loss'][-1]:.7f} (rel "
        f"{loss_rel[-1]:.2e} <= {TRAIN_LOSS_RTOL}; max over iterations "
        f"{loss_rel.max():.2e}); initial prediction "
        f"{model.initial_predictions[0]:.9g} vs "
        f"{exp['initial_predictions'][0]:.9g}; raw scores on "
        f"{TRAIN_REQUEST_ROWS} fresh rows: max abs {raw_err.max():.3g} "
        f"(<= {RAW_SCORE_ATOL}), mean {raw_err.mean():.3g} (<= "
        f"{RAW_SCORE_MEAN_ATOL}); predictions max abs "
        f"{np.abs(pred - exp['predictions']).max():.3g}; the trained model "
        f"served through {served}")

    # -- 6d where the boosting loop's time goes (torch.profiler) ------- #
    prof = profile_train(data)
    log("6 profile", f"one more train under torch.profiler (the profiler "
        f"slows the host): wall {prof['wall_ms']:.1f} ms, boosting loop "
        f"{prof['loop_ms']:.1f} ms; {prof['kernels']} device kernels, "
        f"{prof['busy_ms']:.3f} ms of device time over the whole train, so "
        f"the device is idle at least {100 * prof['idle_share']:.1f}% of "
        f"the loop; largest: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms" for name, ms in prof["top"]))

    # -- 6e each training kernel timed at the path's shapes ------------ #
    out = []
    for name, src, replaces in (
        ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
        ("histogram", "histogram.cu", "ydf_tpu/ops/histogram_pallas.py:81"),
        ("histogram_routed", "histogram_routed.cu",
         "ydf_tpu/ops/histogram_pallas.py:172"),
    ):
        t = measure_train(name, inp)
        log("6 timing", f"{name} ({t['shape']}): kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.3f} ms, library "
            f"{t['library_ms'] if t['library_ms'] is None else round(t['library_ms'], 4)} "
            f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
            f"{t['detail']}), {smi}")
        out.append({
            "name": f"{name}/train_bench", "route": "cuda",
            "source": f"ydf_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": counted[name], "max_abs_err": err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    return out


def profile_train(data):
    """One training of train_bench under torch.profiler: device time by
    kernel name, the number of device kernels, and the device's idle
    share of the boosting loop, bounded from below by 1 - (device time
    of the whole train) / (loop wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import ydf_tpu_torch

    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **TRAIN_HP)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.train(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, kernels = {}, 0
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", 0.0)
        if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + dev_us / 1e3
            kernels += e.count
    busy = sum(by_name.values())
    loop_ms = learner.last_timings["boost_s"] * 1e3
    assert kernels > 0, "the profiler saw no device kernel"
    return {
        "wall_ms": wall * 1e3, "loop_ms": loop_ms, "kernels": kernels,
        "busy_ms": busy, "idle_share": max(0.0, 1 - busy / loop_ms),
        "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:6],
    }


def sha256(t):
    import hashlib

    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def abs_stats(args, i):
    """The same call with |stats| at argument position i: the cell mass
    that bounds an f32 sum's rounding."""
    args = list(args)
    args[i] = args[i].abs()
    return tuple(args)


def hist_check(got, want, mass, what):
    """Max abs difference of an f32 histogram from its plain version,
    after asserting every cell is within HIST_RTOL x mass + HIST_ATOL."""
    import torch

    torch.cuda.synchronize()
    diff = (got - want).abs()
    assert torch.all(diff <= HIST_RTOL * mass + HIST_ATOL), (
        f"{what}: kernel != plain beyond tolerance ({float(diff.max())})")
    return float(diff.max())


def train_inputs(data, binner):
    """The training kernels' inputs at the path's shapes, on the card:
    binning of every training value; the root histogram (one slot, the
    first tree's binomial stats); the deepest fused layer (the previous
    layer's 16 splits into 32 slots, each split's smaller child on one
    of Lh = 16 hist slots), with seeded tables over the real bins."""
    import torch

    from ydf_tpu_torch.learners.losses import BinomialLogLikelihood
    from ydf_tpu_torch.ops.binning import bin_columns
    from ydf_tpu_torch.ops.histogram_kernels import RouteTables

    dev = torch.device(DEVICE)
    F, n = TRAIN_FEATURES, TRAIN_ROWS
    Fn = binner.num_numerical
    values = np.stack([data[name] for name in binner.feature_names[:Fn]])
    bin_args = (
        torch.from_numpy(values).to(dev),
        torch.from_numpy(binner.boundaries[:Fn]).to(dev),
        torch.from_numpy(binner.feature_num_bins[:Fn] - 1).to(dev),
        torch.from_numpy(binner.impute_values[:Fn]).to(dev),
    )
    bins_t = bin_columns(*bin_args).t().contiguous()
    B = binner.num_bins
    # The first tree's stats, [g w, h w, w] at the initial prediction.
    loss = BinomialLogLikelihood()
    y = torch.from_numpy(data["label"].astype(np.float32)).to(dev)
    w = torch.ones(n, device=dev)
    preds = loss.initial_predictions(y, w).expand(n)
    g, h = loss.grad_hess(y, preds)
    stats = torch.stack([g * w, h * w, w], dim=1).contiguous()
    root = (bins_t, torch.zeros(n, dtype=torch.int32, device=dev), stats,
            1, B)
    L, Lh, N = 32, 16, 127
    rng = np.random.default_rng(6)
    do_split = np.zeros(L + 1, bool)
    do_split[:Lh] = True
    split_rank = np.where(do_split, np.arange(L + 1), 0).astype(np.int32)
    cut = rng.integers(32, 224, L + 1)
    left_id = np.where(do_split, 31 + 2 * np.arange(L + 1), N)
    small_left = rng.uniform(size=Lh) < 0.5
    hmap = np.full(L + 1, Lh, np.int32)
    hmap[2 * np.arange(Lh)] = np.where(small_left, np.arange(Lh), Lh)
    hmap[2 * np.arange(Lh) + 1] = np.where(small_left, Lh, np.arange(Lh))
    tables = RouteTables(*(torch.from_numpy(a).to(dev) for a in (
        do_split, rng.integers(0, F, L + 1).astype(np.int32),
        np.arange(B)[None, :] <= cut[:, None], left_id.astype(np.int32),
        np.where(do_split, left_id + 1, N).astype(np.int32), split_rank,
        hmap, np.zeros(L + 1, bool), np.zeros(1, np.uint8),
    )))
    slot = np.where(rng.uniform(size=n) < 0.03, L,
                    rng.integers(0, Lh, n)).astype(np.int32)
    leaf = rng.integers(15, 31, n).astype(np.int32)
    routed = (bins_t, torch.from_numpy(slot).to(dev),
              torch.from_numpy(leaf).to(dev), tables, stats, Lh, B)
    return {"binning": bin_args, "root": root, "routed": routed}


def measure_train(name, inp, reps=20):
    """Kernel time (CUDA events, after warm-up), the plain version's time
    (once, after one call), the library call's time, and the bound: the
    larger of the bytes the function must move (inputs read once,
    outputs written once) over HBM bandwidth and its least operations
    on these inputs over the card's 32-bit scalar rate."""
    import torch

    from ydf_tpu_torch.ops import binning, histogram_kernels

    if name == "binning":
        args = inp["binning"]
        kernel = lambda: binning.bin_columns(*args)  # noqa: E731
        plain = lambda: binning.bin_columns_plain(*args)  # noqa: E731
        values, bounds, nb, impute = args
        F, n = values.shape
        v = torch.where(torch.isnan(values), impute[:, None], values)
        library = lambda: torch.searchsorted(bounds, v, right=True)  # noqa
        nbytes = (values.numel() * 4 + bounds.numel() * 4 + F * 8 + n * F)
        # A binary search over nb boundaries: ceil(log2(nb + 1)) compares.
        steps = np.ceil(np.log2(nb.cpu().numpy().astype(np.float64) + 1))
        ops = int(n * steps.sum())
        shape = f"{n} x {F} values"
    elif name == "histogram":
        bins_t, slot, stats, L, B = args = inp["root"]
        kernel = lambda: histogram_kernels.histogram(*args)  # noqa: E731
        plain = lambda: histogram_kernels.histogram_plain(*args)  # noqa
        F, n = bins_t.shape
        S = stats.shape[1]
        idx, src = fused_index(bins_t, slot, stats, B)
        library = lambda: torch.zeros(  # noqa: E731
            (L * F * B, S), device=stats.device).index_add_(0, idx, src)
        live = n
        nbytes = bins_t.numel() + n * 4 + stats.numel() * 4 + L * F * B * S * 4
        ops = live * F * S
        shape = f"n={n}, F={F}, B={B}, L={L}, S={S}"
    else:
        args = inp["routed"]
        bins_t, slot, leaf, tables, stats, Lh, B = args
        kernel = lambda: histogram_kernels.histogram_routed(*args)  # noqa
        plain = lambda: histogram_kernels.histogram_routed_plain(*args)  # noqa
        library = None
        F, n = bins_t.shape
        S = stats.shape[1]
        hist_slot = histogram_kernels.route_plain(bins_t, slot, leaf,
                                                  tables)[2]
        live = int((hist_slot < Lh).sum())
        table_b = sum(t.numel() * t.element_size() for t in tables)
        # bins, slot, leaf, stats, tables in; hist, new slot, new leaf out.
        nbytes = (bins_t.numel() + n * 4 * 2 + stats.numel() * 4 + table_b
                  + Lh * F * B * S * 4 + n * 4 * 2)
        # One add per (live row, feature, stat); per row a slot read, the
        # split test, the go-left bit and the child and hist-slot selects.
        ops = live * F * S + 6 * n
        shape = f"n={n}, F={F}, B={B}, L={tables.do_split.shape[0] - 1}, " \
            f"Lh={Lh}, S={S}, live rows {live}"
    for _ in range(3):
        kernel()
    torch.cuda.synchronize()
    ms = time_ms(kernel, reps=reps)
    plain()
    plain_ms = time_ms(plain, reps=1)
    library_ms = None
    if library is not None:
        library()
        library_ms = time_ms(library, reps=reps)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "detail": f"{nbytes} bytes -> {bytes_ms:.4f} ms, {ops} ops -> "
                  f"{ops_ms:.4f} ms", "shape": shape,
    }


def fused_index(bins_t, slot, stats, B):
    """The library call's operands: the fused (slot, feature, bin) index
    of every (row, feature) and its stats rows, [F*n] and [F*n, S]."""
    import torch

    F, n = bins_t.shape
    f = torch.arange(F, device=bins_t.device)[:, None]
    idx = ((slot.long()[None, :] * F + f) * B + bins_t.long()).reshape(-1)
    src = stats[None].expand(F, n, stats.shape[1]).reshape(-1,
                                                            stats.shape[1])
    return idx, src.contiguous()


if __name__ == "__main__":
    sys.exit(main())
