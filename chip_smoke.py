"""Chip smoke of ydf_tpu_torch, the PyTorch/CUDA port: builds its CUDA
kernels, checks each against its plain PyTorch version at full width,
serves the committed fixture models through `load_model(...).predict`
on the card, times each kernel, and prints one JSON summary.

    python3 chip_smoke.py        # needs one CUDA card and nvcc

Phases (one line each; any failure is an uncaught exception):
  1 device    card name, count, nvidia-smi name and power limit
  2 build     nvcc for sm_90a, seconds, ptxas registers / shared memory
  3 kernels   each kernel == its plain version (torch.equal) on 4096 rows
              of the 300-tree default GBT (QuickScorer, BankScorer) and
              the 50-tree depth-8 GBT (BankScorer)
  4 predict   load_model + predict on the stored rows == the JAX
              package's expected.npz (raw bitwise, predictions 1e-6)
  5 serve     requests of 1 .. 1,048,576 rows; then the path's kernel
              timed alone with CUDA events at 1,048,576 rows

Phases 4-5 run once per main path: gbt_d6 with the registry's choice
(QuickScorer), gbt_d6 with BankScorer forced, and gbt_d8 (BankScorer).
The launch counters are set to 0 just before each path and read just
after it; phase 3 and the timing launches do not count. The `kernels`
line has one entry per path.
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
    secs = cuda_build.build_all(["quickscorer", "bank_scorer"], force=True)
    ptxas = []
    for name, text in cuda_build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                ptxas.append(f"{name}: {line.strip()}")
    log("2 build", f"nvcc sm_90a, 2 sources in parallel, {secs:.2f} s; "
        + " | ".join(ptxas))

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


if __name__ == "__main__":
    sys.exit(main())
