"""Chip smoke of ydf_tpu_torch, the PyTorch/CUDA port: builds its CUDA
kernels, checks each against its plain PyTorch version at full width,
serves the committed fixture models through `load_model(...).predict`
on the card, trains the bench GBT, a GBT on vector sequences and the
library's default GBT on the card through
`GradientBoostedTreesLearner(...).train`, evaluates, saves and loads
the last, times each kernel, and prints one JSON summary.

    python3 chip_smoke.py        # needs one CUDA card and nvcc

Phases (one line each; any failure is an uncaught exception):
  1 device    card name, count, nvidia-smi name and power limit
  2 build     nvcc for sm_90a (all six sources in parallel), seconds,
              ptxas registers / shared memory / spills (per kernel for the
              histogram and binning sources); the shared atomics the two
              histogram sources compile to (cuobjdump -sass)
  3 kernels   each serving kernel == its plain version (torch.equal) on
              4096 rows of the 300-tree default GBT (QuickScorer,
              BankScorer) and the 50-tree depth-8 GBT (BankScorer), the
              bank in both its walks; the bank on synthetic forests, ==
              plain and the routed oracle in both walks: one whose first
              tree is too large for a shared tree block (walked in global
              memory), one whose feature and node ids pass a narrow
              record's 30 bits and one whose trees share a subtree (both
              packed in wide records)
  4 predict   load_model + predict on the stored rows == the JAX
              package's expected.npz (raw bitwise, predictions 1e-6)
  5 serve     requests of 1 .. 1,048,576 rows; the path's kernel time
              (CUDA events around each launch, each launch's rows and
              time logged) and its launches weighted by their rows; then
              the kernel timed alone at 1,048,576 rows; the registry's
              order held against the card's (QuickScorer and the bank on
              gbt_d6)
  6 train     the bench GBT (500,000 rows x 28 features, 20 trees,
              depth 6) trained on the card: each training kernel against
              its plain version at the path's shapes (binning in both
              layouts; the root histogram also on a pile-up case, 12% of
              200,000 rows in bin 0 of 36 features), then the training
              itself held against the JAX package's run (the committed
              ydf_tpu_torch/testdata/train_bench fixture), then one more
              training under torch.profiler (device time, idle share of
              the boosting loop), then each training kernel timed with
              CUDA events, the routed kernel at each hist-slot count of
              the path
  7 vs        the vector-sequence paths (ydf_tpu_torch/testdata/train_vs,
              the JAX package's run of its GBT on make_vs_data: 200,000
              rows, sequences of up to 16 vectors of 16, 20 trees, depth
              6): the scoring kernel against its plain version at the
              training shape and at ragged shapes (D = 1, 3, 5, 40 among
              them: the generic instantiation), bitwise; serve_vs, the JAX
              model loaded and served on 1024 fresh rows against the JAX
              package's scores, and the kernel against its plain version
              on the serve path's own inputs; train_vs, the same GBT
              trained on the card
              against the JAX run (anchors bitwise, tree 0, losses, raw
              scores); then each kernel timed at the path's shapes
  8 default   train_default (ydf_tpu_torch/testdata/train_default, the
              JAX package's GradientBoostedTreesLearner(label="label")
              with every default on make_frame: 500,000 rows, 28
              numerical and 4 categorical columns, evaluated on 100,000
              fresh rows): the frames' SHA-256; the main path (train with
              the validation split, look-ahead early stopping and
              categorical splits, then evaluate) with its launches, host
              reads and stage walls; against the JAX run (bins and
              validation rows bitwise, the kept and trained tree counts,
              tree 0 with its categorical masks, losses, raw scores,
              evaluate's metrics); the JAX model loaded and evaluated on
              the card; save -> load; the routed kernel against its plain
              version on the path's categorical tables; a profiled train
              of 50 trees (the device's idle share); each of the path's
              kernels timed at its shapes

Phases 4-5 run once per serving path: gbt_d6 with the registry's choice
(BankScorer), gbt_d6 with QuickScorer forced, and gbt_d8 (BankScorer);
phase 6 is the training path, phase 7 the serve_vs and train_vs paths,
phase 8 the default train path (train, then evaluate).
The launch counters are set to 0 just before each path and read just
after it; phase 3, the comparisons and the timing launches do not count.
The `kernels` line has one entry per (kernel, path). Each timing gives a
call's time (CUDA events around calls back to back: host work included)
and its device time (torch.profiler: the sum of the kernels, memsets and
copies one call launches), and the same two for the library call; each
entry also has `path_ms`, the kernel's CUDA-event time summed over the
path's launches (the serving kernels add their launches weighted by
rows, the routed kernel its numbers at each hist-slot count).
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
# The vector-sequence path (train_vs): the JAX package's GBT at its
# default anchor counts on make_vs_data. VS_RADIUS puts about half of the
# labels at 1.
TRAIN_VS = os.path.join(TESTDATA, "train_vs")
VS_ROWS = 200_000
VS_MAX_LEN = 16
VS_DIM = 16
VS_NOISE = 4
VS_RADIUS = 11.75
# Score tolerance of the comparisons of vector-sequence scores with the
# JAX package's (the kernel equals its plain version bitwise): |difference|
# <= VS_RTOL * M + VS_ATOL,
# M = max over the row's vectors of |v|^2 + |a|^2 + 2|v||a|.
VS_RTOL = 1e-5
VS_ATOL = 1e-6
# serve_vs: a raw score may differ from the JAX package's beyond 1e-5
# only on a row whose VS score sits within VS_RTOL * M of a threshold on
# its path, and on at most this share of the rows.
VS_SERVE_ATOL = 1e-5
VS_MAX_EXPLAINED = 0.005
VS_THRESHOLD_ULPS = 4
# The default train path (train_default): the JAX package's
# GradientBoostedTreesLearner(label="label") with every default, on
# make_frame's recipe (the 28 numerical columns of make_data with NaNs in
# three of them, four categorical columns), evaluated on fresh rows.
TRAIN_DEFAULT = os.path.join(TESTDATA, "train_default")
DEFAULT_ROWS = 500_000
DEFAULT_TEST_ROWS = 100_000
DEFAULT_CAT_SEED = 7
DEFAULT_CAT_VOCABS = (5, 12, 40, 200)
DEFAULT_MISSING = (0, 5, 11)
DEFAULT_HP = dict(label="label")
DEFAULT_COMPARE_ROWS = 1024
# train_default: evaluate() of the card-trained model against the JAX
# model's metrics on the test rows (a few split flips move them a
# little); the JAX model loaded by the port evaluates to within
# EVAL_SAME_ATOL of the JAX package's own evaluation.
EVAL_ATOL = 2e-3
EVAL_SAME_ATOL = 1e-12
# Trees of phase 8's profiled train: two chunks of the look-ahead stop.
PROFILE_TREES = 50
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


def make_frame(train_rows, test_rows, seed=DEFAULT_CAT_SEED):
    """scripts/make_torch_port_fixtures.py:make_frame with the test rows'
    labels kept: (train, test) columns; numerical f32 (NaNs in
    DEFAULT_MISSING), categorical unicode with some signal about the
    label, an int label; the test rows carry unseen ("unseen") and
    missing ("") categories."""
    n = train_rows + test_rows
    data = make_data(n, TRAIN_FEATURES)
    y = data["label"]
    rng = np.random.default_rng(seed)
    for j, vocab in enumerate(DEFAULT_CAT_VOCABS):
        code = rng.integers(0, vocab, n)
        # Positive rows favour the lower third of the vocabulary.
        skew = (y == 1) & (rng.uniform(size=n) < 0.4)
        code = np.where(skew, code % max(vocab // 3, 1), code)
        data[f"c{j}"] = np.array([f"v{c}" for c in code])
    for i in DEFAULT_MISSING:
        miss = rng.uniform(size=n) < 0.03
        data[f"f{i}"] = np.where(miss, np.nan, data[f"f{i}"]).astype(
            np.float32)
    train = {k: v[:train_rows] for k, v in data.items()}
    test = {k: v[train_rows:].copy() for k, v in data.items()}
    for j in range(len(DEFAULT_CAT_VOCABS)):
        col = test[f"c{j}"].astype("<U8")
        col[rng.uniform(size=test_rows) < 0.05] = "unseen"
        col[rng.uniform(size=test_rows) < 0.03] = ""
        test[f"c{j}"] = col
    return train, test


def frame_sha256(frame):
    """SHA-256 of a frame's columns: names, dtypes, shapes and bytes, in
    name order."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(frame):
        a = np.ascontiguousarray(frame[name])
        h.update(f"{name}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def make_vs_data(rows, max_len=VS_MAX_LEN, dim=VS_DIM, noise=VS_NOISE,
                 radius=VS_RADIUS, seed=DATA_SEED):
    """The train_vs task, modelled on the JAX package's
    tests/test_vector_sequence.py:_closer_task: column "seq" of
    vector sequences (2% missing cells, 8% empty sequences, the rest of
    uniform length 1..max_len with N(0, 1) vectors of `dim`), `noise`
    N(0, 1) columns x0.., and "label" = 1 where the sequence holds a
    vector within squared distance `radius` of
    c = linspace(-0.8, 0.8, dim). numpy RandomState(seed)."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(size=rows)
    missing = u < 0.02
    empty = (u >= 0.02) & (u < 0.10)
    lens = rng.randint(1, max_len + 1, size=rows)
    lens[missing | empty] = 0
    flat = rng.normal(size=(int(lens.sum()), dim)).astype(np.float32)
    x = rng.normal(size=(rows, noise)).astype(np.float32)
    c = np.linspace(-0.8, 0.8, dim).astype(np.float32)
    d2 = ((flat - c) ** 2).sum(axis=1)
    ends = np.cumsum(lens)
    nonempty = lens > 0
    near = np.zeros(rows, bool)
    near[nonempty] = np.minimum.reduceat(d2, (ends - lens)[nonempty]) < radius
    seq = np.empty(rows, dtype=object)
    for i in range(rows):
        seq[i] = None if missing[i] else flat[ends[i] - lens[i]:ends[i]]
    data = {"seq": seq}
    data.update({f"x{j}": x[:, j] for j in range(noise)})
    data["label"] = near.astype(np.int64)
    return data


# Synthetic forests for the bank kernel (tests/test_torch_bank_vs_redesign.py
# uses them too): trees, numerical and categorical features, mask words,
# share of categorical splits, leaves a tree (cycled over the trees; 0:
# random in 2..200), chain trees (one child of every split a leaf), and
# the max_depth the walk stops at.
BANK_FORESTS = {
    "mixed": (23, 6, 3, 2, 0.4, (0, 1, 2, 0), False, 12),
    # Unbalanced deep trees, cut at max_depth.
    "chain": (5, 4, 2, 8, 0.5, (60, 3, 45), True, 40),
    # W = 0: a categorical split sends every code right.
    "numerical": (17, 7, 2, 0, 0.2, (0, 0, 1), False, 10),
    # Its first tree is larger than a shared tree block (TREE_BLOCK_BYTES).
    "oversize": (6, 8, 4, 8, 0.5, (1500, 0, 0, 0, 0, 0), False, 40),
    # Feature ids of 15 bits and a tree of about 40,000 nodes (16 bits):
    # past a narrow record's 30 bits, packed wide.
    "wide": (2, 16_390, 3, 2, 0.4, (20_000, 40), False, 64),
    # "mixed" with both sides of each root split sent to its left
    # subtree: nodes reached twice, not trees, packed wide.
    "shared": (23, 6, 3, 2, 0.4, (0, 1, 2, 0), False, 12),
}


def bank_forest(name, seed=0):
    """A BANK_FORESTS forest as numpy arrays in the JAX package's layout
    (Forest.to_numpy()): each tree's nodes at shuffled positions below its
    node count (the root at 0), unreachable junk nodes after them,
    finite thresholds everywhere, leaf values 0 at internal nodes."""
    T, Fn, Fc, W, cat_share, leaf_counts, chain, _ = BANK_FORESTS[name]
    rng = np.random.default_rng(seed)
    trees = []
    for t in range(T):
        k = leaf_counts[t % len(leaf_counts)] or int(rng.integers(2, 201))
        nodes = []  # [feature, threshold, is_cat, mask, left, right, value]

        def build(k):
            i = len(nodes)
            nodes.append(None)
            if k == 1:
                nodes[i] = [-1, 0.0, False, np.zeros(W, np.uint32), 0, 0,
                            float(rng.normal())]
                return i
            # A chain's split sends most examples on down its left side.
            kl = k - 1 if chain else int(rng.integers(1, k))
            left, right = build(kl), build(k - kl)
            cat = Fc > 0 and rng.uniform() < cat_share
            mask = rng.integers(0, 2**32, W, dtype=np.uint64).astype(
                np.uint32)
            nodes[i] = [Fn + int(rng.integers(0, Fc)) if cat
                        else int(rng.integers(0, Fn)),
                        0.0 if cat else 2.5 if chain else float(
                            rng.normal()), cat,
                        (mask | np.uint32(0xFFFFFFFE) if chain else mask)
                        if cat else np.zeros(W, np.uint32),
                        left, right, 0.0]
            return i

        build(k)
        trees.append(nodes)
    N = max(len(nodes) for nodes in trees) + 3
    f = {
        "feature": np.full((T, N), -1, np.int32),
        "threshold": rng.normal(size=(T, N)).astype(np.float32),
        "threshold_bin": np.zeros((T, N), np.int32),
        "is_cat": np.zeros((T, N), bool),
        "is_set": np.zeros((T, N), bool),
        "cat_mask": rng.integers(0, 2**32, (T, N, W), dtype=np.uint64
                                 ).astype(np.uint32),
        "left": rng.integers(0, N, (T, N)).astype(np.int32),
        "right": rng.integers(0, N, (T, N)).astype(np.int32),
        "is_leaf": rng.uniform(size=(T, N)) < 0.5,
        "na_left": np.zeros((T, N), bool),
        "leaf_value": rng.normal(size=(T, N, 1)).astype(np.float32),
        "cover": np.ones((T, N), np.float32),
        "oblique_weights": np.zeros((T, 0, 0), np.float32),
        "oblique_na_repl": np.zeros((T, 0, 0), np.float32),
        "vs_anchor": np.zeros((T, 0, 0), np.float32),
        "vs_feat": np.zeros((T, 0), np.int32),
        "vs_is_closer": np.zeros((T, 0), bool),
        "num_nodes": np.array([len(nodes) for nodes in trees], np.int32),
    }
    for t, nodes in enumerate(trees):
        pos = np.r_[0, 1 + rng.permutation(len(nodes) - 1)]
        for i, (feat, thr, cat, mask, left, right, value) in enumerate(nodes):
            k = pos[i]
            leaf = feat < 0
            f["feature"][t, k] = feat
            f["threshold"][t, k] = thr
            f["is_cat"][t, k] = cat
            f["cat_mask"][t, k] = mask
            f["is_leaf"][t, k] = leaf
            f["left"][t, k] = 0 if leaf else pos[left]
            f["right"][t, k] = 0 if leaf else pos[right]
            f["leaf_value"][t, k, 0] = value
    if name == "shared":
        split = ~f["is_leaf"][:, 0]
        f["right"][split, 0] = f["left"][split, 0]
    return f


def both_walks(fn):
    """[fn() in the bank's split walk, fn() in its per-thread walk],
    whatever the rows (bank_scorer.SPLIT_BELOW_ROWS set for each call)."""
    from ydf_tpu_torch.serving import bank_scorer

    keep = bank_scorer.SPLIT_BELOW_ROWS
    try:
        out = []
        for below in (1 << 62, 0):
            bank_scorer.SPLIT_BELOW_ROWS = below
            out.append(fn())
        return out
    finally:
        bank_scorer.SPLIT_BELOW_ROWS = keep


def bank_inputs(name, n, seed=1, inside=False):
    """x_num f32 [n, Fn] with 5% NaN and x_cat i32 [n, Fc] for a
    BANK_FORESTS forest: codes from -3 to 40 past the mask words' 32 W, or,
    with `inside`, within [0, 32 W), where the routed engine's test (a
    negative code takes na_left, a word past W reads as ones) and the
    bank's agree."""
    _, Fn, Fc, W, _, _, _, _ = BANK_FORESTS[name]
    rng = np.random.default_rng(seed)
    x_num = rng.normal(size=(n, Fn)).astype(np.float32)
    x_num[rng.uniform(size=x_num.shape) < 0.05] = np.nan
    lo, hi = (0, 32 * W) if inside else (-3, 32 * max(W, 1) + 40)
    return x_num, rng.integers(lo, hi, (n, Fc)).astype(np.int32)


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


# The CUDA kernels one call of each wrapper launches, once each (names
# as the profiler shows them contain these).
KERNELS_OF = {
    "quickscorer": ("qs_score_kernel",),
    "bank_scorer": ("bank_walk_kernel",),  # at TIMING_ROWS; fewer rows
                                           # launch bank_split_kernel
    "histogram": ("hist_kernel", "reduce_partials"),
    "histogram_routed": ("routed_kernel", "reduce_partials"),
    "binning": ("bin_feature_major",),
    "vector_sequence": ("vs_kernel",),
}


def device_ms(fn, kernels=(), reps=10, warm=3):
    """Device time of one call of `fn` from torch.profiler over `warm` +
    `reps` calls: for each CUDA kernel, memset or copy, its mean time
    per record times the times one call launches it (its count over the
    calls, rounded, so a stray record counts for nothing). The profiler
    drops records now and then, the window's first most often (hence
    the `warm` calls): a profile counts only if each of `kernels` (name
    parts of the kernels one call launches, KERNELS_OF for a wrapper)
    shows at least `reps` times, and is taken again if not. Returns (ms,
    how). Without such a profile it falls back to CUDA events around
    each call alone, which also bracket the call's host work while the
    card waits: an upper bound, marked so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls = warm + reps
    seen = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        recs = [e for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and getattr(e, "device_time_total", 0.0) > 0]
        seen = {k: sum(e.count for e in recs if k in e.key)
                for k in kernels}
        if not recs or min(seen.values(), default=reps) < reps:
            continue
        busy_us = sum(e.device_time_total / e.count
                      * round(e.count / calls) for e in recs)
        return busy_us / 1e3, "profiler"
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    counts = ", ".join(f"{k} {c} of {calls}" for k, c in seen.items())
    return total / reps, ("events, an upper bound; last profile: "
                          f"{counts or 'no device records'}")


def shared_atomics_finding(cuda_build):
    """What shared-memory atomics the two histogram sources compile to on
    sm_90a, read from the SASS (cuobjdump -sass). Both add float stats in
    tag rounds (no float atomics) and int8 stats with int32 atomicAdd;
    histogram_routed.cu also ranks rows with int32 atomics. An f64 shared
    atomicAdd would show as a 64-bit compare-and-swap loop
    (ATOMS.CAST.SPIN.64). scripts/bench_shared_adds.py times the f32
    ways."""
    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()),
                        "cuobjdump")
    if not os.path.isfile(tool):
        return f"cuobjdump not found beside nvcc ({tool}): SASS not read"
    found, cas64 = [], False
    for name in ("histogram_routed", "histogram"):
        sass = subprocess.run(
            [tool, "-sass", cuda_build.library_path(name)],
            capture_output=True, text=True, timeout=120, check=True,
        ).stdout
        ops = sorted({tok.rstrip(" ;") for line in sass.splitlines()
                      for tok in line.split() if tok.startswith("ATOMS")})
        found.append(f"{name}: {ops or 'no shared atomics'}")
        cas64 = cas64 or any("CAS" in op and "64" in op for op in ops)
    verdict = ("a 64-bit compare-and-swap loop remains" if cas64 else
               "no 64-bit compare-and-swap loop")
    return f"{verdict} ({'; '.join(found)})"


def pileup_case(n=200_000, F=36, B=256, frac=0.12, seed=12):
    """The root histogram at train_vs's width with frac of the rows in
    bin 0 of every feature (empty vector sequences pile up there):
    bins_t u8 [F, n], slot i32 [n] (all 0), integer-valued stats f32
    [n, 3] in -8..8, and real-valued f32 stats [n, 3], on the card."""
    import torch

    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (F, n)).astype(np.uint8)
    bins[:, rng.uniform(size=n) < frac] = 0
    dev = torch.device(DEVICE)
    ints = rng.integers(-8, 9, (n, 3)).astype(np.float32)
    real = rng.normal(size=(n, 3)).astype(np.float32)
    return (torch.from_numpy(bins).to(dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.from_numpy(ints).to(dev), torch.from_numpy(real).to(dev))


def pileup_check():
    """The pile-up case against the plain version: integer-valued stats
    bitwise in f32, bf16 and int8; real f32 stats within HIST_RTOL x cell
    mass + HIST_ATOL. Returns the real stats' max abs difference."""
    import torch

    from ydf_tpu_torch.ops import histogram_kernels as hk

    bins_t, slot, ints, real = pileup_case()
    B = 256
    for stats in (ints, ints.to(torch.bfloat16), ints.to(torch.int8)):
        got = hk.histogram(bins_t, slot, stats, 1, B)
        torch.cuda.synchronize()
        assert torch.equal(got, hk.histogram_plain(bins_t, slot, stats, 1,
                                                   B)), (
            f"pile-up {stats.dtype}: kernel != plain")
    return hist_check(
        hk.histogram(bins_t, slot, real, 1, B),
        hk.histogram_plain(bins_t, slot, real, 1, B),
        hk.histogram_plain(bins_t, slot, real.abs(), 1, B),
        "pile-up f32")


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
               "binning", "vector_sequence"]
    secs = cuda_build.build_all(sources, force=True)
    # ptxas's registers, shared memory and spills of each entry function,
    # after the (mangled) name ptxas prints before them.
    ptxas, entry = [], ""
    for name, text in cuda_build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "Used" in line or "spill" in line:
                ptxas.append(f"{name} {entry}: {line.strip()}")
    log("2 build", f"nvcc sm_90a, {len(sources)} sources in parallel, "
        f"{secs:.2f} s; " + " | ".join(ptxas))
    log("2 sass", shared_atomics_finding(cuda_build))

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
        ("bank_scorer/gbt_d6", "gbt_d6", None, bank_scorer, bank6.tables,
         bank6.tables, "ydf_tpu_torch/csrc/bank_scorer.cu",
         "ydf_tpu/serving/pallas_scorer.py:118"),
        ("quickscorer/gbt_d6/forced", "gbt_d6", "QuickScorer", quickscorer,
         qs6.tables, bank6.tables, "ydf_tpu_torch/csrc/quickscorer.cu",
         "ydf_tpu/serving/quickscorer.py:232"),
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
        walks = ""
        if mod is bank_scorer:  # both walks, whichever the rows pick
            for walk, got in zip(("split", "per-thread"), both_walks(
                    lambda: mod.score(tables, xT))):
                assert torch.equal(got, want), f"{label} {walk}: != plain"
            walks = " (the split and the per-thread walk)"
        log("3 kernels", f"{label}: {COMPARE_ROWS} rows, "
            f"{model.forest.feature.shape[0]} trees, torch.equal to plain "
            f"and to the routed oracle{walks}")
    for name in ("oversize", "wide", "shared"):
        max_err[f"bank_scorer/{name}"] = synthetic_check(name)

    # -- 4-5 main paths: load, predict, serve; then time the kernel ----- #
    counters = (quickscorer, bank_scorer)
    kernels = []
    for (label, name, forced, mod, tables, walk_tables, src,
         replaces) in main_paths:
        model = ydf_tpu_torch.load_model(paths[name])
        model.force_engine(forced)
        for c in counters:
            c.KERNEL_LAUNCHES = 0
            c.KERNEL_ROWS = 0
        cuda_build.LAUNCH_EVENTS = []
        drive_path(model, name, forced, req[name], paths[name], rng)
        torch.cuda.synchronize()
        events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
        launches = {c.__name__: c.KERNEL_LAUNCHES for c in counters}
        short = mod.__name__.rsplit(".", 1)[-1]
        # Each launch's rows (the event's name) and CUDA-event time.
        per_launch = [(int(k.split("/rows=")[1]), s.elapsed_time(e))
                      for k, s, e in events if k.split("/")[0] == short]
        path_ms = sum(ms for _, ms in per_launch)
        # The path's launches weighted by their rows, in launches of
        # TIMING_ROWS rows (the size the kernel is timed at below).
        path_launches = mod.KERNEL_ROWS / TIMING_ROWS
        for c in counters:
            want_used = c is mod
            assert (launches[c.__name__] > 0) == want_used, (
                f"{label}: launches {launches}")
        log("4-5 launches", f"{label}: {launches[mod.__name__]} launches "
            f"of {short} on this path ({mod.KERNEL_ROWS} rows: "
            f"{path_launches:.4f} launches of {TIMING_ROWS} rows), none of "
            f"the other kernel; path time {path_ms:.4f} ms (CUDA events "
            "around each launch); each launch (rows:ms) " + " ".join(
                f"{r}:{ms:.4f}" for r, ms in per_launch))

        xT = encoded_xT(model, draw_requests(req[name], TIMING_ROWS, rng))
        t = measure(mod, tables, walk_tables, xT)
        max_err[label] = max(max_err[label], t["max_abs_err"])
        log("5 timing", f"{label} at {xT.shape[1]} rows x "
            f"{xT.shape[0]} features: kernel {t['ms']:.4f} ms a call back "
            f"to back, {t['device_ms']:.4f} ms on the card "
            f"({t['device_how']}), plain "
            f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}; {t['detail']}), {smi}")
        kernels.append({
            "name": label, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[mod.__name__],
            "max_abs_err": max_err[label], "ms": t["ms"],
            "device_ms": t["device_ms"],
            "device_how": t["device_how"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "library_device_ms": None,
            "path_ms": path_ms, "path_how": "CUDA events around each launch",
            "path_launch_ms": per_launch,
            "path_launches_at_timing_rows": path_launches,
            "path_bound_ms": t["bound_ms"] * path_launches,
        })
    registry_check(kernels, models["gbt_d6"], smi)
    torch.cuda.synchronize()
    kernels.extend(train_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(vs_path(smi, serving=counters))
    torch.cuda.synchronize()
    kernels.extend(default_path(smi, serving=counters))
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


def synthetic_check(name):
    """The bank kernel on a BANK_FORESTS forest, both walks, torch.equal
    to plain and to the routed oracle: "oversize", whose first tree is
    larger than a shared tree block (walked from its packed records in
    global memory); "wide" and "shared", packed in wide records. Returns
    the max abs difference to plain (0)."""
    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.ops.routing import forest_predict_values
    from ydf_tpu_torch.serving import bank_scorer
    from ydf_tpu_torch.serving.quickscorer import feature_major

    _, Fn, _, _, _, _, _, max_depth = BANK_FORESTS[name]
    forest = ydf_tpu_torch.forest_from_jax(bank_forest(name)).to(DEVICE)
    tables = bank_scorer.make_tables(forest, max_depth, DEVICE)
    biggest = 16 * int(tables.tree_off.diff().max())
    assert tables.wide == (name != "oversize"), (name, tables.wide)
    if name != "shared":
        assert biggest > bank_scorer.TREE_BLOCK_BYTES, biggest
    x_num, x_cat = (torch.from_numpy(a).to(DEVICE) for a in bank_inputs(
        name, COMPARE_ROWS, inside=True))
    xT = feature_major(x_num, x_cat)
    want = bank_scorer.score_plain(tables, xT)
    oracle = forest_predict_values(forest, x_num, x_cat, num_numerical=Fn,
                                   max_depth=max_depth)[:, 0]
    assert torch.equal(want, oracle), f"{name}: plain != routed oracle"
    err = 0.0
    for walk, got in zip(("split", "per-thread"), both_walks(
            lambda: bank_scorer.score(tables, xT))):
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{name} {walk}: != plain"
        err = max(err, float((got - want).abs().max()))
    log("3 kernels", f"bank_scorer/{name}: {COMPARE_ROWS} rows x "
        f"{xT.shape[0]} features, {forest.num_trees} trees, "
        f"{'wide' if tables.wide else 'narrow'} records, the largest tree "
        f"{biggest} bytes packed (a tree block holds "
        f"{bank_scorer.TREE_BLOCK_BYTES}; larger ones are walked in global "
        "memory), both walks torch.equal to plain and to the routed oracle")
    return err


def registry_check(kernels, model, smi):
    """The registry's order against the card's: QuickScorer's and the
    bank's device times on gbt_d6 at TIMING_ROWS rows. The registry must
    pick the faster engine when one is faster by more than 10%."""
    dev = {k["name"]: k["device_ms"] for k in kernels}
    qs_ms = dev["quickscorer/gbt_d6/forced"]
    bank_ms = dev["bank_scorer/gbt_d6"]
    faster = "QuickScorer" if qs_ms < bank_ms else "BankScorer"
    picked = model.list_compatible_engines()[0]
    log("5 registry", f"gbt_d6 at {TIMING_ROWS} rows on the card: "
        f"QuickScorer {qs_ms:.4f} ms, BankScorer {bank_ms:.4f} ms, so "
        f"{faster} is faster ({max(qs_ms, bank_ms) / min(qs_ms, bank_ms):.2f}"
        f"x); the registry picks {picked} (compatible, by rank: "
        f"{model.list_compatible_engines()}), {smi}")
    if max(qs_ms, bank_ms) > 1.1 * min(qs_ms, bank_ms):
        assert picked == faster, f"the registry picks {picked}, {faster} is"


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
    dev_ms, how = device_ms(lambda: mod.score(tables, xT),
                            KERNELS_OF[mod.__name__.rsplit(".", 1)[-1]])
    plain_ms = time_ms(lambda: mod.score_plain(tables, xT), reps=1)
    want = mod.score_plain(tables, xT)
    assert torch.equal(got, want), f"{mod.__name__} at {n} rows: != plain"
    nbytes = xT.numel() * 4 + table_bytes(tables) + n * 4
    steps = 0
    chunk = bank_scorer.PLAIN_ROW_CHUNK
    for r0 in range(0, n, chunk):
        steps += int(bank_scorer.walk_plain(
            walk_tables, xT[:, r0:r0 + chunk])[1].sum())
    ops = 2 * steps + n * walk_tables.num_trees
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {
        "ms": ms, "device_ms": dev_ms, "device_how": how,
        "plain_ms": plain_ms,
        "max_abs_err": float((got - want).abs().max()),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "detail": f"{nbytes} bytes -> {bytes_ms:.4f} ms, {ops} ops -> "
                  f"{ops_ms:.4f} ms",
    }


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
    binning_check(inp["binning"], sha=cfg["bins_sha256"])
    log("6 kernels", f"binning {TRAIN_ROWS} x {TRAIN_FEATURES}: "
        "torch.equal to plain, feature-major in memory; SHA-256 of the bin "
        "matrix == the JAX package's")
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
    pile = pileup_check()
    log("6 kernels", "root histogram pile-up case (n=200000, F=36, 12% of "
        "rows in bin 0 of every feature): integer-valued stats torch.equal "
        "to plain in f32, bf16 and int8; real f32 stats within "
        f"{HIST_RTOL} x cell mass + {HIST_ATOL} (max abs {pile:.3g})")

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
    ev_ms, routed_lh = split_events(events)
    kernel_ms.update(ev_ms)
    boost_ms = learner.last_timings["boost_s"] * 1e3
    log("6 launches", f"train_bench: {counted} launches (routed by hist "
        f"slots: {routed_lh}); serving kernels {serving_launches}")
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
        log("6 timing", f"{name} ({t['shape']}): {timing_text(t)}, {smi}")
        out.append(train_entry(name, "train_bench", src, replaces, t,
                               counted[name], err[name], kernel_ms[name]))
        if name == "histogram_routed":
            layers = routed_by_layer(name, inp, events, routed_lh)
            out[-1].update(layer_fields(layers))
            log("6 layers", f"{name} on train_bench by hist slots: "
                f"{layer_text(layers)}, {smi}")
    return out


def train_entry(name, path, src, replaces, t, launches, err, path_ms):
    """A training kernel's `kernels` entry: its timings at the path's
    shape (measure_train) and its CUDA-event time over the path's
    launches."""
    return {
        "name": f"{name}/{path}", "route": "cuda",
        "source": f"ydf_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": t["ms"], "device_ms": t["device_ms"],
        "device_how": t["device_how"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        "path_ms": path_ms, "path_how": "CUDA events around each launch",
    }


def layer_fields(layers):
    """The routed kernel's per-layer numbers for its `kernels` entry; the
    path's bound is each layer's bound times its launches."""
    return {
        "by_hist_slots": {str(k): v for k, v in layers.items()},
        "path_bound_ms": sum(v["bound_ms"] * v["launches"]
                             for v in layers.values()),
    }


def layer_text(layers):
    return "; ".join(
        f"Lh={k}: {v['launches']} launches, {v['device_ms']:.4f} ms on the "
        f"card ({v['device_how']}), bound {v['bound_ms']:.4f} ms, path "
        f"{v['path_ms']:.3f} ms (events)" for k, v in layers.items())


def profile_train(data, hp=TRAIN_HP):
    """One training (train_bench's configuration unless `hp` says
    otherwise) under torch.profiler: device time by kernel name, the
    number of device kernels, and the device's idle share of the
    boosting loop, bounded from below by 1 - (device time of the whole
    train) / (loop wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import ydf_tpu_torch

    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE, **hp)
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


def binning_check(args, sha=None):
    """The binning kernel against its plain version, and its bins
    feature-major in memory: the [n, F] result is the view of a
    contiguous [F, n]. With `sha`, the [n, F] matrix's SHA-256 against
    the JAX package's."""
    import torch

    from ydf_tpu_torch.ops import binning

    got = binning.bin_columns(*args)
    torch.cuda.synchronize()
    assert got.t().is_contiguous(), "binning kernel: bins not feature-major"
    assert torch.equal(got, binning.bin_columns_plain(*args)), (
        "binning kernel != plain")
    if sha is not None:
        assert sha256(got) == sha, "bins != the JAX package's"


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


def train_inputs(data, binner, extra_bins=None):
    """The training kernels' inputs at the path's shapes, on the card:
    binning of every training value; the root histogram (one slot, the
    first tree's binomial stats); the deepest fused layer (the previous
    layer's 16 splits into 32 slots, each split's smaller child on one
    of Lh = 16 hist slots), with seeded tables over the real bins.
    `extra_bins` (u8 [P, n], on the card) are candidate columns a tree
    grows on after the binned features (train_vs: the anchors' bins)."""
    import torch

    from ydf_tpu_torch.learners.losses import BinomialLogLikelihood
    from ydf_tpu_torch.ops.binning import bin_columns

    dev = torch.device(DEVICE)
    Fn = binner.num_numerical
    values = np.stack([data[name] for name in binner.feature_names[:Fn]])
    bin_args = (
        torch.from_numpy(values).to(dev),
        torch.from_numpy(binner.boundaries[:Fn]).to(dev),
        torch.from_numpy(binner.feature_num_bins[:Fn] - 1).to(dev),
        torch.from_numpy(binner.impute_values[:Fn]).to(dev),
    )
    bins_t = bin_columns(*bin_args).t()
    if extra_bins is not None:
        bins_t = torch.cat([bins_t, extra_bins]).contiguous()
    F, n = bins_t.shape
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
    routed = routed_layer(bins_t, stats, 16, B)
    return {"binning": bin_args, "root": root, "routed": routed}


def routed_layer(bins_t, stats, Lh, B, L=32, seed=6):
    """A fused layer's inputs with Lh hist slots, on the card: the previous
    layer's Lh splits into 2 Lh of L = 32 slots, each split's smaller
    child on a hist slot (the other on the trash slot), seeded tables over
    the real bins, 3% of the rows on the trash slot."""
    import torch

    from ydf_tpu_torch.ops.histogram_kernels import RouteTables

    dev = bins_t.device
    F, n = bins_t.shape
    N = 127
    rng = np.random.default_rng(seed)
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
    return (bins_t, torch.from_numpy(slot).to(dev),
            torch.from_numpy(leaf).to(dev), tables, stats, Lh, B)


def routed_by_layer(name, inp, events, launches_by_lh):
    """The routed kernel at each hist-slot count of the path (the Lh of
    its launches): device time and bound from measure_train on
    routed_layer inputs, and the path's CUDA-event time of those
    launches. Returns {Lh: {...}}."""
    out = {}
    bins_t, _, _, _, stats, _, B = inp["routed"]
    for lh in sorted(launches_by_lh):
        layer = dict(inp, routed=routed_layer(bins_t, stats, lh, B))
        t = measure_train(name, layer, timing_only=True)
        out[lh] = {
            "launches": launches_by_lh[lh], "device_ms": t["device_ms"],
            "device_how": t["device_how"], "bound_ms": t["bound_ms"],
            "path_ms": sum(s.elapsed_time(e) for k, s, e in events
                           if k == f"histogram_routed/Lh={lh}"),
        }
    return out


def split_events(events):
    """Event time summed by kernel (the name before any '/'), and the
    routed kernel's launches by hist-slot count."""
    kernel_ms, by_lh = {}, {}
    for name, start, end in events:
        base = name.split("/")[0]
        kernel_ms[base] = kernel_ms.get(base, 0.0) + start.elapsed_time(end)
        if name.startswith("histogram_routed/Lh="):
            lh = int(name.split("=")[1])
            by_lh[lh] = by_lh.get(lh, 0) + 1
    return kernel_ms, by_lh


def measure_train(name, inp, reps=20, timing_only=False):
    """Kernel time (CUDA events, after warm-up), the plain version's time
    (once, after one call), the library call's time, and the bound: the
    larger of the bytes the function must move (inputs read once,
    outputs written once) over HBM bandwidth and its least operations
    on these inputs over the card's 32-bit scalar rate. timing_only skips
    the plain version and the library call."""
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
        library_kernels = ("searchsorted",)
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
        library_kernels = ("index",)
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
    dev_ms, how = device_ms(kernel, KERNELS_OF[name])
    plain_ms = library_ms = library_dev_ms = None
    if not timing_only:
        plain()
        plain_ms = time_ms(plain, reps=1)
    if library is not None and not timing_only:
        library()
        library_ms = time_ms(library, reps=reps)
        library_dev_ms, lib_how = device_ms(library, library_kernels)
        how = how if lib_how == how else f"{how}; library {lib_how}"
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return {
        "ms": ms, "device_ms": dev_ms, "device_how": how,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_device_ms": library_dev_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "detail": f"{nbytes} bytes -> {bytes_ms:.4f} ms, {ops} ops -> "
                  f"{ops_ms:.4f} ms", "shape": shape,
    }


def timing_text(t):
    """A `6 timing` / `7 timing` line's numbers: the kernel's call and
    device times, the plain version's, the library call's both, the
    bound."""
    lib = "null" if t["library_ms"] is None else (
        f"{t['library_ms']:.4f} ms a call, "
        f"{t['library_device_ms']:.4f} ms on the card")
    return (f"kernel {t['ms']:.4f} ms a call back to back, "
            f"{t['device_ms']:.4f} ms on the card ({t['device_how']}), "
            f"plain {t['plain_ms']:.3f} ms, library {lib}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']})")


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


# --------------------------------------------------------------------- #
# 7 vs: the vector-sequence paths, served and trained on the card
# --------------------------------------------------------------------- #


def vs_ragged_cases():
    """(n, L, D, A, all rows empty): n not a multiple of a block's rows,
    L = 1, A = 1, a D that pads nothing evenly, all-empty rows."""
    return [(1, 1, 1, 1, False), (1001, 16, 16, 32, False),
            (777, 1, 16, 32, False), (513, 9, 5, 1, False),
            (300, 7, 3, 33, False), (257, 4, 16, 16, True),
            (129, 6, 40, 70, False)]


def vs_random_case(n, L, D, A, all_empty, seed):
    import torch

    rng = np.random.RandomState(seed)
    lengths = np.zeros(n, np.int32) if all_empty else rng.randint(
        0, L + 1, n).astype(np.int32)
    values = np.zeros((n, L, D), np.float32)
    for e in range(n):
        values[e, :lengths[e]] = rng.normal(size=(lengths[e], D))
    anchors = rng.normal(size=(A, D)).astype(np.float32)
    closer = rng.uniform(size=A) < 0.5
    dev = torch.device(DEVICE)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (values, lengths, anchors, closer))


def vs_check(args, what):
    """Kernel against plain on `args`: bitwise (the kernel rounds as the
    plain version does at every shape), empty rows' -FLT_MAX too. Returns
    the max abs error (0)."""
    import torch

    from ydf_tpu_torch.ops import vector_sequence as vso

    got = vso.vs_scores(*args)
    torch.cuda.synchronize()
    want = vso.vs_scores_plain(*args)
    empty = args[1] == 0
    assert torch.equal(got[empty].view(torch.int32),
                       want[empty].view(torch.int32)), (
        f"{what}: empty rows != -FLT_MAX")
    diff = (got.double() - want.double()).abs()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
        f"{what}: kernel != plain ({float(diff.max())})")
    return float(diff.max()) if diff.numel() else 0.0


def vs_near_threshold(model, data):
    """bool [n]: rows whose VS score at some VS node on their path (any
    tree) lies within VS_RTOL x M + VS_ATOL of the node's threshold; the
    rows where another summation order may route differently."""
    import torch

    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.ops import vector_sequence as vso
    from ydf_tpu_torch.ops.routing import (
        route_tree_values,
        vs_tree_projections,
    )

    ds = Dataset.from_data(data, model.dataspec)
    x_num, x_cat = model._encode_inputs(ds)
    vals, lens, _ = model.binner.transform_vs(ds)
    dev = model.device
    xn, xc = (torch.from_numpy(a).to(dev) for a in (x_num, x_cat))
    vals = [torch.from_numpy(np.ascontiguousarray(vals[:, j])).to(dev)
            for j in range(vals.shape[1])]
    lens = [torch.from_numpy(np.ascontiguousarray(lens[:, j])).to(dev)
            for j in range(lens.shape[1])]
    fo = model.forest
    F_total = x_num.shape[1] + x_cat.shape[1]
    near = torch.zeros(x_num.shape[0], dtype=torch.bool, device=dev)
    for t in range(fo.num_trees):
        proj = vs_tree_projections(fo, t, vals, lens)
        fsel = fo.vs_feat[t].long()
        M = torch.stack([vso.score_tolerance(v, ln, fo.vs_anchor[t])
                         for v, ln in zip(vals, lens)], dim=1)
        M = torch.gather(M, 1, fsel[None, None, :].expand(M.shape[0], 1, -1)
                         )[:, 0, :]
        for depth in range(model.max_depth):
            node = route_tree_values(fo, t, xn, xc, model.binner.num_numerical,
                                     depth, vs_proj=proj)
            f = fo.feature[t].long()[node]
            q = (f - F_total).clamp(0, proj.shape[1] - 1)[:, None]
            at_vs = (f >= F_total) & ~fo.is_leaf[t][node]
            gap = (proj.gather(1, q)[:, 0] - fo.threshold[t][node]).abs()
            near |= at_vs & (gap <= VS_RTOL * M.gather(1, q)[:, 0] + VS_ATOL)
    return near.cpu().numpy()


def ulps_apart(a, b):
    """Distance in units in the last place between float32 arrays."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def vs_path(smi, serving):
    """Phase 7: returns the `kernels` entries of the vector-sequence
    kernel on serve_vs and train_vs and of the three training kernels on
    train_vs."""
    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.ops import binning, histogram_kernels
    from ydf_tpu_torch.ops import vector_sequence as vso
    from ydf_tpu_torch.utils import cuda_build

    t_phase = time.perf_counter()
    with open(os.path.join(TRAIN_VS, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["learner"], cfg["data_seed"],
            cfg["request_rows"], cfg["request_seed"], cfg["generator"]) == (
        VS_ROWS, TRAIN_HP, DATA_SEED, TRAIN_REQUEST_ROWS, REQUEST_SEED,
        dict(max_len=VS_MAX_LEN, dim=VS_DIM, noise=VS_NOISE,
             radius=VS_RADIUS)), cfg
    exp = np.load(os.path.join(TRAIN_VS, "expected.npz"))
    jax_forest = dict(np.load(os.path.join(TRAIN_VS, "forest.npz")))
    t0 = time.perf_counter()
    data = make_vs_data(VS_ROWS)
    req = make_vs_data(TRAIN_REQUEST_ROWS, seed=REQUEST_SEED)
    del req["label"]
    log("7 vs", f"data {VS_ROWS} rows (numpy RandomState({DATA_SEED})) in "
        f"{time.perf_counter() - t0:.2f} s; JAX fixture: jax "
        f"{cfg['jax_version']}, threefry partitionable "
        f"{cfg['jax_threefry_partitionable']}, impls {cfg['jax_impls']}")

    # -- 7a the kernel against plain: training shape, ragged shapes ---- #
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **TRAIN_HP)
    prep = learner._prepare(data)
    vs = port_gbt.vs_inputs(prep["vs"], *learner._vs_anchor_counts(),
                            DEVICE)
    dev = vs.values[0].device
    full = (vs.values[0], vs.lengths[0],
            torch.from_numpy(jax_forest["vs_anchor"][0]).to(dev),
            torch.from_numpy(jax_forest["vs_is_closer"][0]).to(dev))
    err = {"vs/train_vs": vs_check(full, "training shape")}
    assert err["vs/train_vs"] == 0.0, (
        f"training shape: kernel != plain ({err['vs/train_vs']})")
    ragged = max(vs_check(vs_random_case(*case, seed=i), f"ragged {case}")
                 for i, case in enumerate(vs_ragged_cases()))
    n, L, D = full[0].shape
    log("7 kernels", f"vector_sequence at the training shape (n={n}, L={L}, "
        f"D={D}, A={full[2].shape[0]}; max abs {err['vs/train_vs']:.3g}) "
        f"and {len(vs_ragged_cases())} ragged shapes {vs_ragged_cases()} "
        f"(max abs {ragged:.3g}; D = 1, 3, 5, 40 take the generic "
        f"instantiation): bitwise to plain, -FLT_MAX rows too")

    out = []
    # -- 7b serve_vs: the JAX model served on the card ---------------- #
    vso.KERNEL_LAUNCHES = 0
    for c in serving:
        c.KERNEL_LAUNCHES = 0
    cuda_build.LAUNCH_EVENTS = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = ydf_tpu_torch.load_model(TRAIN_VS, device=DEVICE)
    pred = model.predict(req)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    path_ms = {"serve_vs": split_events(events)[0].get("vector_sequence",
                                                        0.0)}
    served = vso.KERNEL_LAUNCHES
    T = TRAIN_HP["num_trees"]
    assert served == T, served  # one launch per tree and VS feature
    assert not any(c.KERNEL_LAUNCHES for c in serving)
    # The kernel's inputs on this path, as vs_tree_projections passes them
    # for tree 0: the padded request sequences against the tree's anchors.
    sv, sl, _ = model.binner.transform_vs(Dataset.from_data(req,
                                                            model.dataspec))
    serve_args = (torch.from_numpy(np.ascontiguousarray(sv[:, 0])).to(dev),
                  torch.from_numpy(np.ascontiguousarray(sl[:, 0])).to(dev),
                  model.forest.vs_anchor[0].contiguous(),
                  model.forest.vs_is_closer[0].contiguous())
    err["vs/serve_vs"] = vs_check(serve_args, "serve_vs shape")
    raw = model._raw_scores(req, combine="sum")[:, 0]
    assert model.list_compatible_engines() == ["Routed"]
    off = np.abs(raw - exp["raw"]) > VS_SERVE_ATOL
    near = vs_near_threshold(model, req)
    explained = int(off.sum())
    assert not (off & ~near).any(), (
        f"serve_vs: {int((off & ~near).sum())} rows differ from JAX with no "
        "VS score near a threshold")
    assert explained <= VS_MAX_EXPLAINED * len(raw), explained
    assert np.isfinite(pred).all() and pred.shape == (len(raw),)
    emptied = dict(req)
    emptied["seq"] = req["seq"].copy()
    missing = [i for i, v in enumerate(req["seq"]) if v is None]
    for i in missing:
        emptied["seq"][i] = np.zeros((0, VS_DIM), np.float32)
    assert np.array_equal(model.predict(emptied), pred), (
        "missing != empty")
    t0 = time.perf_counter()
    model.predict(req)
    torch.cuda.synchronize()
    predict_ms = (time.perf_counter() - t0) * 1e3
    log("7 serve", f"serve_vs: load_model + predict of "
        f"{len(raw)} rows in {serve_wall * 1e3:.1f} ms, {served} launches "
        f"of vector_sequence (engines {model.list_compatible_engines()}); "
        f"raw vs JAX max abs {np.abs(raw - exp['raw']).max():.3g}, rows "
        f"beyond {VS_SERVE_ATOL}: {explained} (all explained by a VS score "
        f"within {VS_RTOL} x M of a threshold on the path; "
        f"{int(near.sum())} rows have one); predictions vs JAX max abs "
        f"{np.abs(pred - exp['predictions']).max():.3g}; {len(missing)} "
        f"missing cells predict like empty ones; one more predict "
        f"{predict_ms:.1f} ms (host clock)")

    # -- 7c train_vs: the GBT trained on the card --------------------- #
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    binning.KERNEL_LAUNCHES = 0
    vso.KERNEL_LAUNCHES = 0
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
    counted = dict(histogram_kernels.LAUNCHES)
    counted["binning"] = binning.KERNEL_LAUNCHES
    counted["vector_sequence"] = vso.KERNEL_LAUNCHES
    depth = TRAIN_HP["max_depth"]
    assert counted["vector_sequence"] == T, counted
    assert counted["histogram"] == T, counted
    assert counted["histogram_routed"] == T * (depth - 1), counted
    assert counted["binning"] >= 1, counted
    assert not any(c.KERNEL_LAUNCHES for c in serving)
    kernel_ms = {k: 0.0 for k in counted}
    ev_ms, routed_lh = split_events(events)
    kernel_ms.update(ev_ms)
    path_ms["train_vs"] = kernel_ms["vector_sequence"]
    boost_ms = learner.last_timings["boost_s"] * 1e3
    log("7 launches", f"train_vs: {counted} (routed by hist slots: "
        f"{routed_lh})")
    log("7 train", f"train_vs GradientBoostedTreesLearner(**{TRAIN_HP})"
        f".train: wall {wall * 1e3:.1f} ms (host clock, ends in "
        "synchronize); stages " + " ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in learner.last_timings.items())
        + "; kernel time (CUDA events) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f", sum {sum(kernel_ms.values()):.3f} ms = "
        f"{100 * sum(kernel_ms.values()) / (wall * 1e3):.2f}% of the wall, "
        f"boosting loop {boost_ms:.1f} ms; {smi}")

    # -- 7d against the JAX package's run ----------------------------- #
    pf = model.forest.to_numpy()
    assert np.array_equal(pf["vs_anchor"].view(np.int32),
                          jax_forest["vs_anchor"].view(np.int32)), (
        "anchors != the JAX package's")
    for field in ("vs_feat", "vs_is_closer"):
        assert np.array_equal(pf[field], jax_forest[field]), field
    split = ~jax_forest["is_leaf"] | ~pf["is_leaf"]
    differ = split & ((pf["feature"] != jax_forest["feature"])
                      | (pf["threshold_bin"] != jax_forest["threshold_bin"])
                      | (pf["is_leaf"] != jax_forest["is_leaf"]))
    Fn = model.binner.num_numerical
    tree0 = []
    for k in np.nonzero(differ[0])[0]:
        jf = int(jax_forest["feature"][0, k])
        assert jf >= Fn, f"tree 0 node {k}: numerical split differs"
        a = torch.from_numpy(jax_forest["vs_anchor"][0, jf - Fn:jf - Fn + 1]
                             ).to(dev)
        ic = torch.from_numpy(
            jax_forest["vs_is_closer"][0, jf - Fn:jf - Fn + 1]).to(dev)
        sc = vso.vs_scores(vs.values[0], vs.lengths[0], a, ic)[:, 0]
        M = vso.score_tolerance(vs.values[0], vs.lengths[0], a)[:, 0]
        rows = int(((sc - float(jax_forest["threshold"][0, k])).abs()
                    <= VS_RTOL * M + VS_ATOL).sum())
        assert rows > 0, f"tree 0 node {k} differs, unexplained"
        tree0.append(f"node {k}: {rows} rows within {VS_RTOL} x M")
    same = ~differ & split & (pf["feature"] >= Fn) & ~pf["is_leaf"]
    ulps = ulps_apart(pf["threshold"][same], jax_forest["threshold"][same])
    assert (ulps <= VS_THRESHOLD_ULPS).all(), int(ulps.max())
    per_tree = differ.sum(axis=1)
    loss = np.asarray(model.training_logs["train_loss"], np.float32)
    loss_rel = np.abs(loss / exp["train_loss"] - 1)
    assert loss.shape == exp["train_loss"].shape
    assert loss_rel[-1] <= TRAIN_LOSS_RTOL, (loss[-1], exp["train_loss"][-1])
    traw = model._raw_scores(req, combine="sum")[:, 0] \
        + model.initial_predictions[0]
    raw_err = np.abs(traw - (exp["raw"] + exp["initial_predictions"][0]))
    assert np.isfinite(traw).all()
    assert raw_err.max() <= RAW_SCORE_ATOL, raw_err.max()
    assert raw_err.mean() <= RAW_SCORE_MEAN_ATOL, raw_err.mean()
    log("7 vs JAX", f"train_vs: anchors of all {T} trees bitwise == JAX; "
        f"tree 0 differing split nodes: {len(tree0)} {tree0}; split nodes "
        f"differing over {T} trees: {int(per_tree.sum())} (per tree "
        f"{per_tree.tolist()}); VS thresholds of equal nodes within "
        f"{int(ulps.max()) if ulps.size else 0} ulps ({int(same.sum())} "
        f"nodes); final train loss {loss[-1]:.7f} vs "
        f"{exp['train_loss'][-1]:.7f} (rel {loss_rel[-1]:.2e}); raw scores "
        f"on {TRAIN_REQUEST_ROWS} fresh rows: max abs {raw_err.max():.3g}, "
        f"mean {raw_err.mean():.3g}")

    # -- 7e the kernels timed at the path's shapes -------------------- #
    draws = port_gbt.vs_draws(learner.random_seed, 1, len(vs.values),
                              vs.num_closer + 2 * vs.num_projected, dev)
    B = model.binner.num_bins
    qs = port_gbt.prng.linspace_f32(1.0 / B, 1.0 - 1.0 / B, B - 1,
                                    device=dev)
    _, _, cols = port_gbt.make_vs_projections(
        vs, {k: v[0] for k, v in draws.items()}, qs)
    inp = train_inputs(data, model.binner, extra_bins=cols)
    got = histogram_kernels.histogram(*inp["root"])
    err["histogram"] = hist_check(
        got, histogram_kernels.histogram_plain(*inp["root"]),
        histogram_kernels.histogram_plain(*abs_stats(inp["root"], 2)),
        "train_vs root histogram")
    got = histogram_kernels.histogram_routed(*inp["routed"])
    want = histogram_kernels.histogram_routed_plain(*inp["routed"])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    err["histogram_routed"] = hist_check(
        got[0], want[0], histogram_kernels.histogram_routed_plain(
            *abs_stats(inp["routed"], 4))[0], "train_vs routed histogram")
    binning_check(inp["binning"])
    err["binning"] = 0.0
    for path, args, launches in (
        ("serve_vs", serve_args, served),
        ("train_vs", full, counted["vector_sequence"]),
    ):
        t = measure_vs(args)
        log("7 timing", f"vector_sequence on {path} ({t['shape']}): kernel "
            f"{t['ms']:.4f} ms a call back to back ({t['launch_ms']:.4f} ms "
            f"between events around the launch alone, {t['device_ms']:.4f} "
            f"ms on the card ({t['device_how']})), plain "
            f"{t['plain_ms']:.3f} ms, library null "
            f"(no single PyTorch call scores a masked max/min over a "
            f"sequence), bound {t['bound_ms']:.4f} ms ({t['bound_by']}; "
            f"{t['detail']}), {smi}")
        out.append({
            "name": f"vector_sequence/{path}", "route": "cuda",
            "source": "ydf_tpu_torch/csrc/vector_sequence.cu",
            "replaces": "ydf_tpu/ops/vector_sequence.py:59",
            "launches": launches, "max_abs_err": err[f"vs/{path}"],
            "ms": t["ms"], "device_ms": t["device_ms"],
            "device_how": t["device_how"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "library_device_ms": None,
            "path_ms": path_ms[path],
            "path_how": "CUDA events around each launch",
        })
    for name, src, replaces in (
        ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
        ("histogram", "histogram.cu", "ydf_tpu/ops/histogram_pallas.py:81"),
        ("histogram_routed", "histogram_routed.cu",
         "ydf_tpu/ops/histogram_pallas.py:172"),
    ):
        t = measure_train(name, inp)
        log("7 timing", f"{name} on train_vs ({t['shape']}): "
            f"{timing_text(t)}, {smi}")
        out.append(train_entry(name, "train_vs", src, replaces, t,
                               counted[name], err[name], kernel_ms[name]))
        if name == "histogram_routed":
            layers = routed_by_layer(name, inp, events, routed_lh)
            out[-1].update(layer_fields(layers))
            log("7 layers", f"{name} on train_vs by hist slots: "
                f"{layer_text(layers)}, {smi}")
    log("7 vs", f"phase 7 wall {time.perf_counter() - t_phase:.1f} s")
    return out


# --------------------------------------------------------------------- #
# 8 default: the library's default GBT workflow on the card
# --------------------------------------------------------------------- #


def default_path(smi, serving):
    """Phase 8: GradientBoostedTreesLearner(label="label") with every
    default (the validation split, look-ahead early stopping, categorical
    splits) trained on the card, evaluated, saved and loaded, against the
    JAX package's run (ydf_tpu_torch/testdata/train_default). Returns the
    `kernels` entries of the path's four kernels."""
    import tempfile

    import torch

    import ydf_tpu_torch
    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.ops import binning, histogram_kernels
    from ydf_tpu_torch.serving import bank_scorer
    from ydf_tpu_torch.utils import cuda_build

    t_phase = time.perf_counter()
    with open(os.path.join(TRAIN_DEFAULT, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["rows"], cfg["test_rows"], cfg["cat_seed"],
            cfg["data_seed"], cfg["compare_rows"], cfg["learner"],
            cfg["generator"]) == (
        DEFAULT_ROWS, DEFAULT_TEST_ROWS, DEFAULT_CAT_SEED, DATA_SEED,
        DEFAULT_COMPARE_ROWS, DEFAULT_HP,
        dict(features=TRAIN_FEATURES, cat_vocabs=list(DEFAULT_CAT_VOCABS),
             missing_features=list(DEFAULT_MISSING))), cfg
    exp = np.load(os.path.join(TRAIN_DEFAULT, "expected.npz"))
    jax_forest = dict(np.load(os.path.join(TRAIN_DEFAULT, "forest.npz")))
    t0 = time.perf_counter()
    train, test = make_frame(DEFAULT_ROWS, DEFAULT_TEST_ROWS)
    assert frame_sha256(train) == cfg["train_sha256"], "train frame"
    assert frame_sha256(test) == cfg["test_sha256"], "test frame"
    log("8 default", f"frames {DEFAULT_ROWS} + {DEFAULT_TEST_ROWS} rows in "
        f"{time.perf_counter() - t0:.2f} s, SHA-256 == the fixture's; JAX "
        f"fixture: jax {cfg['jax_version']}, impls {cfg['jax_impls']}")

    # -- 8a the main path: train with every default, evaluate ---------- #
    for k in histogram_kernels.LAUNCHES:
        histogram_kernels.LAUNCHES[k] = 0
    binning.KERNEL_LAUNCHES = 0
    for c in serving:
        c.KERNEL_LAUNCHES = 0
        c.KERNEL_ROWS = 0
    reads0 = port_gbt.HOST_READS
    cuda_build.LAUNCH_EVENTS = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    learner = ydf_tpu_torch.GradientBoostedTreesLearner(device=DEVICE,
                                                        **DEFAULT_HP)
    model = learner.train(train)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = model.evaluate(test)
    torch.cuda.synchronize()
    eval_wall = time.perf_counter() - t0
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    counted = dict(histogram_kernels.LAUNCHES)
    counted["binning"] = binning.KERNEL_LAUNCHES
    counted["bank_scorer"] = bank_scorer.KERNEL_LAUNCHES
    others = {c.__name__: c.KERNEL_LAUNCHES for c in serving
              if c is not bank_scorer}
    reads = port_gbt.HOST_READS - reads0
    logs = model.training_logs
    trained, kept = logs["num_trees_trained"], logs["num_trees"]
    depth = learner.max_depth
    chunks = -(-trained // min(learner.early_stopping_num_trees_look_ahead,
                               port_gbt.MAX_CHUNK_TREES))
    assert counted["histogram"] == trained, counted
    assert counted["histogram_routed"] == trained * (depth - 1), counted
    assert counted["binning"] >= 1 and counted["bank_scorer"] >= 1, counted
    assert not any(others.values()), others
    assert reads == chunks, (reads, chunks)
    kernel_ms, routed_lh = split_events(events)
    boost_ms = learner.last_timings["boost_s"] * 1e3
    valid_ms = kernel_ms.pop("valid_route", 0.0)
    log("8 launches", f"train_default (train + evaluate): {counted} "
        f"launches (routed by hist slots: {routed_lh}); other serving "
        f"kernels {others}")
    log("8 train", f"GradientBoostedTreesLearner(**{DEFAULT_HP}).train: "
        f"wall {wall * 1e3:.1f} ms (host clock, ends in synchronize); "
        "stages " + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                             learner.last_timings.items())
        + f"; {trained} trees trained, {kept} kept; {chunks} chunks, "
        f"{reads} host reads of the validation losses; "
        f"{boost_ms / trained:.2f} ms a tree (loop wall / trees trained); "
        f"validation routing {valid_ms:.1f} ms (CUDA events around each "
        f"tree's route, predictions and loss) = "
        f"{100 * valid_ms / boost_ms:.2f}% of the loop; kernel time (CUDA "
        "events, train + evaluate) " + " ".join(
            f"{k}={v:.3f}ms" for k, v in kernel_ms.items())
        + f"; evaluate of {DEFAULT_TEST_ROWS} rows {eval_wall * 1e3:.1f} "
        f"ms; {smi}")

    # -- 8b against the JAX package's run ------------------------------ #
    bins = model.binner.transform(
        Dataset.from_data(train, dataspec=model.dataspec), model.device)
    assert sha256(bins) == cfg["bins_sha256"], "bins != the JAX package's"
    _, va_idx = port_gbt.split_validation(DEFAULT_ROWS,
                                          learner.validation_ratio,
                                          learner.random_seed)
    import hashlib

    assert hashlib.sha256(va_idx.astype(np.int64).tobytes()).hexdigest() \
        == cfg["valid_idx_sha256"], "validation rows != the JAX package's"
    jv = exp["valid_loss"].astype(np.float64)
    pv = np.array([r["valid_loss"] for r in logs["iterations"]])
    pt = np.array([r["train_loss"] for r in logs["iterations"]])
    two = np.sort(jv)[:2]
    jax_tie = two[1] - two[0] <= 1e-5 * two[0]
    counts_same = (kept, trained) == (cfg["num_trees"],
                                      cfg["num_trees_trained"])
    if not counts_same:
        a = cfg["num_trees"] - 1
        lo, hi = max(a - 5, 0), a + 6
        log("8 vs JAX", f"kept/trained {kept}/{trained} != JAX "
            f"{cfg['num_trees']}/{cfg['num_trees_trained']}; validation "
            f"losses near JAX's argmin, iterations {lo + 1}-{hi}: JAX "
            f"{jv[lo:hi].tolist()}, port {pv[lo:hi].tolist()}")
    assert counts_same or jax_tie, (
        "the kept tree count differs from JAX's where JAX's two smallest "
        "validation losses lie more than rtol 1e-5 apart")
    pf = model.forest.to_numpy()
    for field in ("feature", "threshold_bin", "is_cat", "cat_mask", "left",
                  "right", "is_leaf", "num_nodes"):
        assert np.array_equal(pf[field][0], jax_forest[field][0]), (
            f"tree 0 {field} != the JAX package's")
    T = min(kept, cfg["num_trees"])
    jf = {k: v[:T] for k, v in jax_forest.items()}
    split = ~jf["is_leaf"] | ~pf["is_leaf"][:T]
    differ = split & ((pf["feature"][:T] != jf["feature"])
                      | (pf["threshold_bin"][:T] != jf["threshold_bin"])
                      | (pf["is_leaf"][:T] != jf["is_leaf"])
                      | (pf["cat_mask"][:T] != jf["cat_mask"]).any(-1))
    per_tree = differ.sum(axis=1)
    m = min(len(pv), len(jv))
    rel = {"train": np.abs(pt[:m] / exp["train_loss"][:m] - 1),
           "valid": np.abs(pv[:m] / jv[:m] - 1)}
    for k, r in rel.items():
        assert r.max() <= TRAIN_LOSS_RTOL, (k, r.max())
    head = {k: v[:DEFAULT_COMPARE_ROWS] for k, v in test.items()}
    raw = model._raw_scores(head, combine="sum")[:, 0] \
        + model.initial_predictions[0]
    raw_exp = exp["raw"] + exp["initial_predictions"][0]
    assert raw.shape == raw_exp.shape and np.isfinite(raw).all()
    raw_err = np.abs(raw - raw_exp)
    assert raw_err.max() <= RAW_SCORE_ATOL, raw_err.max()
    assert raw_err.mean() <= RAW_SCORE_MEAN_ATOL, raw_err.mean()
    jev = cfg["jax_evaluate"]
    ev_err = {k: abs(ev.metrics[k] - jev[k]) for k in jev}
    assert ev_err["accuracy"] <= EVAL_ATOL and ev_err["auc"] <= EVAL_ATOL, \
        ev_err
    assert ev_err["loss"] <= TRAIN_LOSS_RTOL * jev["loss"], ev_err
    cat_nodes = int((pf["is_cat"] & ~pf["is_leaf"]).sum())
    log("8 vs JAX", f"bins and validation rows bitwise == JAX; kept "
        f"{kept} of {trained} trained (JAX {cfg['num_trees']} of "
        f"{cfg['num_trees_trained']}; JAX's two smallest validation losses "
        f"{two[0]:.9g}, {two[1]:.9g}); tree 0 == JAX, categorical masks "
        f"included; {cat_nodes} of {int((~pf['is_leaf']).sum())} split "
        f"nodes categorical; split nodes differing from JAX over {T} "
        f"trees: {int(per_tree.sum())} (first differing tree "
        f"{int(np.argmax(per_tree > 0)) if per_tree.any() else None}); "
        f"losses over {m} iterations: train max rel "
        f"{rel['train'].max():.2e}, valid max rel {rel['valid'].max():.2e} "
        f"(<= {TRAIN_LOSS_RTOL}); raw scores on {DEFAULT_COMPARE_ROWS} "
        f"test rows: max abs {raw_err.max():.3g} (<= {RAW_SCORE_ATOL}), "
        f"mean {raw_err.mean():.3g} (<= {RAW_SCORE_MEAN_ATOL}); evaluate "
        f"on {DEFAULT_TEST_ROWS} rows: " + " ".join(
            f"{k} {ev.metrics[k]:.6f} (JAX {jev[k]:.6f})" for k in jev))

    # -- 8c the JAX model served and evaluated by the port ------------- #
    jm = ydf_tpu_torch.load_model(TRAIN_DEFAULT, device=DEVICE)
    jraw = jm._raw_scores(head, combine="sum")[:, 0]
    assert np.array_equal(jraw.view(np.int32), exp["raw"].view(np.int32)), (
        "the JAX model's raw scores on the card != JAX's")
    jme = jm.evaluate(test)
    same = max(abs(jme.metrics[k] - jev[k]) for k in jev)
    assert same <= EVAL_SAME_ATOL, (jme.metrics, jev)
    log("8 load", f"the JAX model on the card: raw scores on "
        f"{DEFAULT_COMPARE_ROWS} rows bitwise == JAX; evaluate on "
        f"{DEFAULT_TEST_ROWS} rows within {same:.3g} of JAX's metrics "
        f"(<= {EVAL_SAME_ATOL})")

    # -- 8d save -> load ----------------------------------------------- #
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "m"))
        back = ydf_tpu_torch.load_model(os.path.join(tmp, "m"),
                                        device=DEVICE)
        got, want = back.predict(test), model.predict(test)
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), (
        "save -> load changed the predictions")
    log("8 save", f"model.save -> load_model: predictions on "
        f"{DEFAULT_TEST_ROWS} rows bitwise equal")

    # -- 8e the routed kernel on the path's categorical tables --------- #
    tr_idx, _ = port_gbt.split_validation(DEFAULT_ROWS,
                                          learner.validation_ratio,
                                          learner.random_seed)
    layers = captured_routed_layers(model, learner, train, tr_idx)
    cat_layers = [a for a in layers if categorical_tables(a[3])]
    assert len(cat_layers) >= 3, f"{len(cat_layers)} categorical layers"
    err_routed = 0.0
    for args in cat_layers:
        got = histogram_kernels.histogram_routed(*args)
        want = histogram_kernels.histogram_routed_plain(*args)
        assert torch.equal(got[1], want[1]) and torch.equal(
            got[2], want[2]), "routed kernel: new_slot / new_leaf != plain"
        err_routed = max(err_routed, hist_check(
            got[0], want[0], histogram_kernels.histogram_routed_plain(
                *abs_stats(args, 4))[0], "routed histogram, categorical"))
    log("8 kernels", f"histogram_routed on {len(cat_layers)} layers of the "
        f"path's first two trees whose tables hold categorical (not prefix) "
        f"go_left rows (Lh = {[a[5] for a in cat_layers]}): new_slot, "
        f"new_leaf torch.equal to plain, the histogram within {HIST_RTOL} x "
        f"cell mass + {HIST_ATOL} (max abs {err_routed:.3g})")

    # -- 8f where the loop's time goes (torch.profiler) ---------------- #
    prof = profile_train(train, dict(DEFAULT_HP, num_trees=PROFILE_TREES))
    log("8 profile", f"one more train, num_trees={PROFILE_TREES} (two "
        "chunks), under torch.profiler (the profiler slows the host): wall "
        f"{prof['wall_ms']:.1f} ms, boosting loop {prof['loop_ms']:.1f} ms; "
        f"{prof['kernels']} device kernels, {prof['busy_ms']:.3f} ms of "
        "device time over the whole train, so the device is idle at least "
        f"{100 * prof['idle_share']:.1f}% of the loop; largest: " + "; ".join(
            f"{name[:60]} {ms:.3f} ms" for name, ms in prof["top"]))

    # -- 8g each kernel timed at the path's shapes --------------------- #
    rows = {k: v[tr_idx] for k, v in train.items()}
    Fn = model.binner.num_numerical
    cat_rows = bins.t()[Fn:].index_select(
        1, torch.from_numpy(tr_idx).to(bins.device)).contiguous()
    inp = train_inputs(rows, model.binner, extra_bins=cat_rows)
    inp["routed"] = max(cat_layers, key=lambda a: a[5])
    err = {"binning": 0.0, "histogram_routed": err_routed}
    err["histogram"] = hist_check(
        histogram_kernels.histogram(*inp["root"]),
        histogram_kernels.histogram_plain(*inp["root"]),
        histogram_kernels.histogram_plain(*abs_stats(inp["root"], 2)),
        "root histogram")
    out = []
    for name, src, replaces in (
        ("binning", "binning.cu", "ydf_tpu/ops/binning_pallas.py:60"),
        ("histogram", "histogram.cu", "ydf_tpu/ops/histogram_pallas.py:81"),
        ("histogram_routed", "histogram_routed.cu",
         "ydf_tpu/ops/histogram_pallas.py:172"),
    ):
        t = measure_train(name, inp)
        log("8 timing", f"{name} ({t['shape']}): {timing_text(t)}, {smi}")
        out.append(train_entry(name, "train_default", src, replaces, t,
                               counted[name], err[name],
                               kernel_ms.get(name, 0.0)))
    bank = bank_scorer.build_bank_scorer(model)
    xT = encoded_xT(model, test)
    t = measure(bank_scorer, bank.tables, bank.tables, xT)
    log("8 timing", f"bank_scorer/train_default at {xT.shape[1]} rows x "
        f"{xT.shape[0]} features ({kept} trees): kernel {t['ms']:.4f} ms a "
        f"call back to back, {t['device_ms']:.4f} ms on the card "
        f"({t['device_how']}), plain {t['plain_ms']:.2f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['detail']}), {smi}")
    out.append({
        "name": "bank_scorer/train_default", "route": "cuda",
        "source": "ydf_tpu_torch/csrc/bank_scorer.cu",
        "replaces": "ydf_tpu/serving/pallas_scorer.py:118",
        "launches": counted["bank_scorer"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "device_ms": t["device_ms"],
        "device_how": t["device_how"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "path_ms": kernel_ms.get("bank_scorer", 0.0),
        "path_how": "CUDA events around each launch",
    })
    log("8 default", f"phase 8 wall {time.perf_counter() - t_phase:.1f} s")
    return out


def categorical_tables(tables):
    """Does a layer's table route some split by a mask that is not a
    prefix of bins (a categorical split)?"""
    import torch

    gl = tables.go_left[tables.do_split]
    prefix = torch.cummin(gl.to(torch.uint8), dim=1).values.bool()
    return bool((gl != prefix).any())


def captured_routed_layers(model, learner, train, tr_idx, num_trees=2):
    """The routed kernel's arguments at every fused layer of the first
    `num_trees` trees the default path grows (its training rows and
    binner, the learner's configuration), cloned as the kernel got them:
    the path's own tables, categorical splits included."""
    import torch

    from ydf_tpu_torch.config import TreeConfig, resolve_max_frontier
    from ydf_tpu_torch.dataset.dataset import Dataset
    from ydf_tpu_torch.learners import gbt as port_gbt
    from ydf_tpu_torch.learners.losses import make_loss
    from ydf_tpu_torch.ops import histogram_kernels
    from ydf_tpu_torch.ops.split_rules import HessianGainRule

    binner = model.binner
    dev = model.device
    idx = torch.from_numpy(tr_idx).to(dev)
    bins_t = binner.transform(Dataset.from_data(train, model.dataspec),
                              dev).t().index_select(1, idx).contiguous()
    n = bins_t.shape[1]
    labels = torch.from_numpy(
        (train["label"][tr_idx].astype(str) == model.classes[1]).astype(
            np.float32)).to(dev)
    cfg = TreeConfig(max_depth=learner.max_depth,
                     max_frontier=resolve_max_frontier(
                         learner.max_frontier, n, learner.min_examples),
                     num_bins=binner.num_bins,
                     min_examples=learner.min_examples)
    captured = []
    original = histogram_kernels.histogram_routed

    def record(*args):
        captured.append(tuple(
            a.clone() if isinstance(a, torch.Tensor) else
            type(a)(*(t.clone() for t in a)) if isinstance(
                a, histogram_kernels.RouteTables) else a for a in args))
        return original(*args)

    histogram_kernels.histogram_routed = record
    try:
        port_gbt.boost(bins_t, labels, torch.ones(n, device=dev),
                       loss_obj=make_loss("DEFAULT", model.task, 2),
                       rule=HessianGainRule(), tree_cfg=cfg,
                       num_trees=num_trees, shrinkage=learner.shrinkage,
                       num_numerical=binner.num_numerical)
    finally:
        histogram_kernels.histogram_routed = original
    return captured


def measure_vs(args, reps=20):
    """The scoring kernel's time (CUDA events, after warm-up: per call of
    the wrapper back to back, and per launch alone) and the
    plain version's (once, after one call) at the path's shape, and the
    bound: the larger of the bytes the function must move (each real
    vector and length read once, the anchors, the scores written once)
    over HBM bandwidth, and its multiply-adds on this run's data (per
    real vector, one per (anchor, d) for the dots and one per d for
    |v|^2; two FLOPs each) over the card's float32 rate."""
    import torch

    from ydf_tpu_torch.ops import vector_sequence as vso
    from ydf_tpu_torch.utils import cuda_build

    values, lengths, anchors, closer = args
    n, L, D = values.shape
    A = anchors.shape[0]
    for _ in range(3):
        vso.vs_scores(*args)
    torch.cuda.synchronize()
    ms = time_ms(lambda: vso.vs_scores(*args), reps=reps)
    # Events around each launch alone: the device time without the
    # wrapper's host work, which sets `ms` at a small shape.
    cuda_build.LAUNCH_EVENTS = []
    for _ in range(reps):
        vso.vs_scores(*args)
    torch.cuda.synchronize()
    events, cuda_build.LAUNCH_EVENTS = cuda_build.LAUNCH_EVENTS, None
    launch_ms = sum(s.elapsed_time(e) for _, s, e in events) / len(events)
    dev_ms, how = device_ms(lambda: vso.vs_scores(*args),
                            KERNELS_OF["vector_sequence"])
    vso.vs_scores_plain(*args)
    plain_ms = time_ms(lambda: vso.vs_scores_plain(*args), reps=1)
    vectors = int(lengths.clamp(0, L).long().sum())
    nbytes = vectors * D * 4 + n * 4 + A * D * 4 + A + n * A * 4
    flops = 2 * vectors * D * (A + 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / SCALAR_OPS_PER_S * 1e3
    return {
        "ms": ms, "launch_ms": launch_ms, "device_ms": dev_ms,
        "device_how": how, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "detail": f"{nbytes} bytes -> {bytes_ms:.4f} ms, {flops} FLOPs -> "
                  f"{ops_ms:.4f} ms", "shape": f"n={n}, L={L}, D={D}, A={A}, "
                  f"{vectors} real vectors",
    }


if __name__ == "__main__":
    sys.exit(main())
