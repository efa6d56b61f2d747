"""Times the redesigned kernels of one tree of the repo on the card, at
the main paths' shapes.

    python3 scripts/time_redesigned_kernels.py [ROOT] [qs|routed|bank|vs|all]

ROOT (default: this checkout) is the directory that holds the
`ydf_tpu_torch` package to time, so that an older tree unpacked beside
this one (`git archive <commit> | tar -x -C chip_tree/parent`) can be
timed in the same call on the same card. Prints, with the card's name
and power limit:

  * qs: QuickScorer and the bank kernel on gbt_d6 at 1,048,576 rows
    (CUDA events around 10 calls back to back, after a warm-up), each
    held against its plain version;
  * routed: the fused route + histogram at train_bench's (500,000 x 28)
    and train_vs's (200,000 x 36) widths, L = 32, at every hist-slot count
    of the paths (Lh = 1, 2, 4, 8, 16), f32 and int8 stats, on seeded
    bins, and at train_vs's width with 12% of the rows in bin 0 of 32
    features (the empty sequences' pile-up): CUDA events a call, and
    new_slot / new_leaf against the plain version; then the device time
    of each of its two kernels at Lh = 16 (torch.profiler);
  * bank: the bank kernel on gbt_d6 and gbt_d8 at 1 to 1,048,576 rows
    (the serving path's launches among them): device time a call
    (torch.profiler: every kernel, memset and copy of 20 calls, over 20)
    and CUDA events a call, each result held against the plain version;
    where the tree has SPLIT_BELOW_ROWS, both walks at every size (the
    module's constants set for the call) and tree blocks of 12 and 16 KB
    at 1,048,576 rows; where it has WIDE_LEAF, the wide records at 1 and
    1,048,576 rows;
  * vs: the vector-sequence kernel at train_vs's shape (200,000 rows of
    make_vs_data padded to 16 vectors of 16, tree 0's 32 anchors of the
    committed train_vs model) and serve_vs's (1,024 fresh rows): device
    time and CUDA events a call, held against the plain version; where
    the tree has `vs_launch_shape`, at 8 and 16 blocks an SM.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
WHICH = sys.argv[2] if len(sys.argv) > 2 else "all"
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import ydf_tpu_torch  # noqa: E402
from ydf_tpu_torch.ops import histogram_kernels as hk  # noqa: E402
from ydf_tpu_torch.serving import bank_scorer, quickscorer  # noqa: E402
from ydf_tpu_torch.utils import cuda_build  # noqa: E402

B, L = 256, 32


def events_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_qs():
    path = os.path.join(ROOT, "ydf_tpu_torch", "testdata", "gbt_d6")
    model = ydf_tpu_torch.load_model(path)
    req = dict(np.load(os.path.join(path, "requests.npz")))
    xT = chip_smoke.encoded_xT(model, chip_smoke.draw_requests(
        req, 1 << 20, np.random.default_rng(0)))
    out = {}
    for mod, build in ((quickscorer, quickscorer.build_quickscorer),
                       (bank_scorer, bank_scorer.build_bank_scorer)):
        tables = build(model).tables
        got = mod.score(tables, xT)
        torch.cuda.synchronize()
        name = mod.__name__.rsplit(".", 1)[-1]
        out[name] = {"ms": events_ms(lambda: mod.score(tables, xT)),
                     "equal_plain": bool(torch.equal(
                         got, mod.score_plain(tables, xT)))}
    print(json.dumps({"gbt_d6_1048576_rows": out}), flush=True)


def routed_args(n, F, Lh, kind="f32", pile=0.0, seed=6):
    """A fused layer as chip_smoke.py builds it (routed_layer: the
    previous layer's Lh splits into 2 Lh of L slots, each split's smaller
    child on a hist slot) on seeded bins; `pile`: the share of rows in bin
    0 of every feature but the first four. Written out here, so that an
    older tree's chip_smoke.py is not needed."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (F, n)).astype(np.uint8)
    if pile:
        bins[4:, rng.uniform(size=n) < pile] = 0
    do_split = np.zeros(L + 1, bool)
    do_split[:Lh] = True
    rank = np.where(do_split, np.arange(L + 1), 0).astype(np.int32)
    cut = rng.integers(32, 224, L + 1)
    left = np.where(do_split, 31 + 2 * np.arange(L + 1), 127)
    small_left = rng.uniform(size=Lh) < 0.5
    hmap = np.full(L + 1, Lh, np.int32)
    hmap[2 * np.arange(Lh)] = np.where(small_left, np.arange(Lh), Lh)
    hmap[2 * np.arange(Lh) + 1] = np.where(small_left, Lh, np.arange(Lh))
    tables = hk.RouteTables(*(torch.from_numpy(a).cuda() for a in (
        do_split, rng.integers(0, F, L + 1).astype(np.int32),
        np.arange(B)[None, :] <= cut[:, None], left.astype(np.int32),
        np.where(do_split, left + 1, 127).astype(np.int32), rank, hmap,
        np.zeros(L + 1, bool), np.zeros(1, np.uint8))))
    slot = np.where(rng.uniform(size=n) < 0.03, L,
                    rng.integers(0, Lh, n)).astype(np.int32)
    stats = torch.from_numpy(rng.normal(size=(n, 3)).astype(
        np.float32)).cuda()
    if kind == "int8":
        stats = (stats * 20).to(torch.int8)
    return (torch.from_numpy(bins).cuda(), torch.from_numpy(slot).cuda(),
            torch.from_numpy(rng.integers(15, 31, n).astype(
                np.int32)).cuda(), tables, stats, Lh, B)


def time_routed():
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for n, F, pile in ((500_000, 28, 0.0), (200_000, 36, 0.0),
                       (200_000, 36, 0.12)):
        for Lh in (1, 2, 4, 8, 16):
            for kind in ("f32", "int8"):
                args = routed_args(n, F, Lh, kind, pile)
                got = hk.histogram_routed(*args)
                torch.cuda.synchronize()
                want = hk.histogram_routed_plain(*args)
                ok = torch.equal(got[1], want[1]) and torch.equal(
                    got[2], want[2])
                out[f"n={n} F={F} pile={pile} Lh={Lh} {kind}"] = (
                    round(events_ms(lambda: hk.histogram_routed(*args), 20),
                          4), ok)
    print(json.dumps({"routed_ms_a_call": out}), flush=True)
    for n, F, pile in ((500_000, 28, 0.0), (200_000, 36, 0.12)):
        args = routed_args(n, F, 16, pile=pile)
        hk.histogram_routed(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                hk.histogram_routed(*args)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if getattr(e, "device_time_total", 0) > 0:
                print(f"profiler n={n} F={F} pile={pile} Lh=16: "
                      f"{e.key[:70]}: {e.device_time_total / e.count:.2f} "
                      f"us a launch ({e.count} launches)", flush=True)


def profiled_ms(fn, calls=20):
    """Device time of one call: the CUDA kernels, memsets and copies of
    `calls` calls under torch.profiler, over `calls` (after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0) / calls / 1e3


def time_bank():
    new = hasattr(bank_scorer, "SPLIT_BELOW_ROWS")
    sizes = (1, 256, 1024, 4096, 16_384, 32_768, 65_536, 131_072, 1 << 20)
    for name in ("gbt_d6", "gbt_d8"):
        path = os.path.join(ROOT, "ydf_tpu_torch", "testdata", name)
        model = ydf_tpu_torch.load_model(path)
        req = dict(np.load(os.path.join(path, "requests.npz")))
        tables = bank_scorer.build_bank_scorer(model).tables
        xT_all = chip_smoke.encoded_xT(model, chip_smoke.draw_requests(
            req, 1 << 20, np.random.default_rng(0)))
        # (rows, label, tables, module settings for the call)
        cases = [(rows, "", tables, {}) for rows in sizes]
        if new:
            cases += [(rows, f" split={split}", tables, {
                "SPLIT_BELOW_ROWS": (1 << 62) if split else 0})
                for rows in sizes for split in (True, False)]
            for kb in (12, 16):
                with settings(TREE_BLOCK_BYTES=kb * 1024):
                    tab = bank_scorer.make_tables(model.forest,
                                                  model.max_depth, "cuda")
                cases.append((1 << 20, f" block_bytes={tab.buf_bytes}",
                              tab, {}))
        if hasattr(bank_scorer, "WIDE_LEAF"):
            with settings(RECORD_BITS=0):  # every forest packs wide
                tab = bank_scorer.make_tables(model.forest, model.max_depth,
                                              "cuda")
            cases += [(rows, " wide", tab, {}) for rows in (1, 1 << 20)]
        for rows, label, tab, kw in cases:
            xT = xT_all[:, :rows].contiguous()
            fn = lambda: bank_scorer.score(tab, xT)  # noqa: E731
            with settings(**kw):
                got = fn()
                torch.cuda.synchronize()
                times = {"device_ms": round(profiled_ms(fn), 4),
                         "events_ms": round(events_ms(fn, 20), 4)}
            print(json.dumps({f"{name} rows={rows}{label}": dict(
                times, equal_plain=bool(torch.equal(
                    got, bank_scorer.score_plain(tab, xT))))}), flush=True)


@contextlib.contextmanager
def settings(**values):
    """bank_scorer's module constants set to `values` inside the block."""
    keep = {k: getattr(bank_scorer, k) for k in values}
    for k, v in values.items():
        setattr(bank_scorer, k, v)
    try:
        yield
    finally:
        for k, v in keep.items():
            setattr(bank_scorer, k, v)


def vs_args(rows, seed):
    """values f32 [rows, 16, 16] zero-padded, lengths i32 (0 for missing
    and empty sequences) from make_vs_data, and tree 0's anchors of the
    committed train_vs model, on the card."""
    data = chip_smoke.make_vs_data(rows, seed=seed)
    L, D = chip_smoke.VS_MAX_LEN, chip_smoke.VS_DIM
    values = np.zeros((rows, L, D), np.float32)
    lengths = np.zeros(rows, np.int32)
    for i, v in enumerate(data["seq"]):
        if v is not None and len(v):
            values[i, :len(v)] = v
            lengths[i] = len(v)
    forest = np.load(os.path.join(ROOT, "ydf_tpu_torch", "testdata",
                                  "train_vs", "forest.npz"))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        values, lengths, forest["vs_anchor"][0], forest["vs_is_closer"][0]))


def time_vs():
    from ydf_tpu_torch.ops import vector_sequence as vso

    shapes = getattr(vso, "BLOCKS_PER_SM", None)
    out = {}
    for path, rows, seed in (("train_vs", 200_000, chip_smoke.DATA_SEED),
                             ("serve_vs", 1024, chip_smoke.REQUEST_SEED)):
        args = vs_args(rows, seed)
        want = vso.vs_scores_plain(*args)
        for per_sm in ((8, 16) if shapes else (None,)):
            if per_sm:
                vso.BLOCKS_PER_SM = per_sm
            fn = lambda: vso.vs_scores(*args)  # noqa: E731
            got = fn()
            torch.cuda.synchronize()
            key = path + (f" blocks_per_sm={per_sm}" if per_sm else "")
            out[key] = {"device_ms": round(profiled_ms(fn), 4),
                        "events_ms": round(events_ms(fn, 20), 4),
                        "equal_plain": bool(torch.equal(got, want))}
            print(json.dumps({key: out[key]}), flush=True)
        if shapes:
            vso.BLOCKS_PER_SM = shapes
    return out


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    secs = cuda_build.build_all(["quickscorer", "bank_scorer",
                                 "histogram_routed", "vector_sequence"],
                                force=True)
    print(f"tree {ROOT}; {smi}; built in {secs:.1f} s", flush=True)
    if WHICH in ("qs", "all"):
        time_qs()
    if WHICH in ("routed", "all"):
        time_routed()
    if WHICH in ("bank", "all"):
        time_bank()
    if WHICH in ("vs", "all"):
        time_vs()
    return 0


if __name__ == "__main__":
    sys.exit(main())
