"""Times the QuickScorer and fused route + histogram kernels of one tree
of the repo on the card, at the main paths' shapes.

    python3 scripts/time_redesigned_kernels.py [ROOT] [qs|routed|all]

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
    of each of its two kernels at Lh = 16 (torch.profiler).
"""

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


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    secs = cuda_build.build_all(["quickscorer", "bank_scorer",
                                 "histogram_routed"], force=True)
    print(f"tree {ROOT}; {smi}; built in {secs:.1f} s", flush=True)
    if WHICH in ("qs", "all"):
        time_qs()
    if WHICH in ("routed", "all"):
        time_routed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
