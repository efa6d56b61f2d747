"""Times the run-sum kernel (csrc/segment_sum.cu) on the card at the set
paths' calls, for several trees of the repo and tile sizes in one call.

    python3 scripts/time_segment_sum.py SPEC [SPEC ...]

SPEC is ROOT or ROOT:TILE. ROOT is a directory holding the
`ydf_tpu_torch` package and `chip_smoke.py` to time (`.` for this
checkout; an older tree unpacked with `git archive <commit> | tar -x -C
chip_tree/parent`); TILE sets that tree's `segment_sum.TILE` where it has
one. Give the trees in turns (parent, change, change, parent) to compare
them on one card.

First, in this checkout, it captures every run-sum call of a one-tree
train of the train_sets GBT, RF and CART (chip_smoke's frames and
hyper-parameters; two calls a layer) and saves them to a temporary
directory. Then, for each SPEC in order, a subprocess of that tree times
its kernel on those inputs: each path's largest call (device ms by
torch.profiler, ms a call by CUDA events over 20 calls back to back,
`index_add_` the same way, the bound: keys and values read once, sums
written once, at 3.35 TB/s), and every call of the one-tree train by
CUDA events around each (the one-tree path ms). Every call's result is
checked torch.equal to that tree's plain version. Prints one line a
(SPEC, path) with the card's name and power limit, and writes all of it
to chiprun_out/time_segment_sum.json.
"""

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("train_sets_gbt", "train_sets_rf", "train_sets_cart")


def capture(out_dir):
    """Every run-sum call of the three one-tree trains, saved as
    out_dir/<path>.pt: a list of (key, vals) on the CPU."""
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke
    import ydf_tpu_torch

    cs = chip_smoke
    for path, cls, hp, rows in (
            ("train_sets_gbt", ydf_tpu_torch.GradientBoostedTreesLearner,
             cs.DEFAULT_HP, (cs.SETS_GBT_ROWS, cs.SETS_GBT_TEST_ROWS)),
            ("train_sets_rf", ydf_tpu_torch.RandomForestLearner, cs.RF_HP,
             (cs.SETS_RF_ROWS, cs.SETS_RF_TEST_ROWS)),
            ("train_sets_cart", ydf_tpu_torch.CartLearner, cs.CART_HP,
             (cs.SETS_CART_ROWS, cs.SETS_CART_TEST_ROWS))):
        train, _ = cs.make_set_frame(*rows)
        calls = chip_smoke.captured_layers(cls, hp, train)["segment"]
        torch.save([(k.cpu(), v.cpu()) for k, v in calls],
                   os.path.join(out_dir, f"{path}.pt"))
        print(f"captured {path}: {len(calls)} run-sum calls", flush=True)


def worker(root, tile, in_dir):
    """Times `root`'s kernel on the saved calls; prints one JSON line."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from ydf_tpu_torch.ops import segment_sum

    if tile and hasattr(segment_sum, "TILE"):
        segment_sum.TILE = tile
    out = {"root": root, "tile": getattr(segment_sum, "TILE", None)}
    for path in PATHS:
        calls = [(k.cuda(), v.cuda()) for k, v in torch.load(
            os.path.join(in_dir, f"{path}.pt"))]
        for args in calls:
            got = segment_sum.segment_sums(*args)
            assert torch.equal(got, segment_sum.segment_sums_plain(*args)), (
                f"{root} {path}: kernel != plain")
        # Every call of the one-tree train, CUDA events around each.
        segment_sum.segment_sums(*calls[0])
        torch.cuda.synchronize()
        path_ms = 0.0
        for args in calls:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            segment_sum.segment_sums(*args)
            end.record()
            torch.cuda.synchronize()
            path_ms += start.elapsed_time(end)
        key, vals = max(calls, key=lambda a: a[0].shape[0])
        E, S = vals.shape
        head = segment_sum.run_heads(key)
        run_of = torch.cumsum(head.long(), 0) - 1
        heads = torch.nonzero(head)[:, 0][run_of]
        lengths = torch.bincount(run_of)
        kernel = lambda: segment_sum.segment_sums(key, vals)  # noqa: E731
        library = lambda: torch.zeros_like(vals).index_add_(  # noqa: E731
            0, heads, vals)
        dev_ms, how = chip_smoke.device_ms(kernel, ("run_sums",), reps=20)
        lib_ms, lib_how = chip_smoke.device_ms(library, ("index",), reps=20)
        out[path] = {
            "calls": len(calls), "E": E, "S": S, "runs": int(head.sum()),
            "longest_run": int(lengths.max()),
            "device_ms": dev_ms, "device_how": how,
            "ms": chip_smoke.time_ms(kernel, reps=20),
            "library_device_ms": lib_ms, "library_how": lib_how,
            "library_ms": chip_smoke.time_ms(library, reps=20),
            "bound_ms": (E * 8 + 2 * E * S * 4) / chip_smoke.HBM_BYTES_PER_S
            * 1e3,
            "one_tree_path_ms": path_ms,
        }
    print(json.dumps(out), flush=True)


def main(specs):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        capture(tmp)
        for spec in specs:
            root, _, tile = spec.partition(":")
            root = os.path.abspath(os.path.join(HERE, root))
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root,
                 tile or "0", tmp], capture_output=True, text=True, cwd=root)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                raise SystemExit(f"{spec}: exit {proc.returncode}")
            r = json.loads(proc.stdout.strip().splitlines()[-1])
            r["spec"] = spec
            results.append(r)
            for path in PATHS:
                p = r[path]
                print(f"{spec} (tile {r['tile']}) {path}: E={p['E']}, "
                      f"S={p['S']}, runs {p['runs']}, longest run "
                      f"{p['longest_run']}; kernel {p['device_ms']:.4f} ms "
                      f"on the card ({p['device_how']}), "
                      f"{p['ms']:.4f} ms a call; index_add_ "
                      f"{p['library_device_ms']:.4f} ms on the card, "
                      f"{p['library_ms']:.4f} a call; bound "
                      f"{p['bound_ms']:.4f} ms ({100 * p['bound_ms'] / p['device_ms']:.1f}%); "
                      f"{p['calls']} calls of a one-tree train "
                      f"{p['one_tree_path_ms']:.3f} ms (events); {smi}",
                      flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "time_segment_sum.json"),
              "w") as f:
        json.dump({"card": smi, "results": results}, f, indent=1)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    else:
        main(sys.argv[1:] or ["."])
