"""Where the time of the run-sum kernel (csrc/segment_sum.cu) goes, block
by block, on the card.

    python3 scripts/probe_segment_sum.py [TILE ...]

Builds a copy of the kernel with timestamps (clock64, and %globaltimer
for the blocks' start and end) taken by thread 0 of each block after
each step's barrier: staging the tile, the heads (flags, ballots, scan),
the walk (one thread a (run, stat) chain), the carry past the tile's end
and the write-back. Runs it on the largest run-sum call of one-tree
trains of the train_sets GBT, RF and CART (scripts/time_segment_sum.py
captures them), at each TILE (default: segment_sum.TILE), checks the
sums torch.equal to the plain version, and prints for each: the share of
blocks that carry a run past their tile, the kernel's span (first start
to last end), each step's cycles (median, 90th percentile, largest), and
the steps of the block that ends last. The copy is built in a temporary
directory; the repo's kernel is not changed. The timestamps cost a few
hundred cycles a block, so the span is a little above the kernel's own
time.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

STEPS = ("stage", "heads", "walk", "carry", "write")


def instrumented(src):
    """The kernel source with the timestamps and a trace argument."""
    def put(old, new):
        nonlocal src
        assert src.count(old) == 1, f"anchor not found once: {old!r}"
        src = src.replace(old, new)

    put("""             float* __restrict__ out, int E, int S_arg, int T, int vec) {
""", """             float* __restrict__ out, int E, int S_arg, int T, int vec,
             long long* __restrict__ trace) {
  long long* tr = trace + blockIdx.x * 16;
  auto mark = [&](int k) {
    if (threadIdx.x == 0) {
      long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      tr[k] = clock64();
      tr[8 + k] = g;
    }
  };
  mark(0);
""")
    put("  // 2. Head flags", "  mark(1);\n  // 2. Head flags")
    put("  // 3. The tile's last run", "  mark(2);\n  // 3. The tile's last run")
    put("  if (carries && R > 0) {\n", "  mark(3);\n  if (carries && R > 0) {\n")
    put("  // 6. Write the tile back", "  mark(4);\n  // 6. Write the tile back")
    put("""    dst[i] = s_flag[i / S] ? s_val[i] : 0.0f;
  }
}""", """    dst[i] = s_flag[i / S] ? s_val[i] : 0.0f;
  }
  __syncthreads();
  mark(5);
  if (tid == 0) {
    int longest = 0;
    for (int r = 0; r < R; ++r) {
      longest = max(longest, s_head[r + 1] - s_head[r]);
    }
    tr[6] = longest;
    tr[7] = carries && R > 0;
  }
}""")
    put("""           int T, int vec, cudaStream_t stream) {""",
        """           int T, int vec, cudaStream_t stream, long long* trace) {""")
    put("stream>>>(key, vals, out, E, S, T, vec);",
        "stream>>>(key, vals, out, E, S, T, vec, trace);")
    put("""extern "C" int ydf_segment_sums(const void* key, const void* vals, void* out,
                                int E, int S, int T, void* stream) {""",
        """extern "C" int ydf_segment_sums(const void* key, const void* vals, void* out,
                                void* trace, int E, int S, int T, void* stream) {
  long long* tp = static_cast<long long*>(trace);""")
    return src.replace("vec, st);", "vec, st, tp);")


def main(tiles):
    import numpy as np
    import torch

    import time_segment_sum
    from ydf_tpu_torch.ops import segment_sum
    from ydf_tpu_torch.utils import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    tiles = tiles or [segment_sum.TILE]
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.so")
        with open(cuda_build.source_path("segment_sum")) as f:
            with open(cu, "w") as g:
                g.write(instrumented(f.read()))
        subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        so, cu], check=True, capture_output=True)
        fn = ctypes.CDLL(so).ydf_segment_sums
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        time_segment_sum.capture(tmp)
        for path in time_segment_sum.PATHS:
            calls = torch.load(os.path.join(tmp, f"{path}.pt"))
            key, vals = (t.cuda() for t in max(
                calls, key=lambda a: a[0].shape[0]))
            E, S = vals.shape
            want = segment_sum.segment_sums_plain(key, vals)
            for T in tiles:
                blocks = (E + T - 1) // T
                trace = torch.zeros(blocks * 16, dtype=torch.int64,
                                    device="cuda")
                out = torch.empty_like(vals)
                for _ in range(5):  # warm, then the last run is read
                    status = fn(key.data_ptr(), vals.data_ptr(),
                                out.data_ptr(), trace.data_ptr(), E, S, T,
                                torch.cuda.current_stream().cuda_stream)
                    assert status == 0, status
                torch.cuda.synchronize()
                assert torch.equal(out, want), f"{path} T={T}: != plain"
                tr = trace.view(blocks, 16).cpu().numpy()
                cycles = np.diff(tr[:, :6], axis=1)
                ns = tr[:, 8:14] - tr[:, 8].min()
                last = int(np.argmax(ns[:, 5]))
                steps = "; ".join(
                    f"{name} {np.median(cycles[:, k]):.0f} / "
                    f"{np.percentile(cycles[:, k], 90):.0f} / "
                    f"{cycles[:, k].max()}" for k, name in enumerate(STEPS))
                print(f"{path} (E={E}, S={S}) tile {T}: {blocks} blocks, "
                      f"{100 * tr[:, 7].mean():.0f}% carry a run past their "
                      f"tile; span {ns[:, 5].max() / 1e3:.2f} us, the blocks "
                      f"started within {ns[:, 0].max() / 1e3:.2f} us; cycles "
                      f"a step (median / p90 / max): {steps}; the last block "
                      f"to end: {dict(zip(STEPS, cycles[last].tolist()))}, "
                      f"its longest run {tr[last, 6]}; {smi}", flush=True)


if __name__ == "__main__":
    main([int(t) for t in sys.argv[1:]])
