"""How fast a warp can add three stats into a shared-memory histogram
cell on the card, by each way the root histogram kernel
(ydf_tpu_torch/csrc/histogram.cu) could settle lanes that hit the same
cell: shared f32 atomicAdd, __match_any_sync with a shuffle sum and one
leader add, tag rounds, and, as floors, a plain read-modify-write (wrong
under collisions) and native int32 atomicAdd.

Each warp owns 256 cells of 3 floats (one feature's sub-histogram) and
adds at random cells, 48 warps on each SM; the script prints the time
of one 32-lane step on one SM, in ns and in SM cycles at the clock
nvidia-smi reports after the run, and the shared-atomic opcodes in the
SASS.

    python3 scripts/bench_shared_adds.py     # needs one CUDA card and nvcc
"""

import ctypes
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ydf_tpu_torch.utils import cuda_build  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned hash(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU;
  return x ^ (x >> 16);
}

template <int MODE>
__global__ void __launch_bounds__(256) bench(float* out, int iters) {
  __shared__ float sh[8][768];
  __shared__ int tag[8][256];
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 8 * 768; i += 256) (&sh[0][0])[i] = 0.f;
  __syncthreads();
  float acc = 0.f;
  unsigned seed = hash(blockIdx.x * 256 + threadIdx.x);
  float* hist = sh[warp];
  for (int it = 0; it < iters; ++it) {
    seed = hash(seed + it);
    const int key = seed & 255;
    float* c = hist + key * 3;
    if (MODE == 0) {  // shared f32 atomicAdd
      atomicAdd(c, 1.f); atomicAdd(c + 1, 2.f); atomicAdd(c + 2, 3.f);
    } else if (MODE == 1) {  // __match_any_sync alone
      acc += __match_any_sync(full, key);
    } else if (MODE == 2) {  // match, shuffle sum, leader add
      const unsigned peers = __match_any_sync(full, key);
      float v0 = 1.f, v1 = 2.f, v2 = 3.f;
      const bool leader = (__ffs(peers) - 1) == lane;
      unsigned rest = leader ? (peers & (peers - 1)) : 0u;
      while (__any_sync(full, rest != 0)) {
        const int src = rest ? __ffs(rest) - 1 : lane;
        const float o0 = __shfl_sync(full, v0, src);
        const float o1 = __shfl_sync(full, v1, src);
        const float o2 = __shfl_sync(full, v2, src);
        if (rest) { v0 += o0; v1 += o1; v2 += o2; }
        rest &= rest - 1;
      }
      if (leader) { c[0] += v0; c[1] += v1; c[2] += v2; }
      __syncwarp();
    } else if (MODE == 3) {  // tag rounds
      bool pending = true;
      while (__any_sync(full, pending)) {
        if (pending) tag[warp][key] = lane;
        __syncwarp();
        const bool win = pending && tag[warp][key] == lane;
        if (win) { c[0] += 1.f; c[1] += 2.f; c[2] += 3.f; }
        pending = pending && !win;
        __syncwarp();
      }
    } else if (MODE == 4) {  // plain read-modify-write
      c[0] += 1.f; c[1] += 2.f; c[2] += 3.f;
      __syncwarp();
    } else {  // native int32 atomicAdd
      int* ci = reinterpret_cast<int*>(c);
      atomicAdd(ci, 1); atomicAdd(ci + 1, 2); atomicAdd(ci + 2, 3);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = acc + sh[0][0] + tag[0][0];
}

extern "C" int run(int mode, float* out, int blocks, int iters,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: bench<0><<<blocks, 256, 0, s>>>(out, iters); break;
    case 1: bench<1><<<blocks, 256, 0, s>>>(out, iters); break;
    case 2: bench<2><<<blocks, 256, 0, s>>>(out, iters); break;
    case 3: bench<3><<<blocks, 256, 0, s>>>(out, iters); break;
    case 4: bench<4><<<blocks, 256, 0, s>>>(out, iters); break;
    default: bench<5><<<blocks, 256, 0, s>>>(out, iters); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""

WAYS = ("shared f32 atomicAdd", "__match_any_sync alone",
        "match, shuffle sum, leader add", "tag rounds",
        "plain read-modify-write (wrong under collisions)",
        "native int32 atomicAdd")
SMS, BLOCKS_PER_SM, WARPS_PER_BLOCK, ITERS = 132, 6, 8, 4000


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("bench_shared_adds: CUDA is not available", file=sys.stderr)
        return 1
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "bench_shared_adds.cu")
    lib_path = os.path.join(cuda_build.BUILD_DIR, "libbench_shared_adds.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = cuda_build.find_nvcc()
    subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", lib_path, src],
                   check=True, capture_output=True, text=True)
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         lib_path], capture_output=True, text=True).stdout
    lib = ctypes.CDLL(lib_path)
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
    lib.run.restype = ctypes.c_int
    blocks = SMS * BLOCKS_PER_SM
    out = torch.zeros(blocks, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    steps_per_sm = BLOCKS_PER_SM * WARPS_PER_BLOCK * ITERS
    ns = {}
    for mode, way in enumerate(WAYS):
        assert lib.run(mode, out.data_ptr(), blocks, 10, stream) == 0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        assert lib.run(mode, out.data_ptr(), blocks, ITERS, stream) == 0
        end.record()
        torch.cuda.synchronize()
        ns[way] = start.elapsed_time(end) * 1e6 / steps_per_sm
    mhz = float(smi("clocks.sm").split()[0])
    print(smi("name,power.limit"))
    print(f"SM clock after the runs {mhz:.0f} MHz; shared atomics in the "
          "SASS: " + ", ".join(sorted(set(re.findall(r"ATOMS\.[A-Z0-9.]+",
                                                     sass)))))
    for way, t in ns.items():
        print(f"{way}: {t:.3f} ns = {t * mhz / 1e3:.1f} SM cycles per "
              f"32-lane step of three adds ({BLOCKS_PER_SM * WARPS_PER_BLOCK}"
              " warps per SM)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
