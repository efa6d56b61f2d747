// Sums of runs of equal keys, each added in order from 0, one f32
// rounding an add: the set candidates' per-item sums
// (ydf_tpu_torch/ops/segment_sum.py, ops/grower.py:set_item_stats),
// which replay the order of XLA's CPU dot in the JAX package's einsum
// "nfv,nl,ns->lfvs" (ydf_tpu/ops/grower.py, the categorical-set block).
//
//   out[i, s] = ((0 + vals[i, s]) + vals[i + 1, s]) + ... over the run
//               of key[i] when i heads its run (i == 0 or key[i - 1] !=
//               key[i]), else 0.
//
// key is i64 [E], sorted so that every run is contiguous; vals and out
// are f32 [E, S] row-major. One thread an entry: a run's head walks its
// run alone, in order (a sum of a run may not be split, or it would
// round otherwise); the other threads write zeros. The adds are
// __fadd_rn: no contraction, no reassociation.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void run_sums(const int64_t* __restrict__ key,
                         const float* __restrict__ vals,
                         float* __restrict__ out, int E, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const int64_t k = key[i];
  const bool head = i == 0 || key[i - 1] != k;
  for (int s = 0; s < S; ++s) {
    float acc = 0.0f;
    if (head) {
      for (int j = i; j < E && key[j] == k; ++j) {
        acc = __fadd_rn(acc, vals[static_cast<int64_t>(j) * S + s]);
      }
    }
    out[static_cast<int64_t>(i) * S + s] = acc;
  }
}

}  // namespace

// Returns a cudaError_t as int (0 = launched).
extern "C" int ydf_segment_sums(const void* key, const void* vals, void* out,
                                int E, int S, void* stream) {
  if (E <= 0 || S <= 0) return 0;
  const int blocks = (E + kThreads - 1) / kThreads;
  run_sums<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), static_cast<const float*>(vals),
      static_cast<float*>(out), E, S);
  return static_cast<int>(cudaGetLastError());
}
