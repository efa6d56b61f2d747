// NUMERICAL_VECTOR_SEQUENCE anchor scores for Hopper (sm_90a).
//
// Replaces the TPU kernel ydf_tpu/ops/vector_sequence.py:_vs_kernel
// (wrapper _scores_pallas). Called from ydf_tpu_torch/ops/vector_sequence.py:
// vs_scores, which also holds the plain PyTorch version (vs_scores_plain)
// this kernel is tested against.
//
// What it computes, per example e and anchor a (values f32 [n, L, D]
// zero-padded, lengths i32 [n], anchors f32 [A, D], is_closer u8 [A]):
//   dot_l = <v_l, a>,  d2_l = (|v_l|^2 - 2 dot_l) + |a|^2,   l < len_e
//   projected-more-than: score = max_l dot_l
//   closer-than:         score = -min_l d2_l
// An empty sequence scores -FLT_MAX, bitwise (the running max starts at
// -FLT_MAX, the running min at FLT_MAX and is negated). d2 is the
// expansion the JAX package computes, not |v - a|^2, so both round alike.
//
// Rounding, fixed: |v|^2 and |a|^2 are fused multiply-adds over d in
// increasing order from 0; a dot keeps `LANES` accumulators (d mod LANES),
// each a chain of fused multiply-adds in increasing d, summed as a pairwise
// tree. The wrapper picks LANES as XLA's CPU dot does at this anchor count
// (2 at 32 anchors), so the scores equal the JAX package's CPU scores bit
// for bit on the paths that train and serve. No tensor cores: TF32 would
// cancel catastrophically in d2 (vector_sequence.py:42-43).
//
// What bounds it on this card: at the training shape (200,000 rows of up
// to 16 vectors of 16, 32 anchors) the real vectors are about 98 MB and the
// scores 26 MB, about 0.037 ms at 3.35 TB/s; the multiply-adds, about
// 0.8 G, take about 0.023 ms at 67 TFLOP/s. Bytes bound it.
//
// What the simple design does about it: a block is a [rows x At] tile of
// (example, anchor) pairs, one thread each, with the tile's anchors
// (transposed, so a warp's reads hit 32 banks) and |a|^2 in shared
// memory. The At threads of a row read the same vector values (a
// broadcast), loop over l < len only, so padding is never read, and
// write their scores as one contiguous segment of the row.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;

// <v, a> for v[0..D) and a[d * a_stride], d in [0, D).
template <int LANES>
__device__ __forceinline__ float lane_dot(const float* __restrict__ v,
                                          const float* __restrict__ a,
                                          int a_stride, int D) {
  float acc[LANES];
#pragma unroll
  for (int k = 0; k < LANES; ++k) acc[k] = 0.0f;
  int d = 0;
  for (; d + LANES <= D; d += LANES) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) {
      acc[k] = __fmaf_rn(v[d + k], a[(d + k) * a_stride], acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < LANES; ++k) {
    if (d + k < D) {
      acc[k] = __fmaf_rn(v[d + k], a[(d + k) * a_stride], acc[k]);
    }
  }
  if constexpr (LANES == 1) {
    return acc[0];
  } else if constexpr (LANES == 2) {
    return __fadd_rn(acc[0], acc[1]);
  } else {
    return __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
  }
}

template <int LANES>
__global__ void __launch_bounds__(kThreads)
vs_kernel(const float* __restrict__ values,
          const int32_t* __restrict__ lengths,
          const float* __restrict__ anchors,
          const uint8_t* __restrict__ is_closer, float* __restrict__ out,
          int n, int L, int D, int A, int At) {
  extern __shared__ __align__(16) float smem[];
  // Anchors transposed, [D, At]: the lanes of a warp (consecutive
  // anchors) read consecutive words, one per bank. Row-major [At, D]
  // would put lanes 2 apart on one bank at D = 16, a 16-way conflict.
  float* s_anchor = smem;
  float* s_asq = smem + At * D;     // [At]
  const int a0 = blockIdx.y * At;
  const int ac = min(At, A - a0);
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < ac * D;
       i += blockDim.x * blockDim.y) {
    const int al = i / D;
    s_anchor[(i - al * D) * At + al] =
        anchors[static_cast<size_t>(a0) * D + i];
  }
  __syncthreads();
  if (threadIdx.y == 0 && static_cast<int>(threadIdx.x) < ac) {
    const float* av = s_anchor + threadIdx.x;
    float sq = 0.0f;
    for (int d = 0; d < D; ++d) sq = __fmaf_rn(av[d * At], av[d * At], sq);
    s_asq[threadIdx.x] = sq;
  }
  __syncthreads();

  const int ai = threadIdx.x;
  const int e = blockIdx.x * blockDim.y + threadIdx.y;
  if (ai >= ac || e >= n) return;
  const int a = a0 + ai;
  const float* av = s_anchor + ai;
  const bool closer = is_closer[a] != 0;
  const float asq = s_asq[ai];
  const int len = min(max(lengths[e], 0), L);
  const float* ve = values + static_cast<size_t>(e) * L * D;
  float best_dot = -FLT_MAX;
  float min_d2 = FLT_MAX;
  for (int l = 0; l < len; ++l) {
    const float* vl = ve + static_cast<size_t>(l) * D;
    const float dot = lane_dot<LANES>(vl, av, At, D);
    if (closer) {
      float vsq = 0.0f;
      for (int d = 0; d < D; ++d) vsq = __fmaf_rn(vl[d], vl[d], vsq);
      const float d2 = __fadd_rn(__fsub_rn(vsq, 2.0f * dot), asq);
      min_d2 = fminf(min_d2, d2);
    } else {
      best_dot = fmaxf(best_dot, dot);
    }
  }
  out[static_cast<size_t>(e) * A + a] = closer ? -min_d2 : best_dot;
}

}  // namespace

// values f32 [n, L, D], lengths i32 [n], anchors f32 [A, D], is_closer u8
// [A] -> out f32 [n, A]. At anchors per block (<= 32, their rows under
// kSmemBytes; the wrapper sizes it), lanes in {1, 2, 4}.
extern "C" int ydf_vs_scores(const void* values, const void* lengths,
                             const void* anchors, const void* is_closer,
                             void* out, int n, int L, int D, int A, int At,
                             int lanes, void* stream) {
  if (n <= 0 || A <= 0) return 0;
  const int smem = (At * D + At) * static_cast<int>(sizeof(float));
  if (At <= 0 || At > 32 || L <= 0 || D <= 0 || smem > kSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(At, kThreads / At);
  const dim3 grid((n + block.y - 1) / block.y, (A + At - 1) / At);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(values);
  const auto* len = static_cast<const int32_t*>(lengths);
  const auto* an = static_cast<const float*>(anchors);
  const auto* ic = static_cast<const uint8_t*>(is_closer);
  auto* o = static_cast<float*>(out);
  switch (lanes) {
    case 1:
      vs_kernel<1><<<grid, block, smem, s>>>(v, len, an, ic, o, n, L, D, A,
                                              At);
      break;
    case 2:
      vs_kernel<2><<<grid, block, smem, s>>>(v, len, an, ic, o, n, L, D, A,
                                              At);
      break;
    case 4:
      vs_kernel<4><<<grid, block, smem, s>>>(v, len, an, ic, o, n, L, D, A,
                                              At);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
