// NUMERICAL_VECTOR_SEQUENCE anchor scores for Hopper (sm_90a).
//
// Replaces the TPU kernel ydf_tpu/ops/vector_sequence.py:_vs_kernel
// (wrapper _scores_pallas). Called from ydf_tpu_torch/ops/vector_sequence.py:
// vs_scores, which also holds the launch shape (vs_launch_shape) and the
// plain PyTorch version (vs_scores_plain) this kernel is tested against.
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
// 0.8 G, take about 0.023 ms at 67 TFLOP/s. Bytes bound it, and then the
// instructions a vector costs each anchor. The first design (a thread per
// (example, anchor), D a runtime value) spent 16 global loads of v and 16
// shared loads of the anchor on every dot, recomputed |v|^2 in every
// closer-than thread, and split each warp in half on the anchor's kind.
//
// What this design does about it:
//   * a warp owns a row at a time (a grid-stride loop over rows), a lane an
//     anchor (32 at a time); the lane keeps its anchor and |a|^2 in
//     registers for all its rows when the anchors fit one pass;
//   * D is a template argument (16 on both paths; D = 0 is the generic
//     instantiation, D a runtime value): the dot and |v|^2 loops unroll;
//   * the row's real vectors, 32 at a time, are copied into the warp's
//     shared buffer with 16-byte copies, coalesced (the padding past the
//     length is never read); the first 32 with cp.async a row ahead,
//     into the other of two buffers, so a row's loads overlap the
//     scoring of the row before (two rows ahead, or the lengths loaded a
//     row early, took more registers and ran 5-7% slower on the card);
//     each vector's |v|^2 is computed once, by one
//     lane, into shared memory; then every lane reads the vector as four
//     16-byte broadcast loads;
//   * every lane computes both the max dot and the min d2 and picks its
//     kind's score with a select: no divergent branch;
//   * a warp writes a row's scores as one contiguous segment.
// The generic instantiation reads the vectors and anchors from global
// memory (L1-cached broadcast loads) instead of staging them.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // a block's warps (vs_launch_shape's WARPS)
constexpr int kChunk = 32;  // vectors a warp stages at once

template <int LANES>
__device__ __forceinline__ float lane_sum(const float (&acc)[LANES]) {
  if constexpr (LANES == 1) {
    return acc[0];
  } else if constexpr (LANES == 2) {
    return __fadd_rn(acc[0], acc[1]);
  } else {
    return __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
  }
}

// Anchor a (clamped to A - 1) into registers (DT > 0), its |a|^2 and its
// kind.
template <int DT>
__device__ __forceinline__ void load_anchor(
    const float* __restrict__ anchors, const uint8_t* __restrict__ is_closer,
    int a, int A, int D, float (&av)[DT > 0 ? DT : 1], float& asq,
    bool& closer) {
  a = min(a, A - 1);
  const float* ap = anchors + static_cast<size_t>(a) * D;
  asq = 0.0f;
  if constexpr (DT > 0) {
#pragma unroll
    for (int d = 0; d < DT; ++d) av[d] = __ldg(ap + d);
#pragma unroll
    for (int d = 0; d < DT; ++d) asq = __fmaf_rn(av[d], av[d], asq);
  } else {
    for (int d = 0; d < D; ++d) {
      const float x = __ldg(ap + d);
      asq = __fmaf_rn(x, x, asq);
    }
  }
  closer = is_closer[a] != 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ int clamp_len(const int32_t* lengths, int e,
                                         int n, int L) {
  return e < n ? min(max(lengths[e], 0), L) : 0;
}

// |v|^2 of the chunk's vectors into vsq (lane j, vector j), from the
// staged chunk (DT > 0) or from global memory.
template <int DT>
__device__ __forceinline__ void chunk_norms(const float* staged,
                                            const float* vc, int cnt, int D,
                                            int lane, float* vsq) {
  if (lane >= cnt) return;
  float sq = 0.0f;
  if constexpr (DT > 0) {
    const float* v = staged + lane * DT;
#pragma unroll
    for (int d = 0; d < DT; ++d) sq = __fmaf_rn(v[d], v[d], sq);
  } else {
    const float* v = vc + static_cast<size_t>(lane) * D;
    for (int d = 0; d < D; ++d) {
      const float x = __ldg(v + d);
      sq = __fmaf_rn(x, x, sq);
    }
  }
  vsq[lane] = sq;
}

// DT > 0: D = DT, the row's vectors staged in shared memory and the
// lane's anchor in registers; DT = 0: D at run time, both read from
// global memory. Shared memory a warp: two [kChunk][DT] row buffers (a
// row's first chunk is copied a row ahead with cp.async, while the warp
// scores the row before) and kChunk |v|^2.
template <int DT, int LANES>
__global__ void __launch_bounds__(kWarps * 32)
vs_kernel(const float* __restrict__ values,
          const int32_t* __restrict__ lengths,
          const float* __restrict__ anchors,
          const uint8_t* __restrict__ is_closer, float* __restrict__ out,
          int n, int L, int D_rt, int A) {
  constexpr int kBuf = DT > 0 ? kChunk * DT : 4;
  __shared__ __align__(16) float s_row[kWarps][2][kBuf];
  __shared__ float s_vsq[kWarps][kChunk];
  const int D = DT > 0 ? DT : D_rt;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* vsq_buf = s_vsq[warp];
  float av[DT > 0 ? DT : 1];  // the lane's anchor (DT > 0)
  float asq = 0.0f;
  bool closer = false;
  const bool one_pass = A <= 32;
  if (one_pass) {
    load_anchor<DT>(anchors, is_closer, lane, A, D, av, asq, closer);
  }

  // Copies the first min(len, kChunk) vectors of row e (none past n)
  // into buffer b, as one cp.async group.
  const int stride = gridDim.x * kWarps;
  auto prefetch = [&](int e, int len, int b) {
    if constexpr (DT > 0) {
      static_assert(DT % 4 == 0, "16-byte copies need DT % 4 == 0");
      const float* src = values + static_cast<size_t>(e) * L * DT;
      float* dst = s_row[warp][b];
      const int n4 = e < n ? min(len, kChunk) * (DT / 4) : 0;
      for (int i = lane; i < n4; i += 32) {
        cp_async16(dst + 4 * i, src + 4 * i);
      }
    }
    cp_async_commit();
  };

  // The warp's rows e, e + stride, ...: the next row's first chunk is in
  // flight while the warp scores this one.
  int e = blockIdx.x * kWarps + warp;
  int len_next = clamp_len(lengths, e, n, L);
  prefetch(e, len_next, 0);
  for (int b = 0; e < n; e += stride, b ^= 1) {
    const int len = len_next;
    const float* ve = values + static_cast<size_t>(e) * L * D;
    float* buf = s_row[warp][b];
    len_next = clamp_len(lengths, e + stride, n, L);
    prefetch(e + stride, len_next, b ^ 1);
    cp_async_wait_one();  // this row's first chunk has landed
    __syncwarp();
    const bool one_chunk = len <= kChunk;
    if (one_chunk) {
      chunk_norms<DT>(buf, ve, len, D, lane, vsq_buf);
      __syncwarp();
    }
    for (int a0 = 0; a0 < A; a0 += 32) {
      if (!one_pass) {
        load_anchor<DT>(anchors, is_closer, a0 + lane, A, D, av, asq,
                        closer);
      }
      const float* ap =
          anchors + static_cast<size_t>(min(a0 + lane, A - 1)) * D;
      float best_dot = -FLT_MAX;
      float min_d2 = FLT_MAX;
      for (int l0 = 0; l0 < len; l0 += kChunk) {
        const int cnt = min(kChunk, len - l0);
        const float* vc = ve + static_cast<size_t>(l0) * D;
        if (!one_chunk) {  // a sequence longer than a chunk: load it here
          __syncwarp();
          if constexpr (DT > 0) {
            const float4* src = reinterpret_cast<const float4*>(vc);
            float4* dst = reinterpret_cast<float4*>(buf);
            for (int j = lane; j < cnt * (DT / 4); j += 32) {
              dst[j] = __ldg(src + j);
            }
            __syncwarp();
          }
          chunk_norms<DT>(buf, vc, cnt, D, lane, vsq_buf);
          __syncwarp();
        }
        for (int l = 0; l < cnt; ++l) {
          float acc[LANES];
#pragma unroll
          for (int k = 0; k < LANES; ++k) acc[k] = 0.0f;
          if constexpr (DT > 0) {
            const float4* v4 =
                reinterpret_cast<const float4*>(buf + l * DT);
#pragma unroll
            for (int q = 0; q < DT / 4; ++q) {
              const float4 x = v4[q];
              acc[(4 * q + 0) % LANES] =
                  __fmaf_rn(x.x, av[4 * q + 0], acc[(4 * q + 0) % LANES]);
              acc[(4 * q + 1) % LANES] =
                  __fmaf_rn(x.y, av[4 * q + 1], acc[(4 * q + 1) % LANES]);
              acc[(4 * q + 2) % LANES] =
                  __fmaf_rn(x.z, av[4 * q + 2], acc[(4 * q + 2) % LANES]);
              acc[(4 * q + 3) % LANES] =
                  __fmaf_rn(x.w, av[4 * q + 3], acc[(4 * q + 3) % LANES]);
            }
          } else {
            const float* v = vc + static_cast<size_t>(l) * D;
            int d = 0;
            for (; d + LANES <= D; d += LANES) {
#pragma unroll
              for (int k = 0; k < LANES; ++k) {
                acc[k] = __fmaf_rn(__ldg(v + d + k), __ldg(ap + d + k),
                                   acc[k]);
              }
            }
#pragma unroll
            for (int k = 0; k < LANES; ++k) {
              if (d + k < D) {
                acc[k] = __fmaf_rn(__ldg(v + d + k), __ldg(ap + d + k),
                                   acc[k]);
              }
            }
          }
          const float dot = lane_sum<LANES>(acc);
          const float d2 =
              __fadd_rn(__fsub_rn(vsq_buf[l], 2.0f * dot), asq);
          best_dot = fmaxf(best_dot, dot);
          min_d2 = fminf(min_d2, d2);
        }
      }
      if (a0 + lane < A) {
        out[static_cast<size_t>(e) * A + a0 + lane] =
            closer ? -min_d2 : best_dot;
      }
    }
    __syncwarp();  // buf and the norms free for the rows after
  }
}

template <int DT, int LANES>
void launch(const float* v, const int32_t* len, const float* an,
            const uint8_t* ic, float* o, int n, int L, int D, int A,
            int blocks, cudaStream_t s) {
  vs_kernel<DT, LANES><<<blocks, kWarps * 32, 0, s>>>(v, len, an, ic, o, n,
                                                      L, D, A);
}

template <int DT>
int launch_lanes(int lanes, const float* v, const int32_t* len,
                 const float* an, const uint8_t* ic, float* o, int n, int L,
                 int D, int A, int blocks, cudaStream_t s) {
  switch (lanes) {
    case 1:
      launch<DT, 1>(v, len, an, ic, o, n, L, D, A, blocks, s);
      break;
    case 2:
      launch<DT, 2>(v, len, an, ic, o, n, L, D, A, blocks, s);
      break;
    case 4:
      launch<DT, 4>(v, len, an, ic, o, n, L, D, A, blocks, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values f32 [n, L, D], lengths i32 [n], anchors f32 [A, D], is_closer u8
// [A] -> out f32 [n, A]. lanes in {1, 2, 4}; blocks of 4 warps
// (vs_launch_shape); staged: D == 16 with values 16-byte aligned (the
// D = 16 instantiation), else the generic one.
extern "C" int ydf_vs_scores(const void* values, const void* lengths,
                             const void* anchors, const void* is_closer,
                             void* out, int n, int L, int D, int A,
                             int lanes, int blocks, int staged,
                             void* stream) {
  if (n <= 0 || A <= 0) return 0;
  if (L <= 0 || D <= 0 || blocks <= 0 || (staged && D != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(values);
  const auto* len = static_cast<const int32_t*>(lengths);
  const auto* an = static_cast<const float*>(anchors);
  const auto* ic = static_cast<const uint8_t*>(is_closer);
  auto* o = static_cast<float*>(out);
  return staged ? launch_lanes<16>(lanes, v, len, an, ic, o, n, L, D, A,
                                   blocks, s)
                : launch_lanes<0>(lanes, v, len, an, ic, o, n, L, D, A,
                                  blocks, s);
}
