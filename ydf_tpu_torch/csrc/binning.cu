// Quantile binning for Hopper (sm_90a).
//
// Replaces the TPU kernel ydf_tpu/ops/binning_pallas.py:_bin_kernel
// (wrapper binning_pallas). Called from ydf_tpu_torch/ops/binning.py:
// bin_columns, which also holds the plain PyTorch version
// (bin_columns_plain) this kernel is tested against.
//
// What it computes, per value v = values[f, r] (feature-major input):
//   v   = isnan(v) ? impute[f] : v
//   bin = isnan(v) ? nb : #{b < nb : boundaries[f, b] <= v}
// with nb = nbounds[f] <= 255, written as u8 feature-major, out[f, r]
// (the layout the training path keeps). The boundaries of a feature ascend, so the count is the upper bound of v
// among the first nb: the same bin as the TPU kernel's compare-and-count
// and as numpy's searchsorted(side="right").
//
// What bounds it on this card: memory. Each value is read once (4 bytes)
// and its bin written once (1 byte); the search is 8 compares against
// boundaries in shared memory. The TPU kernel's 255 compares per value (a
// reduction with no data-dependent control, which is what Mosaic wants)
// are not needed here.
//
// What the design does about it:
//   * a thread bins 16 consecutive rows of one feature: four 16-byte
//     loads of values and one 16-byte store of bins (a warp moves 2 KB
//     in and 512 B out, contiguous);
//   * the boundaries sit in shared memory padded with +inf to 256, so the
//     search is 8 fixed steps, lo += (bd[lo + s - 1] <= v) ? s : 0 for
//     s = 128 .. 1, then min(lo, nb): no data-dependent trip count;
//   * the table is stored in level order (the root bd[127], then bd[63]
//     and bd[191], ...: node i's children are 2i + 1 and 2i + 2), so the
//     candidates of each step sit side by side. In sorted order those of
//     steps 3-6 all fall on one or two banks (bd[31 + 64k], bd[15 + 32k],
//     ...), and a warp's 32 searches cost about 38 shared-memory
//     wavefronts; in level order about 11, below the bytes' time;
//   * a block bins 2,048 rows of one feature.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 16;
constexpr int kTable = 256;  // boundaries per feature, +inf padded

// Feature f's boundaries, +inf past nb, into table[0 .. kTable - 1) in
// level order: node i at level j (i = 2^j - 1 + k) holds the sorted
// boundary (2k + 1) * 2^(7 - j) - 1, the one step j + 1 compares with.
__device__ __forceinline__ void load_table(float* table,
                                           const float* __restrict__ bounds,
                                           int f, int nb, int max_b) {
  for (int i = threadIdx.x; i < kTable - 1; i += kThreads) {
    const int j = 31 - __clz(i + 1);
    const int b = ((2 * (i + 1 - (1 << j)) + 1) << (7 - j)) - 1;
    table[i] = b < nb ? bounds[static_cast<size_t>(f) * max_b + b]
                      : __int_as_float(0x7f800000);
  }
}

// The fixed-step search on the level-order table: after 8 steps node i
// is 255 + lo, lo = #{b < 255 : bd[b] <= v}.
__device__ __forceinline__ unsigned bin_of(const float* table, int nb,
                                           float imp, float v) {
  if (isnan(v)) v = imp;
  if (isnan(v)) return static_cast<unsigned>(nb);
  int i = 0;
#pragma unroll
  for (int step = 0; step < 8; ++step) {
    i = 2 * i + 1 + (table[i] <= v ? 1 : 0);
  }
  return static_cast<unsigned>(min(i - (kTable - 1), nb));
}

// Bins of the 16 rows r .. r + 15 of feature row `src` (values of one
// feature) as four little-endian words; rows at or past n bin to 0.
__device__ __forceinline__ uint4 bin16(const float* __restrict__ src,
                                       int r, int n, const float* table,
                                       int nb, float imp) {
  float v[kRowsPerThread];
  if (r + kRowsPerThread <= n &&
      (reinterpret_cast<uintptr_t>(src + r) & 15) == 0) {
    const float4* p = reinterpret_cast<const float4*>(src + r);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x = __ldg(p + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      v[k] = r + k < n ? src[r + k] : 0.0f;
    }
  }
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    w[k >> 2] |= bin_of(table, nb, imp, v[k]) << (8 * (k & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Grid (row blocks of kThreads * 16 rows, F): out[f, r], u8 [F, n].
__global__ void __launch_bounds__(kThreads)
bin_feature_major(const float* __restrict__ values,
                  const float* __restrict__ bounds,
                  const int32_t* __restrict__ nbounds,
                  const float* __restrict__ impute, uint8_t* __restrict__ out,
                  int n, int max_b) {
  __shared__ float table[kTable];
  const int f = blockIdx.y;
  const int nb = min(max(nbounds[f], 0), max_b);
  load_table(table, bounds, f, nb, max_b);
  __syncthreads();
  const int r = (blockIdx.x * kThreads + threadIdx.x) * kRowsPerThread;
  if (r >= n) return;
  const size_t row = static_cast<size_t>(f) * n;
  const uint4 w = bin16(values + row, r, n, table, nb, impute[f]);
  uint8_t* dst = out + row + r;
  if (r + kRowsPerThread <= n &&
      (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = w;
  } else {
    const unsigned x[4] = {w.x, w.y, w.z, w.w};
    for (int k = 0; k < kRowsPerThread && r + k < n; ++k) {
      dst[k] = static_cast<uint8_t>(x[k >> 2] >> (8 * (k & 3)));
    }
  }
}

}  // namespace

// values f32 [F, n], bounds f32 [F, max_b] (max_b <= 255), nbounds i32
// [F], impute f32 [F] -> out u8 [F, n].
extern "C" int ydf_bin_columns(const void* values, const void* bounds,
                               const void* nbounds, const void* impute,
                               void* out, int n, int F, int max_b,
                               void* stream) {
  if (n <= 0 || F <= 0) return 0;
  if (max_b < 0 || max_b >= kTable) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = kThreads * kRowsPerThread;
  const dim3 grid((n + rows - 1) / rows, F);
  bin_feature_major<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(bounds),
      static_cast<const int32_t*>(nbounds), static_cast<const float*>(impute),
      static_cast<uint8_t*>(out), n, max_b);
  return static_cast<int>(cudaGetLastError());
}
