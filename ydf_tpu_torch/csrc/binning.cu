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
// with nb = nbounds[f] <= 255, written to out[r, f] (u8, row-major as the
// training rows are). The boundaries of a feature ascend (+inf padded past
// nb), so the count is the upper bound of v among the first nb, found by
// binary search: the same bin as the TPU kernel's compare-and-count and as
// numpy's searchsorted(side="right").
//
// What bounds it on this card: memory. Each value is read once (4 bytes)
// and its bin written once (1 byte); the search is about 8 compares against
// boundaries in shared memory. The TPU kernel's 255 compares per value (a
// reduction with no data-dependent control, which is what Mosaic wants)
// are not needed here.
//
// What the simple design does about it: one thread per row of a block of
// kRows rows, looping over a tile of features whose boundaries sit in
// shared memory; reads of one feature are consecutive across the warp.
// The block's bins go to a shared [kRows, Ft] tile and are written out as
// whole row segments, so the u8 [n, F] stores are contiguous rather than
// one byte every F.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;
constexpr int kSmemBytes = 48 * 1024;

__global__ void __launch_bounds__(kRows)
bin_kernel(const float* __restrict__ values,
           const float* __restrict__ bounds,
           const int32_t* __restrict__ nbounds,
           const float* __restrict__ impute, uint8_t* __restrict__ out, int n,
           int F, int max_b, int Ft) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_bd = reinterpret_cast<float*>(smem);
  uint8_t* s_out = reinterpret_cast<uint8_t*>(s_bd + Ft * max_b);
  const int f0 = blockIdx.y * Ft;
  const int fc = min(Ft, F - f0);
  const int r0 = blockIdx.x * kRows;
  for (int i = threadIdx.x; i < fc * max_b; i += kRows) {
    s_bd[i] = bounds[static_cast<size_t>(f0) * max_b + i];
  }
  __syncthreads();

  const int r = r0 + threadIdx.x;
  if (r < n) {
    for (int f = 0; f < fc; ++f) {
      float v = values[static_cast<size_t>(f0 + f) * n + r];
      if (isnan(v)) v = impute[f0 + f];
      const int nb = min(max(nbounds[f0 + f], 0), max_b);
      int lo = nb;
      if (!isnan(v)) {
        const float* bd = s_bd + f * max_b;
        lo = 0;
        int hi = nb;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (bd[mid] <= v) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
      }
      s_out[threadIdx.x * fc + f] = static_cast<uint8_t>(lo);
    }
  }
  __syncthreads();

  const int rows = min(kRows, n - r0);
  for (int i = threadIdx.x; i < rows * fc; i += kRows) {
    const int rr = i / fc;
    const int f = i - rr * fc;
    out[static_cast<size_t>(r0 + rr) * F + f0 + f] = s_out[i];
  }
}

}  // namespace

// values f32 [F, n], bounds f32 [F, max_b], nbounds i32 [F], impute f32
// [F] -> out u8 [n, F]. Ft features per block share its boundaries in
// shared memory (the wrapper sizes Ft under kSmemBytes).
extern "C" int ydf_bin_columns(const void* values, const void* bounds,
                               const void* nbounds, const void* impute,
                               void* out, int n, int F, int max_b, int Ft,
                               void* stream) {
  if (n <= 0 || F <= 0) return 0;
  const int smem = Ft * max_b * 4 + kRows * Ft;
  if (Ft <= 0 || smem > kSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kRows - 1) / kRows, (F + Ft - 1) / Ft);
  bin_kernel<<<grid, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(bounds),
      static_cast<const int32_t*>(nbounds),
      static_cast<const float*>(impute), static_cast<uint8_t*>(out), n, F,
      max_b, Ft);
  return static_cast<int>(cudaGetLastError());
}
