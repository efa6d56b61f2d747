// Layer histogram for Hopper (sm_90a).
//
// Replaces the TPU kernels ydf_tpu/ops/histogram_pallas.py:_hist_kernel
// and _hist_kernel_packed (wrapper histogram_pallas). The packed body is a
// lane layout of the TPU's matrix unit with an identical output, so one
// kernel covers both. Called from ydf_tpu_torch/ops/histogram_kernels.py:
// histogram, which also holds the plain PyTorch version (histogram_plain)
// this kernel is tested against.
//
// What it computes:
//   out[l, f, b, s] = sum over rows r with slot[r] == l and
//                     bins_t[f, r] == b of stats[r, s]
// for l < L; rows on the trash slot (slot >= L, or < 0) and bins >= B are
// dropped. The accumulator follows the stats type as the TPU kernel's
// operand precision does: f32 -> f32, bf16 (the bf16x2 halves) -> f32,
// int8 -> int32 (exact; the wrapper dequantizes once).
//
// What bounds it on this card: the read of the bin matrix (one byte per
// (row, feature)) and of the stats, and the scatter-add per
// (live row, feature, stat). The TPU kernel turns the scatter into one-hot
// matrix products because Mosaic has no fast scatter; here shared memory
// takes the scatter directly, so the one-hot work (B times the adds) is
// gone.
//
// What the simple design does about it:
//   * bins are feature-major u8 [F, n]: a warp's read of one feature is 32
//     consecutive bytes, one sector;
//   * each block owns a (feature block, slot block, row chunk) and
//     accumulates into a shared-memory sub-histogram with shared atomics
//     (Fb * Lb * B * Sq cells, at most kSmemBytes);
//   * each block writes its sub-histogram to its own slice of a partials
//     buffer, and a second kernel sums the partials over row chunks in
//     chunk order (f32 partials in f64, rounded once): no float atomics
//     cross blocks, so the cross-block sum is in a fixed order. Inside a
//     block the order of the shared f32 atomics varies from run to run,
//     so f32 results may differ in the last bits between runs; int32
//     results are exact.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kMaxStats = 8;
// Shared memory a block may take for its sub-histogram; the wrapper sizes
// the feature and slot blocks under the same budget (SMEM_BUDGET there).
constexpr int kSmemBytes = 96 * 1024;

template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<int8_t> {
  using type = int32_t;
};

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int32_t to_acc(int8_t v) {
  return static_cast<int32_t>(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ bins_t,
            const int32_t* __restrict__ slot,
            const T* __restrict__ stats,
            typename Acc<T>::type* __restrict__ partial, int n, int F,
            int B, int Sq, int L, int Fb, int Lb, int rows_per_chunk) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A* sh = reinterpret_cast<A*>(smem);
  const int f0 = blockIdx.x * Fb;
  const int l0 = blockIdx.y * Lb;
  const int fc = min(Fb, F - f0);
  const int lc = min(Lb, L - l0);
  const int cells = lc * fc * B * Sq;
  for (int i = threadIdx.x; i < cells; i += kThreads) sh[i] = A(0);
  __syncthreads();

  const int r0 = blockIdx.z * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  const size_t stride = static_cast<size_t>(n);
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const int l = slot[r] - l0;
    if (l < 0 || l >= lc) continue;  // trash slot, or another slot block
    A v[kMaxStats];
    for (int s = 0; s < Sq; ++s) {
      v[s] = to_acc(stats[static_cast<size_t>(r) * Sq + s]);
    }
    for (int f = 0; f < fc; ++f) {
      const int b = bins_t[static_cast<size_t>(f0 + f) * stride + r];
      if (b >= B) continue;
      A* cell = sh + ((l * fc + f) * B + b) * Sq;
      for (int s = 0; s < Sq; ++s) atomicAdd(cell + s, v[s]);
    }
  }
  __syncthreads();

  // This block's slice of partial[chunk][L][F][B][Sq].
  const size_t base = static_cast<size_t>(blockIdx.z) * L * F * B * Sq;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    int t = i / Sq;
    const int s = i - t * Sq;
    const int b = t % B;
    t /= B;
    const int f = t % fc;
    const int l = t / fc;
    partial[base + ((static_cast<size_t>(l0 + l) * F + (f0 + f)) * B + b) *
                       Sq + s] = sh[i];
  }
}

// The cross-chunk sum: int32 exactly; f32 partials in f64, rounded once.
template <typename A>
struct Wide {
  using type = A;
};
template <>
struct Wide<float> {
  using type = double;
};

// out[i] = partial[0][i] + partial[1][i] + ... in chunk order.
template <typename A>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const A* __restrict__ partial, A* __restrict__ out,
                size_t total, int chunks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kReduceThreads +
                   threadIdx.x;
  if (i >= total) return;
  typename Wide<A>::type acc = partial[i];
  for (int c = 1; c < chunks; ++c) acc += partial[c * total + i];
  out[i] = static_cast<A>(acc);
}

template <typename T>
int launch(const void* bins_t, const void* slot, const void* stats,
           void* partial, void* out, int n, int F, int B, int Sq, int L,
           int Fb, int Lb, int chunks, int rows_per_chunk,
           cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int smem = Fb * Lb * B * Sq * static_cast<int>(sizeof(A));
  if (Sq > kMaxStats || smem > kSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + Fb - 1) / Fb, (L + Lb - 1) / Lb, chunks);
  hist_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(bins_t), static_cast<const int32_t*>(slot),
      static_cast<const T*>(stats), static_cast<A*>(partial), n, F, B, Sq,
      L, Fb, Lb, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(L) * F * B * Sq;
  const unsigned blocks =
      static_cast<unsigned>((total + kReduceThreads - 1) / kReduceThreads);
  reduce_partials<A><<<blocks, kReduceThreads, 0, stream>>>(
      static_cast<const A*>(partial), static_cast<A*>(out), total, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stats_kind: 0 = f32 [n, Sq], 1 = bf16 [n, Sq], 2 = int8 [n, Sq].
// partial holds chunks * L*F*B*Sq accumulators (f32, or int32 for int8),
// out L*F*B*Sq.
extern "C" int ydf_histogram(const void* bins_t, const void* slot,
                             const void* stats, void* partial, void* out,
                             int n, int F, int B, int Sq, int L,
                             int stats_kind, int Fb, int Lb, int chunks,
                             int rows_per_chunk, void* stream) {
  if (n <= 0 || F <= 0 || L <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stats_kind) {
    case 0:
      return launch<float>(bins_t, slot, stats, partial, out, n, F, B, Sq,
                           L, Fb, Lb, chunks, rows_per_chunk, s);
    case 1:
      return launch<__nv_bfloat16>(bins_t, slot, stats, partial, out, n, F,
                                   B, Sq, L, Fb, Lb, chunks, rows_per_chunk,
                                   s);
    case 2:
      return launch<int8_t>(bins_t, slot, stats, partial, out, n, F, B, Sq,
                            L, Fb, Lb, chunks, rows_per_chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
