// Fused previous-layer routing + this-layer histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel ydf_tpu/ops/histogram_pallas.py:
// _hist_routed_kernel (wrapper histogram_routed_pallas). Called from
// ydf_tpu_torch/ops/histogram_kernels.py:histogram_routed, which also
// holds the plain PyTorch version (histogram_routed_plain) this kernel is
// tested against.
//
// What it computes, per row r, from the previous layer's decision tables
// (padded to L1 = L + 1 entries; slot L is the trash slot):
//   l = slot[r]
//   if do_split[l]:
//     b  = bins_t[route_f[l], r]
//     gl = is_set[l] ? set_go_left[r] : go_left[l, b]
//     new_slot = 2 * split_rank[l] + (gl ? 0 : 1)
//     new_leaf = gl ? left_id[l] : right_id[l]
//     hs       = hmap[new_slot]
//   else:
//     new_slot = L, new_leaf = leaf[r], hs = hmap[L]
// then this layer's histogram exactly as csrc/histogram.cu, from slot hs
// over Lh slots (hs >= Lh is the trash slot). hmap is composed into two
// per-slot tables (hl = hmap[2 sr], hr = hmap[2 sr + 1]) when the tables
// are loaded, as the TPU wrapper composes it (histogram_pallas.py:347-362),
// so no row gathers by new slot. Routing is integer-exact.
//
// What bounds it on this card: as csrc/histogram.cu, the bin matrix and
// stats reads and the scatter-adds, plus per row a slot read, one gathered
// bin of the routed feature and two int32 writes. The TPU kernel's one-hot
// table products (Mosaic has no vector gather) become shared-memory loads.
//
// What the simple design does about it: the tables and the go-left bits
// ([L1, B] bytes) sit in shared memory beside the sub-histogram; every
// block re-derives the routing of its rows (a handful of integer ops), and
// only the blocks of the first feature and slot block write new_slot and
// new_leaf, so each row is written once. Partials are summed over row
// chunks in chunk order; routing and int32 results are exact.
//
// Float stats (f32, bf16) add into f64 shared cells, and the partials and
// their cross-chunk sum stay f64, rounded once to f32. An f32 cell summed
// a chunk's thousands of rows in whatever order its atomics landed: on a
// small leaf reached through sibling subtraction that moved the leaf
// value by 3e-5 against the f64 plain version (scripts/
// card_leaf_drift.py). In f64 the order moves the f32 result only when a
// sum lies within a few f64 ulps of an f32 rounding boundary. The cells
// take twice the bytes; the wrapper gives them twice the budget, so a
// block holds as many (slot, feature) pairs as with 4-byte cells and
// routes as many rows (ops/histogram_kernels.py:launch_shape), and runs
// 512 threads, one such block to an SM.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Threads of a block: 256 with 4-byte cells, 512 with f64 ones (their
// block holds twice the bytes, one block to an SM).
constexpr int kThreads = 256;
constexpr int kThreadsWide = 512;
constexpr int kReduceThreads = 256;
constexpr int kMaxStats = 8;
constexpr int kSmemBytes = 200 * 1024;

// Acc: the output's accumulator type (f32, or int32 for int8 stats);
// Sum: the shared cells' and partials' type (f64 for float stats).
template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<int8_t> {
  using type = int32_t;
};
template <typename T>
struct Sum {
  using type = double;
};
template <>
struct Sum<int8_t> {
  using type = int32_t;
};

__device__ __forceinline__ double to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int32_t to_acc(int8_t v) {
  return static_cast<int32_t>(v);
}

struct Tables {
  const uint8_t* do_split;   // [L1]
  const int32_t* route_f;    // [L1]
  const uint8_t* go_left;    // [L1, B]
  const int32_t* left_id;    // [L1]
  const int32_t* right_id;   // [L1]
  const int32_t* split_rank; // [L1]
  const int32_t* hmap;       // [L1]
  const uint8_t* is_set;     // [L1]
  const uint8_t* set_go_left;  // [n], or nullptr when no set feature
};

// Bytes of the table region at the head of shared memory, 16-aligned.
__host__ __device__ inline int table_bytes(int L1, int B) {
  const int bytes = L1 * B + L1 * 2 + L1 * 4 * 5;
  return (bytes + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(kThreadsWide)
routed_kernel(const uint8_t* __restrict__ bins_t,
              const int32_t* __restrict__ slot,
              const int32_t* __restrict__ leaf, Tables tab,
              const T* __restrict__ stats,
              typename Sum<T>::type* __restrict__ partial,
              int32_t* __restrict__ new_slot, int32_t* __restrict__ new_leaf,
              int n, int F, int B, int Sq, int L, int Lh, int Fb, int Lb,
              int rows_per_chunk) {
  using A = typename Sum<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int L1 = L + 1;
  // Table region: int32 tables first (aligned), then the byte tables.
  int32_t* s_route_f = reinterpret_cast<int32_t*>(smem);
  int32_t* s_left = s_route_f + L1;
  int32_t* s_right = s_left + L1;
  int32_t* s_hl = s_right + L1;
  int32_t* s_hr = s_hl + L1;
  uint8_t* s_split = reinterpret_cast<uint8_t*>(s_hr + L1);
  uint8_t* s_set = s_split + L1;
  uint8_t* s_gl = s_set + L1;
  A* sh = reinterpret_cast<A*>(smem + table_bytes(L1, B));

  for (int l = threadIdx.x; l < L1; l += nt) {
    s_route_f[l] = min(max(tab.route_f[l], 0), F - 1);
    s_left[l] = tab.left_id[l];
    s_right[l] = tab.right_id[l];
    const int sr = tab.split_rank[l];
    s_hl[l] = tab.hmap[min(max(2 * sr, 0), L)];
    s_hr[l] = tab.hmap[min(max(2 * sr + 1, 0), L)];
    s_split[l] = tab.do_split[l];
    s_set[l] = tab.is_set[l];
  }
  for (int i = threadIdx.x; i < L1 * B; i += nt) {
    s_gl[i] = tab.go_left[i];
  }
  const int trash_hs = tab.hmap[L];

  const int f0 = blockIdx.x * Fb;
  const int l0 = blockIdx.y * Lb;
  const int fc = min(Fb, F - f0);
  const int lc = min(Lb, Lh - l0);
  const int cells = lc * fc * B * Sq;
  for (int i = threadIdx.x; i < cells; i += nt) sh[i] = A(0);
  __syncthreads();

  const bool write_route = blockIdx.x == 0 && blockIdx.y == 0;
  const int r0 = blockIdx.z * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  const size_t stride = static_cast<size_t>(n);
  for (int r = r0 + threadIdx.x; r < r1; r += nt) {
    int l = slot[r];
    if (l < 0 || l > L) l = L;
    int ns, nl, hs;
    if (s_split[l]) {
      const int b = bins_t[static_cast<size_t>(s_route_f[l]) * stride + r];
      bool gl = b < B && s_gl[l * B + b] != 0;
      if (s_set[l]) gl = tab.set_go_left != nullptr && tab.set_go_left[r];
      const int sr2 = 2 * tab.split_rank[l];
      ns = gl ? sr2 : sr2 + 1;
      nl = gl ? s_left[l] : s_right[l];
      hs = gl ? s_hl[l] : s_hr[l];
    } else {
      ns = L;
      nl = leaf[r];
      hs = trash_hs;
    }
    if (write_route) {
      new_slot[r] = ns;
      new_leaf[r] = nl;
    }
    const int h = hs - l0;
    if (hs >= Lh || h < 0 || h >= lc) continue;
    A v[kMaxStats];
    for (int s = 0; s < Sq; ++s) {
      v[s] = to_acc(stats[static_cast<size_t>(r) * Sq + s]);
    }
    for (int f = 0; f < fc; ++f) {
      const int b = bins_t[static_cast<size_t>(f0 + f) * stride + r];
      if (b >= B) continue;
      A* cell = sh + ((h * fc + f) * B + b) * Sq;
      for (int s = 0; s < Sq; ++s) atomicAdd(cell + s, v[s]);
    }
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(blockIdx.z) * Lh * F * B * Sq;
  for (int i = threadIdx.x; i < cells; i += nt) {
    int t = i / Sq;
    const int s = i - t * Sq;
    const int b = t % B;
    t /= B;
    const int f = t % fc;
    const int h = t / fc;
    partial[base + ((static_cast<size_t>(l0 + h) * F + (f0 + f)) * B + b) *
                       Sq + s] = sh[i];
  }
}

// The cross-chunk sum in chunk order: int32 exactly; f64 partials in f64,
// rounded once to f32.
template <typename S, typename A>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const S* __restrict__ partial, A* __restrict__ out,
                size_t total, int chunks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kReduceThreads +
                   threadIdx.x;
  if (i >= total) return;
  S acc = partial[i];
  for (int c = 1; c < chunks; ++c) acc += partial[c * total + i];
  out[i] = static_cast<A>(acc);
}

template <typename T>
int launch(const void* bins_t, const void* slot, const void* leaf,
           const Tables& tab, const void* stats, void* partial, void* out,
           void* new_slot, void* new_leaf, int n, int F, int B, int Sq,
           int L, int Lh, int Fb, int Lb, int chunks, int rows_per_chunk,
           cudaStream_t stream) {
  using A = typename Acc<T>::type;
  using S = typename Sum<T>::type;
  const int smem = table_bytes(L + 1, B) +
                   Fb * Lb * B * Sq * static_cast<int>(sizeof(S));
  if (Sq > kMaxStats || smem > kSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      routed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Lh = 0 still launches one slot block: the rows must be routed.
  const dim3 grid((F + Fb - 1) / Fb, max(1, (Lh + Lb - 1) / Lb), chunks);
  const int threads = sizeof(S) == 8 ? kThreadsWide : kThreads;
  routed_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(bins_t), static_cast<const int32_t*>(slot),
      static_cast<const int32_t*>(leaf), tab, static_cast<const T*>(stats),
      static_cast<S*>(partial), static_cast<int32_t*>(new_slot),
      static_cast<int32_t*>(new_leaf), n, F, B, Sq, L, Lh, Fb, Lb,
      rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(Lh) * F * B * Sq;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kReduceThreads - 1) / kReduceThreads);
  reduce_partials<S, A><<<blocks, kReduceThreads, 0, stream>>>(
      static_cast<const S*>(partial), static_cast<A*>(out), total, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tables follow the padded [L + 1] contract of the TPU kernel; go_left is
// u8 [L + 1, B]; set_go_left is u8 [n] or null. stats_kind: 0 = f32,
// 1 = bf16, 2 = int8, each [n, Sq]. partial holds chunks * Lh*F*B*Sq
// sums (f64, or int32 for int8), out Lh*F*B*Sq accumulators (f32, or
// int32 for int8).
extern "C" int ydf_histogram_routed(
    const void* bins_t, const void* slot, const void* leaf,
    const void* do_split, const void* route_f, const void* go_left,
    const void* left_id, const void* right_id, const void* split_rank,
    const void* hmap, const void* is_set, const void* set_go_left,
    const void* stats, void* partial, void* out, void* new_slot,
    void* new_leaf, int n, int F, int B, int Sq, int L, int Lh,
    int stats_kind, int Fb, int Lb, int chunks, int rows_per_chunk,
    void* stream) {
  if (n <= 0 || F <= 0) return 0;
  Tables tab{static_cast<const uint8_t*>(do_split),
             static_cast<const int32_t*>(route_f),
             static_cast<const uint8_t*>(go_left),
             static_cast<const int32_t*>(left_id),
             static_cast<const int32_t*>(right_id),
             static_cast<const int32_t*>(split_rank),
             static_cast<const int32_t*>(hmap),
             static_cast<const uint8_t*>(is_set),
             static_cast<const uint8_t*>(set_go_left)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stats_kind) {
    case 0:
      return launch<float>(bins_t, slot, leaf, tab, stats, partial, out,
                           new_slot, new_leaf, n, F, B, Sq, L, Lh, Fb, Lb,
                           chunks, rows_per_chunk, s);
    case 1:
      return launch<__nv_bfloat16>(bins_t, slot, leaf, tab, stats, partial,
                                   out, new_slot, new_leaf, n, F, B, Sq, L,
                                   Lh, Fb, Lb, chunks, rows_per_chunk, s);
    case 2:
      return launch<int8_t>(bins_t, slot, leaf, tab, stats, partial, out,
                            new_slot, new_leaf, n, F, B, Sq, L, Lh, Fb, Lb,
                            chunks, rows_per_chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
