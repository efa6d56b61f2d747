// Layer histogram for Hopper (sm_90a).
//
// Replaces the TPU kernels ydf_tpu/ops/histogram_pallas.py:_hist_kernel
// and _hist_kernel_packed (wrapper histogram_pallas). The packed body is a
// lane layout of the TPU's matrix unit with an identical output, so one
// kernel covers both. Called from ydf_tpu_torch/ops/histogram_kernels.py:
// histogram (the grower's root layer), which also holds the plain PyTorch
// version (histogram_plain) this kernel is tested against, and the launch
// shape (root_launch_shape).
//
// What it computes:
//   out[l, f, b, s] = sum over rows r with slot[r] == l and
//                     bins_t[f, r] == b of stats[r, s]
// for l < L; rows on the trash slot (slot >= L, or < 0) and bins >= B are
// dropped. The output follows the stats type as the TPU kernel's
// operand precision does: f32 -> f32, bf16 (the bf16x2 halves) -> f32,
// int8 -> int32 (exact; the wrapper dequantizes once). f32 stats add
// into f64 cells and partials, rounded once to f32 (the correctly
// rounded sum but for a double-rounding case, like the plain version's
// and the JAX package's f64 block partials): so the card's histograms,
// and the splits they pick, match the CPU's and the JAX package's; the
// routed kernel does the same.
//
// What bounds it on this card: not the bytes (one byte of bins per (row,
// feature) and the stats once: 0.0066 ms at 500,000 x 28 at 3.35 TB/s)
// but instruction throughput. Every (live row, feature, stat) is one add
// into a shared-memory sub-histogram, and the adds of a warp's 32 lanes
// may hit the same cell. scripts/bench_shared_adds.py times the ways to
// add on an NVIDIA H100 80GB HBM3 at 700 W (SM cycles at 1980 MHz per
// 32-lane step of three stat adds, 48 warps per SM): shared f32
// atomicAdd, which sm_90a compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN), 47.0; __match_any_sync alone 60.5, with a shuffle
// sum and one leader add 68.0; the tag rounds below 34.4; a plain
// read-modify-write 18.9 (wrong under collisions); native int32
// atomicAdd 10.3. The TPU kernel turns the scatter into one-hot matrix
// products; here shared memory takes the scatter directly (no one-hot on
// tensor cores: TF32 would break the f32 contract).
//
// What the design does about it:
//   * small balanced blocks: a block owns Fb features (one warp each) of a
//     slot block and a row chunk; its sub-histogram and tags take at most
//     32 KB, the features split into G groups of equal size (within one;
//     exactly where F allows), and the wrapper sizes the row chunks for
//     about 32 resident warps on each of the 132 SMs
//     (ops/histogram_kernels.py:root_launch_shape);
//   * wide loads: a lane reads 16 consecutive rows of its feature as one
//     16-byte load (the warp 512 contiguous bytes); a tile of 512 rows'
//     stats and slots is staged in shared memory once for all the block's
//     features, laid out so that the lanes' reads of a step hit 32 banks;
//   * the number of stats is a template argument, so the 16 steps are
//     straight-line code (with a runtime count every stat read was a
//     guarded branch with its own address arithmetic);
//   * no float atomics: a warp owns its feature's cells, so only its own
//     lanes collide, and they settle it in tag rounds. Each lane with a
//     row left writes its lane id to the cell's tag word; the lane whose
//     id stays adds its stats with a plain read-modify-write; the rest go
//     again. Lanes on one cell (the empty vector sequences that all land
//     in bin 0, or the root layer's chance collisions) cost one round
//     each, no retries against other warps. Tags are one byte, and three
//     stats take a 16-byte cell, 32 bytes in f64 (one or two loads and
//     stores a round): both cut shared-memory traffic, which bounds the
//     rounds. f32 stats add into f64 cells, so the order of the adds
//     (set by which write to a tag the hardware keeps) does not reach
//     the rounded result; f64 cells halve the (feature, slot) pairs a
//     block holds. int8 stats add with native int32 atomics, exact in any
//     order;
//   * each block writes its sub-histogram to its own slice of a partials
//     buffer, and a second kernel sums the chunks in a fixed order (f32
//     and f64 partials in f64, rounded once; int32 exactly): 8 warps each
//     take every 8th chunk, then one sums the 8 in order. No atomics
//     cross blocks, and every output cell is written, so the output needs
//     no zero fill;
//   * all shared memory stays under the 48 KB a block gets without
//     cudaFuncSetAttribute, so a call is two launches and nothing else.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerLane = 16;
constexpr int kTileRows = 32 * kRowsPerLane;
constexpr int kMaxWarps = 32;
// A block's shared memory: sub-histogram + the tile's stats and slots.
constexpr int kSmemBytes = 48 * 1024;
constexpr int kReduceWarps = 8;

// Cells and partials: f32 stats in f64, bf16 halves in f32, int8 in
// int32. Out: the histogram's type. Stage: the tile's staged stats.
template <typename T>
struct Acc {
  using type = double;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};
template <>
struct Acc<int8_t> {
  using type = int32_t;
};
template <typename T>
struct Out {
  using type = float;
};
template <>
struct Out<int8_t> {
  using type = int32_t;
};
template <typename T>
struct Stage {
  using type = float;
};
template <>
struct Stage<int8_t> {
  using type = int32_t;
};

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int32_t to_acc(int8_t v) {
  return static_cast<int32_t>(v);
}

// Words a histogram cell takes: three stats are padded to four, so that a
// lane's read-modify-write of its cell is one 16-byte load and store (two
// for f64 cells).
__host__ __device__ constexpr int cell_stride(int sq) {
  return sq == 3 ? 4 : sq;
}

// Byte k (0..15) of a 16-byte word.
__device__ __forceinline__ int byte_of(const uint4& w, int k) {
  const unsigned x = k < 4 ? w.x : k < 8 ? w.y : k < 12 ? w.z : w.w;
  return static_cast<int>((x >> (8 * (k & 3))) & 0xffu);
}

// Grid: (row chunk, slot block, feature group); 32 * Fb threads, warp w
// takes feature f0 + w of its group. SQ (the stat columns) is a template
// argument: the 16 steps are then straight-line code with every shared
// address a constant offset from the lane's base.
template <typename T, int SQ>
__global__ void __launch_bounds__(kMaxWarps * 32)
hist_kernel(const uint8_t* __restrict__ bins_t,
            const int32_t* __restrict__ slot,
            const T* __restrict__ stats,
            typename Acc<T>::type* __restrict__ partial, int n, int F,
            int B, int L, int G, int Lb, int rows_per_chunk) {
  using A = typename Acc<T>::type;
  using S = typename Stage<T>::type;
  constexpr int CS = cell_stride(SQ);
  constexpr int kGroup = kRowsPerLane * SQ + 1;  // a lane's stats, padded
  extern __shared__ __align__(16) unsigned char smem[];
  const int Fb = blockDim.x / 32;
  const int g = blockIdx.z;
  const int f0 = static_cast<int>(static_cast<long long>(g) * F / G);
  const int fc = static_cast<int>(static_cast<long long>(g + 1) * F / G) -
                 f0;
  const int l0 = blockIdx.y * Lb;
  const int lc = min(Lb, L - l0);
  const int BC = B * CS;
  // Shared memory: the sub-histogram [f][l][b][CS], then the tile's stats
  // and slots, each lane's 16 rows together with one padding word after
  // them, so that the lanes' reads at one step fall on 32 banks, then a
  // one-byte tag per cell of the sub-histogram ([f][l][b]).
  A* sh = reinterpret_cast<A*>(smem);
  S* s_stats = reinterpret_cast<S*>(sh + Fb * Lb * BC);
  int32_t* s_slot = reinterpret_cast<int32_t*>(s_stats + 32 * kGroup);
  for (int i = threadIdx.x; i < fc * lc * BC; i += blockDim.x) sh[i] = A(0);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  A* hf = sh + warp * lc * BC;
  const uint8_t* brow =
      bins_t + static_cast<size_t>(f0 + min(warp, fc - 1)) * n;
  const S* sv = s_stats + lane * kGroup;
  const int32_t* sl = s_slot + lane * (kRowsPerLane + 1);
  uint8_t* tag = reinterpret_cast<uint8_t*>(s_slot + 32 * (kRowsPerLane + 1)) +
                 warp * lc * B;
  for (int t0 = r0; t0 < r1; t0 += kTileRows) {
    const int rows = min(kTileRows, r1 - t0);
    __syncthreads();  // the zero fill, or the last tile's readers, done
    for (int i = threadIdx.x; i < kTileRows; i += blockDim.x) {
      const int l = i < rows ? slot[t0 + i] - l0 : -1;
      s_slot[i + i / kRowsPerLane] = l >= 0 && l < lc ? l : -1;
    }
    const T* st = stats + static_cast<size_t>(t0) * SQ;
    for (int i = threadIdx.x; i < rows * SQ; i += blockDim.x) {
      s_stats[i + i / (kRowsPerLane * SQ)] = to_acc(st[i]);
    }
    __syncthreads();
    if (warp >= fc) continue;  // a short group leaves its last warp idle

    // This lane's 16 rows of the warp's feature: one 16-byte load when
    // aligned and whole, else byte by byte.
    const int rr = lane * kRowsPerLane;
    const uint8_t* p = brow + t0 + rr;
    uint4 w;
    if (rr + kRowsPerLane <= rows &&
        (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      w = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      unsigned x[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < kRowsPerLane; ++k) {
        const unsigned b = rr + k < rows ? p[k] : 0u;
        x[k >> 2] |= b << (8 * (k & 3));
      }
      w = make_uint4(x[0], x[1], x[2], x[3]);
    }
#pragma unroll
    for (int k = 0; k < kRowsPerLane; ++k) {
      const int l = sl[k];  // -1: trash slot, another slot block, or no row
      const int b = byte_of(w, k);
      const bool live = l >= 0 && b < B;
      const int key = live ? l * B + b : 0;
      A* cell = hf + key * CS;
      if constexpr (std::is_same<A, int32_t>::value) {
        // Exact integer sums: native shared atomics, any order.
        if (live) {
#pragma unroll
          for (int s = 0; s < SQ; ++s) atomicAdd(cell + s, sv[k * SQ + s]);
        }
      } else {
        // Tag rounds: each pending lane writes its id to its cell's tag,
        // the lane whose id stays adds with a plain read-modify-write, the
        // others try again in the next round (a round per lane beyond the
        // first on one cell; most steps take one or two).
        bool pending = live;
        while (__any_sync(kFull, pending)) {
          if (pending) tag[key] = lane;
          __syncwarp();
          const bool win = pending && tag[key] == lane;
          if (win) {
            if constexpr (CS == 4 && std::is_same<A, double>::value) {
              // An f64 cell: two 16-byte loads and stores.
              double2* c2 = reinterpret_cast<double2*>(cell);
              double2 lo = c2[0];
              double2 hi = c2[1];
              lo.x += static_cast<double>(sv[k * SQ]);
              lo.y += static_cast<double>(sv[k * SQ + 1]);
              hi.x += static_cast<double>(sv[k * SQ + 2]);
              if constexpr (SQ == 4) hi.y += static_cast<double>(sv[k * SQ + 3]);
              c2[0] = lo;
              c2[1] = hi;
            } else if constexpr (CS == 4) {  // one 16-byte load and store
              float4 c = *reinterpret_cast<float4*>(cell);
              c.x += sv[k * SQ];
              c.y += sv[k * SQ + 1];
              c.z += sv[k * SQ + 2];
              if constexpr (SQ == 4) c.w += sv[k * SQ + 3];
              *reinterpret_cast<float4*>(cell) = c;
            } else {
#pragma unroll
              for (int s = 0; s < SQ; ++s) {
                cell[s] += static_cast<A>(sv[k * SQ + s]);
              }
            }
          }
          pending = pending && !win;
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();

  // This block's cells to its slice of partial[chunk][L][F][B][SQ].
  const int BS = B * SQ;
  const size_t base = static_cast<size_t>(blockIdx.x) * L * F * BS;
  for (int fl = 0; fl < fc * lc; ++fl) {
    const int f = fl / lc;
    const int l = fl - f * lc;
    A* dst = partial + base + (static_cast<size_t>(l0 + l) * F + f0 + f) * BS;
    for (int i = threadIdx.x; i < BS; i += blockDim.x) {
      const int b = i / SQ;
      dst[i] = sh[fl * BC + b * CS + (i - b * SQ)];
    }
  }
}

// The cross-chunk sum: int32 exactly; f32 and f64 partials in f64,
// rounded once to the output type.
template <typename A>
struct Wide {
  using type = A;
};
template <>
struct Wide<float> {
  using type = double;
};

// out[i] = sum over chunks of partial[c][i] in a fixed order: warp w sums
// chunks w, w + 8, ... in order, then the 8 sums are added in warp order.
// A block takes 32 consecutive cells, so each load is one 128-byte line.
template <typename A, typename O>
__global__ void __launch_bounds__(kReduceWarps * 32)
reduce_partials(const A* __restrict__ partial, O* __restrict__ out,
                size_t total, int chunks) {
  using W = typename Wide<A>::type;
  __shared__ W part[kReduceWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t i = static_cast<size_t>(blockIdx.x) * 32 + lane;
  W acc = W(0);
  if (i < total) {
#pragma unroll 4
    for (int c = warp; c < chunks; c += kReduceWarps) {
      acc += static_cast<W>(partial[static_cast<size_t>(c) * total + i]);
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && i < total) {
    W sum = part[0][lane];
#pragma unroll
    for (int w = 1; w < kReduceWarps; ++w) sum += part[w][lane];
    out[i] = static_cast<O>(sum);
  }
}

template <typename T, int SQ>
int launch(const void* bins_t, const void* slot, const void* stats,
           void* partial, void* out, int n, int F, int B, int L, int G,
           int Fb, int Lb, int chunks, int rows_per_chunk,
           cudaStream_t stream) {
  using A = typename Acc<T>::type;
  using O = typename Out<T>::type;
  const int smem = Fb * Lb * B * cell_stride(SQ) * static_cast<int>(sizeof(A)) +
                   (32 * (kRowsPerLane * SQ + 1) + 32 * (kRowsPerLane + 1)) *
                       4 +
                   Fb * Lb * B;
  if (Fb < 1 || Fb > kMaxWarps || G < 1 || Lb < 1 ||
      (F + G - 1) / G > Fb || smem > kSmemBytes || rows_per_chunk < 1 ||
      static_cast<long long>(rows_per_chunk) * chunks < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(chunks, (L + Lb - 1) / Lb, G);
  hist_kernel<T, SQ><<<grid, 32 * Fb, smem, stream>>>(
      static_cast<const uint8_t*>(bins_t), static_cast<const int32_t*>(slot),
      static_cast<const T*>(stats), static_cast<A*>(partial), n, F, B, L, G,
      Lb, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(L) * F * B * SQ;
  const unsigned blocks = static_cast<unsigned>((total + 31) / 32);
  reduce_partials<A, O><<<blocks, kReduceWarps * 32, 0, stream>>>(
      static_cast<const A*>(partial), static_cast<O*>(out), total, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sq(int Sq, const void* bins_t, const void* slot,
              const void* stats, void* partial, void* out, int n, int F,
              int B, int L, int G, int Fb, int Lb, int chunks, int rows,
              cudaStream_t s) {
  switch (Sq) {
#define YDF_HIST_SQ(q)                                                    \
  case q:                                                                 \
    return launch<T, q>(bins_t, slot, stats, partial, out, n, F, B, L, G, \
                        Fb, Lb, chunks, rows, s);
    YDF_HIST_SQ(1)
    YDF_HIST_SQ(2)
    YDF_HIST_SQ(3)
    YDF_HIST_SQ(4)
    YDF_HIST_SQ(5)
    YDF_HIST_SQ(6)
    YDF_HIST_SQ(7)
    YDF_HIST_SQ(8)
#undef YDF_HIST_SQ
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// stats_kind: 0 = f32 [n, Sq], 1 = bf16 [n, Sq], 2 = int8 [n, Sq].
// G feature groups of at most Fb features (group g takes features
// [g*F/G, (g+1)*F/G)), slot blocks of Lb slots, `chunks` row chunks of
// rows_per_chunk rows. partial holds chunks * L*F*B*Sq accumulators (f64
// for f32 stats, f32 for bf16, int32 for int8), out L*F*B*Sq (f32, or
// int32 for int8); every cell of out is written.
extern "C" int ydf_histogram(const void* bins_t, const void* slot,
                             const void* stats, void* partial, void* out,
                             int n, int F, int B, int Sq, int L,
                             int stats_kind, int G, int Fb, int Lb,
                             int chunks, int rows_per_chunk, void* stream) {
  if (n <= 0 || F <= 0 || L <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stats_kind) {
    case 0:
      return launch_sq<float>(Sq, bins_t, slot, stats, partial, out, n, F, B,
                              L, G, Fb, Lb, chunks, rows_per_chunk, s);
    case 1:
      return launch_sq<__nv_bfloat16>(Sq, bins_t, slot, stats, partial, out,
                                      n, F, B, L, G, Fb, Lb, chunks,
                                      rows_per_chunk, s);
    case 2:
      return launch_sq<int8_t>(Sq, bins_t, slot, stats, partial, out, n, F,
                               B, L, G, Fb, Lb, chunks, rows_per_chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
