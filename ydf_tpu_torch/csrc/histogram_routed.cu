// Fused previous-layer routing + this-layer histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel ydf_tpu/ops/histogram_pallas.py:
// _hist_routed_kernel (wrapper histogram_routed_pallas). Called from
// ydf_tpu_torch/ops/histogram_kernels.py:histogram_routed, which also
// holds the plain PyTorch version (histogram_routed_plain) this kernel is
// tested against and the launch shape (routed_launch_shape).
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
// then this layer's histogram out[hs, f, bins_t[f, r], s] += stats[r, s]
// over Lh slots (hs >= Lh is the trash slot). hmap is composed into two
// per-slot tables (hl = hmap[2 sr], hr = hmap[2 sr + 1]) when the tables
// are loaded, as the TPU wrapper composes it (histogram_pallas.py:347-362).
// Routing is integer-exact.
//
// What bounds it on this card: not the bytes (0.0088 ms at train_bench's
// deepest layer at 3.35 TB/s) but the work that blocks repeat and the
// adds. Every block that owns some of a row's (feature, hist slot) cells
// must route the row (its slot, the routed feature's bin gathered from a
// random feature row, the go-left bit); float stats go into f64 shared
// cells, for which sm_90a has no atomic add (a 64-bit compare-and-swap
// loop, ATOMS.CAST.SPIN.64); and a tile's phases (route, sort, add) are
// separated by barriers.
//
// What this design does about it:
//   * a block owns P <= 32 (feature, hist slot) pairs, a warp each: Fb
//     features x Lb slots, with Lb = Lh where 32 allows, so one block
//     covers every hist slot of its features and a row is routed once per
//     feature group (14 groups at train_bench's Lh = 16, one at Lh = 1),
//     not once per feature. The pairs' f64 cells take most of the SM's
//     shared memory; one block of 1024 threads runs on each SM
//     (ops/histogram_kernels.py:routed_launch_shape sizes it);
//   * a tile of 1024 rows is routed once, a row a thread; every global
//     load of a tile (slot, leaf, stats, the routed feature's bin, the
//     block's features' bins) is issued during the tile before. new_slot
//     and new_leaf are written by the blocks of the first feature group
//     and slot block only, so once per row. The tile's live rows are then
//     sorted by hist slot into shared lists (a counting sort without
//     atomics: each warp's rows of a slot by __match_any_sync, a scan of
//     each slot's counts over the warps, a scan of the slot totals),
//     with their stats beside them, and the tile's bins of the block's
//     features are staged once;
//   * each pair's warp walks its slot's list, a row a lane, and adds into
//     its own 256 cells in tag rounds (csrc/histogram.cu): each pending
//     lane writes its id to the cell's one-byte tag, the lane whose id
//     stays adds its stats with a plain read-modify-write, the others go
//     again. After two rounds the lanes still pending group by cell
//     (__match_any_sync) and each group's lowest lane adds the group's
//     rows: a pile-up of rows on one bin (train_vs's empty sequences, 10%
//     of the rows in bin 0 of 32 of its 36 features) costs three rounds,
//     not one a row. No float atomics. int8 stats add into int32 cells
//     with native shared atomics, exact in any order;
//   * float stats (f32, bf16) add into f64 cells, and the partials and
//     their cross-chunk sum stay f64, rounded once to f32. An f32 cell
//     summed a chunk's thousands of rows in whatever order its atomics
//     landed: on a small leaf reached through sibling subtraction that
//     moved the leaf value by 3e-5 against the f64 plain version
//     (scripts/card_leaf_drift.py). In f64 the order moves the f32 result
//     only when a sum lies within a few f64 ulps of an f32 rounding
//     boundary;
//   * each block writes its pairs' cells to its chunk's slice of a
//     partials buffer, and a second kernel sums the chunks in chunk
//     order: two launches a layer, as before.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kTileRows = kThreads;
constexpr int kMaxPairs = kThreads / 32;
constexpr int kReduceThreads = 256;
// The most dynamic shared memory a block may opt into on sm_90.
constexpr int kSmemLimit = 232448;

// Sum: the shared cells' and partials' type (f64 for float stats); Stage:
// a staged stat (exact for f32 and bf16); Acc: the output's type.
template <typename T>
struct Sum {
  using type = double;
  using stage = float;
  using acc = float;
};
template <>
struct Sum<int8_t> {
  using type = int32_t;
  using stage = int32_t;
  using acc = int32_t;
};

__device__ __forceinline__ float to_stage(float v) { return v; }
__device__ __forceinline__ float to_stage(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int32_t to_stage(int8_t v) {
  return static_cast<int32_t>(v);
}

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// Bytes of the table region: six int32 tables, the go-left bits (one
// 32-bit word per 32 bins), the split and set flags.
__host__ __device__ inline int table_bytes(int L1, int B) {
  return align16(L1 * 6 * 4 + L1 * ((B + 31) / 32) * 4 + L1 * 2);
}

// The shared-memory layout, in bytes from the start: cells, tags, staged
// stats, list rows, staged bins, tables, then the counts: each warp's rows
// of each slot ([Lb][32]), the slot totals and the list starts.
struct Layout {
  int tags, stats, rows, bins, tables, counts, total;
};

__host__ __device__ inline Layout layout(int Fb, int Lb, int B, int Sq,
                                         int L1, int cell_bytes) {
  Layout s;
  const int P = Fb * Lb;
  s.tags = align16(P * B * Sq * cell_bytes);
  s.stats = s.tags + (cell_bytes == 8 ? align16(P * B) : 0);
  s.rows = s.stats + kTileRows * Sq * 4;
  s.bins = s.rows + kTileRows * 2;
  s.tables = s.bins + align16(Fb * kTileRows);
  s.counts = s.tables + table_bytes(L1, B);
  s.total = s.counts + (kMaxPairs * Lb + 2 * Lb + 1) * 4;
  return s;
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

// Grid: (row chunk, slot block, feature group). Group g takes features
// [g*F/G, (g+1)*F/G), at most Fb; slot block y takes hist slots
// [y*Lb, y*Lb + Lb). Warp w < Fb*Lb owns the pair (feature w / Lb, slot
// w % Lb).
template <typename T, int SQ>
__global__ void __launch_bounds__(kThreads, 1)
routed_kernel(const uint8_t* __restrict__ bins_t,
              const int32_t* __restrict__ slot,
              const int32_t* __restrict__ leaf, Tables tab,
              const T* __restrict__ stats,
              typename Sum<T>::type* __restrict__ partial,
              int32_t* __restrict__ new_slot, int32_t* __restrict__ new_leaf,
              int n, int F, int B, int L, int Lh, int G, int Fb, int Lb,
              int rows_per_chunk) {
  using S = typename Sum<T>::type;
  using V = typename Sum<T>::stage;
  constexpr bool kInt = sizeof(S) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L1 = L + 1;
  const int BW = (B + 31) / 32;
  const Layout lay = layout(Fb, Lb, B, SQ, L1, sizeof(S));
  S* cells = reinterpret_cast<S*>(smem);
  uint8_t* tags = smem + lay.tags;
  V* s_stats = reinterpret_cast<V*>(smem + lay.stats);
  uint16_t* s_rows = reinterpret_cast<uint16_t*>(smem + lay.rows);
  uint8_t* s_bins = smem + lay.bins;
  int32_t* s_route_f = reinterpret_cast<int32_t*>(smem + lay.tables);
  int32_t* s_left = s_route_f + L1;
  int32_t* s_right = s_left + L1;
  int32_t* s_hl = s_right + L1;
  int32_t* s_hr = s_hl + L1;
  int32_t* s_sr2 = s_hr + L1;
  uint32_t* s_gl = reinterpret_cast<uint32_t*>(s_sr2 + L1);
  uint8_t* s_split = reinterpret_cast<uint8_t*>(s_gl + L1 * BW);
  uint8_t* s_set = s_split + L1;
  int32_t* s_wcnt = reinterpret_cast<int32_t*>(smem + lay.counts);
  int32_t* s_total = s_wcnt + kMaxPairs * Lb;
  int32_t* s_base = s_total + Lb;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int l = tid; l < L1; l += kThreads) {
    s_route_f[l] = min(max(tab.route_f[l], 0), F - 1);
    s_left[l] = tab.left_id[l];
    s_right[l] = tab.right_id[l];
    const int sr = tab.split_rank[l];
    s_sr2[l] = 2 * sr;
    s_hl[l] = tab.hmap[min(max(2 * sr, 0), L)];
    s_hr[l] = tab.hmap[min(max(2 * sr + 1, 0), L)];
    s_split[l] = tab.do_split[l];
    s_set[l] = tab.is_set[l];
  }
  // go_left[l, b] as bits: warp w packs words w, w + 32, ...
  for (int wd = warp; wd < L1 * BW; wd += kMaxPairs) {
    const int l = wd / BW;
    const int b = (wd - l * BW) * 32 + lane;
    const bool g = b < B && tab.go_left[static_cast<size_t>(l) * B + b];
    const unsigned bits = __ballot_sync(kFull, g);
    if (lane == 0) s_gl[wd] = bits;
  }
  const int trash_hs = tab.hmap[L];

  const int g = blockIdx.z;
  const int f0 = static_cast<int>(static_cast<long long>(g) * F / G);
  const int fc =
      static_cast<int>(static_cast<long long>(g + 1) * F / G) - f0;
  const int l0 = blockIdx.y * Lb;
  const int lc = max(0, min(Lb, Lh - l0));
  // With no hist slot (Lh = 0) the block only routes.
  const int cell_count = lc > 0 ? Fb * Lb * B * SQ : 0;
  const int fstage = lc > 0 ? fc : 0;
  for (int i = tid; i < cell_count; i += kThreads) cells[i] = S(0);
  if (tid < kMaxPairs * Lb) s_wcnt[tid] = 0;

  const bool write_route = blockIdx.y == 0 && blockIdx.z == 0;
  const int r0 = blockIdx.x * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  const size_t stride = static_cast<size_t>(n);
  // This warp's pair (the last warps of a short group or slot block
  // idle in the add phase).
  const int fi = warp / Lb;
  const int li = warp - fi * Lb;
  const bool pair = fi < fc && li < lc;
  S* my_cells = cells + static_cast<size_t>(warp) * B * SQ;
  uint8_t* my_tags = tags + warp * B;
  // Every global load of a tile is issued during the tile before, so that
  // its latency hides behind that tile's work: the row's slot, leaf and
  // stats (`prefetch`), the block's features' bins as 16-byte words, at
  // most two a thread, in registers until they are stored (`stage_load`),
  // and the routed feature's bin, which needs the slot (`gather`).
  int next_slot = 0, next_leaf = 0, next_gbin = 0;
  V next_v[SQ];
  uint4 next_bins[2];
  constexpr int kWords = kTileRows / 16;  // 16-byte words of a feature row
  auto prefetch = [&](int rr) {
    if (rr < r1) {
      next_slot = slot[rr];
      next_leaf = leaf[rr];
#pragma unroll
      for (int s = 0; s < SQ; ++s) {
        next_v[s] = to_stage(stats[static_cast<size_t>(rr) * SQ + s]);
      }
    }
  };
  auto stage_load = [&](int t) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * kThreads;
      next_bins[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i >= fstage * kWords) continue;
      const int f = i / kWords;
      const int rr = t + (i - f * kWords) * 16;
      const uint8_t* src = bins_t + static_cast<size_t>(f0 + f) * stride + rr;
      if (rr + 16 <= r1 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        next_bins[j] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        unsigned x[4] = {0u, 0u, 0u, 0u};
        for (int k = 0; k < 16 && rr + k < r1; ++k) {
          x[k >> 2] |= static_cast<unsigned>(src[k]) << (8 * (k & 3));
        }
        next_bins[j] = make_uint4(x[0], x[1], x[2], x[3]);
      }
    }
  };
  auto stage_store = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * kThreads;
      if (i >= fstage * kWords) continue;
      const int f = i / kWords;
      *reinterpret_cast<uint4*>(s_bins + f * kTileRows +
                                (i - f * kWords) * 16) = next_bins[j];
    }
  };
  auto gather = [&](int rr) {
    next_gbin = 0;
    if (rr < r1) {
      const int l = next_slot < 0 || next_slot > L ? L : next_slot;
      if (s_split[l]) {
        next_gbin = bins_t[static_cast<size_t>(s_route_f[l]) * stride + rr];
      }
    }
  };
  __syncthreads();  // the tables and cleared counts, before `gather`
  prefetch(r0 + tid);
  stage_load(r0);
  gather(r0 + tid);

  for (int t0 = r0; t0 < r1; t0 += kTileRows) {
    // -- route the tile, a row a thread --------------------------------
    const int r = t0 + tid;
    const bool inside = r < r1;
    int l = next_slot;
    const int row_leaf = next_leaf;
    const int route_bin = next_gbin;
    V v[SQ];
#pragma unroll
    for (int s = 0; s < SQ; ++s) v[s] = next_v[s];
    stage_store();
    prefetch(r + kTileRows);
    int h = -1;
    if (inside) {
      if (l < 0 || l > L) l = L;
      int hs;
      int ns, nl;
      if (s_split[l]) {
        const int b = route_bin;
        bool gl = b < B && ((s_gl[l * BW + (b >> 5)] >> (b & 31)) & 1u);
        if (s_set[l]) gl = tab.set_go_left != nullptr && tab.set_go_left[r];
        ns = gl ? s_sr2[l] : s_sr2[l] + 1;
        nl = gl ? s_left[l] : s_right[l];
        hs = gl ? s_hl[l] : s_hr[l];
      } else {
        ns = L;
        nl = row_leaf;
        hs = trash_hs;
      }
      if (write_route) {
        new_slot[r] = ns;
        new_leaf[r] = nl;
      }
      if (hs < Lh && hs >= l0 && hs - l0 < lc) h = hs - l0;
    }
    // The warp's rows of each slot: one write by the lowest lane of each
    // slot's group, and each row's rank in its group. (A shared atomic a
    // row serialised on the few slot counters and took most of a tile's
    // time on the card.)
    const unsigned peers = __match_any_sync(kFull, h);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (h >= 0 && rank == 0) s_wcnt[h * kMaxPairs + warp] = __popc(peers);
    __syncthreads();
    // -- list starts: warp h scans slot h's counts over the warps, then
    // one warp scans the slot totals --------------------------------------
    if (warp < lc) {
      const int c = s_wcnt[warp * kMaxPairs + lane];
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      s_wcnt[warp * kMaxPairs + lane] = incl - c;
      if (lane == 31) s_total[warp] = incl;
    }
    __syncthreads();
    if (warp == 0) {
      const int c = lane < lc ? s_total[lane] : 0;
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      if (lane < lc) s_base[lane + 1] = incl;
      if (lane == 0) s_base[0] = 0;
    }
    __syncthreads();
    if (h >= 0) {
      const int k = s_base[h] + s_wcnt[h * kMaxPairs + warp] + rank;
      s_rows[k] = static_cast<uint16_t>(tid);
#pragma unroll
      for (int s = 0; s < SQ; ++s) s_stats[k * SQ + s] = v[s];
    }
    __syncthreads();
    // Every warp's counts read: clear them for the next tile.
    if (tid < kMaxPairs * Lb) s_wcnt[tid] = 0;
    gather(r + kTileRows);
    stage_load(t0 + kTileRows);
    // -- each pair's warp adds its slot's rows, a row a lane -----------
    if (pair) {
      const int end = s_base[li + 1];
      const uint8_t* fb = s_bins + fi * kTileRows;
      for (int k0 = s_base[li]; k0 < end; k0 += 32) {
        const int k = k0 + lane;
        const int b = k < end ? fb[s_rows[k]] : B;
        const bool live = b < B;
        S* cell = my_cells + (live ? b : 0) * SQ;
        if constexpr (kInt) {
          if (live) {
#pragma unroll
            for (int s = 0; s < SQ; ++s) {
              atomicAdd(cell + s, s_stats[k * SQ + s]);
            }
          }
        } else {
          // Two tag rounds, then the lanes still pending (three or more
          // rows on one cell: the pile-up of empty sequences in bin 0)
          // group by cell, and each group's lowest lane adds the group's
          // rows at once.
          bool pending = live;
          for (int round = 0; __any_sync(kFull, pending); ++round) {
            if (round == 2) {
              const unsigned peers = __match_any_sync(kFull, pending ? b : -1);
              if (pending && (peers & ((1u << lane) - 1u)) == 0u) {
                double sum[SQ];
#pragma unroll
                for (int s = 0; s < SQ; ++s) sum[s] = s_stats[k * SQ + s];
                for (unsigned m = peers & (peers - 1u); m; m &= m - 1u) {
                  const int kk = k0 + __ffs(m) - 1;
#pragma unroll
                  for (int s = 0; s < SQ; ++s) sum[s] += s_stats[kk * SQ + s];
                }
#pragma unroll
                for (int s = 0; s < SQ; ++s) cell[s] += sum[s];
              }
              break;
            }
            if (pending) my_tags[b] = static_cast<uint8_t>(lane);
            __syncwarp();
            const bool win = pending && my_tags[b] == lane;
            if (win) {
#pragma unroll
              for (int s = 0; s < SQ; ++s) {
                cell[s] += static_cast<double>(s_stats[k * SQ + s]);
              }
            }
            pending = pending && !win;
            __syncwarp();
          }
        }
      }
    }
    __syncthreads();
  }

  // This block's pairs to its chunk's slice of partial[chunk][Lh][F][B][SQ].
  const int BS = B * SQ;
  const size_t base = static_cast<size_t>(blockIdx.x) * Lh * F * BS;
  for (int i = tid; i < cell_count; i += kThreads) {
    const int w = i / BS;
    const int fw = w / Lb;
    const int lw = w - fw * Lb;
    if (fw >= fc || lw >= lc) continue;
    partial[base + (static_cast<size_t>(l0 + lw) * F + f0 + fw) * BS +
            (i - w * BS)] = cells[i];
  }
}

// The cross-chunk sum in chunk order (int32 exactly; f64 partials in
// f64, rounded once to f32), a thread a cell; the loads of several chunks
// are in flight at once.
template <typename S, typename A>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const S* __restrict__ partial, A* __restrict__ out,
                size_t total, int chunks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kReduceThreads +
                   threadIdx.x;
  if (i >= total) return;
  S acc = partial[i];
#pragma unroll 8
  for (int c = 1; c < chunks; ++c) acc += partial[c * total + i];
  out[i] = static_cast<A>(acc);
}

template <typename T, int SQ>
int launch(const void* bins_t, const void* slot, const void* leaf,
           const Tables& tab, const void* stats, void* partial, void* out,
           void* new_slot, void* new_leaf, int n, int F, int B, int L,
           int Lh, int G, int Fb, int Lb, int chunks, int rows_per_chunk,
           int wide, cudaStream_t stream) {
  using S = typename Sum<T>::type;
  using A = typename Sum<T>::acc;
  const Layout lay = layout(Fb, Lb, B, SQ, L + 1, sizeof(S));
  const int slot_blocks = Lh > 0 ? (Lh + Lb - 1) / Lb : 1;
  if (Fb < 1 || Lb < 1 || Fb * Lb > kMaxPairs || G < 1 ||
      (F + G - 1) / G > Fb || lay.total > kSmemLimit || B < 1 || B > 256 ||
      rows_per_chunk < 1 ||
      static_cast<long long>(rows_per_chunk) * chunks < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The attribute is a device's own: set once per instantiation, process
  // and device (bit d of attr_set: device d < 64).
  static unsigned long long attr_set = 0;
  int device = 0;
  const cudaError_t derr = cudaGetDevice(&device);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  const unsigned long long bit = 1ull << (device & 63);
  if (!(attr_set & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        routed_kernel<T, SQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= bit;
  }
  const dim3 grid(chunks, slot_blocks, G);
  routed_kernel<T, SQ><<<grid, kThreads, lay.total, stream>>>(
      static_cast<const uint8_t*>(bins_t), static_cast<const int32_t*>(slot),
      static_cast<const int32_t*>(leaf), tab, static_cast<const T*>(stats),
      static_cast<S*>(partial), static_cast<int32_t*>(new_slot),
      static_cast<int32_t*>(new_leaf), n, F, B, L, Lh, G, Fb, Lb,
      rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(Lh) * F * B * SQ;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kReduceThreads - 1) / kReduceThreads);
  if (wide) {
    // A shard's sum, unrounded: the mesh merge adds the shards' sums and
    // rounds once.
    reduce_partials<S, S><<<blocks, kReduceThreads, 0, stream>>>(
        static_cast<const S*>(partial), static_cast<S*>(out), total, chunks);
  } else {
    reduce_partials<S, A><<<blocks, kReduceThreads, 0, stream>>>(
        static_cast<const S*>(partial), static_cast<A*>(out), total, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sq(int Sq, const void* bins_t, const void* slot, const void* leaf,
              const Tables& tab, const void* stats, void* partial, void* out,
              void* new_slot, void* new_leaf, int n, int F, int B, int L,
              int Lh, int G, int Fb, int Lb, int chunks, int rows, int wide,
              cudaStream_t s) {
  switch (Sq) {
#define YDF_ROUTED_SQ(q)                                                   \
  case q:                                                                  \
    return launch<T, q>(bins_t, slot, leaf, tab, stats, partial, out,      \
                        new_slot, new_leaf, n, F, B, L, Lh, G, Fb, Lb,     \
                        chunks, rows, wide, s);
    YDF_ROUTED_SQ(1)
    YDF_ROUTED_SQ(2)
    YDF_ROUTED_SQ(3)
    YDF_ROUTED_SQ(4)
    YDF_ROUTED_SQ(5)
    YDF_ROUTED_SQ(6)
    YDF_ROUTED_SQ(7)
    YDF_ROUTED_SQ(8)
#undef YDF_ROUTED_SQ
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Tables follow the padded [L + 1] contract of the TPU kernel; go_left is
// u8 [L + 1, B]; set_go_left is u8 [n] or null. stats_kind: 0 = f32,
// 1 = bf16, 2 = int8, each [n, Sq]. G feature groups of at most Fb
// features, slot blocks of Lb hist slots (Fb * Lb <= 32), `chunks` row
// chunks of rows_per_chunk rows. partial holds chunks * Lh*F*B*Sq sums
// (f64, or int32 for int8), out Lh*F*B*Sq accumulators (f32, or int32 for
// int8; with `wide` the unrounded sums, f64 or int32); every cell of out is
// written.
extern "C" int ydf_histogram_routed(
    const void* bins_t, const void* slot, const void* leaf,
    const void* do_split, const void* route_f, const void* go_left,
    const void* left_id, const void* right_id, const void* split_rank,
    const void* hmap, const void* is_set, const void* set_go_left,
    const void* stats, void* partial, void* out, void* new_slot,
    void* new_leaf, int n, int F, int B, int Sq, int L, int Lh,
    int stats_kind, int G, int Fb, int Lb, int chunks, int rows_per_chunk,
    int wide, void* stream) {
  if (n <= 0 || F <= 0) return 0;
  const Tables tab{static_cast<const uint8_t*>(do_split),
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
      return launch_sq<float>(Sq, bins_t, slot, leaf, tab, stats, partial,
                              out, new_slot, new_leaf, n, F, B, L, Lh, G, Fb,
                              Lb, chunks, rows_per_chunk, wide, s);
    case 1:
      return launch_sq<__nv_bfloat16>(Sq, bins_t, slot, leaf, tab, stats,
                                      partial, out, new_slot, new_leaf, n, F,
                                      B, L, Lh, G, Fb, Lb, chunks,
                                      rows_per_chunk, wide, s);
    case 2:
      return launch_sq<int8_t>(Sq, bins_t, slot, leaf, tab, stats, partial,
                               out, new_slot, new_leaf, n, F, B, L, Lh, G, Fb,
                               Lb, chunks, rows_per_chunk, wide, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
