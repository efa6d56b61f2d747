// QuickScorer leaf-bitmask scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel ydf_tpu/serving/quickscorer.py:_qs_kernel.
// Called from ydf_tpu_torch/serving/quickscorer.py:score, which also holds
// the host packing (pack_tables), the launch shape (launch_shape) and the
// plain PyTorch version (score_plain) over the same packed tables.
//
// What it computes, per example i:
//   acc = 0
//   for tree t in 0..T-1, in order:
//     live = ~0 (64-bit survivor mask over the tree's leaves)
//     for each condition c of tree t:
//       triggered = categorical ? bit code(x[feature[c], i]) of bitmap[c]
//                                 is NOT set (a code outside the bitmap
//                                 triggers)
//                               : x[feature[c], i] >= thresh[c]
//       if triggered: live &= mask[c]
//     acc += leaf_values[t][lowest set bit of live]    (one f32 add)
//   out[i] = acc
// Trees are added in order, one f32 add each, per example: bit-identical
// to the routed engine (ydf_tpu_torch/ops/routing.py) and to the JAX
// package.
//
// What bounds it on this card: the instructions and shared-memory
// wavefronts of the condition tests. Tested one by one, every example
// tests every condition (18,427 at the default GBT, 13,344 of them
// categorical with 8-word bitmaps), so the work is n * C tests against
// n * F * 4 bytes of input; the function's least work (the walk to one
// leaf a tree) is far less. Read from global memory, each test is a chain
// of dependent loads (the condition's fields, then the input at its
// feature), and load issue and latency bound it.
//
// What this design does about it:
//   * the live mask is the AND of the triggered conditions' masks, in any
//     order and grouping. So the host (pack_tables) folds a tree's
//     categorical conditions on one feature into one mask table: entry v
//     is the AND of the masks that code v triggers. A categorical feature
//     costs one table lookup a tree, not one bitmap test a condition
//     (about 1,200 lookups an example at the default GBT instead of
//     13,344 tests);
//   * a block owns E = threads x K examples (K = 2 adjacent ones a
//     thread);
//     their input rows are staged once into a shared [feature][example]
//     tile, so a record's read of the thread's values is one
//     conflict-free shared load (8 bytes for K = 2), not a global one.
//     Categorical rows are staged as table indices (the code, or 32 W
//     outside the bitmaps), converted once per example;
//   * numerical conditions are 16-byte records (feature, threshold bits,
//     mask lo, mask hi), a categorical group a 16-byte record (feature,
//     its table's first entry); records, leaf values and tables are
//     grouped into tree blocks of about 20 KB, each copied into shared
//     memory with cp.async, double-buffered: the next block loads while
//     this one is scored. A record is one broadcast shared load, shared
//     by the thread's K examples;
//   * the survivor masks live in registers, K pairs of 32-bit words;
//   * too many features for the tile (wider than launch_shape allows)
//     read the input from global memory instead, coalesced by example.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kMaxThreads = 256;
// Examples a thread scores (adjacent columns: one 8-byte shared load reads
// both values of a feature, one record load serves both). One a thread
// ran slower on the card at every tree-block size tried.
constexpr int K = 2;
// Shared memory a block may take: two such blocks fit on an SM.
constexpr int kSmemLimit = 113 * 1024;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

struct Packed {
  const uint4* rec;          // [R] numerical: feature, thresh bits, lo, hi;
                             // group: feature, first table entry, 0, 0
  const int32_t* tree_off;   // [T+1] tree t owns records [off[t], off[t+1])
  const int32_t* num_end;    // [T] end of tree t's numerical records
  const int32_t* block_tree; // [NB+1] first tree of each tree block
  const int32_t* block_mask; // [NB+1] first mask entry of each tree block
  const uint2* masks;        // [M] (lo, hi) mask table entries
  const float* leaves;       // [T, 64]
};

// Tree block b in a buffer: its records, then its trees' leaf values,
// then its mask entries (every part 16-byte aligned: 16 bytes a record,
// 256 a tree).
struct Block {
  int t0, t1;
  uint4* rec;
  float* leaf;
  uint2* mask;
};

__device__ __forceinline__ Block block_at(const Packed& p, int b,
                                          unsigned char* buf) {
  Block k;
  k.t0 = p.block_tree[b];
  k.t1 = p.block_tree[b + 1];
  k.rec = reinterpret_cast<uint4*>(buf);
  k.leaf = reinterpret_cast<float*>(k.rec + (p.tree_off[k.t1] -
                                             p.tree_off[k.t0]));
  k.mask = reinterpret_cast<uint2*>(k.leaf + (k.t1 - k.t0) * kMaxLeaves);
  return k;
}

// Copies tree block b into a buffer.
__device__ __forceinline__ void stage(const Packed& p, int b,
                                      unsigned char* buf) {
  const Block k = block_at(p, b, buf);
  const int r0 = p.tree_off[k.t0], r1 = p.tree_off[k.t1];
  const int m0 = p.block_mask[b], m1 = p.block_mask[b + 1];
  for (int i = threadIdx.x; i < r1 - r0; i += blockDim.x) {
    cp_async16(k.rec + i, p.rec + r0 + i);
  }
  const int leaf4 = (k.t1 - k.t0) * (kMaxLeaves / 4);
  for (int i = threadIdx.x; i < leaf4; i += blockDim.x) {
    cp_async16(k.leaf + 4 * i,
               p.leaves + static_cast<size_t>(k.t0) * kMaxLeaves + 4 * i);
  }
  for (int i = threadIdx.x; i < m1 - m0; i += blockDim.x) {
    cp_async8(k.mask + i, p.masks + m0 + i);
  }
}

// A categorical value's entry in its group's table: the code, or `codes`
// (32 W) for a code outside the bitmaps.
__device__ __forceinline__ int table_index(float v, int codes) {
  const int code = static_cast<int>(v);
  return static_cast<unsigned>(code) < static_cast<unsigned>(codes) ? code
                                                                    : codes;
}

// The thread's K examples' values of one feature row: adjacent columns,
// one 8-byte shared load (TILE) or K coalesced global loads clamped at
// n - 1 (their scores are not written).
template <bool TILE>
__device__ __forceinline__ void load_k(const float* row, int col0, int n,
                                       float (&v)[K]) {
  if constexpr (TILE) {
    const float2 p = *reinterpret_cast<const float2*>(row + col0);
    v[0] = p.x;
    v[1] = p.y;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = row[TILE ? col0 + k : min(col0 + k, n - 1)];
    }
  }
}

// TILE: the examples' rows sit in shared memory ([feature][example],
// categorical rows as table indices); otherwise they are read from xT.
template <bool TILE>
__global__ void __launch_bounds__(kMaxThreads)
qs_score_kernel(const float* __restrict__ xT, Packed p,
                float* __restrict__ out, int n, int F, int num_blocks,
                int codes, int cat_from, int buf_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int E = nt * K;
  const int e0 = blockIdx.x * E;
  const int tid = threadIdx.x;
  float* tile = reinterpret_cast<float*>(smem);
  const int tile_bytes = TILE ? F * E * 4 : 0;
  unsigned char* const buf0 = smem + tile_bytes;

  stage(p, 0, buf0);
  cp_async_commit();
  if (TILE) {
    for (int i = tid; i < F * E; i += nt) {
      const int f = i / E;
      const int e = e0 + (i - f * E);
      const float v = e < n ? xT[static_cast<size_t>(f) * n + e] : 0.0f;
      tile[i] = f >= cat_from ? __int_as_float(table_index(v, codes)) : v;
    }
  }
  // The thread's examples: K adjacent columns.
  const int col0 = TILE ? tid * K : e0 + tid * K;
  const int xs = TILE ? E : n;
  const float* xb = TILE ? tile : xT;

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;

  for (int b = 0; b < num_blocks; ++b) {
    if (b + 1 < num_blocks) {
      stage(p, b + 1, buf0 + ((b + 1) & 1) * buf_bytes);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // block b (and the tile) visible to every thread
    const Block blk = block_at(p, b, buf0 + (b & 1) * buf_bytes);
    const uint4* s_rec = blk.rec;
    const float* s_leaf = blk.leaf;
    const uint2* s_mask = blk.mask;
    const int t0 = blk.t0, t1 = blk.t1;
    const int rbase = p.tree_off[t0];
    for (int t = t0; t < t1; ++t) {
      const int cs = p.tree_off[t] - rbase;
      const int cm = p.num_end[t] - rbase;
      const int ce = p.tree_off[t + 1] - rbase;
      uint32_t lo[K], hi[K];
#pragma unroll
      for (int k = 0; k < K; ++k) lo[k] = hi[k] = ~0u;
#pragma unroll 2
      for (int c = cs; c < cm; ++c) {
        const uint4 q = s_rec[c];
        const float th = __uint_as_float(q.y);
        float v[K];
        load_k<TILE>(xb + static_cast<size_t>(q.x) * xs, col0, n, v);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (v[k] >= th) {
            lo[k] &= q.z;
            hi[k] &= q.w;
          }
        }
      }
      // A categorical group: one table entry an example.
#pragma unroll 2
      for (int c = cm; c < ce; ++c) {
        const uint4 q = s_rec[c];
        float v[K];
        load_k<TILE>(xb + static_cast<size_t>(q.x) * xs, col0, n, v);
        const uint2* table = s_mask + q.y;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int idx =
              TILE ? __float_as_int(v[k]) : table_index(v[k], codes);
          const uint2 m = table[idx];
          lo[k] &= m.x;
          hi[k] &= m.y;
        }
      }
      const float* leaf = s_leaf + (t - t0) * kMaxLeaves;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint64_t live =
            (static_cast<uint64_t>(hi[k]) << 32) | static_cast<uint64_t>(lo[k]);
        // No survivor cannot happen for a well-formed tree; it reads 0
        // like the TPU kernel's empty one-hot.
        const float v =
            live ? leaf[__ffsll(static_cast<long long>(live)) - 1] : 0.0f;
        acc[k] = __fadd_rn(acc[k], v);
      }
    }
    __syncthreads();  // every thread is done with buffer b & 1
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = e0 + tid * K + k;
    if (e < n) out[e] = acc[k];
  }
}

template <bool TILE>
int launch(const float* xT, const Packed& p, float* out, int n, int F,
           int num_blocks, int codes, int cat_from, int buf_bytes,
           int threads, cudaStream_t stream) {
  const int smem = (TILE ? F * threads * K * 4 : 0) + 2 * buf_bytes;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // The attribute is a device's own: set once per instantiation, process
  // and device (bit d of attr_set: device d < 64).
  static unsigned long long attr_set = 0;
  int device = 0;
  const cudaError_t derr = cudaGetDevice(&device);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  const unsigned long long bit = 1ull << (device & 63);
  if (!(attr_set & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        qs_score_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= bit;
  }
  const int E = threads * K;
  const int blocks = (n + E - 1) / E;
  qs_score_kernel<TILE><<<blocks, threads, smem, stream>>>(
      xT, p, out, n, F, num_blocks, codes, cat_from, buf_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed tables as ydf_tpu_torch/serving/quickscorer.py:pack_tables makes
// them. F: the rows of xT the conditions read (staged when tile != 0);
// rows >= cat_from are categorical codes, their tables codes + 1 entries
// long; buf_bytes: the largest tree block (a multiple of 16). threads (a multiple of 32, at most 256) x K examples a block.
extern "C" int ydf_qs_score(const void* xT, const void* rec,
                            const void* tree_off, const void* num_end,
                            const void* block_tree, const void* block_mask,
                            const void* masks, const void* leaf_values,
                            void* out, int n, int F, int num_blocks,
                            int codes, int cat_from, int buf_bytes,
                            int threads, int tile, void* stream) {
  if (n <= 0) return 0;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      num_blocks < 1 || buf_bytes % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Packed p{static_cast<const uint4*>(rec),
                 static_cast<const int32_t*>(tree_off),
                 static_cast<const int32_t*>(num_end),
                 static_cast<const int32_t*>(block_tree),
                 static_cast<const int32_t*>(block_mask),
                 static_cast<const uint2*>(masks),
                 static_cast<const float*>(leaf_values)};
  const float* x = static_cast<const float*>(xT);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile) {
    return launch<true>(x, p, o, n, F, num_blocks, codes, cat_from,
                        buf_bytes, threads, s);
  }
  return launch<false>(x, p, o, n, F, num_blocks, codes, cat_from, buf_bytes,
                       threads, s);
}
