// Data-bank forest scoring for Hopper (sm_90a): trees of any shape.
//
// Replaces the TPU kernel ydf_tpu/serving/pallas_scorer.py:_bank_kernel.
// Called from ydf_tpu_torch/serving/bank_scorer.py:score, which also holds
// the host packing (pack_tables), the walk each batch size takes
// (split_walk) and the plain PyTorch version (score_plain) over the same
// packed tables. This file owns the shared-memory layout and its limits.
//
// What it computes, per example i:
//   acc = 0
//   for tree t in 0..T-1, in order:
//     rec = record 0 of tree t
//     while rec is not a leaf (and, wide, fewer than max_depth steps):
//       v = xT[feature(rec), i]
//       go_left = categorical(rec) ? bit (c & 31) of mask word
//                                    min(c >> 5, W-1), c = max((int)v, 0)
//                                  : v < threshold(rec)
//       rec = go_left ? left(rec) : right(rec)
//     acc += leaf value(rec), 0 at an internal node      (one f32 add)
//   out[i] = acc
// The narrow packing makes a node max_depth steps from the root a leaf
// (value 0 when it is internal); the wide walk counts its steps. Either is
// the TPU kernel's max_depth steps with a self-loop at leaves. Trees are
// added in order, one f32 add each: bit-identical to the generic routed
// engine and to the JAX package.
//
// What bounds it on this card: the walk's dependent loads, not the bytes
// (the bytes of 1,048,576 rows x 32 features take 0.04 ms; the default GBT
// takes about 6 steps a tree, 1,800 an example). A step is a chain: the
// node's record, then the input at its feature, then the mask word of a
// categorical node, then the next record. The first design read every link
// from global memory (node tables as [T, N] arrays, the input
// feature-major with a different feature in each lane: up to 32 sectors a
// warp's load) and walked one example a thread, so a small batch was one
// thread's serial walk through every tree.
//
// What this design does about it:
//   * a node is one record: narrow, 8 bytes (meta: leaf and categorical
//     bits, feature, left child, the right child next to it; payload:
//     threshold, leaf value or mask offset), for trees whose ids fit 30
//     bits; wide, 16 bytes (feature and categorical bit, payload, left,
//     right), for any other forest; mask words stored for categorical
//     nodes only; trees are grouped into tree blocks of about 12 KB, each
//     copied into shared memory with cp.async, double-buffered: the next
//     block loads while this one is walked. A step is one shared record
//     load;
//   * a block's examples' input rows are staged once into a shared
//     [feature][example] tile, coalesced from xT; the lanes of a warp
//     hold consecutive examples, so a step's value load hits 32 banks
//     whatever the features are;
//   * a thread walks one example (two at once, independent chains, ran
//     slower: the wider tile left fewer warps an SM);
//   * a small batch (the split walk): a block scores 32 examples, one a
//     lane, and its 8 warps share out each tree block's trees; each warp
//     writes its trees' leaf values to shared memory and lane e of warp 0
//     adds them in tree order, the same adds in the same order;
//   * a tree too large for a tree block is a block of its own, walked by
//     the same code from its packed records in global memory;
//   * too many features for the tile: the input is read from xT.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The split walk's examples a block: one a lane.
constexpr int kSplitExamples = 32;
// Shared memory a block may take: two such blocks fit on an SM.
constexpr int kSmemLimit = 113 * 1024;
constexpr uint32_t kWideLeaf = 0xFFFFFFFFu;  // a wide leaf record's left

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

struct Packed {
  const uint4* pack;          // trees, 16-byte aligned runs of u32 words
  const int32_t* tree_off;    // [T+1] tree t = pack[off[t], off[t+1])
  const int32_t* block_tree;  // [NB+1] first tree of each tree block
  int buf_units;              // 16-byte units of the largest staged block
  int num_words;              // W
  int child_shift;            // narrow records
  int max_depth;              // wide records: steps a walk takes at most
};

// A tree's words in shared memory (staged) or global memory (a tree too
// large for a tree block).
struct SharedTree {
  const uint32_t* w;
  __device__ __forceinline__ uint2 rec(uint32_t i) const {
    return reinterpret_cast<const uint2*>(w)[i];
  }
  __device__ __forceinline__ uint4 wide(uint32_t i) const {
    return reinterpret_cast<const uint4*>(w)[i];
  }
  __device__ __forceinline__ uint32_t word(uint32_t i) const { return w[i]; }
};

struct GlobalTree {
  const uint32_t* w;
  __device__ __forceinline__ uint2 rec(uint32_t i) const {
    return __ldg(reinterpret_cast<const uint2*>(w) + i);
  }
  __device__ __forceinline__ uint4 wide(uint32_t i) const {
    return __ldg(reinterpret_cast<const uint4*>(w) + i);
  }
  __device__ __forceinline__ uint32_t word(uint32_t i) const {
    return __ldg(w + i);
  }
};

// The examples' values of one feature: TILE, row f of the shared
// [feature][example] tile (stride = the block's examples); else row f of
// xT (stride n; columns clamped at n - 1 by the caller).
template <bool TILE>
__device__ __forceinline__ float value(const float* x, size_t stride,
                                       uint32_t f, int col) {
  if constexpr (TILE) {
    return x[f * static_cast<uint32_t>(stride) + col];
  } else {
    return __ldg(x + f * stride + col);
  }
}

// One step's decision at a node of feature f, categorical or not, with
// payload pay.
template <bool TILE, class Tree>
__device__ __forceinline__ bool go_left(const Tree& tree, const Packed& p,
                                        uint32_t f, bool cat, uint32_t pay,
                                        const float* x, size_t stride,
                                        int col) {
  const float v = value<TILE>(x, stride, f, col);
  if (cat) {
    const int c = max(__float2int_rz(v), 0);
    const int w = min(c >> 5, p.num_words - 1);
    return (tree.word(pay + w) >> (c & 31)) & 1u;
  }
  return v < __uint_as_float(pay);
}

// One example's walk of one tree; returns its leaf value (0 where a wide
// walk stops at an internal node).
template <bool TILE, bool WIDE, class Tree>
__device__ __forceinline__ float walk(const Tree& tree, const Packed& p,
                                      const float* x, size_t stride,
                                      int col) {
  if constexpr (WIDE) {
    uint4 r = tree.wide(0);
    for (int d = 0; d < p.max_depth && r.z != kWideLeaf; ++d) {
      const bool left = go_left<TILE>(tree, p, r.x & 0x7FFFFFFFu,
                                      r.x >> 31, r.y, x, stride, col);
      r = tree.wide(left ? r.z : r.w);
    }
    return r.z == kWideLeaf ? __uint_as_float(r.y) : 0.0f;
  } else {
    const uint32_t fmask = (1u << (p.child_shift - 2)) - 1u;
    uint2 r = tree.rec(0);
    while (!(r.x & 1u)) {
      const bool left = go_left<TILE>(tree, p, (r.x >> 2) & fmask,
                                      r.x & 2u, r.y, x, stride, col);
      r = tree.rec((r.x >> p.child_shift) + (left ? 0u : 1u));
    }
    return __uint_as_float(r.y);
  }
}

// Copies tree block b into a buffer (a block too large for one is not
// staged).
__device__ __forceinline__ void stage(const Packed& p, int b, uint4* buf) {
  const int u0 = p.tree_off[p.block_tree[b]];
  const int u1 = p.tree_off[p.block_tree[b + 1]];
  if (u1 - u0 > p.buf_units) return;
  for (int i = threadIdx.x; i < u1 - u0; i += blockDim.x) {
    cp_async16(buf + i, p.pack + u0 + i);
  }
}

// Stages the block's E examples' rows into the [feature][example] tile.
__device__ __forceinline__ void stage_tile(const float* __restrict__ xT,
                                           float* tile, int F, int E, int e0,
                                           int n) {
  for (int i = threadIdx.x; i < F * E; i += blockDim.x) {
    const int f = i / E;
    const int e = e0 + (i - f * E);
    tile[i] = e < n ? xT[static_cast<size_t>(f) * n + e] : 0.0f;
  }
}

// The walk of a block's examples through every tree block. Not SPLIT (the
// large batch): an example a thread, every thread walks every tree. SPLIT
// (the small batch): 32 examples a block, one a lane; warp w walks trees
// t0 + w, t0 + w + 8, ... of each tree block and writes their leaf values
// to `vals`; lane e of warp 0 adds them in tree order. Shared memory as
// `Layout` places it.
template <bool SPLIT, bool TILE, bool WIDE>
__device__ __forceinline__ void walk_blocks(const float* __restrict__ xT,
                                            const Packed& p,
                                            float* __restrict__ out, int n,
                                            int F, int num_blocks,
                                            int vals_at, int bufs_at) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = SPLIT ? kSplitExamples : kThreads;
  const int e0 = blockIdx.x * E;
  const int ex = SPLIT ? (threadIdx.x & 31) : threadIdx.x;  // its example
  const int warp = threadIdx.x >> 5;
  const bool adds = !SPLIT || warp == 0;  // the thread that adds
  float* tile = reinterpret_cast<float*>(smem);
  float* vals = reinterpret_cast<float*>(smem + vals_at);
  uint4* buf0 = reinterpret_cast<uint4*>(smem + bufs_at);

  stage(p, 0, buf0);
  cp_async_commit();
  if (TILE) stage_tile(xT, tile, F, E, e0, n);
  const float* x = TILE ? tile : xT;
  const size_t stride = TILE ? E : static_cast<size_t>(n);
  const int col = TILE ? ex : min(e0 + ex, n - 1);
  float acc = 0.0f;

  for (int b = 0; b < num_blocks; ++b) {
    if (b + 1 < num_blocks) {
      stage(p, b + 1, buf0 + ((b + 1) & 1) * p.buf_units);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // block b (and the tile) visible to every thread
    const int t0 = p.block_tree[b], t1 = p.block_tree[b + 1];
    const int u0 = p.tree_off[t0];
    if (p.tree_off[t1] - u0 <= p.buf_units) {
      const uint32_t* base =
          reinterpret_cast<const uint32_t*>(buf0 + (b & 1) * p.buf_units);
      for (int t = t0 + (SPLIT ? warp : 0); t < t1;
           t += (SPLIT ? kWarps : 1)) {
        const SharedTree tree{base + 4 * (p.tree_off[t] - u0)};
        const float v = walk<TILE, WIDE>(tree, p, x, stride, col);
        if (SPLIT) {
          vals[(t - t0) * E + ex] = v;
        } else {
          acc = __fadd_rn(acc, v);
        }
      }
    } else if (adds) {
      const GlobalTree tree{reinterpret_cast<const uint32_t*>(p.pack + u0)};
      const float v = walk<TILE, WIDE>(tree, p, x, stride, col);
      if (SPLIT) {
        vals[ex] = v;
      } else {
        acc = __fadd_rn(acc, v);
      }
    }
    if (SPLIT) {
      __syncthreads();  // the block's leaf values visible to warp 0
      if (adds) {
        for (int t = t0; t < t1; ++t) {
          acc = __fadd_rn(acc, vals[(t - t0) * E + ex]);
        }
      }
    }
    __syncthreads();  // buffer b & 1 (and the leaf values) free again
  }
  if (adds && e0 + ex < n) out[e0 + ex] = acc;
}

template <bool TILE, bool WIDE>
__global__ void __launch_bounds__(kThreads)
bank_walk_kernel(const float* __restrict__ xT, Packed p,
                 float* __restrict__ out, int n, int F, int num_blocks,
                 int vals_at, int bufs_at) {
  walk_blocks<false, TILE, WIDE>(xT, p, out, n, F, num_blocks, vals_at,
                                 bufs_at);
}

template <bool TILE, bool WIDE>
__global__ void __launch_bounds__(kThreads)
bank_split_kernel(const float* __restrict__ xT, Packed p,
                  float* __restrict__ out, int n, int F, int num_blocks,
                  int vals_at, int bufs_at) {
  walk_blocks<true, TILE, WIDE>(xT, p, out, n, F, num_blocks, vals_at,
                                bufs_at);
}

// A launch's shared memory: [tile F x E f32][leaf values, the split walk:
// block_trees x 32 f32][buffer 0][buffer 1], byte offsets and size.
struct Layout {
  int64_t vals, bufs, bytes;
};

Layout layout(bool split, bool tile, int64_t F, int64_t block_trees,
              int64_t buf_units) {
  const int64_t E = split ? kSplitExamples : kThreads;
  Layout l;
  l.vals = tile ? F * E * 4 : 0;
  l.bufs = l.vals + (split ? block_trees * E * 4 : 0);
  l.bytes = l.bufs + 2 * buf_units * 16;
  return l;
}

template <bool SPLIT, bool TILE, bool WIDE>
int launch(const float* xT, const Packed& p, float* out, int n, int F,
           int num_blocks, const Layout& l, cudaStream_t stream) {
  auto kernel = SPLIT ? bank_split_kernel<TILE, WIDE>
                      : bank_walk_kernel<TILE, WIDE>;
  // The attribute is a device's own: set once per instantiation, process
  // and device (bit d of attr_set: device d < 64).
  static unsigned long long attr_set = 0;
  int device = 0;
  const cudaError_t derr = cudaGetDevice(&device);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  const unsigned long long bit = 1ull << (device & 63);
  if (!(attr_set & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= bit;
  }
  constexpr int E = SPLIT ? kSplitExamples : kThreads;
  kernel<<<(n + E - 1) / E, kThreads, static_cast<int>(l.bytes), stream>>>(
      xT, p, out, n, F, num_blocks, static_cast<int>(l.vals),
      static_cast<int>(l.bufs));
  return static_cast<int>(cudaGetLastError());
}

template <bool SPLIT, bool WIDE>
int launch_fit(const float* xT, const Packed& p, float* out, int n, int F,
               int num_blocks, int block_trees, cudaStream_t stream) {
  // The examples' rows in a shared tile when it fits beside the rest.
  const Layout tiled = layout(SPLIT, true, F, block_trees, p.buf_units);
  if (tiled.bytes <= kSmemLimit) {
    return launch<SPLIT, true, WIDE>(xT, p, out, n, F, num_blocks, tiled,
                                     stream);
  }
  const Layout direct = layout(SPLIT, false, F, block_trees, p.buf_units);
  if (direct.bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  return launch<SPLIT, false, WIDE>(xT, p, out, n, F, num_blocks, direct,
                                    stream);
}

}  // namespace

// Packed tables as ydf_tpu_torch/serving/bank_scorer.py:pack_tables makes
// them: pack (16-byte units), tree_off [T+1] (16-byte units), block_tree
// [NB+1] (at most block_trees trees a block). F: the rows of xT the nodes
// read; wide: the record layout (narrow records use child_shift, wide
// walks stop after max_depth steps); buf_bytes: the largest staged tree
// block (a multiple of 16; a larger block is walked in global memory);
// split: the small batch walk.
extern "C" int ydf_bank_score(const void* xT, const void* pack,
                              const void* tree_off, const void* block_tree,
                              void* out, int n, int F, int num_blocks,
                              int block_trees, int num_words, int wide,
                              int child_shift, int max_depth, int buf_bytes,
                              int split, void* stream) {
  if (n <= 0) return 0;
  if (num_blocks < 1 || block_trees < 1 || buf_bytes % 16 != 0 ||
      (!wide && (child_shift < 3 || child_shift > 31))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Packed p{static_cast<const uint4*>(pack),
                 static_cast<const int32_t*>(tree_off),
                 static_cast<const int32_t*>(block_tree), buf_bytes / 16,
                 num_words, child_shift, max_depth};
  const float* x = static_cast<const float*>(xT);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bt = block_trees;
  if (split) {
    return wide ? launch_fit<true, true>(x, p, o, n, F, num_blocks, bt, s)
                : launch_fit<true, false>(x, p, o, n, F, num_blocks, bt, s);
  }
  return wide ? launch_fit<false, true>(x, p, o, n, F, num_blocks, bt, s)
              : launch_fit<false, false>(x, p, o, n, F, num_blocks, bt, s);
}
