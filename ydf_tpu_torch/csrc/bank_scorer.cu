// Data-bank forest scoring for Hopper (sm_90a): trees of any shape.
//
// Replaces the TPU kernel ydf_tpu/serving/pallas_scorer.py:_bank_kernel.
// Called from ydf_tpu_torch/serving/bank_scorer.py:score, which also holds
// the plain PyTorch version (score_plain) this kernel is tested against.
//
// What it computes, per example i (one thread each):
//   acc = 0
//   for tree t in 0..T-1, in order:
//     node = 0
//     up to max_depth times, stopping at a leaf:
//       v = xT[feature[t][node], i]
//       go_left = is_cat ? bit (c & 31) of mask[t][node][min(c >> 5, W-1)]
//                          with c = max((int)v, 0)
//                        : v < thresh[t][node]
//       node = go_left ? left : right
//     acc += leaf_value[t][node]                       (one f32 add)
//   out[i] = acc
// Stopping at a leaf equals the TPU kernel's self-loop; trees are added in
// order, one f32 add each: bit-identical to the generic routed engine.
//
// What bounds it on this card: dependent loads. Each step's node index
// comes from the previous step's load, so a thread's walk is a chain of
// L1/L2 round trips; the arithmetic per step is a handful of integer and
// compare operations. The TPU kernel's one-hot masked reductions over the
// padded node axis (Mosaic has no vector gather) are gone: here a node
// read is a plain indexed load.
//
// What the simple design does about it: one thread per example, many
// warps per SM to hide the latency of the chains; the node tables are in
// native types (int32 ids, f32 thresholds and values, u8 flags, u32 mask
// words; with 8 mask words about 1.4 MB for 50 depth-8 trees and 2 MB for
// 300 depth-6 trees, far inside the 50 MB L2), and a tree's nodes are
// contiguous, so the warp's walks of one
// tree share L1 lines. The input is feature-major. Ragged last block:
// threads past n return.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bank_score_kernel(const float* __restrict__ xT,
                  const int32_t* __restrict__ feature,
                  const float* __restrict__ thresh,
                  const int32_t* __restrict__ left,
                  const int32_t* __restrict__ right,
                  const float* __restrict__ leaf_value,
                  const uint8_t* __restrict__ is_cat,
                  const uint8_t* __restrict__ is_leaf,
                  const uint32_t* __restrict__ mask,
                  float* __restrict__ out,
                  int n, int num_trees, int num_nodes, int num_words,
                  int max_depth) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t stride = static_cast<size_t>(n);
  float acc = 0.0f;
  for (int t = 0; t < num_trees; ++t) {
    const size_t tree = static_cast<size_t>(t) * num_nodes;
    int node = 0;
    for (int d = 0; d < max_depth; ++d) {
      const size_t k = tree + node;
      if (is_leaf[k]) break;
      const float v = xT[static_cast<size_t>(feature[k]) * stride + i];
      bool go_left;
      if (is_cat[k]) {
        bool bit = false;
        if (num_words > 0) {
          const int c = max(static_cast<int>(v), 0);
          const int w = min(c >> 5, num_words - 1);
          bit = (mask[k * num_words + w] >> (c & 31)) & 1u;
        }
        go_left = bit;
      } else {
        go_left = v < thresh[k];
      }
      node = go_left ? left[k] : right[k];
    }
    acc = __fadd_rn(acc, leaf_value[tree + node]);
  }
  out[i] = acc;
}

}  // namespace

extern "C" int ydf_bank_score(const void* xT, const void* feature,
                              const void* thresh, const void* left,
                              const void* right, const void* leaf_value,
                              const void* is_cat, const void* is_leaf,
                              const void* mask, void* out, int n,
                              int num_trees, int num_nodes, int num_words,
                              int max_depth, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  bank_score_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xT), static_cast<const int32_t*>(feature),
      static_cast<const float*>(thresh), static_cast<const int32_t*>(left),
      static_cast<const int32_t*>(right),
      static_cast<const float*>(leaf_value),
      static_cast<const uint8_t*>(is_cat),
      static_cast<const uint8_t*>(is_leaf),
      static_cast<const uint32_t*>(mask), static_cast<float*>(out), n,
      num_trees, num_nodes, num_words, max_depth);
  return static_cast<int>(cudaGetLastError());
}
