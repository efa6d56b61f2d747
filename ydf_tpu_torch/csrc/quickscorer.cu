// QuickScorer leaf-bitmask scoring for Hopper (sm_90a).
//
// Replaces the TPU kernel ydf_tpu/serving/quickscorer.py:_qs_kernel.
// Called from ydf_tpu_torch/serving/quickscorer.py:score, which also holds
// the plain PyTorch version (score_plain) this kernel is tested against.
//
// What it computes, per example i (one thread each):
//   acc = 0
//   for tree t in 0..T-1, in order:
//     live = ~0 (64-bit survivor mask over the tree's leaves)
//     for condition c in [tree_offsets[t], tree_offsets[t+1]):
//       v = xT[feature[c], i]
//       triggered = categorical ? bit (int)v of bitmap[c] is NOT set
//                               : v >= thresh[c]
//       if triggered: live &= mask[c]
//     acc += leaf_values[t][lowest set bit of live]    (one f32 add)
//   out[i] = acc
// Trees are added in order, one f32 add each: bit-identical to the
// generic routed engine (ydf_tpu_torch/ops/routing.py).
//
// What bounds it on this card: integer/compare work. Every example
// evaluates every condition (C of them, about 63 per depth-6 tree), so the
// work is n * C compare-and-AND steps against n * F * 4 bytes of input;
// at the default GBT's widths it is far above the card's bytes-per-op
// balance. The TPU kernel's one-hot masked reductions (Mosaic has no
// vector gather) are gone: here they are plain indexed loads.
//
// What the simple design does about it: one thread per example keeps the
// 64-bit mask in registers; the condition arrays are the same for every
// thread of a warp, so their loads are broadcasts served by L1 (about
// 1 MB for 300 trees, well inside L2); the input is feature-major, so the
// warp's read of one feature row is one coalesced 128-byte line. Ragged
// last block: threads past n return. Faster designs (trees across lanes,
// conditions sorted by feature as in the QuickScorer paper) change the
// summation order and belong to a later change that states a tolerance.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;

__global__ void __launch_bounds__(kThreads)
qs_score_kernel(const float* __restrict__ xT,
                const int32_t* __restrict__ tree_offsets,
                const int32_t* __restrict__ cond_feature,
                const float* __restrict__ cond_thresh,
                const uint32_t* __restrict__ cond_mask_lo,
                const uint32_t* __restrict__ cond_mask_hi,
                const int32_t* __restrict__ cond_is_cat,
                const uint32_t* __restrict__ cond_bitmap,
                const float* __restrict__ leaf_values,
                float* __restrict__ out,
                int n, int num_trees, int num_words) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t stride = static_cast<size_t>(n);
  float acc = 0.0f;
  int c = tree_offsets[0];
  for (int t = 0; t < num_trees; ++t) {
    const int end = tree_offsets[t + 1];
    uint64_t live = ~0ull;
    for (; c < end; ++c) {
      const float v = xT[static_cast<size_t>(cond_feature[c]) * stride + i];
      bool trig;
      if (num_words > 0 && cond_is_cat[c]) {
        // The category code rides the float row. Only a code inside the
        // bitmap can hit a set bit; any other code triggers (goes right),
        // as in the TPU kernel's unroll over bitmap words.
        const int idx = static_cast<int>(v);
        const int w = idx >> 5;
        uint32_t bit = 0u;
        if (w >= 0 && w < num_words) {
          bit = (cond_bitmap[static_cast<size_t>(c) * num_words + w] >>
                 (idx & 31)) & 1u;
        }
        trig = bit == 0u;
      } else {
        trig = v >= cond_thresh[c];
      }
      if (trig) {
        live &= (static_cast<uint64_t>(cond_mask_hi[c]) << 32) |
                static_cast<uint64_t>(cond_mask_lo[c]);
      }
    }
    // No survivor cannot happen for a well-formed tree; it reads 0 like
    // the TPU kernel's empty one-hot.
    const float leaf_value =
        live ? leaf_values[t * kMaxLeaves +
                           (__ffsll(static_cast<long long>(live)) - 1)]
             : 0.0f;
    acc = __fadd_rn(acc, leaf_value);
  }
  out[i] = acc;
}

}  // namespace

extern "C" int ydf_qs_score(const void* xT, const void* tree_offsets,
                            const void* cond_feature, const void* cond_thresh,
                            const void* cond_mask_lo, const void* cond_mask_hi,
                            const void* cond_is_cat, const void* cond_bitmap,
                            const void* leaf_values, void* out, int n,
                            int num_trees, int num_words, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  qs_score_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xT), static_cast<const int32_t*>(tree_offsets),
      static_cast<const int32_t*>(cond_feature),
      static_cast<const float*>(cond_thresh),
      static_cast<const uint32_t*>(cond_mask_lo),
      static_cast<const uint32_t*>(cond_mask_hi),
      static_cast<const int32_t*>(cond_is_cat),
      static_cast<const uint32_t*>(cond_bitmap),
      static_cast<const float*>(leaf_values), static_cast<float*>(out), n,
      num_trees, num_words);
  return static_cast<int>(cudaGetLastError());
}
