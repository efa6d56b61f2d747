// Host helpers of ops/mhld.py (no card), built at first use with g++:
//   ydf_fma_chain: the one sequential fused multiply-add chain XLA's CPU
//     dot runs for a vector-matrix product w [n] . x [n, F] (jax 0.9.0):
//     out[j] = fma(w[n-1], x[n-1][j], ... fma(w[0], x[0][j], 0)).
//   ydf_or_mxcsr: sets the given bits in this thread's x86 MXCSR and
//     returns the old value; ydf_set_mxcsr writes a value read so back.
//     The solves set flush-to-zero and denormals-are-zero around the
//     LAPACK calls, as XLA's CPU runtime does around its own (elsewhere
//     both are no-ops returning 0). No other bit changes: the exception
//     masks stay as they were.
#include <cmath>
#include <cstdint>
#if defined(__x86_64__) || defined(__i386__)
#include <xmmintrin.h>
#endif

// The chain for each output in row order; built twice on x86, the
// second with the FMA instructions (one rounding a step either way, so
// the same bits) and taken when the CPU has them.
#define YDF_FMA_CHAIN_BODY                                              \
  for (int32_t j = 0; j < F; ++j) out[j] = 0.0f;                        \
  for (int64_t r = 0; r < n; ++r) {                                     \
    const float wr = w[r];                                              \
    const float* row = x + r * F;                                       \
    for (int32_t j = 0; j < F; ++j) out[j] = std::fma(wr, row[j], out[j]); \
  }

static void fma_chain_plain(const float* w, const float* x, int64_t n,
                            int32_t F, float* out) {
  YDF_FMA_CHAIN_BODY
}

#if defined(__x86_64__)
__attribute__((target("avx2,fma"))) static void fma_chain_fma(
    const float* w, const float* x, int64_t n, int32_t F, float* out) {
  YDF_FMA_CHAIN_BODY
}
#endif

extern "C" void ydf_fma_chain(const float* w, const float* x, int64_t n,
                              int32_t F, float* out) {
#if defined(__x86_64__)
  if (__builtin_cpu_supports("fma") && __builtin_cpu_supports("avx2")) {
    fma_chain_fma(w, x, n, F, out);
    return;
  }
#endif
  fma_chain_plain(w, x, n, F, out);
}

extern "C" uint32_t ydf_or_mxcsr(uint32_t bits) {
#if defined(__x86_64__) || defined(__i386__)
  const uint32_t old = _mm_getcsr();
  _mm_setcsr(old | bits);
  return old;
#else
  (void)bits;
  return 0;
#endif
}

extern "C" void ydf_set_mxcsr(uint32_t value) {
#if defined(__x86_64__) || defined(__i386__)
  _mm_setcsr(value);
#else
  (void)value;
#endif
}
