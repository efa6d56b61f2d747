// Sums of runs of equal keys, each added in order from +0, one f32
// rounding an add, for Hopper (sm_90a): the set candidates' per-item sums
// (ydf_tpu_torch/ops/segment_sum.py, ops/grower.py:set_item_stats), which
// replay the order of XLA's CPU dot in the JAX package's einsum
// "nfv,nl,ns->lfvs" (ydf_tpu/ops/grower.py:810, the categorical-set
// block). It replaces that einsum; there is no Pallas kernel behind it.
//
//   out[i, s] = ((+0 + vals[i, s]) + vals[i + 1, s]) + ... over the run
//               of key[i] when i heads its run (i == 0 or key[i - 1] !=
//               key[i]), else +0.
//
// key is i64 [E], sorted so that every run is contiguous; vals and out
// are f32 [E, S] row-major. Each (run, stat) sum is one chain of
// __fadd_rn in the run's order: never split, reassociated or contracted
// (a split sum rounds otherwise, and the rounding picks the items' ranks
// on near ties), and no atomics. The build uses no fast-math flag, so
// NaN, infinities, signed zeros and subnormals go through the chain as
// they are.
//
// What bounds it on this card: the bytes, E * 8 + 2 * E * S * 4 (keys and
// values read once, sums written once) at 3.35 TB/s: 0.0179 ms at the
// set GBT's 1,876,297 entries and S = 3. The adds are E * S, far below
// any rate. What held the first version back was latency: one thread an
// entry, and each run's head walked its run alone through global memory,
// each load waiting on the last key compare, S passes a run, the warp
// idle around it. At the set RF's 208,355 entries the grid is about one
// wave, so a block's own latency (its copies, its longest chain, the run
// it carries past its tile) is the kernel's time;
// scripts/probe_segment_sum.py times each step of each block.
//
// The design:
//   * tiles in shared memory: a block of 256 threads stages a tile of T
//     entries (keys, then values) with 16-byte cp.async copies, all in
//     flight at once, plus the key before the tile (does its first entry
//     head a run?) and the key after it (does its last run go on?). T
//     comes from the wrapper (segment_sum.py:TILE and tile_entries, the
//     only place it is set): 1,024, faster than 2,048 at the three set
//     paths' shapes on an H100 (scripts/time_segment_sum.py); at S = 3 a
//     block takes 35,844 bytes of dynamic shared memory, so several
//     blocks share an SM and one block's copies overlap another's adds;
//   * the runs are found before they are walked: each entry's head flag,
//     a warp ballot ranking each warp's heads and a scan of the warps'
//     counts list the tile's heads in order, so a run's end is the next
//     head and no load waits on a key;
//   * one thread a (run, stat) chain: a run's S chains sit on neighbouring
//     lanes, each reading one column of the tile, 8 loads and then their
//     8 adds (one shared-memory latency per 8 adds). The run is read once
//     for all its stats;
//   * a run that crosses the tile's end belongs to the block that holds
//     its head. When the key after the tile equals the tile's last key,
//     the block stages the next 512 entries as soon as its heads are
//     listed (the copies fly while it walks its runs), counts the run's
//     entries among them, and S threads carry the head's chains on
//     through them, in order; a longer run goes on 512 entries a round.
//     A run is never split between blocks (the first call's runs have at
//     most 1,024 entries, the second call's ceil(n / 512)). Nine blocks
//     in ten carry one at the set paths' shapes;
//   * the sums overwrite their heads' values in shared memory, and the
//     tile goes back with 16-byte stores, zeros at the other entries:
//     every output entry is written, so `out` needs no fill.
// One launch a call; the grid is one block a tile.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCont = 512;  // entries a continuation chunk stages, at most
constexpr int kMaxTile = 4096;  // s_cnt holds a count a (256 entries, warp)
// Dynamic shared memory a block may take: the 227 KB a block may opt
// into, less 1 KB for the kernel's static shared variables.
constexpr int kSmemLimit = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of a block, C = min(kCont, T): keys i64 [T],
// values f32 [T * S], a continuation chunk's keys i64 [C] and values f32
// [C * S], the heads i32 [T + 1], the head flags u8 [T].
// ops/segment_sum.py:shared_bytes mirrors it. T % 4 == 0 keeps each
// array 16-byte aligned.
inline long long smem_bytes(int T, int S) {
  const long long C = T < kCont ? T : kCont;
  return 8LL * T + 4LL * T * S + 8LL * C + 4LL * C * S + 4LL * (T + 1) + T;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies n keys from key and n * S values from vals into shared memory:
// 16-byte cp.async copies when vec (the caller waits for them), the
// ragged end and the unaligned case one value at a time.
__device__ __forceinline__ void stage(int64_t* s_key, float* s_val,
                                      const int64_t* key, const float* vals,
                                      int n, int S, bool vec) {
  const int nv = n * S;
  int kc = 0, vc = 0;
  if (vec) {
    kc = n >> 1;
    vc = nv >> 2;
    for (int c = threadIdx.x; c < kc + vc; c += kThreads) {
      if (c < kc) {
        cp_async16(s_key + 2 * c, key + 2 * c);
      } else {
        cp_async16(s_val + 4 * (c - kc), vals + 4 * (c - kc));
      }
    }
  }
  for (int i = 2 * kc + threadIdx.x; i < n; i += kThreads) s_key[i] = key[i];
  for (int i = 4 * vc + threadIdx.x; i < nv; i += kThreads) {
    s_val[i] = vals[i];
  }
}

// acc + v[a] + v[a + 1] + ... + v[b - 1] (each `stride` floats apart),
// one __fadd_rn each, in order: 8 loads, then their 8 adds.
__device__ __forceinline__ float chain(float acc, const float* v, int stride,
                                       int a, int b) {
  int j = a;
  for (; j + 8 <= b; j += 8) {
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = v[(j + k) * stride];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = __fadd_rn(acc, x[k]);
  }
  for (; j < b; ++j) acc = __fadd_rn(acc, v[j * stride]);
  return acc;
}

// SC > 0: S == SC, known at compile time (the divisions by S are cheap);
// SC == 0: any S. vec: key, vals and out are 16-byte aligned (the 16-byte
// copies and stores); else every access is scalar.
template <int SC>
__global__ void __launch_bounds__(kThreads)
    run_sums(const int64_t* __restrict__ key, const float* __restrict__ vals,
             float* __restrict__ out, int E, int S_arg, int T, int vec) {
  const int S = SC > 0 ? SC : S_arg;
  const int C = T < kCont ? T : kCont;
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_key = reinterpret_cast<int64_t*>(smem);
  float* s_val = reinterpret_cast<float*>(s_key + T);
  int64_t* c_key = reinterpret_cast<int64_t*>(s_val + T * S);
  float* c_val = reinterpret_cast<float*>(c_key + C);
  int* s_head = reinterpret_cast<int*>(c_val + C * S);
  unsigned char* s_flag = reinterpret_cast<unsigned char*>(s_head + T + 1);
  __shared__ int s_cnt[kMaxTile / 32];
  __shared__ int s_total;
  __shared__ int64_t s_prev, s_next;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * T;
  const int n = static_cast<int>(E - t0 < T ? E - t0 : T);
  const int nv = n * S;
  const int64_t base = t0 * S;

  // 1. Stage the tile, and the keys on either side of it.
  stage(s_key, s_val, key + t0, vals + base, n, S, vec);
  if (tid == 0) {
    s_prev = t0 > 0 ? key[t0 - 1] : 0;
    s_next = t0 + n < E ? key[t0 + n] : 0;
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. Head flags and the heads in order: entry i = k * kThreads + tid;
  //    a warp ballot ranks a warp's heads, a scan of the (k, warp) counts
  //    gives their offsets.
  const int q = (n + kThreads - 1) / kThreads;
  for (int k = 0; k < q; ++k) {
    const int i = k * kThreads + tid;
    const bool f = i < n && (i > 0 ? s_key[i] != s_key[i - 1]
                                   : (t0 == 0 || s_prev != s_key[0]));
    if (i < n) s_flag[i] = f;
    const unsigned bal = __ballot_sync(kFull, f);
    if (lane == 0) s_cnt[k * kWarps + warp] = __popc(bal);
  }
  __syncthreads();
  if (warp == 0) {
    const int cells = q * kWarps, per = (cells + 31) / 32;
    const int lo = lane * per < cells ? lane * per : cells;
    const int hi = lo + per < cells ? lo + per : cells;
    int mine = 0;
    for (int j = lo; j < hi; ++j) mine += s_cnt[j];
    int incl = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - mine;
    for (int j = lo; j < hi; ++j) {
      const int c = s_cnt[j];
      s_cnt[j] = run;
      run += c;
    }
    if (lane == 31) s_total = incl;
  }
  __syncthreads();
  const int R = s_total;  // runs headed in the tile
  for (int k = 0; k < q; ++k) {
    const int i = k * kThreads + tid;
    const bool f = i < n && s_flag[i];
    const unsigned bal = __ballot_sync(kFull, f);
    const int rank = __popc(bal & ((1u << lane) - 1));
    if (f) s_head[s_cnt[k * kWarps + warp] + rank] = i;
  }
  if (tid == 0) s_head[R] = n;
  __syncthreads();

  // 3. The tile's last run goes on past its end (uniform over the block):
  //    stage the next chunk now, so that its copies fly during step 4.
  const int64_t last = s_key[n - 1];
  const bool carries = t0 + n < E && s_next == last;
  int64_t pos = t0 + n;
  if (carries) {
    stage(c_key, c_val, key + pos, vals + pos * S,
          static_cast<int>(E - pos < C ? E - pos : C), S, vec);
  }

  // 4. One thread a (run, stat) chain; the sum goes over the head's value
  //    once the chain is read (the run's other chains read other columns).
  for (int p = tid; p < R * S; p += kThreads) {
    const int r = p / S;
    const int s = p - r * S;
    const int a = s_head[r];
    s_val[a * S + s] = chain(0.0f, s_val + s, S, a, s_head[r + 1]);
  }

  // 5. Carry the last run's chains on past the tile, a chunk a round,
  //    until the key changes (when the tile heads that run).
  cp_async_wait_all();
  __syncthreads();
  if (carries && R > 0) {
    const int a = s_head[R - 1];
    for (;;) {
      // The run's entries in the chunk are a prefix of it: count them.
      const int len = static_cast<int>(E - pos < C ? E - pos : C);
      int m = 0;
      for (int k = 0; k < C; k += kThreads) {
        m += __syncthreads_count(k + tid < len && c_key[k + tid] == last);
      }
      for (int s = tid; s < S; s += kThreads) {
        s_val[a * S + s] = chain(s_val[a * S + s], c_val + s, S, 0, m);
      }
      pos += len;
      const bool done = m < len || pos >= E;
      __syncthreads();
      if (done) break;
      stage(c_key, c_val, key + pos, vals + pos * S,
            static_cast<int>(E - pos < C ? E - pos : C), S, vec);
      cp_async_wait_all();
      __syncthreads();
    }
  }

  // 6. Write the tile back: sums at heads, +0 elsewhere.
  const int vc = vec ? nv >> 2 : 0;
  float* dst = out + base;
  for (int d = tid; d < vc; d += kThreads) {
    float4 w = *reinterpret_cast<const float4*>(s_val + 4 * d);
    const int f = 4 * d;
    w.x = s_flag[f / S] ? w.x : 0.0f;
    w.y = s_flag[(f + 1) / S] ? w.y : 0.0f;
    w.z = s_flag[(f + 2) / S] ? w.z : 0.0f;
    w.w = s_flag[(f + 3) / S] ? w.w : 0.0f;
    *reinterpret_cast<float4*>(dst + f) = w;
  }
  for (int i = 4 * vc + tid; i < nv; i += kThreads) {
    dst[i] = s_flag[i / S] ? s_val[i] : 0.0f;
  }
}

template <int SC>
int launch(const int64_t* key, const float* vals, float* out, int E, int S,
           int T, int vec, cudaStream_t stream) {
  // The attribute is a device's own: set once per instantiation, process
  // and device (bit d of attr_set: device d < 64).
  static unsigned long long attr_set = 0;
  int device = 0;
  const cudaError_t derr = cudaGetDevice(&device);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  const unsigned long long bit = 1ull << (device & 63);
  if (!(attr_set & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        run_sums<SC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= bit;
  }
  const int blocks = static_cast<int>((static_cast<long long>(E) + T - 1) / T);
  run_sums<SC><<<blocks, kThreads, static_cast<int>(smem_bytes(T, S)),
                 stream>>>(key, vals, out, E, S, T, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// T: entries a tile (a multiple of 4, at most kMaxTile, whose shared
// memory fits a block; ops/segment_sum.py:tile_entries). Returns a cudaError_t as int (0 =
// launched).
extern "C" int ydf_segment_sums(const void* key, const void* vals, void* out,
                                int E, int S, int T, void* stream) {
  if (E <= 0 || S <= 0) return 0;
  if (T < 4 || T % 4 != 0 || T > kMaxTile || smem_bytes(T, S) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = ((reinterpret_cast<uintptr_t>(key) |
                    reinterpret_cast<uintptr_t>(vals) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const auto* k = static_cast<const int64_t*>(key);
  const auto* v = static_cast<const float*>(vals);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return launch<1>(k, v, o, E, S, T, vec, st);
    case 2: return launch<2>(k, v, o, E, S, T, vec, st);
    case 3: return launch<3>(k, v, o, E, S, T, vec, st);
    case 4: return launch<4>(k, v, o, E, S, T, vec, st);
    case 5: return launch<5>(k, v, o, E, S, T, vec, st);
    case 6: return launch<6>(k, v, o, E, S, T, vec, st);
    case 7: return launch<7>(k, v, o, E, S, T, vec, st);
    case 8: return launch<8>(k, v, o, E, S, T, vec, st);
    default: return launch<0>(k, v, o, E, S, T, vec, st);
  }
}
