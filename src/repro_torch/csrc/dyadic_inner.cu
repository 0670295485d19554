// Key-switch digit MAC for Hopper (sm_90a), for one key or two:
//   out_i[p, b, j] = sum_d ext[d, p, b, j] * evk_i[d, p, (b,) j]  mod q_p
// ML-DSA's products run here too, with one key and the 23-bit Barrett
// trait: Â ŷ with the matrix's k rows on the prime axis (ext stride 0
// there) and its l columns as digits, and ĉ times the key's 17 NTT rows
// as one digit; an ext shared by the primes takes a body of its own that
// reads it once for every prime row.
//
// Replaces the TPU kernel src/repro/kernels/dyadic_kernel.py
// dyadic_inner_banks (_inner_banks_kernel): the paper's Fig 22 MM/MA
// arrays, 32-bit Barrett products accumulated over every digit.  A key
// switch runs it with both key halves (evk_b, evk_a) in one launch.
//
// What bounds it on an H100: device memory.  Each output word reads d
// extension words and d key words per key and writes one word; the
// Barrett products are a few integer multiplies per byte read.  The least
// time is ext once, each key once and each output once over the card's
// memory rate.
//
// What this design does about it:
//   * Both keys in one launch: each extension word is read once for both
//     accumulators (two calls read the mod-up's output twice).
//   * ext, the keys and the outputs are read and written through their
//     (digit, prime, batch) strides; only the ring axis is unit-stride.
//     The key switch's ext is the (digit, prime, B, n) transpose of the
//     mod-up's (prime, digit, B, n) stack, read in place, and the outputs
//     may be the two halves of one (k, 2R, n) stack (the hoisted
//     rotations' mod-down input), so no copy is made on either side.
//   * A block owns one prime and a tile of 4 * kThreads ring words, one
//     16-byte vector a thread, and loops over a run of batch rows.  A key
//     shared by the batch (batch stride 0) with up to kMaxRegDigits
//     digits is loaded once into registers and reused for every row of
//     the run; a per-row key, or more digits, is read per row.  Re-reading
//     a shared key per row instead (from L1/L2) took 0.622-0.626 ms
//     against 0.548-0.551 at (4, 30, 32, 2^16) and 0.0918-0.0928 against
//     0.0757-0.0762 at (8, 9, 32, 2^14) on an H100 SXM (80 GB, 700 W).
//   * The batch splits into runs over more blocks only where the primes'
//     tiles would leave the SMs short (fig22's 9 primes at 2^14); the
//     split is read from the shapes and the kernel's residency.
//   * Block indices are decomposed once a block in 32-bit integers; no
//     per-word division.
// The lazy/eager accumulate order is the reference's exactly: lazy keeps
// products and the accumulator in [0, 2q) and reduces once at the end.
#include <cuda_runtime.h>

#include <cstdint>

#include "host.cuh"
#include "modarith.cuh"

using namespace modarith;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRegDigits = 8;  // digits of a shared key held in registers
constexpr int kMinRun = 4;        // least batch rows a block sharing registered keys
constexpr int kWaves = 4;         // blocks wanted: this many waves of resident blocks

// A strided operand: words between digits, primes and batch rows (a key
// shared by the batch has sb = 0; an output has no digit axis).
struct Plane {
  const uint32_t* p;
  long long sd, sp, sb;
};

struct Out {
  uint32_t* p;
  long long sp, sb;
};

struct Args {
  Plane ext, key[2];
  Out out[2];
  const uint32_t* qs;
  const uint32_t* mus;
  int d, n, b, tiles, splits, run;
  int lanes, rows;  // the shared-ext body: threads a ring row takes, rows side by side
};

template <int V>
__device__ __forceinline__ void load(const uint32_t* p, uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  } else {
    w[0] = __ldg(p);
  }
}

// ext is read once: a streaming load, so the keys keep their L2 lines
template <int V>
__device__ __forceinline__ void load_once(const uint32_t* p, uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  } else {
    w[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void store(uint32_t* p, const uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    p[0] = w[0];
  }
}

// acc of digit 0, then acc + e * key of each further digit, in the
// reference's order; B the moduli's Barrett trait (32 or 23)
template <bool kLazy, int B>
__device__ __forceinline__ uint32_t mac_first(uint32_t e, uint32_t key, uint32_t q,
                                              uint32_t mu) {
  return kLazy ? lane_barrett_lazy<B>(e, key, q, mu) : lane_barrett<B>(e, key, q, mu);
}

template <bool kLazy, int B>
__device__ __forceinline__ uint32_t mac_next(uint32_t acc, uint32_t e, uint32_t key,
                                             uint32_t q, uint32_t mu) {
  return kLazy ? lazy_add(acc, lane_barrett_lazy<B>(e, key, q, mu), q << 1)
               : add_mod(acc, lane_barrett<B>(e, key, q, mu), q);
}

template <bool kLazy>
__device__ __forceinline__ uint32_t finish(uint32_t acc, uint32_t q) {
  return kLazy && acc >= q ? acc - q : acc;
}

// V words a thread (4: one 16-byte vector), NK keys (1 or 2).  D > 0: the
// keys are shared by the batch and have D digits, held in registers;
// D == 0: a.d digits, each key read per row through its strides.  B: the
// Barrett trait of the moduli.
template <int V, int NK, bool kLazy, int D, int B>
__global__ void __launch_bounds__(kThreads)
dyadic_inner_banks_kernel(const Args a) {
  unsigned bid = blockIdx.x;
  const int split = bid % a.splits;
  bid /= a.splits;
  const int tile = bid % a.tiles;
  const int p = bid / a.tiles;
  const int j = (tile * kThreads + threadIdx.x) * V;
  if (j >= a.n) return;
  const uint32_t q = a.qs[p];
  const uint32_t mu = a.mus[p];
  const int b0 = split * a.run;
  const int b1 = min(a.b, b0 + a.run);
  const uint32_t* ext = a.ext.p + p * a.ext.sp + j;
  const uint32_t* key[NK];
  uint32_t* out[NK];
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    key[i] = a.key[i].p + p * a.key[i].sp + j;
    out[i] = a.out[i].p + p * a.out[i].sp + j;
  }
  if constexpr (D > 0) {
    uint32_t kw[NK][D][V];
#pragma unroll
    for (int i = 0; i < NK; ++i) {
#pragma unroll
      for (int dd = 0; dd < D; ++dd) load<V>(key[i] + dd * a.key[i].sd, kw[i][dd]);
    }
    for (int bb = b0; bb < b1; ++bb) {
      const uint32_t* e = ext + bb * a.ext.sb;
      uint32_t w[D][V];
#pragma unroll
      for (int dd = 0; dd < D; ++dd) load_once<V>(e + dd * a.ext.sd, w[dd]);
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        uint32_t acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[v] = mac_first<kLazy, B>(w[0][v], kw[i][0][v], q, mu);
#pragma unroll
          for (int dd = 1; dd < D; ++dd) {
            acc[v] = mac_next<kLazy, B>(acc[v], w[dd][v], kw[i][dd][v], q, mu);
          }
          acc[v] = finish<kLazy>(acc[v], q);
        }
        store<V>(out[i] + bb * a.out[i].sb, acc);
      }
    }
  } else {
    for (int bb = b0; bb < b1; ++bb) {
      const uint32_t* e = ext + bb * a.ext.sb;
      uint32_t acc[NK][V];
      for (int dd = 0; dd < a.d; ++dd) {
        uint32_t w[V];
        load_once<V>(e + dd * a.ext.sd, w);
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          uint32_t kv[V];
          load<V>(key[i] + dd * a.key[i].sd + bb * a.key[i].sb, kv);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[i][v] = dd == 0 ? mac_first<kLazy, B>(w[v], kv[v], q, mu)
                                : mac_next<kLazy, B>(acc[i][v], w[v], kv[v], q, mu);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NK; ++i) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[i][v] = finish<kLazy>(acc[i][v], q);
        store<V>(out[i] + bb * a.out[i].sb, acc[i]);
      }
    }
  }
}

// One ext row shared by every prime row (ext's prime stride 0: ML-DSA's ŷ
// under the matrix's k rows, ĉ under the key's 17), one key of D digits
// shared by the batch: a thread reads its ext words once a batch row and
// makes every prime row's output from them, the keys read through L1 (k D
// vectors, 30 KB of Â for every thread of a block).  The per-prime body
// would read ext once for each of the k rows.  A ring narrower than a
// block's tile (256 words: 64 threads of 4 words) runs kThreads / (n / 4)
// batch rows side by side, each on its own group of threads.
template <bool kLazy, int D, int B>
__global__ void __launch_bounds__(kThreads)
dyadic_inner_shared_ext_kernel(const Args a, int k) {
  constexpr int V = 4;
  const int split = blockIdx.x % a.splits;
  const int tile = blockIdx.x / a.splits;
  const int group = threadIdx.x / a.lanes;
  const int j = (tile * kThreads + threadIdx.x % a.lanes) * V;
  if (j >= a.n || group >= a.rows) return;
  const int b0 = split * a.run;
  const int b1 = min(a.b, b0 + a.run);
  const uint32_t* key = a.key[0].p + j;
  uint32_t* out = a.out[0].p + j;
  for (int bb = b0 + group; bb < b1; bb += a.rows) {
    const uint32_t* e = a.ext.p + j + bb * a.ext.sb;
    uint32_t w[D][V];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) load_once<V>(e + dd * a.ext.sd, w[dd]);
    for (int p = 0; p < k; ++p) {
      const uint32_t q = __ldg(a.qs + p), mu = __ldg(a.mus + p);
      const uint32_t* kp = key + p * a.key[0].sp;
      uint32_t kv[V], acc[V];
      load<V>(kp, kv);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = mac_first<kLazy, B>(w[0][v], kv[v], q, mu);
#pragma unroll
      for (int dd = 1; dd < D; ++dd) {
        load<V>(kp + dd * a.key[0].sd, kv);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = mac_next<kLazy, B>(acc[v], w[dd][v], kv[v], q, mu);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = finish<kLazy>(acc[v], q);
      store<V>(out + p * a.out[0].sp + bb * a.out[0].sb, acc);
    }
  }
}

// Sizes the grid of one instantiation and launches it: (prime, tile,
// run) blocks, the batch cut into runs only while the primes' tiles
// fall short of kWaves waves of resident blocks.
template <int V, int NK, bool kLazy, int D, int B>
int launch(Args a, int k, cudaStream_t s) {
  auto kernel = &dyadic_inner_banks_kernel<V, NK, kLazy, D, B>;
  static int cached_per_sm[host::kMaxDevices] = {};  // resident blocks a SM, once a card
  const int dev = host::current_device();
  int per_sm = host::kept(dev) ? cached_per_sm[dev] : 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                        kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm <= 0) per_sm = 1;
    if (host::kept(dev)) cached_per_sm[dev] = per_sm;
  }
  a.tiles = (a.n / V + kThreads - 1) / kThreads;
  const long long blocks = (long long)k * a.tiles;
  const long long want = (long long)kWaves * per_sm * host::sm_count();
  long long splits = blocks < want ? (want + blocks - 1) / blocks : 1;
  constexpr int min_run = D > 0 ? kMinRun : 1;  // a run reuses registered keys
  const long long most = (a.b + min_run - 1) / min_run;
  splits = splits < most ? splits : most;
  a.run = (int)((a.b + splits - 1) / splits);
  a.splits = (a.b + a.run - 1) / a.run;
  const long long grid = blocks * a.splits;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int V, int NK, bool kLazy>
int launch_digits(const Args& a, int k, bool cached, cudaStream_t s) {
  if constexpr (V == 4) {
    if (cached) {
      switch (a.d) {
#define CASE(D) \
  case D:       \
    return launch<V, NK, kLazy, D, 32>(a, k, s);
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
        default:
          break;
      }
    }
  }
  return launch<V, NK, kLazy, 0, 32>(a, k, s);
}

// The shared-ext body's grid: (tile, run) blocks, as many runs as kWaves
// waves of resident blocks want, each at least kMinRun rows a group.
template <bool kLazy, int D, int B>
int launch_shared_ext(Args a, int k, cudaStream_t s) {
  auto kernel = &dyadic_inner_shared_ext_kernel<kLazy, D, B>;
  static int cached_per_sm[host::kMaxDevices] = {};
  const int dev = host::current_device();
  int per_sm = host::kept(dev) ? cached_per_sm[dev] : 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                        kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm <= 0) per_sm = 1;
    if (host::kept(dev)) cached_per_sm[dev] = per_sm;
  }
  a.tiles = (a.n / 4 + kThreads - 1) / kThreads;
  a.lanes = a.tiles == 1 ? a.n / 4 : kThreads;
  a.rows = kThreads / a.lanes;
  const long long want = (long long)kWaves * per_sm * host::sm_count();
  long long splits = (want + a.tiles - 1) / a.tiles;
  const long long most = (a.b + kMinRun * a.rows - 1) / (kMinRun * a.rows);
  splits = splits < most ? splits : most;
  a.run = (int)((a.b + splits - 1) / splits);
  a.splits = (a.b + a.run - 1) / a.run;
  const long long grid = (long long)a.tiles * a.splits;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreads, 0, s>>>(a, k);
  return (int)cudaGetLastError();
}

bool vec_ok(const void* p, long long s0, long long s1, long long s2) {
  return host::aligned16(p) && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0;
}

}  // namespace

// ext: (d, k, b, n) with (digit, prime, batch) strides ext_s*; key0 and
// key1 (null for one key): (d, k, [b,] n) with strides k*_s* (batch stride
// 0 for a key shared by the batch); out0 and out1 (null for one key):
// (k, b, n) with (prime, batch) strides o*_s*; qs, mus (k,).  Every ring
// axis unit-stride.  All uint32 (int32 bit patterns), checked by the
// Python wrapper.  barrett: the moduli's Barrett trait, 32 (the RNS
// window) or 23 (ML-DSA's products: one key, 16-byte loads).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for shapes past the grid,
// another trait or a layout the 23-bit trait does not take.
extern "C" int dyadic_inner_banks(
    const void* ext, long long ext_sd, long long ext_sp, long long ext_sb,
    const void* key0, long long k0_sd, long long k0_sp, long long k0_sb,
    const void* key1, long long k1_sd, long long k1_sp, long long k1_sb,
    void* out0, long long o0_sp, long long o0_sb, void* out1, long long o1_sp,
    long long o1_sb, const void* qs, const void* mus, int d, int k, int b, int n,
    int lazy, int barrett, void* stream) {
  if (d <= 0 || k <= 0 || b <= 0 || n <= 0) return (int)cudaGetLastError();
  const int nk = key1 != nullptr ? 2 : 1;
  Args a{};
  a.ext = {static_cast<const uint32_t*>(ext), ext_sd, ext_sp, ext_sb};
  a.key[0] = {static_cast<const uint32_t*>(key0), k0_sd, k0_sp, k0_sb};
  a.key[1] = {static_cast<const uint32_t*>(key1), k1_sd, k1_sp, k1_sb};
  a.out[0] = {static_cast<uint32_t*>(out0), o0_sp, o0_sb};
  a.out[1] = {static_cast<uint32_t*>(out1), o1_sp, o1_sb};
  a.qs = static_cast<const uint32_t*>(qs);
  a.mus = static_cast<const uint32_t*>(mus);
  a.d = d, a.n = n, a.b = b;
  bool vec = n % 4 == 0 && vec_ok(ext, ext_sd, ext_sp, ext_sb);
  bool shared = true;
  for (int i = 0; i < nk; ++i) {
    vec = vec && vec_ok(a.key[i].p, a.key[i].sd, a.key[i].sp, a.key[i].sb) &&
          vec_ok(a.out[i].p, a.out[i].sp, a.out[i].sb, 0);
    shared = shared && a.key[i].sb == 0;
  }
  const bool cached = vec && shared && d <= kMaxRegDigits;
  auto* s = static_cast<cudaStream_t>(stream);
  if (barrett == 23) {
    // ML-DSA's three layouts, and no other: Â ŷ (5 digits) and ĉ times the
    // key's rows (1 digit) on an ext shared by the prime rows, and
    // keygen's per-row keys on the per-row body.
    if (nk != 1 || !vec) return (int)cudaErrorInvalidValue;
    if (cached && k > 1 && a.ext.sp == 0 && (d == 1 || d == 5)) {
      if (d == 1) return lazy ? launch_shared_ext<true, 1, 23>(a, k, s)
                              : launch_shared_ext<false, 1, 23>(a, k, s);
      return lazy ? launch_shared_ext<true, 5, 23>(a, k, s)
                  : launch_shared_ext<false, 5, 23>(a, k, s);
    }
    return lazy ? launch<4, 1, true, 0, 23>(a, k, s) : launch<4, 1, false, 0, 23>(a, k, s);
  }
  if (barrett != 32) return (int)cudaErrorInvalidValue;
#define LAUNCH(V)                                                         \
  (nk == 2 ? (lazy ? launch_digits<V, 2, true>(a, k, cached, s)           \
                   : launch_digits<V, 2, false>(a, k, cached, s))         \
           : (lazy ? launch_digits<V, 1, true>(a, k, cached, s)           \
                   : launch_digits<V, 1, false>(a, k, cached, s)))
  return vec ? LAUNCH(4) : LAUNCH(1);
#undef LAUNCH
}
