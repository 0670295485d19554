// The key switch's two RNS base conversions for Hopper (sm_90a), in u32
// lanes:
//   extend_centered   the mod-up: every coefficient digit, centred about
//                     its own prime, reduced onto each of kt primes
//   mod_down_tail     the mod-down's tail: (acc - extn) * P^-1 mod q_j,
//                     with an optional addend folded in
//
// No TPU kernel stands behind them: the reference runs both as XLA
// elementwise ops (repro/fhe/batched.py extend_centered and the end of
// mod_down_banks), and the port ran them as int64 PyTorch chains.  Each
// kernel copies that op sequence exactly (kernels/ref.py holds it), so
// the words are the same on every input the chains take.
//
// What bounds them on an H100: device memory.  A mod-up reads a digit
// word once and writes kt words; the tail reads two words (three with
// the addend) and writes one.  The arithmetic is a few integer
// instructions a word.
//
// What this design does about it: one thread per 16-byte vector of four
// coefficients (one per word where a row is not a multiple of four words
// or a pointer or stride is not 16-byte aligned), a grid row per digit or
// per prime so its moduli and constants sit in registers, and no int64
// temporaries: each input crosses memory once and each output once, in
// the layout its consumer reads.
//   * extend_centered writes straight into the (kt, d, B, n) stack the
//     forward banks transform (the digit axis folded into the batch).
//     The centred value c - q_src, negative or not, is reduced as
//     torch.remainder does (the result takes the sign of the divisor):
//     its magnitude is reduced by a Barrett factor floor((2^32 - 1) / q)
//     and a negative one is mirrored to q - r.  That holds for any int32
//     input and any moduli below 2^31, also where q_src / 2 exceeds a
//     destination prime.
//   * mod_down_tail reads acc, extn and the addend through (prime, batch)
//     strides and writes the (k, B, n) or the batch-leading (B, k, n)
//     layout, so a transposed stack needs no copy on either side.  The
//     addend covers the first `badd` batch columns (the hoisted rotations
//     add c0 to the first R of their 2R halves).
#include <cuda_runtime.h>

#include <cstdint>

#include "host.cuh"
#include "modarith.cuh"

using namespace modarith;

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 132 * 8;  // 2048 threads on each SM per grid row
constexpr int kMaxDst = 6144;               // destination moduli: 48 KB of shared memory
constexpr long long kMaxWords = 1LL << 31;  // words a grid row: 32-bit item indices

// |c| mod q for any |c| < 2^32 and 1 <= q < 2^31: m = floor((2^32 - 1) / q)
// puts the quotient estimate at most one below the true one.
__device__ __forceinline__ uint32_t reduce(uint32_t a, uint32_t q, uint32_t m) {
  const uint32_t r = a - __umulhi(a, m) * q;
  return r >= q ? r - q : r;
}

// The (kt, d, per) output of d digits of `per` words: grid.y is the
// digit, grid.x strides over its items of V words.
template <int V>
__global__ void __launch_bounds__(kThreads)
extend_centered_kernel(const uint32_t* __restrict__ ci, uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ src_qs,
                       const uint32_t* __restrict__ dst_qs, int d, int kt,
                       long long per) {
  extern __shared__ uint32_t dst[];  // kt moduli, then their Barrett factors
  for (int j = threadIdx.x; j < kt; j += blockDim.x) {
    const uint32_t q = dst_qs[j];
    dst[j] = q;
    dst[kt + j] = 0xFFFFFFFFu / q;
  }
  __syncthreads();
  const int i = blockIdx.y;
  const long long sq = src_qs[i];
  const long long half = sq >> 1;
  ci += i * per;
  out += i * per;
  const long long plane = (long long)d * per;
  const unsigned items = (unsigned)(per / V);
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < items;
       v += gridDim.x * kThreads) {
    uint32_t w[V];
    if constexpr (V == 4) {
      const uint4 a = reinterpret_cast<const uint4*>(ci)[v];
      w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    } else {
      w[0] = ci[v];
    }
    uint32_t mag[V];
    bool neg[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      long long c = (int32_t)w[e];  // torch reads the int32 as signed
      if (c > half) c -= sq;
      neg[e] = c < 0;
      mag[e] = (uint32_t)(neg[e] ? -c : c);
    }
    for (int j = 0; j < kt; ++j) {
      const uint32_t q = dst[j];
      const uint32_t m = dst[kt + j];
      uint32_t r[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const uint32_t x = reduce(mag[e], q, m);
        r[e] = neg[e] && x != 0 ? q - x : x;
      }
      if constexpr (V == 4) {
        reinterpret_cast<uint4*>(out + j * plane)[v] = make_uint4(r[0], r[1], r[2], r[3]);
      } else {
        out[j * plane + v] = r[0];
      }
    }
  }
}

struct Strides {
  long long j, b;  // words between primes and between batch columns
};

// out[j, c] = shoup(sub_mod(acc[j, c], extn[j, c]), pinv[j]) (+ add[j, c]
// for c < badd), c = (batch, word).  grid.y is the prime j; grid.x strides
// over its b * n / V items.
template <int V, bool kAdd>
__global__ void __launch_bounds__(kThreads)
mod_down_tail_kernel(const uint32_t* __restrict__ acc, Strides sa,
                     const uint32_t* __restrict__ extn, Strides se,
                     const uint32_t* __restrict__ add, Strides sd, unsigned badd,
                     uint32_t* __restrict__ out, Strides so,
                     const uint32_t* __restrict__ qs,
                     const uint32_t* __restrict__ pinv,
                     const uint32_t* __restrict__ pinv_p, long long b, int n) {
  const int j = blockIdx.y;
  const uint32_t q = qs[j];
  const uint32_t w = pinv[j];
  const uint32_t wp = pinv_p[j];
  acc += j * sa.j;
  extn += j * se.j;
  out += j * so.j;
  if (kAdd) add += j * sd.j;
  const unsigned nv = (unsigned)(n / V);
  const unsigned items = (unsigned)b * nv;
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < items;
       v += gridDim.x * kThreads) {
    const unsigned bb = v / nv;
    const unsigned col = (v - bb * nv) * V;
    uint32_t x[V], y[V], r[V];
    if constexpr (V == 4) {
      const uint4 a = *reinterpret_cast<const uint4*>(acc + bb * sa.b + col);
      const uint4 e = *reinterpret_cast<const uint4*>(extn + bb * se.b + col);
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      y[0] = e.x, y[1] = e.y, y[2] = e.z, y[3] = e.w;
    } else {
      x[0] = acc[bb * sa.b + col];
      y[0] = extn[bb * se.b + col];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) r[e] = shoup(sub_mod(x[e], y[e], q), w, wp, q);
    if (kAdd && bb < badd) {
      if constexpr (V == 4) {
        const uint4 s = *reinterpret_cast<const uint4*>(add + bb * sd.b + col);
        r[0] = add_mod(s.x, r[0], q), r[1] = add_mod(s.y, r[1], q);
        r[2] = add_mod(s.z, r[2], q), r[3] = add_mod(s.w, r[3], q);
      } else {
        r[0] = add_mod(add[bb * sd.b + col], r[0], q);
      }
    }
    if constexpr (V == 4) {
      *reinterpret_cast<uint4*>(out + bb * so.b + col) = make_uint4(r[0], r[1], r[2], r[3]);
    } else {
      out[bb * so.b + col] = r[0];
    }
  }
}

unsigned blocks_x(long long items) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocksX ? blocks : kMaxBlocksX);
}

bool vec_ok(const void* p, Strides s) {
  return host::aligned16(p) && s.j % 4 == 0 && s.b % 4 == 0;
}

}  // namespace

// ci (d, per) contiguous; out (kt, d, per) contiguous; src_qs (d,),
// dst_qs (kt,): uint32 (int32 bit patterns), moduli in [1, 2^31), checked
// by the Python wrapper but for the moduli's values.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for more than kMaxDst
// destination moduli, a digit count past the grid's y limit or 2^31
// words a digit.
extern "C" int extend_centered(const void* ci, void* out, const void* src_qs,
                               const void* dst_qs, int d, int kt, long long per,
                               void* stream) {
  if (d <= 0 || kt <= 0 || per <= 0) return (int)cudaGetLastError();
  if (kt > kMaxDst || d > 65535 || per >= kMaxWords) return (int)cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * sizeof(uint32_t) * kt;
  const auto* a_ci = static_cast<const uint32_t*>(ci);
  auto* a_out = static_cast<uint32_t*>(out);
  const auto* a_src = static_cast<const uint32_t*>(src_qs);
  const auto* a_dst = static_cast<const uint32_t*>(dst_qs);
  if (per % 4 == 0 && host::aligned16(ci) && host::aligned16(out)) {
    const dim3 grid(blocks_x(per / 4), d);
    extend_centered_kernel<4><<<grid, kThreads, smem, s>>>(a_ci, a_out, a_src, a_dst,
                                                          d, kt, per);
  } else {
    const dim3 grid(blocks_x(per), d);
    extend_centered_kernel<1><<<grid, kThreads, smem, s>>>(a_ci, a_out, a_src, a_dst,
                                                          d, kt, per);
  }
  return (int)cudaGetLastError();
}

// acc, extn, out: (k, b, n) views with unit stride along n and the given
// (prime, batch) strides in words; add: null, or the first badd batch
// columns of out's layout with its own strides.  qs, pinv, pinv_p (k,).
// All uint32 (int32 bit patterns), checked by the Python wrapper.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for more than
// 65535 primes or 2^31 words a prime.
extern "C" int mod_down_tail(const void* acc, long long acc_sj, long long acc_sb,
                             const void* extn, long long extn_sj, long long extn_sb,
                             const void* add, long long add_sj, long long add_sb,
                             long long badd, void* out, long long out_sj,
                             long long out_sb, const void* qs, const void* pinv,
                             const void* pinv_p, int k, long long b, int n,
                             void* stream) {
  if (k <= 0 || b <= 0 || n <= 0) return (int)cudaGetLastError();
  if (k > 65535 || b * n >= kMaxWords) return (int)cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  const Strides sa{acc_sj, acc_sb}, se{extn_sj, extn_sb}, sd{add_sj, add_sb},
      so{out_sj, out_sb};
  const bool with_add = add != nullptr && badd > 0;
  const bool vec = n % 4 == 0 && vec_ok(acc, sa) && vec_ok(extn, se) &&
                   vec_ok(out, so) && (!with_add || vec_ok(add, sd));
  const auto* a_acc = static_cast<const uint32_t*>(acc);
  const auto* a_extn = static_cast<const uint32_t*>(extn);
  const auto* a_add = static_cast<const uint32_t*>(add);
  auto* a_out = static_cast<uint32_t*>(out);
  const auto* a_qs = static_cast<const uint32_t*>(qs);
  const auto* a_pinv = static_cast<const uint32_t*>(pinv);
  const auto* a_pinvp = static_cast<const uint32_t*>(pinv_p);
#define LAUNCH(V, A)                                                          \
  mod_down_tail_kernel<V, A><<<dim3(blocks_x(b * n / V), k), kThreads, 0, s>>>( \
      a_acc, sa, a_extn, se, a_add, sd, badd, a_out, so, a_qs, a_pinv,        \
      a_pinvp, b, n)
  if (vec) {
    if (with_add) LAUNCH(4, true); else LAUNCH(4, false);
  } else {
    if (with_add) LAUNCH(1, true); else LAUNCH(1, false);
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
