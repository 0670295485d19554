// The key switch's RNS base conversions for Hopper (sm_90a), in u32
// lanes:
//   extend_centered   the mod-up of one prime per digit (alpha = 1): every
//                     coefficient digit, centred about its own prime,
//                     reduced onto each of kt primes
//   base_conv         the fast base conversion of hybrid key switching
//                     (alpha > 1): the mod-up of each digit of alpha
//                     primes onto the kt primes, and the mod-down's
//                     conversion of the K special primes onto the chain
//   mod_down_tail     the mod-down's tail: (acc - extn) * P^-1 mod q_j,
//                     with an optional addend folded in
//
// No TPU kernel stands behind them: the reference runs the alpha = 1
// conversions as XLA elementwise ops (repro/fhe/batched.py
// extend_centered and the end of mod_down_banks), and the port ran them
// as int64 PyTorch chains.  extend_centered and mod_down_tail copy that
// op sequence exactly (kernels/ref.py holds it), so the words are the
// same on every input the chains take; base_conv's words are the exact
// residues of its formula, as its plain version in kernels/ref.py
// computes them.
//
// What bounds extend_centered and the tail on an H100: device memory.  A
// mod-up reads a digit word once and writes kt words; the tail reads two
// words (three with the addend) and writes one.  The arithmetic is a few
// integer instructions a word.
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
//   * base_conv computes, for group g (a digit, or the K special primes)
//     of sources q_i with Q_g their product and each target p,
//       Conv(x)_p = sum_i [x_i (Q_g/q_i)^-1]_{q_i} (Q_g/q_i mod p) mod p,
//     the unsigned fast base conversion (Cheon, Han, Kim, Kim & Song, SAC
//     2018); a target that is one of the group's own sources is a copy of
//     that source row.  Each thread keeps the group's premultiplied words
//     in registers and sums the up to 16 products of two 30-bit residues
//     in a 64-bit accumulator (16 (2^30 - 1)^2 < 2^64), reduced once per
//     output word, so a multiply-add is one wide multiply-add.  At
//     alpha = 6 onto 30 primes a digit's coefficient takes 6 x 24 = 144
//     multiply-adds for 6 words read and 30 written: the first kernel of
//     the key switch whose arithmetic is on a par with its memory
//     traffic.  It writes the (kt, groups, per) stack the forward banks
//     read.  The mod-down's
//     K -> L + 1 conversion shares the kernel (one group): its output
//     must pass the forward NTT before the tail can subtract it, so it
//     cannot be fused into the tail.
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

constexpr int kMaxTargets = 512;  // base_conv targets: 42 KB of shared memory at A = 16

// x mod p for any u64 x, p < 2^30: the high word through the Shoup product
// by 2^32 mod p (r32, companion r32p), the low word through `reduce`.
__device__ __forceinline__ uint32_t reduce64(unsigned long long x, uint32_t p,
                                             uint32_t m, uint32_t r32,
                                             uint32_t r32p) {
  const uint32_t hi = (uint32_t)(x >> 32);
  uint32_t s = shoup_lazy(hi, r32, r32p, p) + reduce((uint32_t)x, p, m);  // < 3p
  s = s >= p ? s - p : s;
  return s >= p ? s - p : s;
}

// out[t, g, c] = Conv_g(x)[t] for every target t and coefficient c of
// group g = blockIdx.y, whose cnt[g] <= A sources are x's rows src[g, i]
// (moduli sq, premultipliers w / wp with Shoup companions); mat[g, t, i]
// = (Q_g / q_i) mod dst[t]; copy[g, t] >= 0 names the source slot that
// target t is.  grid.x strides over the per / V items of the group.
template <int A, int V>
__global__ void __launch_bounds__(kThreads)
base_conv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const int32_t* __restrict__ src, const uint32_t* __restrict__ sq,
                 const uint32_t* __restrict__ w, const uint32_t* __restrict__ wp,
                 const int32_t* __restrict__ cnt, const uint32_t* __restrict__ mat,
                 const int32_t* __restrict__ copy, const uint32_t* __restrict__ dst,
                 int groups, int kt, long long per) {
  extern __shared__ uint32_t sm[];  // p, m, r32, r32p, copy, then mat (kt x A)
  uint32_t* s_p = sm;
  uint32_t* s_m = sm + kt;
  uint32_t* s_r = sm + 2 * kt;
  uint32_t* s_rp = sm + 3 * kt;
  int32_t* s_copy = reinterpret_cast<int32_t*>(sm + 4 * kt);
  uint32_t* s_mat = sm + 5 * kt;
  const int g = blockIdx.y;
  for (int t = threadIdx.x; t < kt; t += blockDim.x) {
    const uint32_t p = dst[t];
    const uint32_t r = (uint32_t)((1ULL << 32) % p);
    s_p[t] = p;
    s_m[t] = 0xFFFFFFFFu / p;
    s_r[t] = r;
    s_rp[t] = (uint32_t)(((unsigned long long)r << 32) / p);
    s_copy[t] = copy[(long long)g * kt + t];
  }
  for (int j = threadIdx.x; j < kt * A; j += blockDim.x) {
    s_mat[j] = mat[(long long)g * kt * A + j];
  }
  __syncthreads();
  const int m = cnt[g];
  const unsigned items = (unsigned)(per / V);
  const long long plane = (long long)groups * per;
  out += (long long)g * per;
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < items;
       v += gridDim.x * kThreads) {
    uint32_t y[A][V];  // the premultiplied source words
#pragma unroll
    for (int i = 0; i < A; ++i) {
      if (i < m) {
        const int gi = g * A + i;
        const uint32_t* row = x + (long long)src[gi] * per;
        const uint32_t q = sq[gi], wi = w[gi], wpi = wp[gi];
        if constexpr (V == 4) {
          const uint4 a = reinterpret_cast<const uint4*>(row)[v];
          y[i][0] = shoup(a.x, wi, wpi, q), y[i][1] = shoup(a.y, wi, wpi, q);
          y[i][2] = shoup(a.z, wi, wpi, q), y[i][3] = shoup(a.w, wi, wpi, q);
        } else {
          y[i][0] = shoup(row[v], wi, wpi, q);
        }
      }
    }
    for (int t = 0; t < kt; ++t) {
      uint32_t r[V];
      const int c = s_copy[t];
      if (c >= 0) {  // one of the group's own primes: its row as it is
        const uint32_t* row = x + (long long)src[g * A + c] * per;
        if constexpr (V == 4) {
          const uint4 a = reinterpret_cast<const uint4*>(row)[v];
          r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
        } else {
          r[0] = row[v];
        }
      } else {
        unsigned long long acc[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0;
#pragma unroll
        for (int i = 0; i < A; ++i) {
          if (i < m) {
            const uint32_t mi = s_mat[t * A + i];
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] += (unsigned long long)y[i][e] * mi;
          }
        }
        const uint32_t p = s_p[t], pm = s_m[t], r32 = s_r[t], r32p = s_rp[t];
#pragma unroll
        for (int e = 0; e < V; ++e) r[e] = reduce64(acc[e], p, pm, r32, r32p);
      }
      if constexpr (V == 4) {
        reinterpret_cast<uint4*>(out + t * plane)[v] = make_uint4(r[0], r[1], r[2], r[3]);
      } else {
        out[t * plane + v] = r[0];
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

// x (R, per) contiguous; out (kt, groups, per) contiguous; src, sq, w, wp
// (groups, slots); cnt (groups,); mat (groups, kt, slots); copy (groups,
// kt); dst (kt,): uint32 / int32, checked by the Python wrapper but for
// the values (moduli below 2^30, 1 <= cnt <= slots, src rows below R,
// copy slots below cnt).  `slots`, the tables' stride a group, is the
// kernel's A: 4, 8 or 16 (the tables pad a group of fewer sources).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another
// `slots`, more than kMaxTargets targets, a group count past the grid's
// y limit or 2^31 words a row.
extern "C" int base_conv(const void* x, void* out, const void* src, const void* sq,
                         const void* w, const void* wp, const void* cnt,
                         const void* mat, const void* copy, const void* dst,
                         int groups, int slots, int kt, long long per, void* stream) {
  if (groups <= 0 || kt <= 0 || per <= 0) return (int)cudaGetLastError();
  if ((slots != 4 && slots != 8 && slots != 16) || kt > kMaxTargets || groups > 65535 ||
      per >= kMaxWords) {
    return (int)cudaErrorInvalidValue;
  }
  auto* s = static_cast<cudaStream_t>(stream);
  const bool vec = per % 4 == 0 && host::aligned16(x) && host::aligned16(out);
  const auto* a_x = static_cast<const uint32_t*>(x);
  auto* a_out = static_cast<uint32_t*>(out);
  const auto* a_src = static_cast<const int32_t*>(src);
  const auto* a_sq = static_cast<const uint32_t*>(sq);
  const auto* a_w = static_cast<const uint32_t*>(w);
  const auto* a_wp = static_cast<const uint32_t*>(wp);
  const auto* a_cnt = static_cast<const int32_t*>(cnt);
  const auto* a_mat = static_cast<const uint32_t*>(mat);
  const auto* a_copy = static_cast<const int32_t*>(copy);
  const auto* a_dst = static_cast<const uint32_t*>(dst);
#define LAUNCH(A, V)                                                              \
  base_conv_kernel<A, V><<<dim3(blocks_x(per / V), groups), kThreads,            \
                           (5 * kt + kt * A) * sizeof(uint32_t), s>>>(            \
      a_x, a_out, a_src, a_sq, a_w, a_wp, a_cnt, a_mat, a_copy, a_dst, groups, kt, per)
  if (slots == 4) {
    if (vec) LAUNCH(4, 4); else LAUNCH(4, 1);
  } else if (slots == 8) {
    if (vec) LAUNCH(8, 4); else LAUNCH(8, 1);
  } else {
    if (vec) LAUNCH(16, 4); else LAUNCH(16, 1);
  }
#undef LAUNCH
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
