// Multi-prime NTT banks for Hopper (sm_90a): forward and inverse
// constant-geometry transforms and the per-prime weight-row multiply.
//
// Replaces the TPU kernels of src/repro/kernels/ntt_kernel.py:
//   ntt_fwd_banks      <- ntt_fwd_banks_pallas     (_ntt_fwd_banks_kernel)
//   ntt_inv_banks      <- ntt_inv_banks_pallas     (_ntt_inv_banks_kernel)
//   twiddle_mul_banks  <- twiddle_mul_banks_pallas (_twiddle_mul_banks_kernel)
//
// What bounds them on an H100: device memory.  A transform reads each
// word once and writes it once (8 bytes per word) and does ~log2(n)
// butterflies on it in between; the weight-row multiply reads the word
// and its two weights and writes one word.  The least time is those
// bytes over the card's memory rate.
//
// What this simple design does about it: each block stages its rows in a
// shared-memory ping-pong pair and runs every stage there, so a word
// crosses device memory exactly twice however many stages the transform
// has (the paper's SRM ping-pong banks).  Stage t's twiddle row
// tw/twp[p, t, :] is copied to shared memory once per block when the
// prime's whole table fits in 16 KB (n <= 256: 3.5 KB at n = 128);
// larger tables are read from device memory (they stay in L1/L2, shared
// by every block of the prime).  The TPU kernel kept all twiddle rows
// resident in VMEM, which does not fit a block's shared memory at
// n = 4096.  Loads and stores of the row tiles are coalesced; the
// interleaved (u, v) writes of the forward stage cost a 2-way bank
// conflict, left for a later change.
//
// The constant-geometry layout is kept exactly: a forward stage reads
// lo = x[:n/2], hi = x[n/2:] and writes interleaved (u, v) pairs; an
// inverse stage reads interleaved pairs and writes [u | v].
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

using namespace modarith;

namespace {

constexpr int kThreads = 256;
constexpr int kTileWords = 4096;     // words in each ping-pong buffer
constexpr int kTwiddleWords = 4096;  // tw + twp words that may go to smem

template <bool kLazy>
__global__ void __launch_bounds__(kThreads)
ntt_fwd_banks_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ qs,
                     const uint32_t* __restrict__ tw,
                     const uint32_t* __restrict__ twp,
                     const uint32_t* __restrict__ psi,
                     const uint32_t* __restrict__ psip, int b, int n, int log_n,
                     int stages, int rows, bool negacyclic, bool reduce_out,
                     bool tw_smem) {
  extern __shared__ uint32_t smem[];
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, b - row0);
  const int h = n >> 1;
  const int words = nrows * n;
  const int half_words = nrows * h;
  const uint32_t q = qs[p];
  const uint32_t q2 = q << 1;

  uint32_t* a = smem;
  uint32_t* c = smem + rows * n;
  const uint32_t* tw_p = tw + (size_t)p * stages * h;
  const uint32_t* twp_p = twp + (size_t)p * stages * h;
  if (tw_smem) {
    uint32_t* s_tw = smem + 2 * rows * n;
    for (int i = threadIdx.x; i < stages * h; i += blockDim.x) {
      s_tw[i] = tw_p[i];
      s_tw[stages * h + i] = twp_p[i];
    }
    tw_p = s_tw;
    twp_p = s_tw + stages * h;
  }

  const uint32_t* src = x + ((size_t)p * b + row0) * n;
  const uint32_t* psi_p = psi + (size_t)p * n;
  const uint32_t* psip_p = psip + (size_t)p * n;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    uint32_t v = src[i];
    if (negacyclic) {
      const int j = i & (n - 1);
      v = kLazy ? shoup_lazy(v, psi_p[j], psip_p[j], q)
                : shoup(v, psi_p[j], psip_p[j], q);
    }
    a[i] = v;
  }
  __syncthreads();

  for (int t = 0; t < stages; ++t) {
    const uint32_t* wrow = tw_p + t * h;
    const uint32_t* wprow = twp_p + t * h;
    for (int i = threadIdx.x; i < half_words; i += blockDim.x) {
      const int r = i >> (log_n - 1);
      const int j = i & (h - 1);
      const uint32_t lo = a[r * n + j];
      const uint32_t hi = a[r * n + j + h];
      const uint32_t w = wrow[j];
      const uint32_t wp = wprow[j];
      uint32_t u, v;
      if (kLazy) {
        const uint32_t tt = shoup_lazy(hi, w, wp, q);
        u = lazy_add(lo, tt, q2);
        v = lazy_sub(lo, tt, q2);
      } else {
        const uint32_t tt = shoup(hi, w, wp, q);
        u = add_mod(lo, tt, q);
        v = sub_mod(lo, tt, q);
      }
      c[r * n + 2 * j] = u;
      c[r * n + 2 * j + 1] = v;
    }
    __syncthreads();
    uint32_t* tmp = a;
    a = c;
    c = tmp;
  }

  uint32_t* dst = out + ((size_t)p * b + row0) * n;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    uint32_t v = a[i];
    if (kLazy && reduce_out) v = v >= q ? v - q : v;
    dst[i] = v;
  }
}

template <bool kLazy>
__global__ void __launch_bounds__(kThreads)
ntt_inv_banks_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ qs,
                     const uint32_t* __restrict__ ninv,
                     const uint32_t* __restrict__ ninv_p,
                     const uint32_t* __restrict__ itw,
                     const uint32_t* __restrict__ itwp,
                     const uint32_t* __restrict__ post,
                     const uint32_t* __restrict__ postp, int b, int n, int log_n,
                     int stages, int rows, bool negacyclic, bool reduce_out,
                     bool tw_smem) {
  extern __shared__ uint32_t smem[];
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, b - row0);
  const int h = n >> 1;
  const int words = nrows * n;
  const int half_words = nrows * h;
  const uint32_t q = qs[p];
  const uint32_t q2 = q << 1;

  uint32_t* a = smem;
  uint32_t* c = smem + rows * n;
  const uint32_t* tw_p = itw + (size_t)p * stages * h;
  const uint32_t* twp_p = itwp + (size_t)p * stages * h;
  if (tw_smem) {
    uint32_t* s_tw = smem + 2 * rows * n;
    for (int i = threadIdx.x; i < stages * h; i += blockDim.x) {
      s_tw[i] = tw_p[i];
      s_tw[stages * h + i] = twp_p[i];
    }
    tw_p = s_tw;
    twp_p = s_tw + stages * h;
  }

  const uint32_t* src = x + ((size_t)p * b + row0) * n;
  for (int i = threadIdx.x; i < words; i += blockDim.x) a[i] = src[i];
  __syncthreads();

  for (int t = stages - 1; t >= 0; --t) {
    const uint32_t* wrow = tw_p + t * h;
    const uint32_t* wprow = twp_p + t * h;
    for (int i = threadIdx.x; i < half_words; i += blockDim.x) {
      const int r = i >> (log_n - 1);
      const int j = i & (h - 1);
      const uint32_t e = a[r * n + 2 * j];
      const uint32_t o = a[r * n + 2 * j + 1];
      const uint32_t w = wrow[j];
      const uint32_t wp = wprow[j];
      uint32_t u, v;
      if (kLazy) {
        u = lazy_add(e, o, q2);
        v = shoup_lazy(lazy_sub(e, o, q2), w, wp, q);
      } else {
        u = add_mod(e, o, q);
        v = shoup(sub_mod(e, o, q), w, wp, q);
      }
      c[r * n + j] = u;
      c[r * n + j + h] = v;
    }
    __syncthreads();
    uint32_t* tmp = a;
    a = c;
    c = tmp;
  }

  // epilogue: psi^-i * n^-1 row (negacyclic) or the n^-1 scalar; the
  // multiply reduces fully unless a lazy consumer asked for [0, 2q)
  uint32_t* dst = out + ((size_t)p * b + row0) * n;
  const uint32_t* post_p = post + (size_t)p * n;
  const uint32_t* postp_p = postp + (size_t)p * n;
  const uint32_t nv = ninv[p];
  const uint32_t nvp = ninv_p[p];
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int j = i & (n - 1);
    const uint32_t w = negacyclic ? post_p[j] : nv;
    const uint32_t wp = negacyclic ? postp_p[j] : nvp;
    dst[i] = (kLazy && !reduce_out) ? shoup_lazy(a[i], w, wp, q)
                                    : shoup(a[i], w, wp, q);
  }
}

template <bool kLazy>
__global__ void __launch_bounds__(kThreads)
twiddle_mul_banks_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                         const uint32_t* __restrict__ qs,
                         const uint32_t* __restrict__ w,
                         const uint32_t* __restrict__ wp, long long per_prime,
                         int n, long long total) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long p = idx / per_prime;
    const long long j = p * n + (idx % n);
    const uint32_t q = qs[p];
    out[idx] = kLazy ? shoup_lazy(x[idx], w[j], wp[j], q)
                     : shoup(x[idx], w[j], wp[j], q);
  }
}

int ilog2(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

struct Geometry {
  dim3 grid;
  int rows;
  bool tw_smem;
  size_t smem_bytes;
};

Geometry geometry(int k, int b, int n, int stages) {
  Geometry g;
  g.rows = kTileWords / n > 1 ? kTileWords / n : 1;
  if (g.rows > b) g.rows = b;
  const int tw_words = 2 * stages * (n / 2);
  g.tw_smem = tw_words <= kTwiddleWords;
  g.smem_bytes = (size_t)(2 * g.rows * n + (g.tw_smem ? tw_words : 0)) * 4;
  g.grid = dim3((b + g.rows - 1) / g.rows, k);
  return g;
}

}  // namespace

// Every launcher returns cudaGetLastError() of its launch; the Python
// wrapper raises on a non-zero code.  Shapes are checked by the wrapper:
// x/out (k, b, n) with n a power of two in [2, 4096], tables as in the
// TablePack layout, all uint32 (int32 bit patterns), contiguous.

extern "C" int ntt_fwd_banks(const void* x, void* out, const void* qs,
                             const void* tw, const void* twp, const void* psi,
                             const void* psip, int k, int b, int n, int stages,
                             int negacyclic, int lazy, int reduce_out,
                             void* stream) {
  if (k <= 0 || b <= 0) return (int)cudaGetLastError();
  const Geometry g = geometry(k, b, n, stages);
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* a_x = static_cast<const uint32_t*>(x);
  auto* a_out = static_cast<uint32_t*>(out);
  const auto* a_qs = static_cast<const uint32_t*>(qs);
  const auto* a_tw = static_cast<const uint32_t*>(tw);
  const auto* a_twp = static_cast<const uint32_t*>(twp);
  const auto* a_psi = static_cast<const uint32_t*>(psi);
  const auto* a_psip = static_cast<const uint32_t*>(psip);
  if (lazy) {
    ntt_fwd_banks_kernel<true><<<g.grid, kThreads, g.smem_bytes, s>>>(
        a_x, a_out, a_qs, a_tw, a_twp, a_psi, a_psip, b, n, ilog2(n),
        stages, g.rows, negacyclic != 0, reduce_out != 0, g.tw_smem);
  } else {
    ntt_fwd_banks_kernel<false><<<g.grid, kThreads, g.smem_bytes, s>>>(
        a_x, a_out, a_qs, a_tw, a_twp, a_psi, a_psip, b, n, ilog2(n),
        stages, g.rows, negacyclic != 0, reduce_out != 0, g.tw_smem);
  }
  return (int)cudaGetLastError();
}

extern "C" int ntt_inv_banks(const void* x, void* out, const void* qs,
                             const void* ninv, const void* ninv_p,
                             const void* itw, const void* itwp, const void* post,
                             const void* postp, int k, int b, int n, int stages,
                             int negacyclic, int lazy, int reduce_out,
                             void* stream) {
  if (k <= 0 || b <= 0) return (int)cudaGetLastError();
  const Geometry g = geometry(k, b, n, stages);
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* a_x = static_cast<const uint32_t*>(x);
  auto* a_out = static_cast<uint32_t*>(out);
  const auto* a_qs = static_cast<const uint32_t*>(qs);
  const auto* a_ninv = static_cast<const uint32_t*>(ninv);
  const auto* a_ninvp = static_cast<const uint32_t*>(ninv_p);
  const auto* a_itw = static_cast<const uint32_t*>(itw);
  const auto* a_itwp = static_cast<const uint32_t*>(itwp);
  const auto* a_post = static_cast<const uint32_t*>(post);
  const auto* a_postp = static_cast<const uint32_t*>(postp);
  if (lazy) {
    ntt_inv_banks_kernel<true><<<g.grid, kThreads, g.smem_bytes, s>>>(
        a_x, a_out, a_qs, a_ninv, a_ninvp, a_itw, a_itwp, a_post, a_postp, b,
        n, ilog2(n), stages, g.rows, negacyclic != 0, reduce_out != 0,
        g.tw_smem);
  } else {
    ntt_inv_banks_kernel<false><<<g.grid, kThreads, g.smem_bytes, s>>>(
        a_x, a_out, a_qs, a_ninv, a_ninvp, a_itw, a_itwp, a_post, a_postp, b,
        n, ilog2(n), stages, g.rows, negacyclic != 0, reduce_out != 0,
        g.tw_smem);
  }
  return (int)cudaGetLastError();
}

extern "C" int twiddle_mul_banks(const void* x, void* out, const void* qs,
                                 const void* w, const void* wp, int k,
                                 long long b, int n, int lazy, void* stream) {
  const long long per_prime = b * n;
  const long long total = per_prime * k;
  if (total <= 0) return (int)cudaGetLastError();
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 1048576 ? blocks : 1048576);
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* a_x = static_cast<const uint32_t*>(x);
  auto* a_out = static_cast<uint32_t*>(out);
  const auto* a_qs = static_cast<const uint32_t*>(qs);
  const auto* a_w = static_cast<const uint32_t*>(w);
  const auto* a_wp = static_cast<const uint32_t*>(wp);
  if (lazy) {
    twiddle_mul_banks_kernel<true><<<grid, kThreads, 0, s>>>(
        a_x, a_out, a_qs, a_w, a_wp, per_prime, n, total);
  } else {
    twiddle_mul_banks_kernel<false><<<grid, kThreads, 0, s>>>(
        a_x, a_out, a_qs, a_w, a_wp, per_prime, n, total);
  }
  return (int)cudaGetLastError();
}
