// Multi-prime NTT banks for Hopper (sm_90a): forward and inverse
// constant-geometry transforms and the per-prime weight-row multiply.
//
// Replaces the TPU kernels of src/repro/kernels/ntt_kernel.py:
//   ntt_fwd_banks      <- ntt_fwd_banks_pallas     (_ntt_fwd_banks_kernel)
//   ntt_inv_banks      <- ntt_inv_banks_pallas     (_ntt_inv_banks_kernel)
//   twiddle_mul_banks  <- twiddle_mul_banks_pallas (_twiddle_mul_banks_kernel)
//
// The two transforms are templated on the lane, as the TPU kernels follow
// their element dtype: uint32_t storage with the 32-bit Shoup multiply
// (the CKKS RNS primes; launchers ntt_fwd_banks / ntt_inv_banks), or
// uint16_t storage with the 16-bit one (ML-KEM's q = 3329 ring, whose
// incomplete transform runs 7 stages on n = 256; launchers
// ntt_fwd_banks_u16 / ntt_inv_banks_u16).  Every stage covers all n/2
// pairs, so any stage count up to log2 n works.
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

template <typename T, bool kLazy>
__global__ void __launch_bounds__(kThreads)
ntt_fwd_banks_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const T* __restrict__ qs, const T* __restrict__ tw,
                     const T* __restrict__ twp, const T* __restrict__ psi,
                     const T* __restrict__ psip, int b, int n, int log_n,
                     int stages, int rows, bool negacyclic, bool reduce_out,
                     bool tw_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, b - row0);
  const int h = n >> 1;
  const int words = nrows * n;
  const int half_words = nrows * h;
  const uint32_t q = qs[p];
  const uint32_t q2 = q << 1;

  T* a = smem;
  T* c = smem + rows * n;
  const T* tw_p = tw + (size_t)p * stages * h;
  const T* twp_p = twp + (size_t)p * stages * h;
  if (tw_smem) {
    T* s_tw = smem + 2 * rows * n;
    for (int i = threadIdx.x; i < stages * h; i += blockDim.x) {
      s_tw[i] = tw_p[i];
      s_tw[stages * h + i] = twp_p[i];
    }
    tw_p = s_tw;
    twp_p = s_tw + stages * h;
  }

  const T* src = x + ((size_t)p * b + row0) * n;
  const T* psi_p = psi + (size_t)p * n;
  const T* psip_p = psip + (size_t)p * n;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    uint32_t v = src[i];
    if (negacyclic) {
      const int j = i & (n - 1);
      v = kLazy ? lane_shoup_lazy<T>(v, psi_p[j], psip_p[j], q)
                : lane_shoup<T>(v, psi_p[j], psip_p[j], q);
    }
    a[i] = (T)v;
  }
  __syncthreads();

  for (int t = 0; t < stages; ++t) {
    const T* wrow = tw_p + t * h;
    const T* wprow = twp_p + t * h;
    for (int i = threadIdx.x; i < half_words; i += blockDim.x) {
      const int r = i >> (log_n - 1);
      const int j = i & (h - 1);
      const uint32_t lo = a[r * n + j];
      const uint32_t hi = a[r * n + j + h];
      const uint32_t w = wrow[j];
      const uint32_t wp = wprow[j];
      uint32_t u, v;
      if (kLazy) {
        const uint32_t tt = lane_shoup_lazy<T>(hi, w, wp, q);
        u = lazy_add(lo, tt, q2);
        v = lazy_sub(lo, tt, q2);
      } else {
        const uint32_t tt = lane_shoup<T>(hi, w, wp, q);
        u = add_mod(lo, tt, q);
        v = sub_mod(lo, tt, q);
      }
      c[r * n + 2 * j] = (T)u;
      c[r * n + 2 * j + 1] = (T)v;
    }
    __syncthreads();
    T* tmp = a;
    a = c;
    c = tmp;
  }

  T* dst = out + ((size_t)p * b + row0) * n;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    uint32_t v = a[i];
    if (kLazy && reduce_out) v = v >= q ? v - q : v;
    dst[i] = (T)v;
  }
}

template <typename T, bool kLazy>
__global__ void __launch_bounds__(kThreads)
ntt_inv_banks_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const T* __restrict__ qs, const T* __restrict__ ninv,
                     const T* __restrict__ ninv_p, const T* __restrict__ itw,
                     const T* __restrict__ itwp, const T* __restrict__ post,
                     const T* __restrict__ postp, int b, int n, int log_n,
                     int stages, int rows, bool negacyclic, bool reduce_out,
                     bool tw_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, b - row0);
  const int h = n >> 1;
  const int words = nrows * n;
  const int half_words = nrows * h;
  const uint32_t q = qs[p];
  const uint32_t q2 = q << 1;

  T* a = smem;
  T* c = smem + rows * n;
  const T* tw_p = itw + (size_t)p * stages * h;
  const T* twp_p = itwp + (size_t)p * stages * h;
  if (tw_smem) {
    T* s_tw = smem + 2 * rows * n;
    for (int i = threadIdx.x; i < stages * h; i += blockDim.x) {
      s_tw[i] = tw_p[i];
      s_tw[stages * h + i] = twp_p[i];
    }
    tw_p = s_tw;
    twp_p = s_tw + stages * h;
  }

  const T* src = x + ((size_t)p * b + row0) * n;
  for (int i = threadIdx.x; i < words; i += blockDim.x) a[i] = src[i];
  __syncthreads();

  for (int t = stages - 1; t >= 0; --t) {
    const T* wrow = tw_p + t * h;
    const T* wprow = twp_p + t * h;
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
        v = lane_shoup_lazy<T>(lazy_sub(e, o, q2), w, wp, q);
      } else {
        u = add_mod(e, o, q);
        v = lane_shoup<T>(sub_mod(e, o, q), w, wp, q);
      }
      c[r * n + j] = (T)u;
      c[r * n + j + h] = (T)v;
    }
    __syncthreads();
    T* tmp = a;
    a = c;
    c = tmp;
  }

  // epilogue: psi^-i * n^-1 row (negacyclic) or the ninv scalar (n^-1, or
  // 2^-stages for an incomplete ring); the multiply reduces fully unless
  // a lazy consumer asked for [0, 2q)
  T* dst = out + ((size_t)p * b + row0) * n;
  const T* post_p = post + (size_t)p * n;
  const T* postp_p = postp + (size_t)p * n;
  const uint32_t nv = ninv[p];
  const uint32_t nvp = ninv_p[p];
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int j = i & (n - 1);
    const uint32_t w = negacyclic ? (uint32_t)post_p[j] : nv;
    const uint32_t wp = negacyclic ? (uint32_t)postp_p[j] : nvp;
    dst[i] = (T)((kLazy && !reduce_out) ? lane_shoup_lazy<T>(a[i], w, wp, q)
                                        : lane_shoup<T>(a[i], w, wp, q));
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

Geometry geometry(int k, int b, int n, int stages, size_t word_bytes) {
  Geometry g;
  g.rows = kTileWords / n > 1 ? kTileWords / n : 1;
  if (g.rows > b) g.rows = b;
  const int tw_words = 2 * stages * (n / 2);
  g.tw_smem = tw_words <= kTwiddleWords;
  g.smem_bytes = (size_t)(2 * g.rows * n + (g.tw_smem ? tw_words : 0)) * word_bytes;
  g.grid = dim3((b + g.rows - 1) / g.rows, k);
  return g;
}

template <typename T>
int launch_fwd(const void* x, void* out, const void* qs, const void* tw,
               const void* twp, const void* psi, const void* psip, int k,
               int b, int n, int stages, int negacyclic, int lazy,
               int reduce_out, void* stream) {
  if (k <= 0 || b <= 0) return (int)cudaGetLastError();
  const Geometry g = geometry(k, b, n, stages, sizeof(T));
  auto* s = static_cast<cudaStream_t>(stream);
  auto kernel = lazy ? &ntt_fwd_banks_kernel<T, true> : &ntt_fwd_banks_kernel<T, false>;
  kernel<<<g.grid, kThreads, g.smem_bytes, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(qs),
      static_cast<const T*>(tw), static_cast<const T*>(twp),
      static_cast<const T*>(psi), static_cast<const T*>(psip), b, n, ilog2(n),
      stages, g.rows, negacyclic != 0, reduce_out != 0, g.tw_smem);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_inv(const void* x, void* out, const void* qs, const void* ninv,
               const void* ninv_p, const void* itw, const void* itwp,
               const void* post, const void* postp, int k, int b, int n,
               int stages, int negacyclic, int lazy, int reduce_out,
               void* stream) {
  if (k <= 0 || b <= 0) return (int)cudaGetLastError();
  const Geometry g = geometry(k, b, n, stages, sizeof(T));
  auto* s = static_cast<cudaStream_t>(stream);
  auto kernel = lazy ? &ntt_inv_banks_kernel<T, true> : &ntt_inv_banks_kernel<T, false>;
  kernel<<<g.grid, kThreads, g.smem_bytes, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(qs),
      static_cast<const T*>(ninv), static_cast<const T*>(ninv_p),
      static_cast<const T*>(itw), static_cast<const T*>(itwp),
      static_cast<const T*>(post), static_cast<const T*>(postp), b, n,
      ilog2(n), stages, g.rows, negacyclic != 0, reduce_out != 0, g.tw_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// Every launcher returns cudaGetLastError() of its launch; the Python
// wrapper raises on a non-zero code.  Shapes are checked by the wrapper:
// x/out (k, b, n) with n a power of two in [2, 4096], tables as in the
// TablePack layout, contiguous; uint32 (int32 bit patterns) for the
// plain launchers, uint16 (int16 bit patterns) for the _u16 ones.

extern "C" int ntt_fwd_banks(const void* x, void* out, const void* qs,
                             const void* tw, const void* twp, const void* psi,
                             const void* psip, int k, int b, int n, int stages,
                             int negacyclic, int lazy, int reduce_out,
                             void* stream) {
  return launch_fwd<uint32_t>(x, out, qs, tw, twp, psi, psip, k, b, n, stages,
                              negacyclic, lazy, reduce_out, stream);
}

extern "C" int ntt_fwd_banks_u16(const void* x, void* out, const void* qs,
                                 const void* tw, const void* twp,
                                 const void* psi, const void* psip, int k,
                                 int b, int n, int stages, int negacyclic,
                                 int lazy, int reduce_out, void* stream) {
  return launch_fwd<uint16_t>(x, out, qs, tw, twp, psi, psip, k, b, n, stages,
                              negacyclic, lazy, reduce_out, stream);
}

extern "C" int ntt_inv_banks(const void* x, void* out, const void* qs,
                             const void* ninv, const void* ninv_p,
                             const void* itw, const void* itwp, const void* post,
                             const void* postp, int k, int b, int n, int stages,
                             int negacyclic, int lazy, int reduce_out,
                             void* stream) {
  return launch_inv<uint32_t>(x, out, qs, ninv, ninv_p, itw, itwp, post, postp,
                              k, b, n, stages, negacyclic, lazy, reduce_out,
                              stream);
}

extern "C" int ntt_inv_banks_u16(const void* x, void* out, const void* qs,
                                 const void* ninv, const void* ninv_p,
                                 const void* itw, const void* itwp,
                                 const void* post, const void* postp, int k,
                                 int b, int n, int stages, int negacyclic,
                                 int lazy, int reduce_out, void* stream) {
  return launch_inv<uint16_t>(x, out, qs, ninv, ninv_p, itw, itwp, post, postp,
                              k, b, n, stages, negacyclic, lazy, reduce_out,
                              stream);
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
