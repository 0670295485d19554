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
// What this simple design does about it: each block runs one prime's
// rows through every stage in a shared-memory ping-pong pair, so a word
// crosses device memory exactly twice (ntt_block.cuh, shared with the
// single-prime kernels of ntt.cu).  The TPU kernel kept all twiddle rows
// resident in VMEM, which does not fit a block's shared memory at
// n = 4096: only tables up to 16 KB (n <= 256) go to shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"
#include "ntt_block.cuh"

using namespace modarith;

namespace {

using ntt_block::kThreads;

template <typename T, bool kLazy>
__global__ void __launch_bounds__(kThreads)
ntt_fwd_banks_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const T* __restrict__ qs, const T* __restrict__ tw,
                     const T* __restrict__ twp, const T* __restrict__ psi,
                     const T* __restrict__ psip, int b, int n, int log_n,
                     int stages, int rows, bool negacyclic, bool reduce_out,
                     bool tw_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int p = blockIdx.y;
  const size_t table = (size_t)p * stages * (n >> 1);
  ntt_block::fwd_block<T, kLazy>(
      reinterpret_cast<T*>(smem_raw), x + (size_t)p * b * n,
      out + (size_t)p * b * n, qs[p], tw + table, twp + table,
      psi + (size_t)p * n, psip + (size_t)p * n, b, n, log_n, stages, rows,
      negacyclic, reduce_out, tw_smem);
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
  const int p = blockIdx.y;
  const size_t table = (size_t)p * stages * (n >> 1);
  ntt_block::inv_block<T, kLazy>(
      reinterpret_cast<T*>(smem_raw), x + (size_t)p * b * n,
      out + (size_t)p * b * n, qs[p], ninv[p], ninv_p[p], itw + table,
      itwp + table, post + (size_t)p * n, postp + (size_t)p * n, b, n, log_n,
      stages, rows, negacyclic, reduce_out, tw_smem);
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

using ntt_block::Geometry;
using ntt_block::geometry;
using ntt_block::ilog2;

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
