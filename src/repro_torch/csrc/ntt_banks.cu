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
// What the transforms' simple design does about it: each block runs one
// prime's rows through every stage in a shared-memory ping-pong pair, so a
// word crosses device memory exactly twice (ntt_block.cuh, shared with the
// single-prime kernels of ntt.cu); up to n = 4096 a block holds 4096 / n
// rows, above it one row (the u32 lane up to 2^14: 128 KB).  The TPU
// kernel kept all twiddle rows resident in VMEM, which does not fit a
// block's shared memory at n = 4096: only tables up to 16 KB (n <= 256) go
// to shared memory.
//
// The weight-row multiply is a 16-byte stream, one prime per grid row
// (twiddle_mul_banks_kernel): the bytes in flight per SM set its time, so
// it keeps about 2048 threads resident on each SM, each holding one
// column's weight pair and moving one 16-byte load and one 16-byte store
// per row, with no division in its index.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"
#include "ntt_block.cuh"

using namespace modarith;

namespace {

using ntt_block::kThreads;

constexpr int kStreamThreads = 256;
constexpr long long kMaxStreamBlocks = 132 * 8;  // 2048 threads on each SM

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

// The weight-row multiply as a memory stream: grid.y is the prime, so q
// and the prime's weight rows are fixed per block; grid.x strides over
// the prime's b*n words.  kVec: one thread per 16-byte vector, four
// independent Shoup products.  n is a power of two and the launcher makes
// the grid stride a multiple of the n/4 vectors of a row, so a thread's
// column v & (n/4 - 1) never changes: it loads its weight pair once and
// streams x through its rows (no division, and the (k, n) weights leave
// L2 once per thread rather than once per row).  Otherwise one thread per
// word and the column i % n (n not a multiple of 4, or an unaligned
// pointer).
template <bool kLazy, bool kVec>
__global__ void __launch_bounds__(kStreamThreads)
twiddle_mul_banks_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                         const uint32_t* __restrict__ qs,
                         const uint32_t* __restrict__ w,
                         const uint32_t* __restrict__ wp, long long per_prime,
                         int n) {
  const int p = blockIdx.y;
  const uint32_t q = qs[p];
  x += (size_t)p * per_prime;
  out += (size_t)p * per_prime;
  w += (size_t)p * n;
  wp += (size_t)p * n;
  auto mul = [q](uint32_t a, uint32_t b, uint32_t bp) {
    return kLazy ? shoup_lazy(a, b, bp, q) : shoup(a, b, bp, q);
  };
  if (kVec) {
    const unsigned items = (unsigned)(per_prime >> 2);
    const unsigned stride = gridDim.x * kStreamThreads;
    unsigned i = blockIdx.x * kStreamThreads + threadIdx.x;
    if (i >= items) return;
    const unsigned col = i & ((unsigned)(n >> 2) - 1);
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(w) + col);
    const uint4 bp = __ldg(reinterpret_cast<const uint4*>(wp) + col);
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    uint4* out4 = reinterpret_cast<uint4*>(out);
#pragma unroll 4
    for (; i < items; i += stride) {
      const uint4 a = x4[i];
      out4[i] = make_uint4(mul(a.x, b.x, bp.x), mul(a.y, b.y, bp.y),
                           mul(a.z, b.z, bp.z), mul(a.w, b.w, bp.w));
    }
  } else {
    for (long long i = (long long)blockIdx.x * kStreamThreads + threadIdx.x;
         i < per_prime; i += (long long)gridDim.x * kStreamThreads) {
      const long long j = i % n;
      out[i] = mul(x[i], w[j], wp[j]);
    }
  }
}

using ntt_block::Geometry;
using ntt_block::geometry;
using ntt_block::ilog2;

// Above n = 4096 a block holds one row's ping-pong pair (64 KB at 8192 and
// 128 KB at 16384 on the u32 lane); above 48 KB a block's dynamic shared
// memory must be asked for, as ntt.cu's prepare does.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, const Geometry& g) {
  if (g.smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)g.smem_bytes);
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
  const cudaError_t e = allow_smem(kernel, g);
  if (e != cudaSuccess) return (int)e;
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
  const cudaError_t e = allow_smem(kernel, g);
  if (e != cudaSuccess) return (int)e;
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
// x/out (k, b, n) with n a power of two in [2, 16384] (the u16 lane up to
// 4096), tables as in the TablePack layout, contiguous; uint32 (int32 bit
// patterns) for the plain launchers, uint16 (int16 bit patterns) for the
// _u16 ones.  twiddle_mul_banks takes x/out (k, b, n) and w/wp (k, n).

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
  if (k <= 0 || per_prime <= 0) return (int)cudaGetLastError();
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // the vector path's 32-bit index covers a prime's b*n/4 vectors
  const bool vec = n % 4 == 0 && (n & (n - 1)) == 0 && per_prime / 4 < (1LL << 31) &&
                   aligned(x) && aligned(out) && aligned(w) && aligned(wp);
  const long long items = vec ? per_prime / 4 : per_prime;
  // about 2048 resident threads on each SM over all k primes, then stride;
  // on the vector path the stride is a whole number of rows (n/4 vectors)
  const long long want = (items + kStreamThreads - 1) / kStreamThreads;
  long long blocks = (kMaxStreamBlocks + k - 1) / k;
  if (want <= blocks) {
    blocks = want;  // one step a thread
  } else if (vec) {
    const long long row_blocks = n / 4 > kStreamThreads ? n / 4 / kStreamThreads : 1;
    blocks = blocks > row_blocks ? blocks / row_blocks * row_blocks : row_blocks;
  }
  const dim3 grid((unsigned)blocks, (unsigned)k);
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* a_x = static_cast<const uint32_t*>(x);
  auto* a_out = static_cast<uint32_t*>(out);
  const auto* a_qs = static_cast<const uint32_t*>(qs);
  const auto* a_w = static_cast<const uint32_t*>(w);
  const auto* a_wp = static_cast<const uint32_t*>(wp);
  auto kernel = lazy ? (vec ? &twiddle_mul_banks_kernel<true, true>
                            : &twiddle_mul_banks_kernel<true, false>)
                     : (vec ? &twiddle_mul_banks_kernel<false, true>
                            : &twiddle_mul_banks_kernel<false, false>);
  kernel<<<grid, kStreamThreads, 0, s>>>(a_x, a_out, a_qs, a_w, a_wp, per_prime, n);
  return (int)cudaGetLastError();
}
