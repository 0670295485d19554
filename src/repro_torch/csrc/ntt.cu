// Single-prime NTT for Hopper (sm_90a): the paper's NTT unit (NTT-128 at
// N = 128, 32-bit coefficients, one prime), forward and inverse
// constant-geometry transforms over a batch of rows.
//
// Replaces the TPU kernels of src/repro/kernels/ntt_kernel.py:
//   ntt_fwd  <- ntt_fwd_pallas  (_ntt_fwd_kernel)
//   ntt_inv  <- ntt_inv_pallas  (_ntt_inv_kernel)
// The TPU kernels took the modulus and n^-1 as static arguments; here they
// are scalar kernel arguments.  Every log2(n) stage runs (complete ring).
// The forward transform pre-weights by psi^i when negacyclic; lazy keeps
// [0, 2q) between stages and always reduces at the end.  The inverse ends
// with the exact Shoup multiply by psi^-i * n^-1 (negacyclic) or n^-1
// (cyclic), so its output is in [0, q) either way.
//
// What bounds them on an H100: device memory.  A transform reads each word
// once and writes it once (8 bytes per word); in between, each of its
// log2(n) stages spends about 8 integer operations per word on a Shoup
// butterfly.  The card's int32 rate is not in its data sheet's table, so
// the bound counted is bytes.
//
// What this simple design does about it: the shared-memory ping-pong block
// body of ntt_block.cuh.  Up to n = 4096 a block holds 4096 / n rows in a
// 32 KB shared-memory ping-pong pair (32 rows of NTT-128), with the stage
// table pair in shared memory when it fits in 16 KB (n <= 256: 3.5 KB at
// n = 128).  The reference's single-prime kernel has no four-step cut-off,
// so at n = 8192 and 16384 a block holds one row in 64 KB / 128 KB of
// dynamic shared memory (asked for with cudaFuncSetAttribute above 48 KB)
// and reads the stage tables from device memory.  Larger rings are refused
// here; the Python wrappers run them as a one-prime bank (ntt_banks.cu).
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_block.cuh"

namespace {

using ntt_block::kThreads;

constexpr int kMaxN = 1 << 14;  // one row's ping-pong pair: 128 KB of smem

template <bool kLazy>
__global__ void __launch_bounds__(kThreads)
ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ tw, const uint32_t* __restrict__ twp,
               const uint32_t* __restrict__ pre,
               const uint32_t* __restrict__ prep, uint32_t q, int b, int n,
               int log_n, int rows, bool negacyclic, bool tw_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ntt_block::fwd_block<uint32_t, kLazy>(
      reinterpret_cast<uint32_t*>(smem_raw), x, out, q, tw, twp, pre, prep, b,
      n, log_n, log_n, rows, negacyclic, /*reduce_out=*/true, tw_smem);
}

template <bool kLazy>
__global__ void __launch_bounds__(kThreads)
ntt_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               const uint32_t* __restrict__ itw,
               const uint32_t* __restrict__ itwp,
               const uint32_t* __restrict__ post,
               const uint32_t* __restrict__ postp, uint32_t q, uint32_t ninv,
               uint32_t ninv_p, int b, int n, int log_n, int rows,
               bool negacyclic, bool tw_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ntt_block::inv_block<uint32_t, kLazy>(
      reinterpret_cast<uint32_t*>(smem_raw), x, out, q, ninv, ninv_p, itw,
      itwp, post, postp, b, n, log_n, log_n, rows, negacyclic,
      /*reduce_out=*/true, tw_smem);
}

// The block geometry, after raising the kernel's dynamic shared memory
// limit when the ping-pong pair needs more than 48 KB.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int b, int n, ntt_block::Geometry* g) {
  if (n < 2 || n > kMaxN || (n & (n - 1)) != 0) return cudaErrorInvalidValue;
  *g = ntt_block::geometry(1, b, n, ntt_block::ilog2(n), sizeof(uint32_t));
  if (g->smem_bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)g->smem_bytes);
  return cudaSuccess;
}

}  // namespace

// Every launcher returns the CUDA error of configuring or launching its
// kernel; the Python wrapper raises on a non-zero code.  Shapes are checked
// by the wrapper: x/out (b, n) uint32 (int32 bit patterns), n a power of
// two in [2, 16384], tables (log2 n, n/2) and rows (n,), all contiguous.

extern "C" int ntt_fwd(const void* x, void* out, const void* tw, const void* twp,
                       const void* pre, const void* prep, unsigned q, int b,
                       int n, int negacyclic, int lazy, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  auto kernel = lazy ? &ntt_fwd_kernel<true> : &ntt_fwd_kernel<false>;
  ntt_block::Geometry g;
  const cudaError_t e = prepare(kernel, b, n, &g);
  if (e != cudaSuccess) return (int)e;
  kernel<<<g.grid, kThreads, g.smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(twp),
      static_cast<const uint32_t*>(pre), static_cast<const uint32_t*>(prep), q,
      b, n, ntt_block::ilog2(n), g.rows, negacyclic != 0, g.tw_smem);
  return (int)cudaGetLastError();
}

extern "C" int ntt_inv(const void* x, void* out, const void* itw,
                       const void* itwp, const void* post, const void* postp,
                       unsigned q, unsigned ninv, unsigned ninv_p, int b, int n,
                       int negacyclic, int lazy, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  auto kernel = lazy ? &ntt_inv_kernel<true> : &ntt_inv_kernel<false>;
  ntt_block::Geometry g;
  const cudaError_t e = prepare(kernel, b, n, &g);
  if (e != cudaSuccess) return (int)e;
  kernel<<<g.grid, kThreads, g.smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(itw), static_cast<const uint32_t*>(itwp),
      static_cast<const uint32_t*>(post), static_cast<const uint32_t*>(postp), q,
      ninv, ninv_p, b, n, ntt_block::ilog2(n), g.rows, negacyclic != 0,
      g.tw_smem);
  return (int)cudaGetLastError();
}
