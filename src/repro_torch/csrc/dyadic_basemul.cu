// Degree-1 basecase product of an incomplete ring for Hopper (sm_90a).
//
// Replaces the TPU kernel dyadic_basemul_banks of
// src/repro/kernels/dyadic_kernel.py (_basemul_banks_kernel): ML-KEM's
// NTT-domain product.  Pair j of the CG-ordered domain is
// (x[j], x[j + n/2]), and the product mod (X^2 - gamma_j) is
//
//   c0[j] = a0*b0 + gamma_j*(a1*b1)      c1[j] = a0*b1 + a1*b0
//
// on the 16-bit lane (uint16_t storage, int16 bit patterns in PyTorch):
// the variable x variable products use the 16-bit Barrett reduction, the
// gamma multiply the 16-bit Shoup one with the precomputed gammap row.
// The lazy mode keeps its sums in the [0, 2q) band (4q < 2^16); the
// epilogue always reduces to [0, q), since the basecase ends the NTT
// domain's algebra and has no lazy consumer.
//
// What bounds it on an H100: device memory, and at ML-KEM's sizes the
// launch.  Each pair reads four u16 words and writes two; the gamma rows
// (n/2 words each) stay in L1/L2.  A batch of 256 keygens moves about
// 3.5 MB through the largest call (9 * 256 rows of 256 words), so the
// launch, not the bytes, sets its time.
//
// What this simple design does about it: one thread per pair over
// (k, B, n/2), consecutive threads on consecutive j, so every load and
// store of a warp is one coalesced 64-byte segment per operand half.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

using namespace modarith;

namespace {

constexpr int kThreads = 256;

template <bool kLazy>
__global__ void __launch_bounds__(kThreads)
dyadic_basemul_banks_kernel(const uint16_t* __restrict__ a,
                            const uint16_t* __restrict__ b,
                            uint16_t* __restrict__ out,
                            const uint16_t* __restrict__ qs,
                            const uint16_t* __restrict__ mus,
                            const uint16_t* __restrict__ gamma,
                            const uint16_t* __restrict__ gammap, int bsz,
                            int log_h, long long total) {
  const int h = 1 << log_h;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx & (h - 1));
    const long long row = idx >> log_h;        // over k * B rows
    const int p = (int)(row / bsz);
    const long long base = row << (log_h + 1);  // row * n
    const uint32_t q = qs[p];
    const uint32_t mu = mus[p];
    const uint32_t g = gamma[(size_t)p * h + j];
    const uint32_t gp = gammap[(size_t)p * h + j];
    const uint32_t a0 = a[base + j], a1 = a[base + j + h];
    const uint32_t b0 = b[base + j], b1 = b[base + j + h];
    uint32_t c0, c1;
    if (kLazy) {
      const uint32_t q2 = q << 1;
      const uint32_t t = shoup16_lazy(barrett16_lazy(a1, b1, q, mu), g, gp, q);
      const uint32_t s0 = barrett16_lazy(a0, b0, q, mu) + t;  // < 4q
      c0 = s0 >= q2 ? s0 - q2 : s0;
      const uint32_t s1 = barrett16_lazy(a0, b1, q, mu) + barrett16_lazy(a1, b0, q, mu);
      c1 = s1 >= q2 ? s1 - q2 : s1;
      c0 = c0 >= q ? c0 - q : c0;  // epilogue
      c1 = c1 >= q ? c1 - q : c1;
    } else {
      const uint32_t t = shoup16(barrett16(a1, b1, q, mu), g, gp, q);
      const uint32_t s0 = barrett16(a0, b0, q, mu) + t;
      c0 = s0 >= q ? s0 - q : s0;
      const uint32_t s1 = barrett16(a0, b1, q, mu) + barrett16(a1, b0, q, mu);
      c1 = s1 >= q ? s1 - q : s1;
    }
    out[base + j] = (uint16_t)c0;
    out[base + j + h] = (uint16_t)c1;
  }
}

int ilog2(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

}  // namespace

// Returns cudaGetLastError() of its launch; the Python wrapper raises on a
// non-zero code.  Shapes are checked by the wrapper: a, b, out (k, b, n)
// with n a power of two >= 2; qs, mus (k,); gamma, gammap (k, n/2); all
// uint16 (int16 bit patterns), contiguous.
extern "C" int dyadic_basemul_banks(const void* a, const void* b, void* out,
                                    const void* qs, const void* mus,
                                    const void* gamma, const void* gammap,
                                    int k, int bsz, int n, int lazy,
                                    void* stream) {
  const long long total = (long long)k * bsz * (n / 2);
  if (total <= 0) return (int)cudaGetLastError();
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 1048576 ? blocks : 1048576);
  auto* s = static_cast<cudaStream_t>(stream);
  auto kernel = lazy ? &dyadic_basemul_banks_kernel<true>
                     : &dyadic_basemul_banks_kernel<false>;
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<uint16_t*>(out), static_cast<const uint16_t*>(qs),
      static_cast<const uint16_t*>(mus), static_cast<const uint16_t*>(gamma),
      static_cast<const uint16_t*>(gammap), bsz, ilog2(n / 2), total);
  return (int)cudaGetLastError();
}
