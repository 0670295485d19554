// Single-prime pointwise Barrett products for Hopper (sm_90a): the
// paper's MM (modular multiply) and MA (multiply-accumulate) units.
//
// Replaces the TPU kernels of src/repro/kernels/dyadic_kernel.py:
//   dyadic_mul  <- dyadic_mul  (_mul_kernel):  out = a * b mod q
//   dyadic_mac  <- dyadic_mac  (_mac_kernel):  out = acc + a * b mod q
// with the u32 Barrett product of modarith.cuh, bit-matched to the
// reference's quotient formula.  The modulus and mu = floor(2^60 / q) are
// scalar kernel arguments (static on the TPU).  The product takes the
// [0, 2q) band and one subtract of q, lazy or not (the reference's two
// paths are the same sequence).  The lazy MAC sums acc (< q) and the
// [0, 2q) product, below 3q, and reduces by 2q then by q; the eager MAC
// adds the reduced product and subtracts q once.  Output is in [0, q).
//
// What bounds them on an H100: device memory.  Each word is read from
// every operand once and written once (12 bytes a word for the product,
// 16 for the MAC), with about 15 integer operations in between.
//
// What this simple design does about it: a grid-stride loop over the
// flat words, one thread per 16-byte vector (4 words) when the word count
// is a multiple of 4 and every pointer is 16-byte aligned, else one
// thread per word.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

using namespace modarith;

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;  // 2048 threads on each SM, then stride

struct Mul {
  __device__ __forceinline__ static uint32_t op(uint32_t, uint32_t a, uint32_t b,
                                                uint32_t q, uint32_t mu, bool) {
    return barrett(a, b, q, mu);
  }
};

struct Mac {
  __device__ __forceinline__ static uint32_t op(uint32_t acc, uint32_t a,
                                                uint32_t b, uint32_t q,
                                                uint32_t mu, bool lazy) {
    uint32_t s;
    if (lazy) {
      s = acc + barrett_lazy(a, b, q, mu);  // < 3q < 2^32
      const uint32_t q2 = q << 1;
      s = s >= q2 ? s - q2 : s;
    } else {
      s = acc + barrett(a, b, q, mu);
    }
    return s >= q ? s - q : s;
  }
};

// acc is read only by the MAC (nullptr for the product).
template <typename Op, bool kVec>
__device__ __forceinline__ void pointwise(const uint32_t* __restrict__ acc,
                                          const uint32_t* __restrict__ a,
                                          const uint32_t* __restrict__ b,
                                          uint32_t* __restrict__ out, uint32_t q,
                                          uint32_t mu, long long items, bool lazy) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < items; i += stride) {
    if (kVec) {
      const uint4 va = reinterpret_cast<const uint4*>(a)[i];
      const uint4 vb = reinterpret_cast<const uint4*>(b)[i];
      const uint4 vc = acc ? reinterpret_cast<const uint4*>(acc)[i]
                           : make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(out)[i] = make_uint4(
          Op::op(vc.x, va.x, vb.x, q, mu, lazy), Op::op(vc.y, va.y, vb.y, q, mu, lazy),
          Op::op(vc.z, va.z, vb.z, q, mu, lazy), Op::op(vc.w, va.w, vb.w, q, mu, lazy));
    } else {
      out[i] = Op::op(acc ? acc[i] : 0u, a[i], b[i], q, mu, lazy);
    }
  }
}

// The product and the MAC have their own __global__ names, so a profile
// tells them apart.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dyadic_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                  uint32_t* __restrict__ out, uint32_t q, uint32_t mu,
                  long long items) {
  pointwise<Mul, kVec>(nullptr, a, b, out, q, mu, items, false);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dyadic_mac_kernel(const uint32_t* __restrict__ acc, const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                  uint32_t q, uint32_t mu, long long items, bool lazy) {
  pointwise<Mac, kVec>(acc, a, b, out, q, mu, items, lazy);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned blocks(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  return (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// Every launcher returns cudaGetLastError() of its launch; the Python
// wrapper raises on a non-zero code.  Shapes are checked by the wrapper:
// every operand and out hold `total` contiguous uint32 words (int32 bit
// patterns) in [0, q); q in (2^28, 2^30) with its Barrett mu.

// The lazy and eager products are one sequence, so the product takes no
// lazy flag.
extern "C" int dyadic_mul(const void* a, const void* b, void* out, unsigned q,
                          unsigned mu, long long total, void* stream) {
  if (total <= 0) return (int)cudaGetLastError();
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  if (total % 4 == 0 && aligned(a) && aligned(b) && aligned(out)) {
    dyadic_mul_kernel<true><<<blocks(total / 4), kThreads, 0, s>>>(pa, pb, po, q, mu,
                                                                    total / 4);
  } else {
    dyadic_mul_kernel<false><<<blocks(total), kThreads, 0, s>>>(pa, pb, po, q, mu,
                                                                 total);
  }
  return (int)cudaGetLastError();
}

extern "C" int dyadic_mac(const void* acc, const void* a, const void* b, void* out,
                          unsigned q, unsigned mu, long long total, int lazy,
                          void* stream) {
  if (total <= 0) return (int)cudaGetLastError();
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* pc = static_cast<const uint32_t*>(acc);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<uint32_t*>(out);
  if (total % 4 == 0 && aligned(acc) && aligned(a) && aligned(b) && aligned(out)) {
    dyadic_mac_kernel<true><<<blocks(total / 4), kThreads, 0, s>>>(
        pc, pa, pb, po, q, mu, total / 4, lazy != 0);
  } else {
    dyadic_mac_kernel<false><<<blocks(total), kThreads, 0, s>>>(pc, pa, pb, po, q, mu,
                                                                 total, lazy != 0);
  }
  return (int)cudaGetLastError();
}
