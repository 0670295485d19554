// Exact modular arithmetic shared by every kernel of the port.
//
// Same op sequence and quotient formulas as the plain versions in
// repro_torch/core/modmath.py (and the JAX reference's datapath), so a
// kernel and its plain version agree on every representative, including
// the lazy [0, 2q) band.  Every RNS prime is below 2^30, so 2q < 2^31 and
// the worst intermediate a + (2q - b) stays below 4q < 2^32.
//
// __umulhi gives the high word of the 32x32 product in one instruction;
// it equals the 16-bit-limb mulhi the TPU needed.
//
// The 16-bit lane (small rings, ML-KEM's q = 3329 in (2^10, 2^12)) keeps
// its values in u32 registers: a 16x16 product is exact there, so the
// Shoup high part is a shift by 16 (wp = floor(w * 2^16 / q)) and the
// Barrett quotient is ((P >> 10) * mu) >> 16 with mu = floor(2^26 / q).
// Results stay below 2q < 2^13 and are stored back as uint16_t; the
// lazy band's add/sub need no change, since 4q < 2^16.
#pragma once
#include <cstdint>

namespace modarith {

// Shoup product without the final subtract: [0, 2q), == x*w mod q.
// w < q, wp = floor(w * 2^32 / q); x may be any u32.
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w,
                                               uint32_t wp, uint32_t q) {
  return x * w - __umulhi(x, wp) * q;
}

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t wp,
                                          uint32_t q) {
  uint32_t r = shoup_lazy(x, w, wp, q);
  return r >= q ? r - q : r;
}

// Barrett product reduced to [0, 2q): P = a*b < 2^60, approx = P >> 29,
// qhat = (approx * mu) >> 31 assembled from its hi/lo halves, mu =
// floor(2^60 / q).  a, b in [0, q).
__device__ __forceinline__ uint32_t barrett_lazy(uint32_t a, uint32_t b,
                                                 uint32_t q, uint32_t mu) {
  uint32_t hi = __umulhi(a, b);
  uint32_t lo = a * b;
  uint32_t approx = (hi << 3) | (lo >> 29);
  uint32_t qhat = (__umulhi(approx, mu) << 1) | ((approx * mu) >> 31);
  uint32_t r = lo - qhat * q;  // wraps; < 3q
  uint32_t q2 = q << 1;
  return r >= q2 ? r - q2 : r;
}

__device__ __forceinline__ uint32_t barrett(uint32_t a, uint32_t b, uint32_t q,
                                            uint32_t mu) {
  uint32_t r = barrett_lazy(a, b, q, mu);
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + (q - b);
}

// [0, 2q) band add/sub: q2 = 2q.
__device__ __forceinline__ uint32_t lazy_add(uint32_t a, uint32_t b, uint32_t q2) {
  uint32_t s = a + b;
  return s >= q2 ? s - q2 : s;
}

__device__ __forceinline__ uint32_t lazy_sub(uint32_t a, uint32_t b, uint32_t q2) {
  return a >= b ? a - b : a + (q2 - b);
}

// The 16-bit lane's helpers write the subtract s >= m ? s - m : s as
// min(s, s - m): the same word for every u32 s (s - m wraps above s when
// s < m), one VIADDMNMX on sm_90a instead of a compare, a select and a
// subtract (as ntt_regs.cuh's band).

// 16-bit Shoup product without the final subtract: [0, 2q) for any u16 x,
// w < q, wp = floor(w * 2^16 / q).
__device__ __forceinline__ uint32_t shoup16_lazy(uint32_t x, uint32_t w,
                                                 uint32_t wp, uint32_t q) {
  return x * w - ((x * wp) >> 16) * q;
}

__device__ __forceinline__ uint32_t shoup16(uint32_t x, uint32_t w, uint32_t wp,
                                            uint32_t q) {
  uint32_t r = shoup16_lazy(x, w, wp, q);
  return min(r, r - q);
}

// 16-bit Barrett product reduced to [0, 2q): P = a*b < 2^24, qhat =
// ((P >> 10) * mu) >> 16, mu = floor(2^26 / q).  a, b in [0, q).
__device__ __forceinline__ uint32_t barrett16_lazy(uint32_t a, uint32_t b,
                                                   uint32_t q, uint32_t mu) {
  uint32_t prod = a * b;
  uint32_t qhat = ((prod >> 10) * mu) >> 16;
  uint32_t r = prod - qhat * q;  // the reference keeps one subtract of 2q
  uint32_t q2 = q << 1;
  return min(r, r - q2);
}

__device__ __forceinline__ uint32_t barrett16(uint32_t a, uint32_t b,
                                              uint32_t q, uint32_t mu) {
  uint32_t r = barrett16_lazy(a, b, q, mu);
  return min(r, r - q);
}

// The u32 lane's 23-bit Barrett trait (moduli in (2^21, 2^23), ML-DSA's
// q = 8380417; core/modmath.py BARRETT23_WINDOW): P = a*b < 2^46, approx =
// P >> 21 < 2^25, qhat = umulhi(approx, mu) with mu = floor(2^53 / q) < 2^32;
// qhat is at most 2 below floor(P / q), so r = P - qhat*q < 3q, and one
// subtract of 2q gives [0, 2q).  a, b in [0, q).  Shoup products and the
// lazy band are the u32 lane's own.
__device__ __forceinline__ uint32_t barrett23_lazy(uint32_t a, uint32_t b,
                                                   uint32_t q, uint32_t mu) {
  uint32_t hi = __umulhi(a, b);
  uint32_t lo = a * b;
  uint32_t approx = (hi << 11) | (lo >> 21);
  uint32_t qhat = __umulhi(approx, mu);
  uint32_t r = lo - qhat * q;  // wraps; < 3q
  uint32_t q2 = q << 1;
  return r >= q2 ? r - q2 : r;
}

__device__ __forceinline__ uint32_t barrett23(uint32_t a, uint32_t b, uint32_t q,
                                              uint32_t mu) {
  uint32_t r = barrett23_lazy(a, b, q, mu);
  return r >= q ? r - q : r;
}

// The u32 lane's Barrett product of trait B: 32 the RNS window's, 23 the
// small moduli's.
template <int B>
__device__ __forceinline__ uint32_t lane_barrett_lazy(uint32_t a, uint32_t b, uint32_t q,
                                                      uint32_t mu) {
  if constexpr (B == 23) {
    return barrett23_lazy(a, b, q, mu);
  } else {
    return barrett_lazy(a, b, q, mu);
  }
}

template <int B>
__device__ __forceinline__ uint32_t lane_barrett(uint32_t a, uint32_t b, uint32_t q,
                                                 uint32_t mu) {
  if constexpr (B == 23) {
    return barrett23(a, b, q, mu);
  } else {
    return barrett(a, b, q, mu);
  }
}

// The lane's Shoup product, chosen by the storage type T: uint32_t is the
// RNS lane, uint16_t the small-ring lane.
template <typename T>
__device__ __forceinline__ uint32_t lane_shoup_lazy(uint32_t x, uint32_t w,
                                                    uint32_t wp, uint32_t q) {
  if constexpr (sizeof(T) == 2) {
    return shoup16_lazy(x, w, wp, q);
  } else {
    return shoup_lazy(x, w, wp, q);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t lane_shoup(uint32_t x, uint32_t w,
                                               uint32_t wp, uint32_t q) {
  uint32_t r = lane_shoup_lazy<T>(x, w, wp, q);
  return r >= q ? r - q : r;
}

}  // namespace modarith
