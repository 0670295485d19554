// One block's constant-geometry NTT, the body of the single-prime kernels
// (ntt.cu), with the reference's _fwd_stages / _inv_stages
// (src/repro/kernels/ntt_kernel.py).
//
// A block transforms `rows` consecutive rows of one prime's (b, n)
// matrix, row tile blockIdx.x, in a shared-memory ping-pong pair, so a
// word crosses device memory exactly twice however many stages run (the
// paper's SRM ping-pong banks).  The stage table pair (stages, n/2) is
// copied to shared memory behind the ping-pong pair when it fits in 16 KB;
// larger tables are read from device memory (they stay in L1/L2, shared by
// every block).  Loads and stores of the row tiles are coalesced; the
// interleaved (u, v) writes of the forward stage cost a 2-way bank
// conflict, left for a later change.
//
// The constant-geometry layout is kept exactly: a forward stage reads
// lo = x[:n/2], hi = x[n/2:] and writes interleaved (u, v) pairs; an
// inverse stage reads interleaved pairs and writes [u | v].
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace ntt_block {

using namespace modarith;

constexpr int kThreads = 256;
constexpr int kTileWords = 4096;     // words of each ping-pong buffer, n <= 4096
constexpr int kTwiddleWords = 4096;  // tw + twp words that may go to smem

inline int ilog2(int n) {
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

// rows = 4096 / n per block (one row above 4096 words), k primes on grid.y
inline Geometry geometry(int k, int b, int n, int stages, size_t word_bytes) {
  Geometry g;
  g.rows = kTileWords / n > 1 ? kTileWords / n : 1;
  if (g.rows > b) g.rows = b;
  const int tw_words = 2 * stages * (n / 2);
  g.tw_smem = tw_words <= kTwiddleWords;
  g.smem_bytes = (size_t)(2 * g.rows * n + (g.tw_smem ? tw_words : 0)) * word_bytes;
  g.grid = dim3((b + g.rows - 1) / g.rows, k);
  return g;
}

// Points tw/twp at a shared-memory copy of the (stages, n/2) table pair
// when tw_smem; the copy sits after the ping-pong pair.
template <typename T>
__device__ __forceinline__ void stage_tables(T* smem, int rows, int n,
                                             int stages, bool tw_smem,
                                             const T*& tw, const T*& twp) {
  if (!tw_smem) return;
  const int h = n >> 1;
  T* s_tw = smem + 2 * rows * n;
  for (int i = threadIdx.x; i < stages * h; i += blockDim.x) {
    s_tw[i] = tw[i];
    s_tw[stages * h + i] = twp[i];
  }
  tw = s_tw;
  twp = s_tw + stages * h;
}

// x/out: the prime's (b, n) rows; tw/twp: its (stages, n/2) table pair;
// psi/psip: its (n,) pre-weight row.  Lazy keeps [0, 2q) between stages
// and reduces at the end when reduce_out.
template <typename T, bool kLazy>
__device__ __forceinline__ void fwd_block(T* smem, const T* __restrict__ x,
                                          T* __restrict__ out, uint32_t q,
                                          const T* tw, const T* twp,
                                          const T* __restrict__ psi,
                                          const T* __restrict__ psip, int b,
                                          int n, int log_n, int stages,
                                          int rows, bool negacyclic,
                                          bool reduce_out, bool tw_smem) {
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, b - row0);
  const int h = n >> 1;
  const int words = nrows * n;
  const int half_words = nrows * h;
  const uint32_t q2 = q << 1;
  T* a = smem;
  T* c = smem + rows * n;
  stage_tables(smem, rows, n, stages, tw_smem, tw, twp);

  const T* src = x + (size_t)row0 * n;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    uint32_t v = src[i];
    if (negacyclic) {
      const int j = i & (n - 1);
      v = kLazy ? lane_shoup_lazy<T>(v, psi[j], psip[j], q)
                : lane_shoup<T>(v, psi[j], psip[j], q);
    }
    a[i] = (T)v;
  }
  __syncthreads();

  for (int t = 0; t < stages; ++t) {
    const T* wrow = tw + t * h;
    const T* wprow = twp + t * h;
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

  T* dst = out + (size_t)row0 * n;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    uint32_t v = a[i];
    if (kLazy && reduce_out) v = v >= q ? v - q : v;
    dst[i] = (T)v;
  }
}

// x/out: the prime's (b, n) rows; itw/itwp: its (stages, n/2) inverse
// table pair; post/postp: its (n,) psi^-i * n^-1 row; ninv/ninv_p the
// cyclic epilogue scalar (n^-1, or 2^-stages for an incomplete ring).  The
// epilogue multiply reduces fully unless a lazy consumer asked for [0, 2q).
template <typename T, bool kLazy>
__device__ __forceinline__ void inv_block(T* smem, const T* __restrict__ x,
                                          T* __restrict__ out, uint32_t q,
                                          uint32_t ninv, uint32_t ninv_p,
                                          const T* itw, const T* itwp,
                                          const T* __restrict__ post,
                                          const T* __restrict__ postp, int b,
                                          int n, int log_n, int stages,
                                          int rows, bool negacyclic,
                                          bool reduce_out, bool tw_smem) {
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, b - row0);
  const int h = n >> 1;
  const int words = nrows * n;
  const int half_words = nrows * h;
  const uint32_t q2 = q << 1;
  T* a = smem;
  T* c = smem + rows * n;
  stage_tables(smem, rows, n, stages, tw_smem, itw, itwp);

  const T* src = x + (size_t)row0 * n;
  for (int i = threadIdx.x; i < words; i += blockDim.x) a[i] = src[i];
  __syncthreads();

  for (int t = stages - 1; t >= 0; --t) {
    const T* wrow = itw + t * h;
    const T* wprow = itwp + t * h;
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

  T* dst = out + (size_t)row0 * n;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int j = i & (n - 1);
    const uint32_t w = negacyclic ? (uint32_t)post[j] : ninv;
    const uint32_t wp = negacyclic ? (uint32_t)postp[j] : ninv_p;
    dst[i] = (T)((kLazy && !reduce_out) ? lane_shoup_lazy<T>(a[i], w, wp, q)
                                        : lane_shoup<T>(a[i], w, wp, q));
  }
}

}  // namespace ntt_block
