// Register-resident bodies of the multi-prime NTT banks (ntt_banks.cu).
//
// Same butterflies as the reference's constant-geometry stages
// (src/repro/kernels/ntt_kernel.py _fwd_stages / _inv_stages): the same
// (w, wp) for every butterfly, the same lazy or eager op sequence, the
// same output positions, so even the lazy [0, 2q) words match.  What
// changes is where a word lives between stages.
//
// The index fact the bodies rest on.  In the reference's forward stage t
// (lo = x[:n/2], hi = x[n/2:], out[2j] = u, out[2j+1] = v) the word that
// started at index o sits at position rotl^t(o) before stage t, where rotl
// rotates the log2 n-bit index left by one.  So stage t pairs the two
// words whose ORIGINAL indices differ only in bit L-1-t (L = log2 n), the
// sum goes to the word whose bit is 0, and the twiddle column is
// rotl^t(o) & (n/2 - 1).  The inverse mirrors it with rotr: its i-th
// applied stage (table row stages-1-i) pairs original bit i, with column
// rotr^(i+1)(o) & (n/2 - 1).  After all L stages every word is back at its
// original index; after stages < L (an incomplete ring) it sits at
// rotl^stages(o) (forward) or rotr^stages(o) (inverse).
//
// So a thread can keep words under their original indices and run, in
// registers, every stage whose pairing bit lies among its register bits.
//
// Row body (ntt_rows_kernel), rows of NL = 2^LL <= 4096 words: a thread
// holds R = 2^RB words, 16 (fewer below n = 16; 4 in the small-batch
// body), and TPR = NL / R threads share a row.  The L index bits are taken
// in phases of RB (forward: top bits first; inverse: bottom bits first);
// in phase k a thread's registers hold the words whose index differs only
// in that phase's RB bits (its "group"), and its row-thread index i
// supplies the other bits in order (deposit()).  Between two phases the
// row goes once through shared memory (at most two exchanges at n = 4096,
// one at n = 128 and 256 in the 16-word body), behind __syncwarp when a
// row sits inside one warp, else __syncthreads.  The shared row is
// XOR-swizzled (swz) with a padded stride of n + n/16 words, which makes
// every exchange of the 16-word body free of bank conflicts for every n
// (checked by tests/test_torch_ntt_banks.py's emulation).  The twiddle
// column of a register pair is base_t + C: base_t from the thread's own
// bits, once per stage; C from the register bits, a constant after
// unrolling, so it folds into the load's offset.  Small rings read the
// tables from a shared-memory copy, larger ones through __ldg.
//
// Column body (ntt_cols_kernel), the first forward / last inverse pass of
// a ring above 4096 words (u32 lane, up to 2^17): viewed as a
// (2^S, 2^(L-S)) matrix, stages over the top S bits pair words of one
// column.  A thread owns one column (2^S <= 32 words, strided by 2^(L-S)),
// neighbouring threads take neighbouring columns, so every load and store
// is coalesced; no shared memory.  The row body then runs stages over the
// low L - S = 12 bits on contiguous 4096-word chunks of the same ring.
// Words stay at their original indices between the two passes, so no
// extra twiddle multiply is needed.  The pre-weight rides on the first
// pass's load, the final reduce and the inverse epilogue on the last
// pass's store.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace ntt_regs {

using namespace modarith;

constexpr int kThreads = 256;  // most threads in a block
constexpr int kRowLog = 12;    // largest row of the row body: 4096 words

// Rotations of an L-bit index, t in [0, L].
__host__ __device__ constexpr uint32_t rotl(uint32_t v, int t, int L) {
  return ((v << t) | (v >> (L - t))) & ((1u << L) - 1u);
}
__host__ __device__ constexpr uint32_t rotr(uint32_t v, int t, int L) {
  return rotl(v, L - t, L);
}

// Register bits per phase (RB: 16 words a thread, fewer below n = 16; the
// small-batch body takes 2, 4 words), the phases, and the group of index
// bits phase k holds in registers: forward from the top, inverse from the
// bottom, the last group clamped to the index's ends.
__host__ __device__ constexpr int reg_bits(int LL) { return LL < 4 ? LL : 4; }
__host__ __device__ constexpr int phases(int LL, int RB) { return (LL + RB - 1) / RB; }
__host__ __device__ constexpr int group(bool fwd, int k, int LL, int RB) {
  return fwd ? (LL - RB * (k + 1) > 0 ? LL - RB * (k + 1) : 0)
             : (RB * k < LL - RB ? RB * k : LL - RB);
}
// Row-thread index i spread over the index bits outside [g, g + rb).
__host__ __device__ constexpr uint32_t deposit(uint32_t i, int g, int rb) {
  return (i & ((1u << g) - 1u)) | ((i >> g) << (g + rb));
}
// Shared-memory swizzle of a row index (linear over bits: swz(a ^ c) =
// swz(a) ^ swz(c)), and the padded row stride.
__host__ __device__ constexpr uint32_t swz(uint32_t l) {
  return l ^ ((l >> 4) & 31u);
}
__host__ __device__ constexpr int row_stride(int LL) {
  return (1 << LL) + (1 << LL) / 16;
}

// The reference's op sequence (modarith.cuh).  The band reduce
// s >= m ? s - m : s is written min(s, s - m): the same word for every
// u32 s, one instruction fewer.
template <typename T, bool kLazy>
struct Arith {
  uint32_t q, q2;

  __device__ __forceinline__ static uint32_t band(uint32_t s, uint32_t m) {
    return min(s, s - m);
  }
  // the stage multiply (and the forward pre-weight): [0, 2q) when lazy
  __device__ __forceinline__ uint32_t mul(uint32_t x, uint32_t w, uint32_t wp) const {
    const uint32_t r = lane_shoup_lazy<T>(x, w, wp, q);
    return kLazy ? r : band(r, q);
  }
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    return band(a + b, kLazy ? q2 : q);
  }
  __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) const {
    const uint32_t m = kLazy ? q2 : q;
    return a >= b ? a - b : a + (m - b);
  }
  __device__ __forceinline__ void fwd(uint32_t& lo, uint32_t& hi, uint32_t w,
                                      uint32_t wp) const {
    const uint32_t t = mul(hi, w, wp);
    hi = sub(lo, t);
    lo = add(lo, t);
  }
  __device__ __forceinline__ void inv(uint32_t& e, uint32_t& o, uint32_t w,
                                      uint32_t wp) const {
    const uint32_t d = sub(e, o);
    e = add(e, o);
    o = mul(d, w, wp);
  }
  // forward end: back to [0, q) when lazy and reduce_out
  __device__ __forceinline__ uint32_t fwd_out(uint32_t v, bool reduce_out) const {
    return (kLazy && reduce_out) ? band(v, q) : v;
  }
  // inverse epilogue multiply: exact unless lazy and not reduce_out
  __device__ __forceinline__ uint32_t inv_out(uint32_t v, uint32_t w, uint32_t wp,
                                              bool reduce_out) const {
    const uint32_t r = lane_shoup_lazy<T>(v, w, wp, q);
    return (kLazy && !reduce_out) ? r : band(r, q);
  }
};

// Per-prime tables and flags of one launch.  wrow/wrowp: the forward's psi
// row or the inverse's psi^-i * n^-1 row, (k, n); ninv/ninv_p: (k,).
template <typename T>
struct Tables {
  const T* qs;
  const T* tw;
  const T* twp;
  const T* wrow;
  const T* wrowp;
  const T* ninv;
  const T* ninv_p;
  int stages;
  bool negacyclic;
  bool reduce_out;
};

// R consecutive words as 16-byte vectors (p 16-byte aligned).
template <typename T, int R>
__device__ __forceinline__ void load_run(const T* p, uint32_t (&v)[R]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < R / kPer; ++u) {
    const uint4 a = *reinterpret_cast<const uint4*>(p + u * kPer);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (sizeof(T) == 4) {
        v[u * 4 + e] = w[e];
      } else {
        v[u * 8 + 2 * e] = w[e] & 0xFFFFu;
        v[u * 8 + 2 * e + 1] = w[e] >> 16;
      }
    }
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_run(T* p, const uint32_t (&v)[R]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < R / kPer; ++u) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (sizeof(T) == 4) {
        w[e] = v[u * 4 + e];
      } else {
        w[e] = (v[u * 8 + 2 * e] & 0xFFFFu) | (v[u * 8 + 2 * e + 1] << 16);
      }
    }
    *reinterpret_cast<uint4*>(p + u * kPer) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The stages of phase K of the row body, whose registers hold the group
// [g, g + RB) of an LL-bit row inside a GL-bit ring; obase = the thread's
// own index bits (its chunk's high bits included).  Forward: the phase's
// new bits b from the top down, stage t = GL-1-b.  Inverse: its new bits
// from the bottom up, applied stage b, table row stages-1-b.  A stage past
// `stages` does not run.  A: Arith, or any type with its fwd / inv (ntt.cu
// records each butterfly's (w, wp) with one).
template <typename T, bool kLazy, bool kFwd, int LL, int GL, int RB, int K, bool kStaged,
          typename A = Arith<T, kLazy>>
__device__ __forceinline__ void row_phase(uint32_t (&v)[1 << RB], const A& ar,
                                          const T* __restrict__ tw,
                                          const T* __restrict__ twp, int stages,
                                          uint32_t obase) {
  constexpr int R = 1 << RB;
  constexpr int g = group(kFwd, K, LL, RB);
  constexpr uint32_t kCol = (1u << (GL - 1)) - 1u;
  constexpr int lo = kFwd ? g : RB * K;
  constexpr int hi = kFwd ? LL - RB * K - 1 : (RB * (K + 1) < LL ? RB * (K + 1) : LL) - 1;
#pragma unroll
  for (int s = 0; s <= hi - lo; ++s) {
    const int b = kFwd ? hi - s : lo + s;
    const int rb = b - g;
    if (kFwd) {
      const int t = GL - 1 - b;
      if (t >= stages) continue;
      // the thread's base column first, so each register's constant
      // folds into the load's offset
      const uint32_t base = rotl(obase, t, GL) & kCol;
      const T* wr = tw + (size_t)t * (kCol + 1) + base;
      const T* wpr = twp + (size_t)t * (kCol + 1) + base;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r & (1 << rb)) continue;
        const uint32_t c = rotl((uint32_t)r << g, t, GL) & kCol;
        ar.fwd(v[r], v[r | (1 << rb)], kStaged ? wr[c] : __ldg(wr + c),
               kStaged ? wpr[c] : __ldg(wpr + c));
      }
    } else {
      if (b >= stages) continue;
      const uint32_t base = rotr(obase, b + 1, GL) & kCol;
      const T* wr = tw + (size_t)(stages - 1 - b) * (kCol + 1) + base;
      const T* wpr = twp + (size_t)(stages - 1 - b) * (kCol + 1) + base;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r & (1 << rb)) continue;
        const uint32_t c = rotr((uint32_t)r << g, b + 1, GL) & kCol;
        ar.inv(v[r], v[r | (1 << rb)], kStaged ? wr[c] : __ldg(wr + c),
               kStaged ? wpr[c] : __ldg(wpr + c));
      }
    }
  }
}

// The barrier of a row's threads: the warp's while a row sits inside one.
template <bool kWarp>
__device__ __forceinline__ void row_sync() {
  if (kWarp) __syncwarp(); else __syncthreads();
}

// Between phases K and K+1: the row through shared memory, from the
// registers of group(K) to those of group(K + 1).  The barrier before the
// writes keeps the previous exchange's reads (of this tile or the last)
// ahead of them.
template <int LL, int RB, bool kFwd, int K, bool kWarp>
__device__ __forceinline__ void row_exchange(uint32_t (&v)[1 << RB], uint32_t* srow,
                                             uint32_t i) {
  constexpr int R = 1 << RB;
  constexpr int g1 = group(kFwd, K, LL, RB);
  constexpr int g2 = group(kFwd, K + 1, LL, RB);
  row_sync<kWarp>();
  const uint32_t s1 = swz(deposit(i, g1, RB));
#pragma unroll
  for (int r = 0; r < R; ++r) srow[s1 ^ swz((uint32_t)r << g1)] = v[r];
  row_sync<kWarp>();
  const uint32_t s2 = swz(deposit(i, g2, RB));
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = srow[s2 ^ swz((uint32_t)r << g2)];
}

// Phase K's stages, then (while phases remain) the exchange to phase K+1
// and the rest: the whole stage schedule of one tile.
template <typename T, bool kLazy, bool kFwd, int LL, int GL, int RB, bool kStaged, int K>
__device__ __forceinline__ void row_stages(uint32_t (&v)[1 << RB], const Arith<T, kLazy>& ar,
                                           const T* tw, const T* twp, int stages,
                                           uint32_t ohigh, uint32_t i, uint32_t* srow) {
  row_phase<T, kLazy, kFwd, LL, GL, RB, K, kStaged>(
      v, ar, tw, twp, stages, ohigh | deposit(i, group(kFwd, K, LL, RB), RB));
  if constexpr (K + 1 < phases(LL, RB)) {
    row_exchange<LL, RB, kFwd, K, (1 << (LL - RB)) <= 32>(v, srow, i);
    row_stages<T, kLazy, kFwd, LL, GL, RB, kStaged, K + 1>(v, ar, tw, twp, stages, ohigh, i,
                                                         srow);
  }
}

// Bytes of a prime's staged stage-table pair, when the row body keeps it
// in shared memory (small rings; larger ones read it through __ldg).
template <typename T, int LL, int GL>
__host__ __device__ constexpr int staged_table_bytes() {
  return (GL == LL && GL * (1 << (GL - 1)) * 2 * (int)sizeof(T) <= 24 * 1024)
             ? GL * (1 << (GL - 1)) * 2 * (int)sizeof(T)
             : 0;
}

// One stage-table array of `words` T's into shared memory, copied by the
// whole block: as 16-byte vectors when vec (both ends 16-byte aligned),
// unrolled so each thread keeps four loads in flight.
template <typename T>
__device__ __forceinline__ void stage_table(T* dst, const T* src, size_t words,
                                            bool vec) {
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const size_t n4 = words * sizeof(T) / 16;
#pragma unroll 4
    for (size_t e = threadIdx.x; e < n4; e += blockDim.x) d4[e] = __ldg(s4 + e);
  } else {
    for (size_t e = threadIdx.x; e < words; e += blockDim.x) dst[e] = __ldg(src + e);
  }
}

// Rows of 2^LL words: every batch row of the ring (LL == GL), or the
// 4096-word chunks of a ring of 2^GL words (LL < GL, the pass after the
// column pass forward, before it inverse).  A tile is blockDim.x / TPR
// rows of one prime; the grid is persistent (at most one wave) and a block
// walks the (prime, tile) pairs with a stride of gridDim.x.  Small rings
// (staged_table_bytes) keep their prime's table pair in shared memory,
// copied by the whole block when its prime changes, so the stages read
// their twiddles from shared memory.  A thread of a row past `rows` runs
// the barriers but loads and stores nothing.  vec_io: x and out 16-byte
// aligned; vec_tables: the tables 16-byte aligned, rows of whole vectors.
template <typename T, bool kLazy, bool kFwd, int LL, int GL, int RB>
__global__ void __launch_bounds__(kThreads)
ntt_rows_kernel(const T* __restrict__ x, T* __restrict__ out, Tables<T> tb,
                int k, int rows, int tiles, bool vec_io, bool vec_tables) {
  constexpr int R = 1 << RB;
  constexpr int TPR = 1 << (LL - RB);
  constexpr int P = phases(LL, RB);
  constexpr int NL = 1 << LL;
  constexpr int H = 1 << (GL - 1);
  constexpr bool kPre = kFwd && GL == LL;    // the first pass takes the pre-weight
  constexpr bool kFinal = kFwd || GL == LL;  // the last pass ends the transform
  constexpr bool kVec = (R * sizeof(T)) % 16 == 0;
  constexpr bool kStaged = staged_table_bytes<T, LL, GL>() > 0;
  extern __shared__ __align__(16) uint32_t smem[];

  const int rpb = blockDim.x / TPR;
  const int lr = threadIdx.x / TPR;
  const uint32_t i = threadIdx.x % TPR;
  const int total = k * tiles;
  const size_t th = (size_t)tb.stages * H;  // words of one stage table
  uint32_t* srow = smem + lr * row_stride(LL);
  T* stw = reinterpret_cast<T*>(smem + (P > 1 ? rpb * row_stride(LL) : 0));
  int staged = -1;                           // the prime whose tables are in stw

  constexpr int g0 = group(kFwd, 0, LL, RB);
  const uint32_t b0 = deposit(i, g0, RB);
  // raw words of tile t's row for this thread (zeros past `rows`)
  auto load = [&](int t, uint32_t (&d)[R]) {
    const int p = t / tiles;
    const int row = (t - p * tiles) * rpb + lr;
    if (row >= rows) {
#pragma unroll
      for (int r = 0; r < R; ++r) d[r] = 0;
      return;
    }
    // b0 and r << g0 share no bit: base pointer plus a constant offset
    const T* xb = x + ((size_t)p * rows + row) * NL + b0;
    if (kVec && g0 == 0 && vec_io) {
      load_run<T, R>(xb, d);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) d[r] = xb[r << g0];
    }
  };

  if ((int)blockIdx.x >= total) return;     // the whole block: uniform
  uint32_t v[R];
  load(blockIdx.x, v);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int p = t / tiles;
    const int row = (t - p * tiles) * rpb + lr;
    const bool active = row < rows;
    const int next = t + gridDim.x;

    const uint32_t q = tb.qs[p];
    const Arith<T, kLazy> ar{q, q << 1};
    const T* tw = tb.tw + p * th;
    const T* twp = tb.twp + p * th;
    if constexpr (kStaged) {
      if (p != staged) {                     // p is the block's: uniform
        __syncthreads();
        stage_table(stw, tw, th, vec_tables);
        stage_table(stw + th, twp, th, vec_tables);
        __syncthreads();
        staged = p;
      }
      tw = stw;
      twp = stw + th;
    }
    if (kPre && tb.negacyclic && active) {
      const T* pw = tb.wrow + (size_t)p * NL + b0;
      const T* pwp = tb.wrowp + (size_t)p * NL + b0;
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = ar.mul(v[r], pw[r << g0], pwp[r << g0]);
    }

    const uint32_t ohigh = ((uint32_t)row & ((1u << (GL - LL)) - 1u)) << LL;
    row_stages<T, kLazy, kFwd, LL, GL, RB, kStaged, 0>(v, ar, tw, twp, tb.stages, ohigh, i,
                                                      srow);

    constexpr int gl = group(kFwd, P - 1, LL, RB);
    const uint32_t bl = deposit(i, gl, RB);
    const bool moved = kFinal && tb.stages != GL;  // an incomplete ring: uniform
    const size_t at = ((size_t)p * rows + row) * NL;
    if (kFinal && active) {
      if (kFwd) {
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = ar.fwd_out(v[r], tb.reduce_out);
      } else {
        const uint32_t wn = tb.ninv[p], wnp = tb.ninv_p[p];
        const T* pw = tb.wrow + (size_t)p * NL;
        const T* pwp = tb.wrowp + (size_t)p * NL;
        if (!tb.negacyclic) {
#pragma unroll
          for (int r = 0; r < R; ++r) v[r] = ar.inv_out(v[r], wn, wnp, tb.reduce_out);
        } else if (!moved) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            v[r] = ar.inv_out(v[r], pw[bl + (r << gl)], pwp[bl + (r << gl)], tb.reduce_out);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const uint32_t pos = rotr(bl | ((uint32_t)r << gl), tb.stages, GL);
            v[r] = ar.inv_out(v[r], pw[pos], pwp[pos], tb.reduce_out);
          }
        }
      }
    }
    if constexpr (GL == LL && P > 1) {
      if (moved) {
        // the words to their output positions through the shared row, then
        // out as runs of R consecutive words (16-byte vectors when aligned)
        row_sync<(TPR <= 32)>();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t o = bl | ((uint32_t)r << gl);
          srow[swz(kFwd ? rotl(o, tb.stages, GL) : rotr(o, tb.stages, GL))] = v[r];
        }
        row_sync<(TPR <= 32)>();
        const uint32_t c0 = i << RB;
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = srow[swz(c0 | r)];
        if (active) {
          T* ob = out + at + c0;
          if (kVec && vec_io) {
            store_run<T, R>(ob, v);
          } else {
#pragma unroll
            for (int r = 0; r < R; ++r) ob[r] = (T)v[r];
          }
        }
        if (next < total) load(next, v);
        continue;
      }
    }
    if (active) {
      if (!moved) {
        T* ob = out + at + bl;
        if (kVec && gl == 0 && vec_io) {
          store_run<T, R>(ob, v);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) ob[r << gl] = (T)v[r];
        }
      } else {
        // a chunk's words may land in other chunks of its ring: one by one
        T* ring = out + at - ohigh;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t o = ohigh | bl | ((uint32_t)r << gl);
          ring[kFwd ? rotl(o, tb.stages, GL) : rotr(o, tb.stages, GL)] = (T)v[r];
        }
      }
    }
    if (next < total) load(next, v);
  }
}

// One column of a (2^S, 2^(GL-S)) view of each ring per thread: the
// forward's first pass (pre-weight, stages 0 .. S-1 over the top S bits,
// words back at their own indices) or the inverse's last pass (applied
// stages GL-S .. GL-1, epilogue, output positions).  u32 lane only.
template <bool kLazy, bool kFwd, int S, int GL>
__global__ void __launch_bounds__(kThreads)
ntt_cols_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                Tables<uint32_t> tb, int b) {
  constexpr int R = 1 << S;
  constexpr int MB = GL - S;                 // column bits
  constexpr uint32_t kCol = (1u << (GL - 1)) - 1u;
  const int p = blockIdx.y;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long ring = tid >> MB;
  if (ring >= b) return;                     // no barrier in this kernel
  const uint32_t c = (uint32_t)tid & ((1u << MB) - 1u);
  const uint32_t q = tb.qs[p];
  const Arith<uint32_t, kLazy> ar{q, q << 1};
  const size_t at = ((size_t)p * b + ring) << GL;
  const uint32_t* tw = tb.tw + (size_t)p * tb.stages * (kCol + 1);
  const uint32_t* twp = tb.twp + (size_t)p * tb.stages * (kCol + 1);
  const uint32_t* pw = tb.wrow + ((size_t)p << GL);
  const uint32_t* pwp = tb.wrowp + ((size_t)p << GL);
  uint32_t v[R];
  const uint32_t* xc = x + at + c;
#pragma unroll
  for (int a = 0; a < R; ++a) v[a] = xc[a << MB];

  if (kFwd) {
    if (tb.negacyclic) {
#pragma unroll
      for (int a = 0; a < R; ++a) v[a] = ar.mul(v[a], pw[c + (a << MB)], pwp[c + (a << MB)]);
    }
#pragma unroll
    for (int t = 0; t < S; ++t) {
      if (t >= tb.stages) break;
      const int ab = S - 1 - t;              // bit GL-1-t of the index
      const uint32_t base = rotl(c, t, GL) & kCol;
      const uint32_t* wr = tw + (size_t)t * (kCol + 1) + base;
      const uint32_t* wpr = twp + (size_t)t * (kCol + 1) + base;
#pragma unroll
      for (int a = 0; a < R; ++a) {
        if (a & (1 << ab)) continue;
        const uint32_t j = rotl((uint32_t)a << MB, t, GL) & kCol;
        ar.fwd(v[a], v[a | (1 << ab)], __ldg(wr + j), __ldg(wpr + j));
      }
    }
    uint32_t* oc = out + at + c;
#pragma unroll
    for (int a = 0; a < R; ++a) oc[a << MB] = v[a];
  } else {
#pragma unroll
    for (int ab = 0; ab < S; ++ab) {
      const int bit = MB + ab;
      if (bit >= tb.stages) break;
      const uint32_t base = rotr(c, bit + 1, GL) & kCol;
      const uint32_t* wr = tw + (size_t)(tb.stages - 1 - bit) * (kCol + 1) + base;
      const uint32_t* wpr = twp + (size_t)(tb.stages - 1 - bit) * (kCol + 1) + base;
#pragma unroll
      for (int a = 0; a < R; ++a) {
        if (a & (1 << ab)) continue;
        const uint32_t j = rotr((uint32_t)a << MB, bit + 1, GL) & kCol;
        ar.inv(v[a], v[a | (1 << ab)], __ldg(wr + j), __ldg(wpr + j));
      }
    }
    const bool moved = tb.stages != GL;
    const uint32_t wn = tb.ninv[p], wnp = tb.ninv_p[p];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const uint32_t o = ((uint32_t)a << MB) + c;
      const uint32_t pos = moved ? rotr(o, tb.stages, GL) : o;
      out[at + pos] = tb.negacyclic ? ar.inv_out(v[a], pw[pos], pwp[pos], tb.reduce_out)
                                    : ar.inv_out(v[a], wn, wnp, tb.reduce_out);
    }
  }
}

// ------------------------------------------------- host-side helpers

inline int ilog2(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

}  // namespace ntt_regs
