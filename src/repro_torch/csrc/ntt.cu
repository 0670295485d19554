// Single-prime NTT for Hopper (sm_90a): the paper's NTT unit (NTT-128 at
// N = 128, 32-bit coefficients, one prime), forward and inverse
// constant-geometry transforms over a batch of rows of up to 4096 words.
//
// Replaces the TPU kernels of src/repro/kernels/ntt_kernel.py:
//   ntt_fwd  <- ntt_fwd_pallas  (_ntt_fwd_kernel)
//   ntt_inv  <- ntt_inv_pallas  (_ntt_inv_kernel)
// Every log2(n) stage runs (complete ring).  The forward transform
// pre-weights by psi^i when negacyclic; lazy keeps [0, 2q) between stages
// and always reduces at the end.  The inverse ends with the exact Shoup
// multiply by psi^-i * n^-1 (negacyclic) or n^-1 (cyclic), so its output
// is in [0, q) either way.  Same butterflies, (w, wp) and op sequence as
// the reference (ntt_regs.cuh's Arith), so the words are the reference's.
//
// What bounds them on an H100: device memory.  A transform reads each word
// once and writes it once (8 bytes per word); in between it runs
// log2(n)/2 butterflies per word at 8 integer instructions each (lazy), so
// at n = 128 the integer work is about three quarters of the bytes' time
// and the rest of the budget is small.
//
// What the design does about it: the row stream (ntt_stream_kernel), for
// rings of 64 .. 4096 words.  The batch is one contiguous (B, n) array and
// every row shares one table, so a persistent block owns a contiguous
// range of rows (an even split of B over at most one wave of blocks) and
// streams it through a ring of kSlots shared-memory tiles of 16 rows of
// 128 words (kStreamThreads * 16 words; one row from 2048 words up):
// Hopper's bulk copy (cp.async.bulk, one per row, completion counted in
// bytes on the slot's mbarrier) lands the next tiles while the block
// transforms this one, so the loads do not wait on the butterflies.  A
// tile row sits at the padded stride n + n/16, which makes the forward's
// first read (16 words a thread, strided) free of bank conflicts, and the
// lanes of a warp take its rows in turn, which at n = 64 and 128 spreads
// the 16-byte accesses (the inverse's first read, the forward's results:
// 16 consecutive words a thread) over 4 and 2 times more bank quads.  The words then
// run ntt_regs.cuh's register schedule (16 to a thread under their
// original indices, the swizzled exchange inside the same tile row).  Up
// to 512 words the table pair is copied to shared memory once per block
// and a negacyclic thread keeps its 16 weight pairs in registers; above,
// where the (stages, n/2) table's columns would scatter a warp's reads
// over many L2 sectors, each thread reads its stage's 8 (w, wp) pairs as
// 16-byte loads from a thread-major copy of the table (tm_phase), which
// thread_major_kernel builds once per table by running row_phase itself
// and recording the (w, wp) each butterfly reads.  Results go back into
// the tile row in the last phase's layout and leave by bulk copy (shared
// to global, one per row); a slot is refilled once its store has read it.
// 3 slots and 128 threads measured best on an H100 (PERF.md).
//
// The stream takes rings of 64 .. 4096 words (a smaller row is shorter
// than one 16-byte-aligned padded tile row) with x and out 16-byte
// aligned (bulk copies need it), and refuses anything else.  The Python
// wrappers run every other ring and view as a one-prime bank
// (ntt_banks.cu): its row body loads and stores each thread's words
// itself, and above 4096 words it takes two passes through scratch.
#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"
#include "host.cuh"
#include "modarith.cuh"
#include "ntt_regs.cuh"

namespace {

using bulk::bulk_commit;
using bulk::bulk_load;
using bulk::bulk_store;
using bulk::bulk_wait_all;
using bulk::bulk_wait_read;
using bulk::fence_proxy_async;
using bulk::mbar_expect_tx;
using bulk::mbar_init;
using bulk::mbar_wait;
using host::aligned16;
using host::sm_count;
using ntt_regs::Arith;
using ntt_regs::ilog2;
using ntt_regs::Tables;

constexpr int kSlots = 3;                 // tiles in flight or in use per block
constexpr int kStreamThreads = 128;       // most threads in a stream block
constexpr int kStreamLog = 6;             // the stream takes rings of 64 words up
constexpr int kMaxLog = 12;               // ... to 4096
constexpr int kBarBytes = 128;            // the slots' mbarriers, ahead of the tiles
constexpr long long kWantBlocks = 4 * 132;  // tiles that fill 132 SMs

static_assert(kSlots >= 2 && kSlots * 8 <= kBarBytes, "2 .. 16 slots");

// ------------------------------------------------------ the row stream

// The thread-major copy of a ring's stage table: entry (a, i, c) holds
// the (w, wp) of thread i's c-th butterfly of applied stage a (the
// forward's stage t, the inverse's b), 16 words a thread.  Phases and
// stages run in that order, 8 butterflies a stage, so a thread's m-th
// butterfly is entry (m / 8, i, m % 8).  Record stands in for Arith in
// ntt_regs::row_phase and stores each butterfly's pair there, so the copy
// holds exactly the twiddles the row body would read.
struct Record {
  uint32_t* w;
  uint32_t* wp;
  uint32_t stride;  // words from one stage's entries to the next's
  mutable uint32_t m;

  __device__ __forceinline__ void put(uint32_t a, uint32_t b) const {
    const uint32_t at = (m >> 3) * stride + (m & 7u);
    w[at] = a;
    wp[at] = b;
    ++m;
  }
  __device__ __forceinline__ void fwd(uint32_t&, uint32_t&, uint32_t a, uint32_t b) const {
    put(a, b);
  }
  __device__ __forceinline__ void inv(uint32_t&, uint32_t&, uint32_t a, uint32_t b) const {
    put(a, b);
  }
};

template <bool kFwd, int LL, int K>
__device__ __forceinline__ void record_phases(uint32_t (&v)[16], const Record& rec,
                                              const uint32_t* tw, const uint32_t* twp,
                                              uint32_t i) {
  ntt_regs::row_phase<uint32_t, true, kFwd, LL, LL, 4, K, false>(
      v, rec, tw, twp, LL, ntt_regs::deposit(i, ntt_regs::group(kFwd, K, LL, 4), 4));
  if constexpr (K + 1 < ntt_regs::phases(LL, 4))
    record_phases<kFwd, LL, K + 1>(v, rec, tw, twp, i);
}

// One thread per row-thread index i of a ring of 2^LL words.
template <bool kFwd, int LL>
__global__ void thread_major_kernel(const uint32_t* __restrict__ tw,
                                    const uint32_t* __restrict__ twp, uint32_t* twt,
                                    uint32_t* twpt) {
  constexpr uint32_t TPR = 1u << (LL - 4);
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= TPR) return;
  const Record rec{twt + 8 * i, twpt + 8 * i, 8 * TPR, 0};
  uint32_t v[16] = {};
  record_phases<kFwd, LL, 0>(v, rec, tw, twp, i);
}

// The stages of phase K with their twiddles from the thread-major table
// (rings above staged_table_bytes, where the (stages, n/2) table's columns
// scatter a warp's reads over many L2 sectors).  A thread reads its 8
// pairs of a stage as four 16-byte loads, a warp 32 consecutive entries.
template <bool kLazy, bool kFwd, int LL, int K>
__device__ __forceinline__ void tm_phase(uint32_t (&v)[16], const Arith<uint32_t, kLazy>& ar,
                                         const uint4* __restrict__ w4,
                                         const uint4* __restrict__ wp4, uint32_t i) {
  constexpr int RB = 4;
  constexpr int TPR = 1 << (LL - RB);
  constexpr int g = ntt_regs::group(kFwd, K, LL, RB);
  constexpr int lo = kFwd ? g : RB * K;
  constexpr int hi = kFwd ? LL - RB * K - 1 : (RB * (K + 1) < LL ? RB * (K + 1) : LL) - 1;
#pragma unroll
  for (int s = 0; s <= hi - lo; ++s) {
    const int b = kFwd ? hi - s : lo + s;
    const int rb = b - g;
    const size_t at = ((size_t)(kFwd ? LL - 1 - b : b) * TPR + i) * 2;
    const uint4 wa = __ldg(w4 + at), wb = __ldg(w4 + at + 1);
    const uint4 pa = __ldg(wp4 + at), pb = __ldg(wp4 + at + 1);
    const uint32_t w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
    const uint32_t wp[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
    int c = 0;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (r & (1 << rb)) continue;
      if (kFwd) {
        ar.fwd(v[r], v[r | (1 << rb)], w[c], wp[c]);
      } else {
        ar.inv(v[r], v[r | (1 << rb)], w[c], wp[c]);
      }
      ++c;
    }
  }
}

template <bool kLazy, bool kFwd, int LL, int K>
__device__ __forceinline__ void tm_stages(uint32_t (&v)[16], const Arith<uint32_t, kLazy>& ar,
                                          const uint4* w4, const uint4* wp4, uint32_t i,
                                          uint32_t* srow) {
  tm_phase<kLazy, kFwd, LL, K>(v, ar, w4, wp4, i);
  if constexpr (K + 1 < ntt_regs::phases(LL, 4)) {
    ntt_regs::row_exchange<LL, 4, kFwd, K, ((1 << (LL - 4)) <= 32)>(v, srow, i);
    tm_stages<kLazy, kFwd, LL, K + 1>(v, ar, w4, wp4, i, srow);
  }
}

// Shared memory of a block of `threads` threads: the barriers, kSlots
// tiles of rows at the padded stride, the staged table pair.
template <int LL>
constexpr size_t stream_smem(int threads) {
  return kBarBytes +
         (size_t)kSlots * (threads >> (LL - 4)) * ntt_regs::row_stride(LL) * sizeof(uint32_t) +
         ntt_regs::staged_table_bytes<uint32_t, LL, LL>();
}

// Rows of 2^LL words (LL >= kStreamLog: a row is 256 bytes or more, and
// its padded stride a multiple of 16 bytes), x and out 16-byte aligned.
// Block g owns rows [g*b/G, (g+1)*b/G); its tiles are blockDim.x / TPR
// consecutive rows of that range (the last one short), tile t in slot
// t % kSlots.  Warp 0's lanes issue the copies, lane l those of rows l,
// l + 32, ... of a tile; slot s's barrier completes once per fill, so
// the m-th fill is waited on with parity m & 1.  A slot holds tile t's
// words, then its results until their bulk store has read them; so once
// tile t is stored, the slot of tile t - 1, whose store has read it by
// then (wait_group.read 1), takes tile t - 1 + kSlots.  A thread of a row
// past the range computes on stale words, and its row is not stored.
// kNeg: negacyclic (the pre- or post-weights); twt/twpt: the thread-major
// stage tables when the ring's table pair is not staged.
template <bool kLazy, bool kFwd, bool kNeg, int LL>
__global__ void __launch_bounds__(ntt_regs::kThreads)
ntt_stream_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  Tables<uint32_t> tb, const uint32_t* __restrict__ twt,
                  const uint32_t* __restrict__ twpt, int b, bool vec_tables) {
  constexpr int RB = 4;
  constexpr int R = 1 << RB;
  constexpr int TPR = 1 << (LL - RB);
  constexpr int P = ntt_regs::phases(LL, RB);
  constexpr int NL = 1 << LL;
  constexpr int SR = ntt_regs::row_stride(LL);
  constexpr uint32_t kRowBytes = NL * sizeof(uint32_t);
  constexpr bool kStaged = ntt_regs::staged_table_bytes<uint32_t, LL, LL>() > 0;
  constexpr int kAhead = kSlots - 1;  // tiles issued before the first
  constexpr int g0 = ntt_regs::group(kFwd, 0, LL, RB);
  constexpr int gl = ntt_regs::group(kFwd, P - 1, LL, RB);
  static_assert(LL >= kStreamLog && LL <= kMaxLog && P > 1, "rows of 64 .. 4096 words");
  static_assert(!kFwd || gl == 0, "the forward ends on consecutive words");
  static_assert(kStreamThreads <= ntt_regs::kThreads, "at most kThreads a block");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint32_t* tiles_smem = reinterpret_cast<uint32_t*>(smem_raw + kBarBytes);

  const int rpb = blockDim.x / TPR;
  const int slot_words = rpb * SR;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // a warp's rows take its lanes in turn (lane % RPW is the row), which
  // spreads a quarter warp's 16-byte accesses over rows at n = 64 and 128
  constexpr int RPW = TPR < 32 ? 32 / TPR : 1;  // rows a warp holds
  const int lr = TPR < 32 ? warp * RPW + lane % RPW : threadIdx.x / TPR;
  const uint32_t i = TPR < 32 ? lane / RPW : threadIdx.x % TPR;
  const long long first = (long long)blockIdx.x * b / gridDim.x;
  const int rows = (int)((long long)(blockIdx.x + 1) * b / gridDim.x - first);
  const int tiles = (rows + rpb - 1) / rpb;
  const uint32_t* xb = x + first * NL;
  uint32_t* ob = out + first * NL;

  const uint32_t q = tb.qs[0];
  const Arith<uint32_t, kLazy> ar{q, q << 1};
  const uint32_t wn = kFwd || kNeg ? 0u : tb.ninv[0];  // the cyclic inverse's n^-1
  const uint32_t wnp = kFwd || kNeg ? 0u : tb.ninv_p[0];
  const uint32_t* tw = tb.tw;
  const uint32_t* twp = tb.twp;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(full + s);
    bulk::fence_mbar_init();
  }
  if constexpr (kStaged) {
    uint32_t* stw = tiles_smem + kSlots * slot_words;
    constexpr size_t th = (size_t)LL * (NL / 2);
    ntt_regs::stage_table(stw, tw, th, vec_tables);
    ntt_regs::stage_table(stw + th, twp, th, vec_tables);
    tw = stw;
    twp = stw + th;
  }
  __syncthreads();

  auto issue = [&](int t) {  // warp 0, all lanes
    const int s = t % kSlots;
    const int nr = min(rpb, rows - t * rpb);
    if (lane == 0) mbar_expect_tx(full + s, nr * kRowBytes);
    __syncwarp();
    for (int r = lane; r < nr; r += 32)
      bulk_load(tiles_smem + s * slot_words + r * SR, xb + (size_t)(t * rpb + r) * NL,
                kRowBytes, full + s);
  };
  if (warp == 0)
    for (int t = 0; t < kAhead && t < tiles; ++t) issue(t);

  const uint32_t b0 = ntt_regs::deposit(i, g0, RB);
  const uint32_t bl = ntt_regs::deposit(i, gl, RB);
  // a small ring's thread keeps its pre- or post-weights in registers for
  // all its tiles; a large one has few tiles and reads them per tile
  constexpr bool kHold = kNeg && kStaged;
  uint32_t wv[kHold ? R : 1], wpv[kHold ? R : 1];
  if constexpr (kHold) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t at = kFwd ? b0 + (r << g0) : bl + (r << gl);
      wv[r] = __ldg(tb.wrow + at);
      wpv[r] = __ldg(tb.wrowp + at);
    }
  }
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kSlots;
    uint32_t* slot = tiles_smem + s * slot_words;
    uint32_t* srow = slot + lr * SR;
    const int row = t * rpb + lr;  // in the block's range
    uint32_t v[R];
    mbar_wait(full + s, (uint32_t)(t / kSlots) & 1u);
    if constexpr (g0 == 0) {
      ntt_regs::load_run<uint32_t, R>(srow + b0, v);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = srow[b0 + (r << g0)];
    }
    if constexpr (kFwd && kNeg) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = kHold ? ar.mul(v[r], wv[r], wpv[r])
                     : ar.mul(v[r], __ldg(tb.wrow + b0 + (r << g0)), __ldg(tb.wrowp + b0 + (r << g0)));
    }
    if constexpr (kStaged) {
      ntt_regs::row_stages<uint32_t, kLazy, kFwd, LL, LL, RB, true, 0>(v, ar, tw, twp, LL, 0u,
                                                                      i, srow);
    } else {
      tm_stages<kLazy, kFwd, LL, 0>(v, ar, reinterpret_cast<const uint4*>(twt),
                                    reinterpret_cast<const uint4*>(twpt), i, srow);
    }
    if constexpr (kFwd) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = ar.fwd_out(v[r], true);
      ntt_regs::row_sync<(TPR <= 32)>();  // the last exchange's reads first
      ntt_regs::store_run<uint32_t, R>(srow + bl, v);
    } else {
      if constexpr (kNeg) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          v[r] = kHold ? ar.inv_out(v[r], wv[r], wpv[r], true)
                       : ar.inv_out(v[r], __ldg(tb.wrow + bl + (r << gl)),
                                    __ldg(tb.wrowp + bl + (r << gl)), true);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = ar.inv_out(v[r], wn, wnp, true);
      }
      ntt_regs::row_sync<(TPR <= 32)>();  // the last exchange's reads first
#pragma unroll
      for (int r = 0; r < R; ++r) srow[bl + (r << gl)] = v[r];
    }
    fence_proxy_async();
    __syncthreads();
    if (warp == 0) {
      {
        const int nr = min(rpb, rows - t * rpb);
        for (int r = lane; r < nr; r += 32)
          bulk_store(ob + (size_t)(t * rpb + r) * NL, slot + r * SR, kRowBytes);
        bulk_commit();
        bulk_wait_read<1>();  // tile t - 1's store has read its slot
      }
      if (t + kAhead < tiles) issue(t + kAhead);
    }
  }
  if (warp == 0) bulk_wait_all();
}

// ------------------------------------------------------------ launch

inline bool tables_vec(const Tables<uint32_t>& tb, int n) {
  return aligned16(tb.tw) && aligned16(tb.twp) &&
         ((size_t)ilog2(n) * (n / 2) * sizeof(uint32_t)) % 16 == 0;
}

// A ring's thread-major stage tables (thread_major_kernel); read only by
// rings above staged_table_bytes.
struct ThreadMajor {
  const uint32_t* w;
  const uint32_t* wp;
};

// kStreamThreads a block (a row's TPR threads at least), halved while
// fewer than kWantBlocks tiles would result (down to one row, and one
// warp); a persistent grid of at most one wave of blocks, the resident
// blocks a SM read once a card per block size and shared-memory size.
template <bool kLazy, bool kFwd, int LL>
int launch(const uint32_t* x, uint32_t* out, const Tables<uint32_t>& tb, const ThreadMajor& tm,
           int b, cudaStream_t s) {
  constexpr int TPR = 1 << (LL - 4);
  constexpr int kMost = kStreamThreads > TPR ? kStreamThreads : TPR;
  constexpr int kLeast = TPR > 32 ? TPR : 32;
  if (!aligned16(x) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  if (ntt_regs::staged_table_bytes<uint32_t, LL, LL>() == 0 &&
      !(aligned16(tm.w) && aligned16(tm.wp) && tm.w != nullptr && tm.wp != nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = tb.negacyclic ? &ntt_stream_kernel<kLazy, kFwd, true, LL>
                              : &ntt_stream_kernel<kLazy, kFwd, false, LL>;
  const int neg = tb.negacyclic ? 1 : 0;
  // above 48 KB: once a card, for the largest block
  static bool opted_in[host::kMaxDevices][2] = {};
  const int dev = host::current_device();
  if (!host::kept(dev) || !opted_in[dev][neg]) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)stream_smem<LL>(kMost));
    if (e != cudaSuccess) return (int)e;
    if (host::kept(dev)) opted_in[dev][neg] = true;
  }
  int tpb = kMost;
  while (tpb > kLeast && ((long long)b + tpb / TPR - 1) / (tpb / TPR) < kWantBlocks) tpb /= 2;
  const size_t smem = stream_smem<LL>(tpb);
  static int per_sm[host::kMaxDevices][2][4] = {};  // [card][neg][log2(tpb / 32)]
  static size_t sizes[host::kMaxDevices][2][4] = {};
  const int slot = ilog2(tpb) - 5;
  int blocks = host::kept(dev) && sizes[dev][neg][slot] == smem ? per_sm[dev][neg][slot] : 0;
  if (blocks == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, tpb, smem);
    if (e != cudaSuccess) return (int)e;
    if (blocks <= 0) blocks = 1;
    if (host::kept(dev)) {
      sizes[dev][neg][slot] = smem;
      per_sm[dev][neg][slot] = blocks;
    }
  }
  const int rpb = tpb / TPR;
  const long long tiles = ((long long)b + rpb - 1) / rpb;
  const long long wave = (long long)blocks * sm_count();
  const dim3 grid((unsigned)(tiles < wave ? tiles : wave));
  kernel<<<grid, tpb, smem, s>>>(x, out, tb, tm.w, tm.wp, b, tables_vec(tb, 1 << LL));
  return (int)cudaGetLastError();
}

template <bool kLazy, bool kFwd>
int dispatch(const uint32_t* x, uint32_t* out, const Tables<uint32_t>& tb,
             const ThreadMajor& tm, int b, int n, cudaStream_t s) {
  switch (ilog2(n)) {
#define NTT_RING(L) \
  case L:           \
    return launch<kLazy, kFwd, L>(x, out, tb, tm, b, s);
    NTT_RING(6) NTT_RING(7) NTT_RING(8) NTT_RING(9) NTT_RING(10) NTT_RING(11) NTT_RING(12)
#undef NTT_RING
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int transform(bool fwd, const void* x, void* out, const Tables<uint32_t>& tb,
              const ThreadMajor& tm, int b, int n, bool lazy, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  if (n < (1 << kStreamLog) || n > (1 << kMaxLog) || (n & (n - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  if (fwd)
    return lazy ? dispatch<true, true>(xi, o, tb, tm, b, n, s)
                : dispatch<false, true>(xi, o, tb, tm, b, n, s);
  return lazy ? dispatch<true, false>(xi, o, tb, tm, b, n, s)
              : dispatch<false, false>(xi, o, tb, tm, b, n, s);
}

template <bool kFwd, int LL>
int launch_thread_major(const uint32_t* tw, const uint32_t* twp, uint32_t* twt, uint32_t* twpt,
                        cudaStream_t s) {
  constexpr int TPR = 1 << (LL - 4);
  constexpr int tpb = TPR < 128 ? TPR : 128;
  thread_major_kernel<kFwd, LL><<<TPR / tpb, tpb, 0, s>>>(tw, twp, twt, twpt);
  return (int)cudaGetLastError();
}

inline const uint32_t* u32(const void* p) { return static_cast<const uint32_t*>(p); }

}  // namespace

// Every launcher returns the CUDA error of configuring or launching its
// kernel; the Python wrapper raises on a non-zero code.  Shapes are checked
// by the wrapper: x/out (b, n) uint32 (int32 bit patterns), both 16-byte
// aligned, n a power of two in [64, 4096]; the prime's tables as a
// one-prime bank (the TablePack layout with k = 1): qs, ninv, ninv_p (1,),
// stage tables (1, log2 n, n/2), rows (1, n); twt/twpt (itwt/itwpt) the
// same stage tables thread-major (ntt_thread_major's output); all
// contiguous.

// tw/twp (log2 n, n/2) -> twt/twpt, their thread-major copy of the same
// size, for the forward (fwd != 0) or the inverse; n in [64, 4096].
extern "C" int ntt_thread_major(const void* tw, const void* twp, void* twt, void* twpt, int n,
                                int fwd, void* stream) {
  auto* s = static_cast<cudaStream_t>(stream);
  auto* wt = static_cast<uint32_t*>(twt);
  auto* wpt = static_cast<uint32_t*>(twpt);
  if ((n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  switch (ilog2(n)) {
#define NTT_RING(L)                                                               \
  case L:                                                                         \
    return fwd ? launch_thread_major<true, L>(u32(tw), u32(twp), wt, wpt, s)      \
               : launch_thread_major<false, L>(u32(tw), u32(twp), wt, wpt, s);
    NTT_RING(6) NTT_RING(7) NTT_RING(8) NTT_RING(9) NTT_RING(10) NTT_RING(11) NTT_RING(12)
#undef NTT_RING
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ntt_fwd(const void* x, void* out, const void* qs, const void* tw,
                       const void* twp, const void* twt, const void* twpt, const void* psi,
                       const void* psip, int b, int n, int negacyclic, int lazy,
                       void* stream) {
  const Tables<uint32_t> tb{u32(qs), u32(tw), u32(twp), u32(psi), u32(psip), nullptr, nullptr,
                            ilog2(n), negacyclic != 0, true};
  return transform(true, x, out, tb, {u32(twt), u32(twpt)}, b, n, lazy != 0, stream);
}

extern "C" int ntt_inv(const void* x, void* out, const void* qs, const void* ninv,
                       const void* ninv_p, const void* itw, const void* itwp, const void* itwt,
                       const void* itwpt, const void* post, const void* postp, int b, int n,
                       int negacyclic, int lazy, void* stream) {
  const Tables<uint32_t> tb{u32(qs), u32(itw), u32(itwp), u32(post), u32(postp), u32(ninv),
                            u32(ninv_p), ilog2(n), negacyclic != 0, true};
  return transform(false, x, out, tb, {u32(itwt), u32(itwpt)}, b, n, lazy != 0, stream);
}
