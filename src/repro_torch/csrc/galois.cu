// NTT-domain Galois automorphism gathers for Hopper (sm_90a):
//   out[row, j] = x[row, idx[j]]
//
// Replaces the three TPU kernels of src/repro/kernels/galois_kernel.py:
//   galois_banks        <- galois_banks_pallas        one (n,) idx row shared
//                                                     by every (prime, batch) row
//   galois_banks_multi  <- galois_banks_multi_pallas  one idx row per batch
//                                                     element, (B, n)
//   galois_digits       <- galois_digits_pallas       the per-batch gather on
//                                                     every digit of (d, k, B, n);
//                                                     with ``shared`` one
//                                                     (d, k, 1, n) stack fanned
//                                                     out to B gather rows
// In the evaluation domain the automorphism is a pure slot permutation,
// the same for every prime and digit, so all three are one gather with
// different maps from output rows to source and idx rows.
//
// What bounds it on an H100: device memory.  Each output word is one
// index read and one word written; each source row is read once (in the
// fan-out mode once for all B gathered rows).  No arithmetic.  A gather
// reads its source words in no useful order (a rotation's row is the
// affine map j -> g*j + (g-1)/2 mod n), so every 4-byte word read
// straight from device memory or L2 costs a 32-byte sector.
//
// Rows move as 16-byte vectors where n is a multiple of 4 and every pointer
// is 16-byte aligned; any other call (a row of 1-3 words past a multiple of
// 4, a view that starts inside a vector) takes the one-word body
// (galois_word_kernel), one output word a thread.  Indices follow
// the reference's jnp.take / take_along_axis: one in [-n, 0) counts from
// the end of the row (n + i), and any other outside [0, n) gives
// 0xFFFFFFFF (never a residue) instead of a read outside the row.  The
// wrap is one unsigned min (wrap), taken where an index is used (in
// pick_ldg and pick, or once for a tile of the ring when its first piece
// has landed), so no index load is waited for earlier than before.
//
// - Staged rows (galois_bulk_kernel; galois_banks_multi and galois_digits,
//   every n).  The output vectors a source row feeds (its B gathered rows
//   in the fan-out mode, its one row otherwise) are cut into runs, one a
//   block, so that a call of few rows fills the card (plan()).  A block copies the
//   source row into its shared memory with Hopper bulk copies
//   (cp.async.bulk, runs of kChunkBytes from the first warp's lanes,
//   counted in bytes on an mbarrier and waited on by parity; a lost copy
//   traps after a bounded wait), and every gather read then hits shared
//   memory.  The indices of the first round load while the row lands.  A
//   row of up to kRowWords words (227 KB) lands whole and the block
//   streams its run: int4 of idx, four shared reads, one uint4 written,
//   kRowVec vectors a thread in flight.  A longer row passes through a
//   ring of kBufs pieces of 64 KB: the block's run is one tile (kPieceVec
//   vectors a thread, held in registers with their indices), each piece
//   fills the words whose index falls in it, and a buffer is refilled
//   once every thread has read it.
//   Measured on an H100 and not kept (tools/probe_galois_cluster.py,
//   PERF.md): staging the row across a thread-block cluster and reading
//   it from the other blocks' shared memory (each scattered word is a
//   transfer between SMs), and multicasting its bulk copies to a cluster
//   of the blocks that share it (the cluster barriers cost more than the
//   copies it saves).
// - Split rows (galois_split_kernel; galois_banks): the grid covers
//   (16-byte output vectors of a row) x (output rows).  A thread reads one
//   int4 of idx, gathers its four words straight from the source row in
//   device memory through the read-only path (a rotate's 8 rows of 64 KB
//   stay in the 50 MB L2 after the first touch) and writes one uint4.  No
//   shared memory, no barrier, no row-length limit, and a small call
//   spreads over every SM (a rotate's (8, 1, 2^14): 256 blocks).
// - One word a thread (galois_word_kernel; all three modes, rows or
//   pointers the vector bodies do not take): a grid-strided loop over the
//   output words, each reading its index and gathering its word through
//   the read-only path.  No scheme path feeds it (every ring the repo
//   builds is 16 words or more, and the scheme hands the gathers whole
//   tensors it allocated); it is there so the card takes every shape the
//   reference takes.
#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"
#include "host.cuh"

namespace {

using host::aligned16;
using host::sm_count;

constexpr int kSplitThreads = 128;
constexpr unsigned kMaxGridY = 65535;
// the most dynamic shared memory one block may take on sm_90 (227 KB)
constexpr int kMaxSmemBytes = 232448;
constexpr int kBufs = 3;                    // the piece ring's buffers
constexpr int kBarBytes = 32;               // their mbarriers, ahead of the buffers
// the longest row a block stages whole: what 227 KB of shared memory holds
constexpr int kRowWords = (kMaxSmemBytes - kBarBytes) / 16 * 4;
constexpr int kRowThreads = 256;            // a block of a whole row
constexpr int kRowVec = 4;                  // vectors a thread has in flight there
constexpr int kPieceWords = 16384;          // a piece of a longer row (64 KB)
constexpr int kPieceThreads = 1024;         // a block of a longer row
constexpr int kPieceVec = 4;                // vectors a thread holds there
constexpr int kTile = kPieceThreads * kPieceVec;  // ... and a block (64 KB of output)
constexpr int kPieceSmem = kBarBytes + 4 * kBufs * kPieceWords;
constexpr int kWaveFactor = 2;              // blocks a SM that whole rows take at most
constexpr int kReceive = 2;                 // ... copying in at most this many bytes a byte out
constexpr int kMinRun = 1024;               // vectors a part of a whole row keeps at least
constexpr uint32_t kChunkBytes = 4096;      // a fill is copied in runs of this size
constexpr long long kMaxBlocks = 1 << 16;   // blocks a launch starts (they loop)
constexpr int kWordThreads = 256;           // a block of the one-word body

// How output rows map to source and idx rows (B idx rows):
//   kSharedIdx: out row r reads source row r through idx row 0 (split body)
//   kPerRowIdx: out row r reads source row r through idx row r % B
//   kFanOut:    out row s*B + b reads source row s through idx row b
enum Mode { kSharedIdx = 0, kPerRowIdx = 1, kFanOut = 2 };

// An index in [-n, 0) becomes n + i and any other keeps its unsigned
// value, so the unsigned range tests below still send i < -n and i >= n
// to 0xFFFFFFFF: for i < 0, (unsigned)i + n wraps to n + i exactly when
// i >= -n; in every other case it is the larger of the two.
__device__ __forceinline__ unsigned wrap(int32_t i, int n) {
  return min((unsigned)i, (unsigned)i + (unsigned)n);
}

__device__ __forceinline__ int4 wrap4(int4 i, int n) {
  return make_int4((int)wrap(i.x, n), (int)wrap(i.y, n), (int)wrap(i.z, n),
                   (int)wrap(i.w, n));
}

// ------------------------------------------------------------ split rows

// word i of source row s (i in [-n, 0) wrapped); outside [-n, n) gives
// 0xFFFFFFFF
__device__ __forceinline__ uint32_t pick_ldg(const uint32_t* __restrict__ s,
                                             int32_t i, int n) {
  const unsigned u = wrap(i, n);
  return u < (unsigned)n ? __ldg(s + u) : 0xFFFFFFFFu;
}

// Every row through the one idx row: grid.x covers the n/4 vectors of a
// row, grid.y strides over the rows (fewer than 2^31: the wrappers refuse
// more; offsets are taken in 64 bits).
__global__ void __launch_bounds__(kSplitThreads)
galois_split_kernel(const uint32_t* __restrict__ x,
                    const int32_t* __restrict__ idx,
                    uint32_t* __restrict__ out, int n, unsigned rows) {
  const int nv = n >> 2;
  const int v = blockIdx.x * kSplitThreads + threadIdx.x;
  if (v >= nv) return;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  const int4 i = __ldg(idx4 + v);
  for (unsigned r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t* s = x + (size_t)r * n;
    out4[(size_t)r * nv + v] = make_uint4(pick_ldg(s, i.x, n), pick_ldg(s, i.y, n),
                                  pick_ldg(s, i.z, n), pick_ldg(s, i.w, n));
  }
}

// ------------------------------------------------------- one word a thread

// Output word w of out row r = w / n: source row r (r / B in the fan-out
// mode), idx row 0 (kSharedIdx) or r % B.  `words`: every output word.
template <int kMode>
__global__ void __launch_bounds__(kWordThreads)
galois_word_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
                   uint32_t* __restrict__ out, int n, int batch, long long words) {
  for (long long w = (long long)blockIdx.x * kWordThreads + threadIdx.x; w < words;
       w += (long long)gridDim.x * kWordThreads) {
    const long long r = w / n;
    const int j = (int)(w - r * n);
    const long long src = kMode == kFanOut ? r / batch : r;
    const long long irow = kMode == kSharedIdx ? 0 : r % batch;
    out[w] = pick_ldg(x + src * n, __ldg(idx + irow * n + j), n);
  }
}

// ---------------------------------------------------------- staged rows

// word i of a staged row of n words (i in [-n, 0) wrapped); outside
// [-n, n) gives 0xFFFFFFFF
__device__ __forceinline__ uint32_t pick(const uint32_t* s, int32_t i, int n) {
  const unsigned u = wrap(i, n);
  return u < (unsigned)n ? s[u] : 0xFFFFFFFFu;
}

// word i (wrapped) of the row into acc if it falls in the piece of `len`
// words that starts at word lo; an index outside [0, n) falls in none
__device__ __forceinline__ void take(uint32_t& acc, const uint32_t* s, int32_t i, int lo,
                                     unsigned len) {
  const unsigned off = (unsigned)i - (unsigned)lo;
  if (off < len) acc = s[off];
}

// Block q (of `blocks`) serves source row q / parts: it writes run
// q % parts of the row's work, the rows * n/4 output vectors it feeds
// (rows = B in the fan-out mode, else 1) taken row by row, cut into
// `parts` even runs.  Fan-out vector (b, v) is out row src*B + b, idx row
// b; otherwise (0, v) is out row src, idx row src % B.  With more blocks
// than the grid holds, a block takes q, q + grid.x, ...
//
// kPieces false (n <= kRowWords): the row lands in buffer 0 and the block
// streams its run, kRowVec vectors a thread in flight (a round's indices
// load while the row lands and while the round before is picked).
// kPieces true: the run is at most one tile, kPieceVec vectors a thread,
// held in registers with their indices while the row passes through the
// ring (piece h in buffer h % kBufs) and each piece fills the words whose
// index falls in it.
template <int kMode, bool kPieces>
__global__ void __launch_bounds__(kPieces ? kPieceThreads : kRowThreads)
galois_bulk_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
                   uint32_t* __restrict__ out, int n, int batch, int parts, long long blocks) {
  constexpr int kVec = kPieces ? kPieceVec : kRowVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint32_t* bufs = reinterpret_cast<uint32_t*>(smem_raw + kBarBytes);
  const int nv = n >> 2;
  const int piece = kPieces ? kPieceWords : n;
  const int pieces = kPieces ? (n + kPieceWords - 1) / kPieceWords : 1;
  const long long work = (long long)(kMode == kFanOut ? batch : 1) * nv;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  if (threadIdx.x == 0) {
    for (int b = 0; b < kBufs; ++b) bulk::mbar_init(full + b);
    bulk::fence_mbar_init();
  }
  __syncthreads();
  uint32_t waits[kBufs] = {};
  auto wait = [&](int b) { bulk::mbar_wait(full + b, waits[b]++ & 1u); };
  // every thread has read its buffers: order the reads before the bulk
  // copies that refill them
  auto read_all = [&] {
    bulk::fence_proxy_async();
    __syncthreads();
  };
  for (long long q = blockIdx.x; q < blocks; q += gridDim.x) {
    const long long src = q / parts;
    const long long part = q % parts;
    const long long w_lo = part * work / parts;
    const long long w_hi = (part + 1) * work / parts;
    // buffer b <- piece h of the row: the first warp's lanes copy its runs
    auto fill = [&](int h, int b) {
      const uint32_t bytes = (uint32_t)min(piece, n - h * piece) * 4u;
      char* dst = reinterpret_cast<char*>(bufs + b * piece);
      const char* from = reinterpret_cast<const char*>(x + src * n + (size_t)h * piece);
      if (threadIdx.x == 0) bulk::mbar_expect_tx(full + b, bytes);
      if (threadIdx.x < 32) {
        __syncwarp();
        for (uint32_t at = threadIdx.x * kChunkBytes; at < bytes; at += 32 * kChunkBytes)
          bulk::bulk_load(dst + at, from + at, min(kChunkBytes, bytes - at), full + b);
      }
    };
    // vector w of the row's work: its idx and out vectors ((B, n) idx rows,
    // out rows src*B + b or src, each row n/4 vectors)
    auto at_idx = [&](long long w) { return kMode == kFanOut ? w : (src % batch) * nv + w; };
    auto at_out = [&](long long w) { return src * work + w; };
    // the indices of the kVec vectors w0, w0 + T, ...; past the run
    // INT32_MIN, outside [-n, n) (those lanes are never written)
    int4 iv[kVec];
    auto load = [&](long long w0) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const long long w = w0 + u * (long long)blockDim.x;
        iv[u] = w < w_hi ? __ldg(idx4 + at_idx(w))
                         : make_int4(INT32_MIN, INT32_MIN, INT32_MIN, INT32_MIN);
      }
    };
    if constexpr (!kPieces) {
      fill(0, 0);
      const long long step = kVec * (long long)blockDim.x;
      load(w_lo + threadIdx.x);
      wait(0);
      for (long long w0 = w_lo + threadIdx.x; w0 < w_hi; w0 += step) {
        uint4 ov[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u)
          ov[u] = make_uint4(pick(bufs, iv[u].x, n), pick(bufs, iv[u].y, n),
                             pick(bufs, iv[u].z, n), pick(bufs, iv[u].w, n));
        load(w0 + step);
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const long long w = w0 + u * (long long)blockDim.x;
          if (w < w_hi) out4[at_out(w)] = ov[u];
        }
      }
    } else {
      for (int h = 0; h < kBufs && h < pieces; ++h) fill(h, h);
      load(w_lo + threadIdx.x);
      uint4 acc[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u)
        acc[u] = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
      for (int h = 0; h < pieces; ++h) {
        const int b = h % kBufs;
        wait(b);
        if (h == 0) {  // wrapped once, when the first piece has landed
#pragma unroll
          for (int u = 0; u < kVec; ++u) iv[u] = wrap4(iv[u], n);
        }
        const uint32_t* s = bufs + b * piece;
        const int lo = h * piece;
        const unsigned len = (unsigned)min(piece, n - lo);
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          take(acc[u].x, s, iv[u].x, lo, len);
          take(acc[u].y, s, iv[u].y, lo, len);
          take(acc[u].z, s, iv[u].z, lo, len);
          take(acc[u].w, s, iv[u].w, lo, len);
        }
        if (h + kBufs < pieces) {
          read_all();
          fill(h + kBufs, b);
        }
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const long long w = w_lo + threadIdx.x + u * (long long)blockDim.x;
        if (w < w_hi) out4[at_out(w)] = acc[u];
      }
    }
    if (q + gridDim.x < blocks) read_all();  // before the next row's fills
  }
}

// ------------------------------------------------------------ launchers

// The runs a source row's output vectors are cut into.  A row of up to
// kRowWords words is staged whole: as many runs as keep a block writing
// at least 1/kReceive of the bytes it copies in (the row) and the card at
// most kWaveFactor blocks a SM, each run at least kMinRun vectors (so a
// call of few rows fills the card, and one of many rows copies each row
// once).  A longer row passes through the piece ring: runs of at most one
// tile.  `sms`: the card's SMs.
inline long long plan(long long src_rows, int n, int batch, bool fan_out, int sms) {
  const long long rows = fan_out ? batch : 1;
  const long long work = rows * (n / 4);
  if (n > kRowWords) return (work + kTile - 1) / kTile;
  long long parts = kReceive * rows;
  const long long wave = kWaveFactor * (long long)sms / src_rows;
  if (parts > wave) parts = wave;
  if (parts > work / kMinRun) parts = work / kMinRun;
  return parts > 1 ? parts : 1;
}

template <int kMode>
int launch_bulk(const uint32_t* x, const int32_t* idx, uint32_t* out, long long src_rows,
                int n, int batch, cudaStream_t stream) {
  const bool pieces = n > kRowWords;
  const long long parts = plan(src_rows, n, batch, kMode == kFanOut, sm_count());
  auto kernel = pieces ? &galois_bulk_kernel<kMode, true> : &galois_bulk_kernel<kMode, false>;
  // above 48 KB: once a card, for the most it takes
  static bool opted_in[host::kMaxDevices][2] = {};
  const int dev = host::current_device();
  if (!host::kept(dev) || !opted_in[dev][pieces]) {
    const int most = pieces ? kPieceSmem : kBarBytes + 4 * kRowWords;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    if (host::kept(dev)) opted_in[dev][pieces] = true;
  }
  const long long blocks = src_rows * parts;
  const unsigned grid = (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  const size_t smem = pieces ? kPieceSmem : kBarBytes + 4 * (size_t)n;
  kernel<<<grid, pieces ? kPieceThreads : kRowThreads, smem, stream>>>(x, idx, out, n, batch,
                                                                     (int)parts, blocks);
  return (int)cudaGetLastError();
}

int launch_split(const uint32_t* x, const int32_t* idx, uint32_t* out, long long rows, int n,
                 cudaStream_t stream) {
  const unsigned gx = (unsigned)((n / 4 + kSplitThreads - 1) / kSplitThreads);
  const unsigned gy = (unsigned)(rows < kMaxGridY ? rows : kMaxGridY);
  galois_split_kernel<<<dim3(gx, gy), kSplitThreads, 0, stream>>>(x, idx, out, n,
                                                                 (unsigned)rows);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_word(const uint32_t* x, const int32_t* idx, uint32_t* out, long long src_rows,
                int n, int batch, cudaStream_t stream) {
  const long long words = (kMode == kFanOut ? src_rows * batch : src_rows) * n;
  const long long blocks = (words + kWordThreads - 1) / kWordThreads;
  const unsigned grid = (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  galois_word_kernel<kMode><<<grid, kWordThreads, 0, stream>>>(x, idx, out, n, batch, words);
  return (int)cudaGetLastError();
}

// src_rows source rows of n words, batch idx rows: the split body for the
// shared idx row, the staged body for the other two modes, the one-word
// body for a row that is not a whole number of 16-byte vectors or a
// pointer off a 16-byte boundary.
template <int kMode>
int launch(const void* x, const void* idx, void* out, long long src_rows, int n,
           int batch, void* stream) {
  if (src_rows <= 0 || n <= 0) return (int)cudaGetLastError();
  const auto* px = static_cast<const uint32_t*>(x);
  const auto* pi = static_cast<const int32_t*>(idx);
  auto* po = static_cast<uint32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  if (n % 4 != 0 || !aligned16(x) || !aligned16(idx) || !aligned16(out))
    return launch_word<kMode>(px, pi, po, src_rows, n, batch, s);
  if constexpr (kMode == kSharedIdx) {
    return launch_split(px, pi, po, src_rows, n, s);
  } else {
    return launch_bulk<kMode>(px, pi, po, src_rows, n, batch, s);
  }
}

}  // namespace

// Shapes are checked by the Python wrappers: every tensor contiguous,
// words uint32 (int32 bit patterns), idx int32.  Every launcher returns the error of its
// launch (or of configuring the kernel); the wrapper raises on a non-zero
// code.

// x, out (k, b, n); idx (n,)
extern "C" int galois_banks(const void* x, const void* idx, void* out, int k,
                            int b, int n, void* stream) {
  return launch<kSharedIdx>(x, idx, out, (long long)k * b, n, 1, stream);
}

// x, out (k, b, n); idx (b, n)
extern "C" int galois_banks_multi(const void* x, const void* idx, void* out,
                                  int k, int b, int n, void* stream) {
  return launch<kPerRowIdx>(x, idx, out, (long long)k * b, n, b, stream);
}

// idx (b, n); out (d, k, b, n); x (d, k, b, n), or (d, k, 1, n) with shared
extern "C" int galois_digits(const void* x, const void* idx, void* out, int d,
                             int k, int b, int n, int shared, void* stream) {
  if (shared) return launch<kFanOut>(x, idx, out, (long long)d * k, n, b, stream);
  return launch<kPerRowIdx>(x, idx, out, (long long)d * k * b, n, b, stream);
}

// The runs plan() cuts each of src_rows source rows' output into on a card
// of `sms` SMs (batch idx rows; fan_out: the shared digit mode), as the
// launches above take them: the schedule the tests emulate.
extern "C" int galois_bulk_parts(long long src_rows, int n, int batch, int fan_out, int sms) {
  return (int)plan(src_rows, n, batch, fan_out != 0, sms);
}
