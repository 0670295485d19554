// Two thread-block-cluster designs for the staged Galois gathers of
// src/repro_torch/csrc/galois.cu (galois_banks_multi: one idx row per
// source row; galois_digits' fan-out: one source row gathered through
// all B idx rows), built and timed by tools/probe_galois_cluster.py
// beside the port's lone-block body.  Not part of the port: measured on
// an H100 and not kept (PERF.md).  Same semantics as the port's gathers:
// out[row, j] = x[src, idx[irow, j]], 0xFFFFFFFF for an index outside
// [0, n); rows move as 16-byte vectors.
//
// - probe_dsmem: a cluster of c blocks (1 .. 8) stages one source row
//   across its blocks' shared memory, block `rank` holding words
//   [rank*slice, rank*slice + slice), filled by bulk copies counted on its
//   mbarrier.  After a cluster barrier each block writes its column slice
//   of every output row the cluster owns (in the fan-out mode the idx
//   rows of one of `splits` parts of B), taking each word from whichever
//   block holds it (mapa + ld.shared::cluster).  A last cluster barrier
//   keeps every slice alive until the other blocks have read it.
// - probe_multicast: each source row's output vectors are cut into
//   `parts` runs, one a block, c blocks (c divides parts) a cluster.
//   Every block needs the whole row, so each copies every c-th 4 KB run
//   of it and multicasts the run to all c blocks (each byte leaves L2
//   once a cluster).  A row of up to kRowWords words lands whole; a longer
//   one passes through a ring of kBufs pieces of 64 KB, a buffer refilled
//   once every block of the cluster has released it (remote arrivals on
//   its `empty` barrier).  At c = 1 this is the port's body with cluster
//   launches.
#include <cuda_runtime.h>

#include <cstdint>

#include "bulk.cuh"
#include "host.cuh"

namespace {

constexpr int kPerRowIdx = 1;  // the port's modes (csrc/galois.cu)
constexpr int kFanOut = 2;
constexpr int kMaxSmemBytes = 232448;  // the most dynamic shared memory of a block
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr long long kMaxClusters = 1 << 16;  // clusters a launch starts (they loop)
constexpr uint32_t kChunkBytes = 4096;       // a bulk copy's run
// dsmem
constexpr int kSliceBar = 16;  // a block's mbarrier, ahead of its slice
constexpr int kMaxSlice = (kMaxSmemBytes - kSliceBar) / 16 * 4;
constexpr int kDsmemThreads = 256;
constexpr int kDsmemVec = 4;  // output vectors a thread has in flight
// multicast
constexpr int kBufs = 3;
constexpr int kBarBytes = 64;  // full and empty mbarriers of the buffers
constexpr int kRowWords = (kMaxSmemBytes - kBarBytes) / 16 * 4;
constexpr int kRowThreads = 256;
constexpr int kRowVec = 4;
constexpr int kPieceWords = 16384;
constexpr int kPieceThreads = 1024;
constexpr int kPieceVec = 4;
constexpr int kPieceSmem = kBarBytes + 4 * kBufs * kPieceWords;

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned c;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(c));
  return c;
}

// every thread of every block of the cluster: what each did before is
// visible to all after (a block's own barrier when the cluster is one block)
__device__ __forceinline__ void cluster_sync(unsigned c) {
  if (c == 1) {
    __syncthreads();
  } else {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n\t"
        "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
}

__device__ __forceinline__ void mbar_init_count(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bulk::smem_u32(bar)), "r"(count)
               : "memory");
}

// the word at shared address `addr` (this block's layout) of cluster block `rank`
__device__ __forceinline__ uint32_t ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t a, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// one arrival on the barrier at `bar` (this block's layout) of cluster
// block `rank`, releasing this block's accesses before it
__device__ __forceinline__ void arrive_remote(uint64_t* bar, unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(bulk::smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(a)
               : "memory");
}

// global -> the same shared address in every block of `mask`, counted on
// each one's barrier at the same address
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;" ::"r"(bulk::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bulk::smem_u32(bar)), "h"(mask)
      : "memory");
}

// ------------------------------------------------------------ dsmem

// word i of the row staged across the cluster: block i / slice holds it
// at i % slice
template <bool kPow2>
__device__ __forceinline__ uint32_t pick_cluster(uint32_t base, int32_t i, unsigned n,
                                                 unsigned slice, unsigned slog) {
  const bool ok = (unsigned)i < n;
  const unsigned w = ok ? (unsigned)i : 0u;
  const unsigned r = kPow2 ? w >> slog : w / slice;
  const uint32_t v = ld_cluster(base + (w - r * slice) * 4u, r);
  return ok ? v : 0xFFFFFFFFu;
}

// Cluster q (of `clusters`) stages source row q / splits and writes part
// q % splits of its output rows (fan-out: idx rows [p*B/splits,
// (p+1)*B/splits), out rows src*B + b; else its one row, idx row src % B).
// kPow2: every block holds slice = 2^slog words.
template <int kMode, bool kPow2>
__global__ void __launch_bounds__(kDsmemThreads)
dsmem_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
             uint32_t* __restrict__ out, int n, int batch, int slice, int slog, int splits,
             long long clusters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint32_t* held = reinterpret_cast<uint32_t*>(smem_raw + kSliceBar);
  const unsigned c = cluster_size();
  const unsigned rank = cluster_rank();
  const int lo = (int)rank * slice;
  const int words = kPow2 ? slice : max(0, min(slice, n - lo));
  const int nv = words >> 2;  // vectors held, and written a row
  const uint32_t base = bulk::smem_u32(held);
  const int4* idx4 = reinterpret_cast<const int4*>(idx + lo);
  uint4* out4 = reinterpret_cast<uint4*>(out + lo);
  if (threadIdx.x == 0) {
    mbar_init_count(full, 1);
    bulk::fence_mbar_init();
  }
  __syncthreads();
  uint32_t parity = 0;
  for (long long q = blockIdx.x / c; q < clusters; q += gridDim.x / c, parity ^= 1u) {
    const long long src = q / splits;
    if (threadIdx.x < 32 && nv > 0) {
      const uint32_t bytes = (uint32_t)words * 4u;
      const char* from = reinterpret_cast<const char*>(x + src * n + lo);
      bulk::fence_proxy_async();  // the last row's reads before this copy's writes
      if (threadIdx.x == 0) bulk::mbar_expect_tx(full, bytes);
      __syncwarp();
      for (uint32_t at = threadIdx.x * kChunkBytes; at < bytes; at += 32 * kChunkBytes)
        bulk::bulk_load(reinterpret_cast<char*>(held) + at, from + at,
                        min(kChunkBytes, bytes - at), full);
    }
    int b0 = 0, rows = 1;
    if (kMode == kFanOut) {
      const int part = (int)(q % splits);
      b0 = (int)((long long)part * batch / splits);
      rows = (int)((long long)(part + 1) * batch / splits) - b0;
    }
    const size_t irow = kMode == kFanOut ? (size_t)b0 : (size_t)(src % batch);
    const size_t orow = kMode == kFanOut ? (size_t)src * batch + b0 : (size_t)src;
    const size_t nv_row = (size_t)n >> 2;
    if (nv > 0) bulk::mbar_wait(full, parity);
    cluster_sync(c);  // every block's slice has landed
    const int total = rows * nv;
    for (int w0 = threadIdx.x; w0 < total; w0 += kDsmemVec * blockDim.x) {
      size_t at_o[kDsmemVec];
      int4 iv[kDsmemVec] = {};
#pragma unroll
      for (int u = 0; u < kDsmemVec; ++u) {
        const int w = w0 + u * (int)blockDim.x;
        const int j = kMode == kFanOut ? (kPow2 ? w >> (slog - 2) : w / nv) : 0;
        const int v = w - j * nv;
        at_o[u] = (orow + j) * nv_row + v;
        if (w < total) iv[u] = __ldg(idx4 + (irow + j) * nv_row + v);
      }
      uint4 ov[kDsmemVec];
#pragma unroll
      for (int u = 0; u < kDsmemVec; ++u)
        if (w0 + u * (int)blockDim.x < total)
          ov[u] = make_uint4(pick_cluster<kPow2>(base, iv[u].x, n, slice, slog),
                             pick_cluster<kPow2>(base, iv[u].y, n, slice, slog),
                             pick_cluster<kPow2>(base, iv[u].z, n, slice, slog),
                             pick_cluster<kPow2>(base, iv[u].w, n, slice, slog));
#pragma unroll
      for (int u = 0; u < kDsmemVec; ++u)
        if (w0 + u * (int)blockDim.x < total) out4[at_o[u]] = ov[u];
    }
    cluster_sync(c);  // no block reuses or leaves its slice while another reads it
  }
}

// -------------------------------------------------------- multicast

__device__ __forceinline__ uint32_t pick(const uint32_t* s, int32_t i, int n) {
  return (unsigned)i < (unsigned)n ? s[i] : 0xFFFFFFFFu;
}

__device__ __forceinline__ void take(uint32_t& acc, const uint32_t* s, int32_t i, int lo,
                                     unsigned len) {
  const unsigned off = (unsigned)i - (unsigned)lo;
  if (off < len) acc = s[off];
}

// Cluster q (of `clusters`) serves source row q / (parts / c): its block
// `rank` writes run (q % (parts / c)) * c + rank of the row's work (the
// rows * n/4 output vectors it feeds, cut into `parts` even runs), as the
// port's galois_bulk_kernel writes run q % parts.
template <int kMode, bool kPieces>
__global__ void __launch_bounds__(kPieces ? kPieceThreads : kRowThreads)
multicast_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
                 uint32_t* __restrict__ out, int n, int batch, int parts, long long clusters) {
  constexpr int kVec = kPieces ? kPieceVec : kRowVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kBufs;
  uint32_t* bufs = reinterpret_cast<uint32_t*>(smem_raw + kBarBytes);
  const unsigned c = cluster_size();
  const unsigned rank = cluster_rank();
  const int nv = n >> 2;
  const int piece = kPieces ? kPieceWords : n;
  const int pieces = kPieces ? (n + kPieceWords - 1) / kPieceWords : 1;
  const long long work = (long long)(kMode == kFanOut ? batch : 1) * nv;
  const int cpr = parts / (int)c;  // clusters a source row
  const long long stride = gridDim.x / c;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  if (threadIdx.x == 0) {
    for (int b = 0; b < kBufs; ++b) {
      mbar_init_count(full + b, 1);
      mbar_init_count(empty + b, c);
    }
    bulk::fence_mbar_init();
  }
  cluster_sync(c);  // every block's barriers are live before a copy lands on them
  uint32_t waits[kBufs] = {};
  uint32_t fills[kBufs] = {};
  auto wait = [&](int b) { bulk::mbar_wait(full + b, waits[b]++ & 1u); };
  // this block's share of filling buffer b with piece h of cluster q's
  // row: once every block has released the buffer's last piece, its first
  // warp copies runs rank, rank + c, ... of the piece to every block
  auto fill = [&](long long q, int h, int b) {
    const uint32_t bytes = (uint32_t)min(piece, n - h * piece) * 4u;
    char* dst = reinterpret_cast<char*>(bufs + b * piece);
    const char* from = reinterpret_cast<const char*>(x + (q / cpr) * n + (size_t)h * piece);
    if (threadIdx.x < 32) {
      if (kPieces && fills[b] > 0) bulk::mbar_wait(empty + b, (fills[b] - 1) & 1u);
      if (threadIdx.x == 0) bulk::mbar_expect_tx(full + b, bytes);
      __syncwarp();
      for (uint32_t at = (rank + c * threadIdx.x) * kChunkBytes; at < bytes;
           at += 32 * c * kChunkBytes) {
        const uint32_t len = min(kChunkBytes, bytes - at);
        if (c == 1)
          bulk::bulk_load(dst + at, from + at, len, full + b);
        else
          bulk_load_multicast(dst + at, from + at, len, full + b, (uint16_t)((1u << c) - 1u));
      }
    }
    ++fills[b];
  };
  // every thread of this block has read buffer b: tell every block
  auto release = [&](int b) {
    bulk::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x < c) arrive_remote(empty + b, threadIdx.x);
  };
  for (long long q = blockIdx.x / c; q < clusters; q += stride) {
    const long long src = q / cpr;
    const long long part = (q % cpr) * c + rank;
    const long long w_lo = part * work / parts;
    const long long w_hi = (part + 1) * work / parts;
    auto at_idx = [&](long long w) { return kMode == kFanOut ? w : (src % batch) * nv + w; };
    auto at_out = [&](long long w) { return src * work + w; };
    int4 iv[kVec];
    auto load = [&](long long w0) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const long long w = w0 + u * (long long)blockDim.x;
        iv[u] = w < w_hi ? __ldg(idx4 + at_idx(w)) : make_int4(-1, -1, -1, -1);
      }
    };
    if constexpr (!kPieces) {
      fill(q, 0, 0);
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
      if (q + stride < clusters) {  // no block refills while another reads
        bulk::fence_proxy_async();
        cluster_sync(c);
      }
    } else {
      for (int h = 0; h < kBufs && h < pieces; ++h) fill(q, h, h);
      load(w_lo + threadIdx.x);
      uint4 acc[kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u)
        acc[u] = make_uint4(0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu);
      for (int h = 0; h < pieces; ++h) {
        const int b = h % kBufs;
        wait(b);
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
        release(b);
        if (h + kBufs < pieces) fill(q, h + kBufs, b);
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const long long w = w_lo + threadIdx.x + u * (long long)blockDim.x;
        if (w < w_hi) out4[at_out(w)] = acc[u];
      }
    }
  }
  // no block leaves while a copy or an arrival may still reach it
  if (c > 1) cluster_sync(c);
}

// --------------------------------------------------------- launchers

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, long long clusters, int c, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((clusters < kMaxClusters ? clusters : kMaxClusters) * c));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool bad_call(const void* x, const void* idx, void* out, long long src_rows, int n, int c) {
  return src_rows <= 0 || n <= 0 || n % 4 != 0 || c < 1 || c > kMaxCluster ||
         !host::aligned16(x) || !host::aligned16(idx) || !host::aligned16(out);
}

int ilog2(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

}  // namespace

// Every kernel may take up to 227 KB of shared memory: called once,
// before any launch (and outside a graph capture).
extern "C" int probe_opt_in() {
  const void* kernels[] = {
      (const void*)&dsmem_kernel<kPerRowIdx, false>, (const void*)&dsmem_kernel<kPerRowIdx, true>,
      (const void*)&dsmem_kernel<kFanOut, false>,    (const void*)&dsmem_kernel<kFanOut, true>,
      (const void*)&multicast_kernel<kPerRowIdx, false>,
      (const void*)&multicast_kernel<kPerRowIdx, true>,
      (const void*)&multicast_kernel<kFanOut, false>,
      (const void*)&multicast_kernel<kFanOut, true>};
  for (const void* k : kernels) {
    const cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// x: src_rows source rows of n words; idx: (batch, n); out: src_rows
// rows (idx row r % batch), or src_rows * batch with fan_out.  Returns the
// launch's error; cudaErrorInvalidValue for a slice above one block's
// shared memory or a bad shape.
extern "C" int probe_dsmem(const void* x, const void* idx, void* out, long long src_rows, int n,
                           int batch, int fan_out, int c, int splits, void* stream) {
  if (bad_call(x, idx, out, src_rows, n, c) || splits < 1 || (!fan_out && splits != 1))
    return (int)cudaErrorInvalidValue;
  const int slice = 4 * ((n / 4 + c - 1) / c);
  if (slice > kMaxSlice) return (int)cudaErrorInvalidValue;
  const bool pow2 = (n & (n - 1)) == 0 && n >= 4 * c;
  const auto* px = static_cast<const uint32_t*>(x);
  const auto* pi = static_cast<const int32_t*>(idx);
  auto* po = static_cast<uint32_t*>(out);
  const size_t smem = kSliceBar + 4 * (size_t)slice;
  const int slog = pow2 ? ilog2(slice) : 0;
  const long long clusters = src_rows * splits;
  auto* s = static_cast<cudaStream_t>(stream);
  if (fan_out)
    return pow2 ? launch_cluster(&dsmem_kernel<kFanOut, true>, clusters, c, kDsmemThreads, smem,
                                 s, px, pi, po, n, batch, slice, slog, splits, clusters)
                : launch_cluster(&dsmem_kernel<kFanOut, false>, clusters, c, kDsmemThreads,
                                 smem, s, px, pi, po, n, batch, slice, slog, splits, clusters);
  return pow2 ? launch_cluster(&dsmem_kernel<kPerRowIdx, true>, clusters, c, kDsmemThreads, smem,
                               s, px, pi, po, n, batch, slice, slog, splits, clusters)
              : launch_cluster(&dsmem_kernel<kPerRowIdx, false>, clusters, c, kDsmemThreads,
                               smem, s, px, pi, po, n, batch, slice, slog, splits, clusters);
}

// As probe_dsmem; `parts` (a multiple of c) runs a source row.  A run of
// a row longer than kRowWords holds at most kPieceThreads * kPieceVec
// vectors.
extern "C" int probe_multicast(const void* x, const void* idx, void* out, long long src_rows,
                               int n, int batch, int fan_out, int c, int parts, void* stream) {
  if (bad_call(x, idx, out, src_rows, n, c) || parts < c || parts % c != 0)
    return (int)cudaErrorInvalidValue;
  const bool pieces = n > kRowWords;
  const long long work = (long long)(fan_out ? batch : 1) * (n / 4);
  if (pieces && (work + parts - 1) / parts > (long long)kPieceThreads * kPieceVec)
    return (int)cudaErrorInvalidValue;
  const auto* px = static_cast<const uint32_t*>(x);
  const auto* pi = static_cast<const int32_t*>(idx);
  auto* po = static_cast<uint32_t*>(out);
  const size_t smem = pieces ? kPieceSmem : kBarBytes + 4 * (size_t)n;
  const int threads = pieces ? kPieceThreads : kRowThreads;
  const long long clusters = src_rows * (parts / c);
  auto* s = static_cast<cudaStream_t>(stream);
  if (fan_out)
    return pieces ? launch_cluster(&multicast_kernel<kFanOut, true>, clusters, c, threads, smem,
                                   s, px, pi, po, n, batch, parts, clusters)
                  : launch_cluster(&multicast_kernel<kFanOut, false>, clusters, c, threads,
                                   smem, s, px, pi, po, n, batch, parts, clusters);
  return pieces ? launch_cluster(&multicast_kernel<kPerRowIdx, true>, clusters, c, threads, smem,
                                 s, px, pi, po, n, batch, parts, clusters)
                : launch_cluster(&multicast_kernel<kPerRowIdx, false>, clusters, c, threads,
                                 smem, s, px, pi, po, n, batch, parts, clusters);
}
