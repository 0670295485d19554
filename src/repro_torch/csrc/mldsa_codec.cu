// ML-DSA-65's codec around the signing loop (FIPS 204 Alg. 7) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference signs on the host.  Three
// launchers, over the slots of the signing stream (src/repro_torch/pq/
// mldsa.py), every operand int32 residues mod q = 8380417 in the stream's
// layouts: y (S, l, 256) from ExpandMask, w (k, S, 256) and cs (l + 2k, S,
// 256) (the rows cs1, cs2, ct0) from the digit MAC and the inverse NTT.
//
// - mldsa_w1_encode: w1Encode(HighBits(w)), (S, 768) bytes, a thread a
//   byte (two 4-bit fields), for c-tilde's hash.
// - mldsa_check: every bound of the iteration, a block of 256 threads a
//   slot, a thread a coefficient of all 17 rows: ||z|| < gamma1 - beta
//   (z = y + cs1 mod+- q), ||r0|| < gamma2 - beta (r0 = LowBits(w - cs2)),
//   ||ct0|| < gamma2, and at most omega hints MakeHint(-ct0, w - cs2 +
//   ct0), reduced over the block with __syncthreads_or / _count; the
//   verdict is the slot's accept flag, anded with its active flag.
// - mldsa_emit: sigEncode(c-tilde, z, h) of each slot whose ring place is
//   below R, into its ring row, with its request id and iteration count;
//   a block a slot (the rejected slots' blocks return at once).  z's
//   20-bit fields are packed from shared memory, two coefficients to five
//   bytes; the hint's positions come from a warp ballot a row and the
//   prefix of the (row, warp) counts.
//
// What bounds them on an H100: device memory.  The check reads 28 rows of
// 1 KB a slot and writes a byte; the emit reads as much for the accepted
// fifth of the slots and writes 3.3 KB each.  Decompose's division by
// 2 gamma2 is a constant division (a multiply and shifts).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kN = 256;
constexpr int kK = 6, kL = 5;
constexpr int kQ = 8380417;
constexpr int kGamma1 = 1 << 19;
constexpr int kGamma2 = (kQ - 1) / 32;       // 261888
constexpr int kBeta = 196;
constexpr int kOmega = 55;
constexpr int kCtBytes = 48;
constexpr int kSigBytes = kCtBytes + kL * 640 + kOmega + kK;   // 3309
constexpr int kW1Bytes = kK * 128;

// FIPS 204 Alg. 36 of r in [0, q): r1 (HighBits) and r0 (LowBits)
__device__ __forceinline__ void decompose(int r, int& r1, int& r0) {
  int lo = r % (2 * kGamma2);
  if (lo > kGamma2) lo -= 2 * kGamma2;
  const int d = r - lo;
  if (d == kQ - 1) {
    r1 = 0;
    r0 = lo - 1;
  } else {
    r1 = d / (2 * kGamma2);
    r0 = lo;
  }
}

__device__ __forceinline__ int high_bits(int r) {
  int r1, r0;
  decompose(r, r1, r0);
  return r1;
}

__device__ __forceinline__ int centered(int x) { return x > (kQ - 1) / 2 ? x - kQ : x; }

__device__ __forceinline__ int add_q(int a, int b) {
  const int s = a + b;
  return s >= kQ ? s - kQ : s;
}

__device__ __forceinline__ int sub_q(int a, int b) { return a >= b ? a - b : a - b + kQ; }

__global__ void __launch_bounds__(256)
    w1_encode_kernel(const int32_t* w, uint8_t* out, long long bytes, int rows) {
  const long long o = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (o >= bytes) return;
  const long long s = o / kW1Bytes;
  const int rem = static_cast<int>(o - s * kW1Bytes);
  const int i = rem / 128, t = rem % 128;
  const int32_t* v = w + (static_cast<long long>(i) * rows + s) * kN + 2 * t;
  out[o] = static_cast<uint8_t>(high_bits(v[0]) | (high_bits(v[1]) << 4));
}

// The slot's coefficient j: z's 5 values, and r = w - cs2 and ct0's 6
struct Column {
  int z[kL];
  int r[kK];
  int ct0[kK];
};

__device__ __forceinline__ Column column(const int32_t* y, const int32_t* w, const int32_t* cs,
                                         long long s, int rows, int j) {
  Column c;
  const long long plane = static_cast<long long>(rows) * kN;
  const long long at = s * kN + j;
#pragma unroll
  for (int r = 0; r < kL; ++r) {
    c.z[r] = centered(add_q(y[(s * kL + r) * kN + j], cs[r * plane + at]));
  }
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    c.r[i] = sub_q(w[i * plane + at], cs[(kL + i) * plane + at]);
    c.ct0[i] = cs[(kL + kK + i) * plane + at];
  }
  return c;
}

// MakeHint(-ct0, r + ct0) = HighBits(r + ct0) != HighBits(r)
__device__ __forceinline__ bool hint(int r, int ct0) {
  return high_bits(add_q(r, ct0)) != high_bits(r);
}

__global__ void __launch_bounds__(256)
    check_kernel(const int32_t* y, const int32_t* w, const int32_t* cs, const bool* active,
                 bool* ok, int rows) {
  const long long s = blockIdx.x;
  const int j = threadIdx.x;
  const Column c = column(y, w, cs, s, rows, j);
  bool bad = false;
#pragma unroll
  for (int r = 0; r < kL; ++r) bad |= abs(c.z[r]) >= kGamma1 - kBeta;
  int hints = 0;
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    int r1, r0;
    decompose(c.r[i], r1, r0);
    bad |= abs(r0) >= kGamma2 - kBeta;
    bad |= abs(centered(c.ct0[i])) >= kGamma2;
    hints |= static_cast<int>(hint(c.r[i], c.ct0[i])) << i;
  }
  const bool any_bad = __syncthreads_or(bad) != 0;
  int total = 0;
#pragma unroll
  for (int i = 0; i < kK; ++i) total += __syncthreads_count((hints >> i) & 1);
  if (j == 0) ok[s] = active[s] && !any_bad && total <= kOmega;
}

__global__ void __launch_bounds__(256)
    emit_kernel(const uint8_t* ct, long long ct_stride, const int32_t* y, const int32_t* w,
                const int32_t* cs, const long long* dest, const long long* ids,
                const int32_t* kappa, uint8_t* ring, long long* ring_ids, int32_t* ring_iters,
                int rows, long long ring_rows) {
  __shared__ uint32_t packed[kL][kN];       // gamma1 - z, 20 bits each
  __shared__ int counts[kK][8];              // hints of a (row, warp)
  __shared__ int offsets[kK][8];
  __shared__ int ends[kK];
  const long long s = blockIdx.x;
  const long long at = dest[s];
  if (at >= ring_rows) return;
  const int j = threadIdx.x, warp = j / 32, lane = j % 32;
  uint8_t* sig = ring + at * kSigBytes;
  const Column c = column(y, w, cs, s, rows, j);
#pragma unroll
  for (int r = 0; r < kL; ++r) packed[r][j] = static_cast<uint32_t>(kGamma1 - c.z[r]);
  unsigned masks[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    masks[i] = __ballot_sync(0xFFFFFFFFu, hint(c.r[i], c.ct0[i]));
    if (lane == 0) counts[i][warp] = __popc(masks[i]);
  }
  if (j < kCtBytes) sig[j] = ct[s * ct_stride + j];
  __syncthreads();
  if (j == 0) {
    int sum = 0;
    for (int i = 0; i < kK; ++i) {
      for (int v = 0; v < 8; ++v) {
        offsets[i][v] = sum;
        sum += counts[i][v];
      }
      ends[i] = sum;
    }
    ring_ids[at] = ids[s];
    ring_iters[at] = kappa[s] / kL + 1;
  }
  // z: pair t of row r to 5 bytes
  for (int task = j; task < kL * kN / 2; task += 256) {
    const int r = task / (kN / 2), t = task % (kN / 2);
    const uint64_t v = packed[r][2 * t] | (static_cast<uint64_t>(packed[r][2 * t + 1]) << 20);
    uint8_t* o = sig + kCtBytes + r * 640 + 5 * t;
#pragma unroll
    for (int b = 0; b < 5; ++b) o[b] = static_cast<uint8_t>(v >> (8 * b));
  }
  __syncthreads();
  uint8_t* h = sig + kCtBytes + kL * 640;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    if ((masks[i] >> lane) & 1u) {
      const int p = offsets[i][warp] + __popc(masks[i] & below);
      if (p < kOmega) h[p] = static_cast<uint8_t>(j);
    }
  }
  const int total = ends[kK - 1];
  if (j < kOmega && j >= total) h[j] = 0;
  if (j < kK) h[kOmega + j] = static_cast<uint8_t>(min(ends[j], 255));
}

int blocks_for(long long threads, int per_block) {
  return static_cast<int>((threads + per_block - 1) / per_block);
}

}  // namespace

// out (rows, 768): w1Encode(HighBits(w)) of w (6, rows, 256).
extern "C" int mldsa_w1_encode(const void* w, void* out, int rows, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const long long bytes = static_cast<long long>(rows) * kW1Bytes;
  w1_encode_kernel<<<blocks_for(bytes, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(w), static_cast<uint8_t*>(out), bytes, rows);
  return static_cast<int>(cudaGetLastError());
}

// ok (rows,) bool: the slot is active and meets every bound.
extern "C" int mldsa_check(const void* y, const void* w, const void* cs, const void* active,
                           void* ok, int rows, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  check_kernel<<<rows, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(y), static_cast<const int32_t*>(w),
      static_cast<const int32_t*>(cs), static_cast<const bool*>(active), static_cast<bool*>(ok),
      rows);
  return static_cast<int>(cudaGetLastError());
}

// sigEncode of every slot s with dest[s] < ring_rows into ring row dest[s]
// (ring rows of 3309 bytes), with ids[s] and kappa[s] / 5 + 1.
extern "C" int mldsa_emit(const void* ct, long long ct_stride, const void* y, const void* w,
                          const void* cs, const void* dest, const void* ids, const void* kappa,
                          void* ring, void* ring_ids, void* ring_iters, int rows,
                          long long ring_rows, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  emit_kernel<<<rows, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ct), ct_stride, static_cast<const int32_t*>(y),
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(cs),
      static_cast<const long long*>(dest), static_cast<const long long*>(ids),
      static_cast<const int32_t*>(kappa), static_cast<uint8_t*>(ring),
      static_cast<long long*>(ring_ids), static_cast<int32_t*>(ring_iters), rows, ring_rows);
  return static_cast<int>(cudaGetLastError());
}
