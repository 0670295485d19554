// Launch variants of the port's basecase product and an empty kernel,
// for tools/time_basemul.py.  Not part of the port: it includes the
// library's own source, so every variant runs the library's vector body
// (basemul_vec_kernel) with another item size, block size or grid.
//
//   basemul_variant(..., pairs, threads, max_blocks): items of `pairs`
//     pairs (2, 4 or 8: 4-, 8- or 16-byte accesses), `threads` a block,
//     one item a thread (max_blocks = 0) or at most max_blocks blocks
//     whose threads loop over the items (a persistent grid)
//   empty_kernel(blocks, threads): a kernel that does nothing
#include "dyadic_basemul.cu"

namespace {

// items of 4 and 8 pairs: 8- and 16-byte accesses
template <>
struct Words<2> {
  union {
    uint2 v;
    uint32_t w[2];
  };
};
template <>
struct Words<4> {
  union {
    uint4 v;
    uint32_t w[4];
  };
};

__global__ void empty() {}

}  // namespace

extern "C" int basemul_variant(const void* a, const void* b, void* out, const void* qs,
                               const void* mus, const void* gamma, const void* gammap,
                               int k, int bsz, int n, int lazy, int pairs, int threads,
                               int max_blocks, void* stream) {
  if ((pairs != 2 && pairs != 4 && pairs != 8) || (n / 2) % pairs || threads > kMaxThreads ||
      !all_aligned(2 * pairs, a, b, out, gamma, gammap))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)k * bsz * (n / 2 / pairs);
  long long blocks = (items + threads - 1) / threads;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  const Plan pl{1, pairs, threads, items, blocks};
  auto* s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint16_t*>(a);
  const auto* pb = static_cast<const uint16_t*>(b);
  auto* po = static_cast<uint16_t*>(out);
  const auto* pq = static_cast<const uint16_t*>(qs);
  const auto* pm = static_cast<const uint16_t*>(mus);
  const auto* pg = static_cast<const uint16_t*>(gamma);
  const auto* pgp = static_cast<const uint16_t*>(gammap);
  auto fn = pairs == 2   ? (lazy ? &launch_vec<true, 2> : &launch_vec<false, 2>)
            : pairs == 4 ? (lazy ? &launch_vec<true, 4> : &launch_vec<false, 4>)
                         : (lazy ? &launch_vec<true, 8> : &launch_vec<false, 8>);
  fn(pl, pa, pb, po, pq, pm, pg, pgp, k, bsz, n, s);
  return (int)cudaGetLastError();
}

extern "C" int empty_kernel(int blocks, int threads, void* stream) {
  empty<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
