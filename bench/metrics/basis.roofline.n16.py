"""The base conversions' share of their roofline in the hybrid key-switch
cell: the least time the card could take for the base-conversion work of
the key switches completed in the profiled sub-window, over the device
time of the ``csrc/basis.cu`` kernels in it.

The work is counted from the deployment (N, L, dnum), not from any
kernel, for a key switch at the full chain (the cell's traffic has no
other level), with K = alpha = ceil((L + 1) / dnum), kt = L + 1 + K and
digits D_j of alpha primes (the last may hold fewer):

  mod-up     reads (L + 1) n words, writes sum_j (kt - |D_j|) n (the
             digit's own primes are left as they are), and does
             sum_j |D_j| (kt - |D_j|) n + (L + 1) n multiply-adds (the
             conversions and the premultiplies by (Q_j/q)^-1)
  mod-down   twice (both halves): reads K n, writes (L + 1) n, does
             K (L + 1) n + K n multiply-adds
  tail       twice: reads 2 (L + 1) n, writes (L + 1) n, does (L + 1) n
             multiply-adds (the P^-1 product); one of the two also reads
             the (L + 1) n words of c0 it adds

The rates are those of ``ntt128_roofline``: 3.35 TB/s and 132 SMs x 64
INT32 lanes at 1980 MHz.  A modular multiply-add counts 2 INT32 lane
instructions: the low and the high word of a 32 x 32-bit product summed
into a 64-bit accumulator, which is all a multiply-add needs when the
sum of up to 16 products of 30-bit residues is reduced once at the end.
That is a floor no kernel can beat, so the share cannot pass 100%; a
textbook count with a reduction per product (a Shoup product and a
modular add, 8 instructions) would make the conversions compute-bound
on paper and let a kernel that sums lazily read above 100%.  Moves
``requests_per_s``."""
from benchlib import trace

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
WORD_BYTES = 4
OPS_PER_MULTIPLY_ADD = 2


def work(n: int, levels: int, dnum: int) -> tuple[int, int]:
    """(bytes, multiply-adds) of one key switch's base conversions."""
    chain = levels + 1
    alpha = -(-chain // dnum)
    kt = chain + alpha
    sizes = [min(alpha, chain - lo) for lo in range(0, chain, alpha)]
    words = chain + sum(kt - d for d in sizes)
    macs = sum(d * (kt - d) for d in sizes) + chain
    words += 2 * (alpha + chain)
    macs += 2 * (alpha * chain + alpha)
    words += 2 * 3 * chain + chain
    macs += 2 * chain
    return words * n * WORD_BYTES, macs * n


def least_seconds(n: int, levels: int, dnum: int) -> float:
    nbytes, macs = work(n, levels, dnum)
    return max(nbytes / HBM_BYTES_PER_S, macs * OPS_PER_MULTIPLY_ADD / INT32_OPS_PER_S)


def read(rec):
    if not rec.get("window") or not rec.get("key_switches") or not rec.get("basis_kernels"):
        return None
    busy = trace.busy_ns(rec, trace.port_filter(rec["basis_kernels"])) / 1e9
    d = rec["deployment"]
    least = rec["key_switches"] * least_seconds(d["n"], d["levels"], d["dnum"])
    return 100.0 * least / busy if busy else None
