"""The Keccak kernels' share of their roofline in the ML-DSA cell: the
least time the card could take for the Keccak work of the signatures
completed in the profiled sub-window, over the device time of the
``csrc/keccak.cu`` kernels in it.

The work is counted from FIPS 204 and FIPS 202, not from any kernel.  A
signature hashes mu = H(tr || M'), 64 + 132 bytes at SHAKE256's rate of
136: 2 permutations, and rho'' = H(K || rnd || mu), 128 bytes: 1; and
each iteration of its rejection loop runs ExpandMask's 5 SHAKE256
streams of 640 bytes (5 permutations each: 25), c-tilde = H(mu ||
w1Encode(w1), 48) over 832 bytes (7) and SampleInBall's first block
(1): 33 at the least.  So 3 + 33 x iterations a signature, the
iterations read from the stream's counters (the iterations the
completed signatures needed).

A permutation is 4320 INT32 instructions on 132 SMs x 64 INT32 lanes at
1980 MHz, as ``keccak.roofline.mlkem`` counts them.  No kernel does a
permutation in fewer, so the share cannot pass 100%.  Moves
``requests_per_s``."""
from benchlib import trace

INT32_OPS_PER_S = 132 * 64 * 1.98e9
PERM_INT32 = 24 * (10 + 5 + 25 + 24 + 25 + 1) * 2
PERMS_A_SIGNATURE = 2 + 1
PERMS_AN_ITERATION = 5 * 5 + 7 + 1


def least_seconds(signatures: int, iterations: int) -> float:
    perms = signatures * PERMS_A_SIGNATURE + iterations * PERMS_AN_ITERATION
    return perms * PERM_INT32 / INT32_OPS_PER_S


def read(rec):
    if not rec.get("window") or not rec.get("requests") or not rec.get("keccak_kernels"):
        return None
    busy = trace.busy_ns(rec, trace.port_filter(rec["keccak_kernels"])) / 1e9
    least = least_seconds(rec["requests"], rec.get("row_iterations", 0))
    return 100.0 * least / busy if busy else None
