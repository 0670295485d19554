"""The Keccak kernels' share of their roofline in the ML-KEM cell: the
least time the card could take for the Keccak work of the encapsulations
completed in the profiled sub-window, over the device time of the
``csrc/keccak.cu`` kernels in it.

The work is counted from FIPS 203 and 202, not from any kernel.  An
encapsulation hashes H(ek), 1184 bytes at SHA3-256's rate of 136: 9
permutations (the padding takes a ninth block); G(m || H(ek)), 64 bytes
at SHA3-512's 72: 1; SampleNTT's 9 SHAKE128 streams at 3 blocks at least
(256 coefficients take 384 bytes at the least, 168 a block): 27; and 7
PRF streams of SHAKE256 (33 bytes in, 128 out): 7.  44 permutations.

A permutation is 24 rounds of 90 operations on 64-bit lanes: theta's 10
three-input XORs of the column sums, 5 rotations of them and 25
three-input XORs applying them, rho's 24 rotations, chi's 25
three-input logic functions (a ^ (~b & c)) and iota's 1.  An operation
on a 64-bit lane is 2 INT32 instructions on its 32-bit halves (a
rotation two funnel shifts, a three-input logic function one LOP3 a
half, counted once), so 4320 instructions, on 132 SMs x 64 INT32 lanes at
1980 MHz.  No kernel does a permutation in fewer, so the share cannot
pass 100%; a kernel that squeezes more SampleNTT blocks than three does
more work than the floor counts.  The bytes (1.2 KB in and 1.6 KB out a
row) take a tenth of that time at 3.35 TB/s.  Moves ``requests_per_s``."""
from benchlib import trace

INT32_OPS_PER_S = 132 * 64 * 1.98e9
PERMS_A_ENCAPS = 9 + 1 + 9 * 3 + 7
ROUNDS = 24
LANE_OPS_A_ROUND = 10 + 5 + 25 + 24 + 25 + 1
INT32_A_LANE_OP = 2


def least_seconds(encapsulations: int) -> float:
    ops = encapsulations * PERMS_A_ENCAPS * ROUNDS * LANE_OPS_A_ROUND * INT32_A_LANE_OP
    return ops / INT32_OPS_PER_S


def read(rec):
    if not rec.get("window") or not rec.get("requests") or not rec.get("keccak_kernels"):
        return None
    busy = trace.busy_ns(rec, trace.port_filter(rec["keccak_kernels"])) / 1e9
    return 100.0 * least_seconds(rec["requests"]) / busy if busy else None
