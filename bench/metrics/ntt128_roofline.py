"""The NTT-128 transforms' share of their roofline: the least time the
card could take for the transforms completed in the profiled sub-window,
over the card's busy time in it.

The work is counted from the transforms, not from any kernel: each
128-point row reads and writes each of its 128 words (4 bytes) once, and
its 64 x 7 butterflies take 8 integer operations each.  The least time
is the larger of the bytes at the HBM rate and the operations on the
INT32 lanes (the H100 SXM data sheet: 3.35 TB/s; 132 SMs x 64 lanes at
1980 MHz).  Moves ``ntt_per_s``."""
from benchlib import trace

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
WORD_BYTES = 4
OPS_PER_BUTTERFLY = 8


def least_seconds(transforms: int, n: int) -> float:
    stages = n.bit_length() - 1
    bytes_ = transforms * n * WORD_BYTES * 2
    ops = transforms * (n // 2) * stages * OPS_PER_BUTTERFLY
    return max(bytes_ / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def read(rec):
    if not rec.get("window") or not rec["transforms"]:
        return None
    busy = trace.busy_ns(rec) / 1e9
    return 100.0 * least_seconds(rec["transforms"], rec["n"]) / busy if busy else None
