"""The ring kernels' share of their roofline in the ML-KEM cell: the least
time the card could take for the ring arithmetic of the encapsulations
completed in the profiled sub-window, over the device time of the
incomplete NTTs' and the basecase product's kernels (``csrc/ntt_regs.cuh``,
``csrc/ntt_banks.cu``, ``csrc/dyadic_basemul.cu``) in it.

The work is counted from FIPS 203's encryption, not from any kernel: a
row transforms ŷ forward (3 polynomials), u and v back (3 + 1), and
takes Âᵀ ŷ's 9 and t̂ᵀ ŷ's 3 basecase products.  Each is counted as
PERF.md's kernel table counts the bounds of the u16 banks and the
product: the larger of its bytes (2-byte words, each read and written
once; a product reads two rows and writes one) at 3.35 TB/s and its
integer instructions on 132 x 64 INT32 lanes at 1980 MHz: a forward row
128 x 7 lazy butterflies of 9 and a final reduce a word, an inverse row
the same butterflies and the n^-1 multiply of 5 a word, a product row
128 pairs of 57 (``runtime.roofline``'s BFLY_OPS, MUL_OPS and
BASEMUL_OPS for the u16 lane).  The tables (per call, not per row) are
left out, which lowers the floor.  Moves ``requests_per_s``."""
from benchlib import trace

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
N, STAGES, WORD_BYTES = 256, 7, 2
BUTTERFLY, FWD_EPILOGUE, INV_EPILOGUE, PAIR = 9, 1, 5, 57
ROWS_A_ENCAPS = {"forward": 3, "inverse": 4, "product": 12}


def row_seconds() -> dict:
    """Least seconds of one row of each kind: (bytes, instructions) at
    their rates, the larger."""
    fly = N // 2 * STAGES * BUTTERFLY
    work = {"forward": (2 * N * WORD_BYTES, fly + N * FWD_EPILOGUE),
            "inverse": (2 * N * WORD_BYTES, fly + N * INV_EPILOGUE),
            "product": (3 * N * WORD_BYTES, N // 2 * PAIR)}
    return {k: max(b / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) for k, (b, ops) in work.items()}


def least_seconds(encapsulations: int) -> float:
    rows = row_seconds()
    return encapsulations * sum(n * rows[k] for k, n in ROWS_A_ENCAPS.items())


def read(rec):
    if not rec.get("window") or not rec.get("requests") or not rec.get("ring_kernels"):
        return None
    busy = trace.busy_ns(rec, trace.port_filter(rec["ring_kernels"])) / 1e9
    return 100.0 * least_seconds(rec["requests"]) / busy if busy else None
