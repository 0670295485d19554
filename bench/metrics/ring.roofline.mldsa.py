"""The ring kernels' share of their roofline in the ML-DSA cell: the least
time the card could take for the ring arithmetic of the signatures
completed in the profiled sub-window, over the device time of the NTTs'
and the products' kernels (``csrc/ntt_regs.cuh``, ``csrc/ntt_banks.cu``,
``csrc/dyadic_inner.cu``) in it.

The work is counted from FIPS 204's Sign_internal, not from any kernel.
Each iteration of the rejection loop transforms ŷ (5 rows) and ĉ (1)
forward, w (6), cs1 (5) and cs2 (6) back, and takes Â ŷ's 30 products and
ĉ ŝ1's and ĉ ŝ2's 11; the iteration that passes the bounds on z and r0
also takes ĉ t̂0's 6 products and transforms ct0 (6) back, which the
floor counts once a signature (the accepted iteration), the least a
signature needs.  An NTT row counts at the larger of its bytes (1 KB
read and 1 KB written: 256 words of 4 bytes) at 3.35 TB/s and its
integer instructions on 132 x 64 INT32 lanes at 1980 MHz (128 x 8 lazy
butterflies of 8 and a final reduce of 1 a word forward, the n^-1
multiply of 4 a word back: ``runtime.roofline``'s BFLY_OPS, BAND_OPS and
MUL_OPS of the u32 lane).  The products count together: the rows they
must read and write (ŷ in and ŵ out, ĉ in and cs1, cs2, ct0 out; the
key's rows are shared by every slot and left out) against a Barrett
product and a lazy add of 8 instructions each.  Moves ``requests_per_s``."""
from benchlib import trace

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
N, STAGES, WORD_BYTES = 256, 8, 4
BUTTERFLY, FWD_EPILOGUE, INV_EPILOGUE, PRODUCT = 8, 1, 4, 8
ROW_BYTES = N * WORD_BYTES
AN_ITERATION = {"forward": 5 + 1, "inverse": 6 + 5 + 6, "products": 30 + 11,
                "product_rows": 5 + 6 + 1 + 11}
A_SIGNATURE = {"inverse": 6, "products": 6, "product_rows": 6}


def row_seconds() -> dict:
    """Least seconds of one NTT row each way: (bytes, instructions) at
    their rates, the larger."""
    fly = N // 2 * STAGES * BUTTERFLY
    work = {"forward": (2 * ROW_BYTES, fly + N * FWD_EPILOGUE),
            "inverse": (2 * ROW_BYTES, fly + N * INV_EPILOGUE)}
    return {k: max(b / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) for k, (b, ops) in work.items()}


def least_seconds(signatures: int, iterations: int) -> float:
    rows = row_seconds()
    ntt = (iterations * (AN_ITERATION["forward"] * rows["forward"]
                         + AN_ITERATION["inverse"] * rows["inverse"])
           + signatures * A_SIGNATURE["inverse"] * rows["inverse"])
    products = iterations * AN_ITERATION["products"] + signatures * A_SIGNATURE["products"]
    product_rows = (iterations * AN_ITERATION["product_rows"]
                    + signatures * A_SIGNATURE["product_rows"])
    return ntt + max(product_rows * ROW_BYTES / HBM_BYTES_PER_S,
                     products * N * PRODUCT / INT32_OPS_PER_S)


def read(rec):
    if not rec.get("window") or not rec.get("requests") or not rec.get("ring_kernels"):
        return None
    busy = trace.busy_ns(rec, trace.port_filter(rec["ring_kernels"])) / 1e9
    least = least_seconds(rec["requests"], rec.get("row_iterations", 0))
    return 100.0 * least / busy if busy else None
