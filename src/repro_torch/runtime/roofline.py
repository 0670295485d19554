"""Roofline terms of a counted program on the H100, the port's
counterpart of the reference's ``runtime/roofline.py``.

compute  = counted FLOPs / peak rate                [runtime.op_cost]
memory   = counted bytes / HBM rate                 [runtime.op_cost]
collect. = ring-model link traffic / link rate      [op_cost's records]

Ring-model traffic per collective of ``bytes`` per device over a group
of n devices (the reference's multipliers):
  all-reduce       2 * bytes * (n-1)/n
  all-gather       bytes_out * (n-1)/n
  reduce-scatter   bytes_out * (n-1)          (input = n * output)
  all-to-all       bytes * (n-1)/n
  collective-permute  bytes (single hop)

The constants are the H100 SXM's data-sheet figures.  The link rate is
one 400 Gb/s NDR InfiniBand port per card (50e9 B/s), as in a DGX H100:
a 16 x 16 mesh crosses nodes on both axes, so its collectives leave the
node.  Within one node NVLink 4 carries 450e9 B/s a direction per card;
a collective that stays inside a node is that much faster, so treat the
collective term as an upper bound.  The integer cells (the FHE dry runs)
use ``INT32_OPS_PER_S``: 132 SMs x 64 INT32 lanes at the 1980 MHz boost
clock.

``banks_int_ops`` and the instruction counts below are the integer model
of the port's NTT kernels that ``chip_smoke.py``'s kernel bounds use too,
so the kernel table and the dry run read one set of numbers.

The reference's ``parse_collectives`` reads collectives out of compiled
HLO text; the port has no HLO to parse, and ``runtime.op_cost`` records
each collective where it happens instead, so it is not ported.
"""
from __future__ import annotations

import dataclasses

# H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = 989.4e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 50e9               # bytes/s: one 400 Gb/s NDR port per card
HBM_BYTES = 80e9             # bytes of device memory (80 GB)
SM_COUNT = 132
INT32_LANES = SM_COUNT * 64  # INT32 lanes a clock
BOOST_MHZ = 1980
INT32_OPS_PER_S = INT32_LANES * BOOST_MHZ * 1e6

# integer instructions of the reference's op sequence as sm_90a compiles
# it (ntt_regs::Arith, counted by tools/sass_ntt_banks.py's probe): a lazy
# u32 butterfly is 8 (IMAD.HI, IMAD, IMAD for the Shoup product; IMAD.IADD,
# VIADDMNMX for the add; ISETP, SEL, IADD3 for the subtract), the u16
# lane's 9 (its product is IMAD, SHF, IMAD, IMAD), eager ones 1 more (the
# product's band reduce).  A pre-weight or epilogue multiply is the
# product (and its band reduce when eager), a final reduce one VIADDMNMX.
# Keys: (bytes a word, lazy).
BFLY_OPS = {(4, True): 8, (4, False): 9, (2, True): 9, (2, False): 10}
MUL_OPS = {(4, True): 3, (4, False): 4, (2, True): 4, (2, False): 5}
BAND_OPS = 1
# integer-ALU instructions a pair of the basecase product's vector body
# at k = 1 (its item loop of 2 pairs, index arithmetic included, as
# tools/time_basemul.py --sass counts them in the built library), by lazy
BASEMUL_OPS = {True: 57, False: 58}


def banks_int_ops(x, stages: int, *, fwd: bool, negacyclic: bool, lazy: bool,
                  reduce_out: bool) -> int:
    """Integer instructions the reference's op sequence needs for one
    banks transform of x (k, B, n): the butterflies, the pre-weight or
    epilogue multiply and the final reduce (BFLY_OPS, MUL_OPS, BAND_OPS)."""
    w = x.element_size()
    words = x.numel()
    ops = words // 2 * stages * BFLY_OPS[(w, lazy)]
    if fwd:
        ops += (words * MUL_OPS[(w, lazy)] if negacyclic else 0) + \
            (BAND_OPS * words if lazy and reduce_out else 0)
    else:
        ops += words * MUL_OPS[(w, lazy and not reduce_out)]
    return ops


def ring_traffic(op: str, nbytes: float, n: int) -> float:
    """Ring-model link bytes of one collective of ``nbytes`` per device
    over ``n`` devices."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * nbytes * (n - 1) / n
    if op in ("all-gather", "all-to-all"):
        return nbytes * (n - 1) / n
    if op == "reduce-scatter":
        return float(nbytes) * (n - 1)
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_op: dict
    traffic_bytes: float

    def total_ops(self):
        return sum(self.counts.values())


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    collectives: CollectiveStats
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "collective_traffic_bytes": self.collectives.traffic_bytes,
            "collective_counts": self.collectives.counts,
            "collective_bytes_by_op": self.collectives.bytes_by_op,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "useful_ratio": self.useful_ratio,
        }


def roofline_from_counts(cost, model_flops: float = 0.0, n_devices: int = 1,
                         peak: float = PEAK_FLOPS) -> Roofline:
    """``cost`` is a per-device ``op_cost.Cost``; model_flops is the
    GLOBAL 6ND/2ND figure, divided by n_devices before comparison with
    the per-device count.  ``peak`` is the compute rate: ``PEAK_FLOPS``
    for the models, ``INT32_OPS_PER_S`` for the integer cells."""
    stats = CollectiveStats(dict(cost.coll_counts), dict(cost.coll_bytes),
                            cost.coll_traffic)
    compute_s = cost.flops / peak
    memory_s = cost.bytes / HBM_BW
    collective_s = stats.traffic_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf_dev = model_flops / max(n_devices, 1)
    useful = mf_dev / cost.flops if cost.flops else 0.0
    return Roofline(cost.flops, cost.bytes, stats, compute_s, memory_s,
                    collective_s, dominant, mf_dev, useful)
