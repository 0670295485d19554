"""Cycle-level simulator of the paper's SRM-based NTT-128 pipeline.

This is the reproduction of the paper's own "architecture simulator"
(§VII.C): seven processing elements, each with

  * two ping-pong coefficient banks of four FIFO shift-register queues
    (32 stages x 32 bit each; Fig 3 / Fig 12 discipline),
  * a circulating twiddle CSRM of length 2^t for PE_t (§VI.B.2),
  * a deep-pipelined butterfly unit modeled as a delay line
    (79 cycles, Table III).

A host model in numpy, the same in the JAX reference and here (held
equal by tests/test_torch_srm_sim.py); it takes no device.  Claims the
reference's tests validate:
  1. the FIFO write/read discipline computes the exact CG-NTT
     (functional equality with core.ntt on random polynomials);
  2. the memory layout equations (4)-(6): at PE_p the coefficient with
     in-stream index i sits at the location given by rotating the 7-bit
     address word (i6 i5 i4 i3 i2 i1 i0) left by p, with the first/last
     bits as queue enables and the middle five as the queue slot;
  3. WAR-hazard freedom: a bank is never read while being written;
  4. steady-state throughput = N/2 = 64 cycles per NTT (=> 531.25M
     NTT/s at 34 GHz), end-to-end latency 7 x 148 = 1,036 cycles
     (Table III: 79-cycle BU + 69-cycle memory per PE);
  5. the large-scale (2^14) and key-switch cycle models of §IX.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.params import NTTParams, make_ntt_params

CLOCK_GHZ = 34.0                 # paper: 29.4 ps clock
BU_LATENCY = 79                  # Table III
MEM_CLK_TO_Q = 5                 # Table III memory latency 69 = 64 fill + 5


class SRMQueue:
    """Tail-load, head-read shift register (the paper's FIFO SRM)."""

    def __init__(self, depth: int):
        self.depth = depth
        self.slots: deque = deque()

    def push(self, v) -> None:
        assert len(self.slots) < self.depth, "SRM overflow"
        self.slots.append(v)

    def pop(self):
        return self.slots.popleft()

    def __len__(self):
        return len(self.slots)


class CoefficientBank:
    """Four SRM queues; Fig 3 write/read discipline for one bank of N."""

    def __init__(self, n: int):
        self.n = n
        self.queues = [SRMQueue(n // 4) for _ in range(4)]
        self.wc = 0              # pairs written
        self.rc = 0              # pairs read
        self.mode = "write"

    def write_pair(self, d0, d1) -> None:
        assert self.mode == "write", "WAR hazard: write during read"
        half = self.n // 4       # pairs per half (e.g. 32 for n=128)
        q0, q1 = (0, 1) if self.wc < half else (2, 3)
        self.queues[q0].push(d0)
        self.queues[q1].push(d1)
        self.wc += 1
        if self.wc == self.n // 2:
            self.mode = "full"

    def start_read(self) -> None:
        assert self.mode == "full"
        self.mode = "read"

    def read_pair(self):
        assert self.mode == "read", "WAR hazard: read during write"
        qa, qb = (0, 2) if self.rc % 2 == 0 else (1, 3)
        a = self.queues[qa].pop()
        b = self.queues[qb].pop()
        self.rc += 1
        if self.rc == self.n // 2:
            self.mode = "write"
            self.wc = self.rc = 0
        return a, b

    def snapshot(self):
        """(queue_id, slot) -> value, for layout-equation checks."""
        out = {}
        for qi, q in enumerate(self.queues):
            for si, v in enumerate(q.slots):
                out[(qi, si)] = v
        return out


class TwiddleCSRM:
    """Wrap-around FIFO of the 2^t distinct stage twiddles, rotating one
    position per read (§VI.B.2: 'data rotates through the CSRM')."""

    def __init__(self, values):
        self.ring = deque(values)

    def read(self):
        v = self.ring[0]
        self.ring.rotate(-1)
        return v


@dataclasses.dataclass
class PEStats:
    first_in_cycle: int = -1
    first_out_cycle: int = -1
    pairs_out: int = 0


class PE:
    """One pipeline stage: ping-pong banks + BU delay line + CSRM."""

    def __init__(self, stage: int, p: NTTParams, bu_latency: int = BU_LATENCY,
                 mem_clk_to_q: int = MEM_CLK_TO_Q):
        self.stage = stage
        self.p = p
        self.n = p.n
        self.banks = [CoefficientBank(p.n), CoefficientBank(p.n)]
        self.wbank = 0           # bank currently written
        self.rbank: int | None = None
        distinct = 1 << stage
        self.tw = TwiddleCSRM([int(p.tw[stage, j]) for j in range(distinct)])
        self.bu = deque()        # (emit_cycle, (u, v))
        self.bu_latency = bu_latency
        self.mem_clk_to_q = mem_clk_to_q
        self.read_queue: deque = deque()   # (bank_idx, readable_from_cycle)
        self.stats = PEStats()
        self.layout_snapshots: list[dict] = []

    def butterfly(self, a: int, b: int, w: int) -> tuple[int, int]:
        q = self.p.q
        t = b * w % q
        return (a + t) % q, (a - t) % q

    def tick(self, cycle: int, in_pairs: deque, out_pairs: deque,
             snapshot_layout: bool = False) -> None:
        # 1. write one incoming pair into the write bank
        if in_pairs:
            if self.stats.first_in_cycle < 0:
                self.stats.first_in_cycle = cycle
            d0, d1 = in_pairs.popleft()
            bank = self.banks[self.wbank]
            bank.write_pair(d0, d1)
            if bank.mode == "full":
                if snapshot_layout:
                    self.layout_snapshots.append(bank.snapshot())
                # ping-pong swap: queue this bank for reading, write other
                bank.start_read()
                self.read_queue.append((self.wbank, cycle + 1))
                self.wbank ^= 1
        # 2. read one pair from the head readable bank into the BU
        #    (clk-to-q is an output latency, folded into the BU delay)
        if self.read_queue and cycle >= self.read_queue[0][1]:
            bank = self.banks[self.read_queue[0][0]]
            a, b = bank.read_pair()
            w = self.tw.read()
            u, v = self.butterfly(a, b, w)
            self.bu.append((cycle + self.mem_clk_to_q + self.bu_latency, (u, v)))
            if bank.mode == "write":           # drained; bank back to writes
                self.read_queue.popleft()
        # 3. BU delay line emits
        if self.bu and self.bu[0][0] <= cycle:
            _, pair = self.bu.popleft()
            out_pairs.append(pair)
            if self.stats.first_out_cycle < 0:
                self.stats.first_out_cycle = cycle
            self.stats.pairs_out += 1


class NTT128Pipeline:
    """The full 7-PE (for n=128; log2(n) in general) streaming pipeline."""

    def __init__(self, p: NTTParams | None = None, bu_latency: int = BU_LATENCY,
                 mem_clk_to_q: int = MEM_CLK_TO_Q):
        self.p = p or make_ntt_params(128)
        s = self.p.stages
        self.pes = [PE(t, self.p, bu_latency, mem_clk_to_q) for t in range(s)]

    def run(self, polys: np.ndarray, snapshot_layout: bool = False):
        """Stream ``polys`` (k, n) back-to-back, 2 coefficients/cycle.

        Returns (outputs (k, n) in the pipeline's native bit-reversed
        order, stats dict)."""
        polys = np.asarray(polys)
        k, n = polys.shape
        assert n == self.p.n
        streams = [deque() for _ in range(len(self.pes) + 1)]
        # primary input: natural order, one pair per cycle
        for poly in polys:
            for j in range(n // 2):
                streams[0].append((int(poly[2 * j]), int(poly[2 * j + 1])))

        out_needed = k * (n // 2)
        cycle = 0
        first_out = -1
        out_cycles = []
        max_cycles = 200_000
        while len(streams[-1]) < out_needed and cycle < max_cycles:
            before = len(streams[-1])
            for i, pe in enumerate(self.pes):
                pe.tick(cycle, streams[i], streams[i + 1], snapshot_layout)
            if len(streams[-1]) > before:
                if first_out < 0:
                    first_out = cycle
                out_cycles.append(cycle)
            cycle += 1
        assert len(streams[-1]) >= out_needed, "pipeline stalled"

        flat = []
        for u, v in streams[-1]:
            flat.extend([u, v])
        outputs = np.array(flat, dtype=np.uint32).reshape(k, n)
        # steady-state cadence: cycles between last pair of consecutive polys
        per_poly_last = [out_cycles[(i + 1) * (n // 2) - 1] for i in range(k)]
        cadence = (np.diff(per_poly_last).tolist() if k > 1 else [])
        stats = {
            "latency_cycles": first_out,
            "total_cycles": cycle,
            "cycles_per_ntt_steady": (cadence[-1] if cadence else None),
            "throughput_ntt_per_s": (CLOCK_GHZ * 1e9 / cadence[-1]) if cadence else None,
        }
        return outputs, stats


# ------------------------------------------------- §IX analytic models

def large_ntt_cycles(log2_n: int = 14, k_units: int = 1,
                     flush_cycles: int = 400) -> dict:
    """Paper §IX: an n=2^14 NTT as two passes of 2^7 NTT-128 each.

    cycles ≈ (128 * 64 / K) * 2 + flush;  'ideal' = 2 * 128 * 64."""
    assert log2_n == 14, "paper model is for 2^14 (two passes of NTT-128)"
    per_pass = 128 * 64
    ideal = 2 * per_pass
    total = (per_pass // k_units) * 2 + flush_cycles
    period_ns = 1.0 / CLOCK_GHZ
    return {
        "ideal_cycles": ideal,
        "ideal_latency_ns": ideal * period_ns,           # ≈ 482 ns
        "cycles": total,
        "latency_ns": total * period_ns,
        "cmos_ref_ns": 23_894.0,                          # HEAX @300MHz [36]
        "speedup_vs_cmos": 23_894.0 / (ideal * period_ns),
    }


def keyswitch_cycles(n_digits: int = 8, stage_cycles: int = 2600) -> dict:
    """Paper §IX key-switch model: L+1=8 outer iterations pipelined at
    2,600 cycles each -> 20,800 cycles -> 1.63M key-switch/s @34 GHz."""
    total = n_digits * stage_cycles
    period_s = 29.4e-12                                   # paper's 0.0294 ns
    thr = 1.0 / (period_s * total)
    return {
        "cycles": total,
        "throughput_per_s": thr,                          # ≈ 1.634e6
        "cmos_ref_per_s": 2616.0,                         # HEAX [36]
        "speedup_vs_cmos": thr / 2616.0,
        "components": {
            "intt_unit": 2600, "ntt_banks": 2600,
            "dyadic_mmma": 2400, "rns_floor_intt": 17000 // n_digits,
            "ms_array": 2600,
        },
    }


def table3_model(n: int = 128, bu_latency: int = BU_LATENCY,
                 mem_latency: int = 64 + MEM_CLK_TO_Q) -> dict:
    """Reproduces Table III's latency arithmetic."""
    stages = n.bit_length() - 1
    per_pe = bu_latency + mem_latency                     # 148
    return {
        "stages": stages,
        "per_pe_cycles": per_pe,
        "total_latency_cycles": stages * per_pe,          # 1,036
        "cycles_per_ntt": n // 2,                         # 64
        "throughput_mntt_per_s": CLOCK_GHZ * 1e9 / (n // 2) / 1e6,  # 531.25
    }
