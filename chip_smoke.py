#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and run its main paths on one GPU.

    python3 chip_smoke.py

Phases (any mismatch raises, so the exit code is non-zero):
  1. build     compile every kernel from src/repro_torch/csrc (one nvcc per
               source, in parallel) and print the card's name and power limit
  2. kernels   hold each kernel against its plain PyTorch version on the
               card, at the shapes of the CKKS multiply -> rescale and
               rotation paths at n = 2^14 with 8 + 1 primes (and one
               bit-reversed gather case at n = 1024); the NTT banks at the
               four-step passes' rows of a B = 1 and a B = 8 request and an
               odd row count, and at n = 8192 .. 2^17 (two passes through
               scratch); the weight-row multiply also at B = 1 and 8 of the
               2^14 ring, on a ring of 2 (its one-word path), on an
               unaligned view and with x over the whole u32 range; the
               three gathers also at n = 2^16 and 2^17, above one block's
               shared memory, and the hoisted rotation's c0 gather
               (1, k, 1, n) fanned out to R = 8, and at 2^14 and 2^16 on
               indices drawn from [-2n, 2n) (a negative one counts from
               the end of the row, one outside [-n, n) gives all ones);
               lazy and eager throughout; results must be bit-identical
  3. slice     CkksContext(n=2^14, levels=7) on the card: encrypt 8 slot
               vectors, answer 4 single multiply -> rescale requests and one
               multiply_many -> rescale_many batch of 8, decrypt_decode every
               answer.  Checks the slot error against the numpy product, that
               the same requests on device="cpu" give bit-identical residue
               stacks, and that every kernel of the path launched and no
               plain version ran during the card's run
  3b. rotation a second CkksContext(n=2^14, levels=7) prepared with 15 Galois
               keys: rotate by 1 and 7, conjugate, rotate_many of 8 with mixed
               amounts 1..8, conjugate_many of 8, rotate_hoisted by 1..8, one
               64 x 64 BSGS matvec and rotate_sum over its 64 outputs.  Checks
               each answer against numpy (np.roll, np.conj, x @ W, the
               sliding sum), bit-identity with the same traffic on the CPU,
               and that every kernel of the path launched and no plain
               version ran
  3e. rot16    rotations above one block's shared memory: a
               CkksContext(n=2^16, levels=3) with Galois keys for 1 and 2:
               rotate by 1, rotate_many by (1, 2), rotate_hoisted by (1, 2)
               and a 4 x 4 matvec, checked against numpy, bit for bit
               against the same requests on device="cpu", and that every
               kernel of the rotation path launched and no plain version ran
  3f. serve    the serving engine (fhe/serve.py) at full width: a third
               CkksContext(n=2^14, levels=7) and a 64 x 64 matrix pack,
               the plan prepared at the full basis and one level down with
               every program captured as a CUDA graph for group sizes 8,
               16, 24 and 32 and the matvec composite (the graphs' memory
               printed); synthetic_trace of 32 requests (mixed kinds and
               levels, rotation amounts in [-2, slots + 3)) drained by run
               and run_async as a backlog, then by run_async under Poisson
               arrivals at half the backlog's measured rate; a mixed queue
               of multiplies, conjugations and 4 ML-KEM decaps at b = 1.
               Checks that no drain captures a graph (fresh_traces == 0)
               or fails a request, async == sync bit for bit, every answer
               equals the eager module-level program on the card, every
               CKKS kernel launched through the replays and no plain
               version ran, and a seeded subset of 8 requests and the mixed
               queue (the decaps' bytes included) equal a CPU run
  3g. scaleout the tile funnel and the batch-sharded EvalPlan at 2^14 with
               8 + 1 primes: autotune.ensure("serve_batch", 8, 2^14, 32,
               shards=2) measured on the card (its candidate table printed
               in ms), its sidecar written to a temporary file and read back
               by a fresh copy of the module, and a resolve inside a CUDA
               graph capture that must not measure; EvalPlan over a mesh of
               the card once and twice (two cards when there are two)
               running multiply_many -> rescale_many, mixed rotate_many,
               conjugate_many of 5, rotate_hoisted by 7 amounts and the
               64 x 64 matvec (batches that pad), bit for bit against the
               unsharded plan; a CkksServeEngine over the two-shard plan
               with batch_tile=None (the tuned entry): group tile, equal
               per_device_rows, fresh_traces == 0, answers == the tile-8
               unsharded drain of phase 3f, and its run_async timed against
               that engine's in interleaved rounds; fourstep_ntt_sharded at
               128 x 128 over 1, 2 and 4 shards == fourstep_ntt; every kernel
               of the rotation path launched, no plain version ran
  3c. mlkem    ML-KEM-768 (FIPS 203) on the u16 lane: the two u16 NTT
               instantiations and the basecase product held bit for bit
               against their plain versions at every shape of the b = 1 and
               b = 256 paths and at an odd batch, the basecase product also
               on both of its bodies (the vector body at those shapes and
               at n = 4, the one-pair body at n = 2 and on a view at an odd
               word); the 4 in-repo KAT vectors
               (ek, dk, ct, K, implicit rejection) on the card; a b = 256
               keygen -> encaps -> decaps round from the seed with equal
               shared keys and the rejection key for tampered ciphertexts;
               every byte equal to the same requests on device="cpu"; each
               of the three kernels launched, no plain version ran, and the
               launches per entry point are the module's
  3d. ntt128   the paper's single-prime NTT-128 unit on the card, through
               ops.ntt / intt / dyadic_mul / dyadic_mac with 30-bit primes:
               the four single-prime kernels held bit for bit against their
               plain versions at every shape of the path, at one row, at an
               uneven 100003 rows, on a view that is not 16-byte aligned and
               at every ring of 2 .. 4096 words (B = 37), lazy and eager,
               the lazy inverse on [0, 2q) inputs; below 64 words, on the
               unaligned views, at n = 8192 and 16384 (B = 13) and through
               ops.ntt / intt at n = 2^15 the transforms run as a one-prime
               bank on the banks launchers; then 10^5 random NTT-128s
               (paper §VII.C; a cyclic forward, the Table III transform, and
               a negacyclic forward -> inverse round trip), negacyclic
               products ntt -> dyadic_mul -> intt at n = 1024 and 4096 (64
               pairs), and an 8-digit product sum (one dyadic_mul, seven
               dyadic_mac, one intt) at n = 4096.  Checks every row against
               the same calls on device="cpu", 512 rows against the
               brute-force oracle, 3 against the SRM pipeline model, 4 rows of
               each product against the schoolbook convolution, the product
               sum against numpy, and that each kernel launched and no plain
               version ran
  4. times     per kernel (CUDA events around a CUDA-graph replay, so the
               device time) beside its memory bound (the NTT banks and the
               single-prime transforms also beside an integer-instruction
               bound at the SM clock that nvidia-smi reads during the
               timings, and the basecase product beside its instructions
               a pair; bound_by names the larger), the banks also at a
               B = 1 request's shapes and at
               2^15 .. 2^17, its eager call, its
               plain version and, for the gathers, the one PyTorch call that
               computes the same function; request latencies of the CKKS
               paths (interleaved rounds: median, quartiles, ratio to a
               rotate of the same round; the plans' programs as CUDA
               graphs, and multiply + rescale at B = 1 and 8, rotate and
               the matvec also on the plans' eager twins, which run the
               module-level programs) and of keygen, encaps and decaps at
               b = 1 and b = 256 (interleaved rounds, handshakes per
               second), NTT-128s per second at B = 10^5 and the host-clock
               latency of that request and of the n = 4096 product, and a
               torch.profiler breakdown of one request's device time (one
               decaps at b = 256 and one NTT-128 batch among them, each CKKS
               request graphed and eager)

    python3 chip_smoke.py --seed N     # another seed for every phase

The last line of standard output is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the per-kernel JSON record.  Imports torch, numpy and
the port only.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 20250821
N = 1 << 14
LEVELS = 7                       # L+1 = 8 ciphertext primes + special P
BATCH = 8
SLOT_TOL = 1e-2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)
INT32_LANES = 132 * 64           # H100 SXM: 132 SMs x 64 INT32 lanes a clock
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
REPS = 25                        # timing repetitions, median reported
LAT_ROUNDS = 20                  # interleaved rounds of the request latencies
PROFILE_TRIES = 3                # profiles of a request before its breakdown is "not measured"

ROT_AMOUNTS = tuple(range(1, BATCH + 1))
MV_DIM = 64                      # bsgs_split(64) = (8, 8)

MLKEM_B = 256                    # a batch of handshakes (b = 1 for latency)
MLKEM_ODD_B = 5
KAT_PATH = os.path.join(ROOT, "tests", "vectors", "mlkem768_kat.json")

NTT128_B = 100_000               # paper §VII.C: 10^5 random NTT-128s
NTT128_BRUTE = 512               # rows held against the brute-force oracle
NTT128_SRM = 3                   # polynomials held against the SRM model
PRODUCT_NS = (1024, 4096)
PRODUCT_B = 64                   # polynomial pairs per product request
PRODUCT_ROWS = 4                 # rows held against the schoolbook product
MAC_N = 4096
MAC_DIGITS = 8                   # the MM -> MA chain: 1 dyadic_mul, 7 dyadic_mac
EDGE_NS = (16, 8192, 16384)
EDGE_B = 13
RING_B = 37                      # rows of every ring of 2 .. 4096 words
UNEVEN_B = 100_003               # rows that split unevenly over the grid
BIG_BANKS_NS = (8192, 16384, 1 << 15, 1 << 16, 1 << 17)  # two passes through scratch
SINGLE_BANK_N = 1 << 15          # ops.ntt / intt as a one-prime bank
N16 = 1 << 16                    # rotation rows above one block's shared memory
N17 = 1 << 17                    # the longest ring the banks take
ROT16_LEVELS = 3
ROT16_AMOUNTS = (1, 2)
ROT16_MV = 4                     # bsgs_split(4) = (2, 2): keys for 1 and 2
NTT128_KERNELS = ("ntt_fwd", "ntt_inv", "dyadic_mul", "dyadic_mac")
SERVE_N = 32                     # requests of the serving phase's trace
SERVE_TILE = 8                   # the engine's batch tile (the reference's default)
SERVE_SIZES = (8, 16, 24, 32)    # padded group sizes up to max_batch = 4 tiles
SERVE_CPU = 8                    # the seeded subset of the trace the CPU drains again
SERVE_DECAPS = 4                 # ML-KEM decaps at b = 1 in the mixed queue
POISSON_LOAD = 0.5               # Poisson arrivals at this share of the backlog rate
SCALE_SHARDS = 2                 # the "b" mesh of phase 3g: the card twice
SCALE_B = 5                      # its batches and rotations pad 5 -> 6 and 7 -> 8
SCALE_R = 7
SCALE_ROUNDS = 3                 # interleaved drains, sharded against unsharded
FOURSTEP_SHARDS = (1, 2, 4)      # fourstep_ntt_sharded at 128 x 128

REPLACES = {
    "ntt_fwd_banks": "src/repro/kernels/ntt_kernel.py:306",
    "ntt_inv_banks": "src/repro/kernels/ntt_kernel.py:320",
    "twiddle_mul_banks": "src/repro/kernels/ntt_kernel.py:346",
    "dyadic_inner_banks": "src/repro/kernels/dyadic_kernel.py:175",
    "galois_banks": "src/repro/kernels/galois_kernel.py:50",
    "galois_banks_multi": "src/repro/kernels/galois_kernel.py:73",
    "galois_digits": "src/repro/kernels/galois_kernel.py:110",
    "ntt_fwd_banks_u16": "src/repro/kernels/ntt_kernel.py:306",
    "ntt_inv_banks_u16": "src/repro/kernels/ntt_kernel.py:320",
    "dyadic_basemul_banks": "src/repro/kernels/dyadic_kernel.py:251",
    "ntt_fwd": "src/repro/kernels/ntt_kernel.py:216",
    "ntt_inv": "src/repro/kernels/ntt_kernel.py:227",
    "dyadic_mul": "src/repro/kernels/dyadic_kernel.py:129",
    "dyadic_mac": "src/repro/kernels/dyadic_kernel.py:136",
}
SOURCE = {
    "ntt_fwd_banks": "src/repro_torch/csrc/ntt_banks.cu",
    "ntt_inv_banks": "src/repro_torch/csrc/ntt_banks.cu",
    "twiddle_mul_banks": "src/repro_torch/csrc/ntt_banks.cu",
    "dyadic_inner_banks": "src/repro_torch/csrc/dyadic_inner.cu",
    "galois_banks": "src/repro_torch/csrc/galois.cu",
    "galois_banks_multi": "src/repro_torch/csrc/galois.cu",
    "galois_digits": "src/repro_torch/csrc/galois.cu",
    "ntt_fwd_banks_u16": "src/repro_torch/csrc/ntt_banks.cu",
    "ntt_inv_banks_u16": "src/repro_torch/csrc/ntt_banks.cu",
    "dyadic_basemul_banks": "src/repro_torch/csrc/dyadic_basemul.cu",
    "ntt_fwd": "src/repro_torch/csrc/ntt.cu",
    "ntt_inv": "src/repro_torch/csrc/ntt.cu",
    "dyadic_mul": "src/repro_torch/csrc/dyadic.cu",
    "dyadic_mac": "src/repro_torch/csrc/dyadic.cu",
}
MLKEM_KERNELS = ("ntt_fwd_banks_u16", "ntt_inv_banks_u16", "dyadic_basemul_banks")
# the kernels each path must launch: multiply -> rescale runs the key
# switch; the rotation path runs the key switch and all three gathers;
# ML-KEM runs the u16 transforms and the basecase product; the NTT-128
# path the four single-prime kernels
PATH_KERNELS = {
    "multiply": ("ntt_fwd_banks", "ntt_inv_banks", "twiddle_mul_banks",
                 "dyadic_inner_banks"),
    "rotation": ("ntt_fwd_banks", "ntt_inv_banks", "twiddle_mul_banks",
                 "dyadic_inner_banks", "galois_banks", "galois_banks_multi",
                 "galois_digits"),
    "mlkem": MLKEM_KERNELS,
    "ntt128": NTT128_KERNELS,
}
PATH_KERNELS["rot16"] = PATH_KERNELS["rotation"]
PATH_KERNELS["serve"] = PATH_KERNELS["rotation"]
PATH_KERNELS["scaleout"] = PATH_KERNELS["rotation"]
# launches per ML-KEM entry point at any batch: (u16 forward NTTs, u16
# inverse NTTs, basecase products), as pq/mlkem.py issues them
MLKEM_LAUNCHES = {"keygen": (1, 0, 1), "encaps": (1, 2, 2), "decaps": (2, 3, 3)}
# device function names of the port's kernels, as the profiler sees them
DEVICE_FUNCTIONS = ("ntt_rows_kernel", "ntt_cols_kernel",
                    "twiddle_mul_banks_kernel", "dyadic_inner_banks_kernel",
                    "galois_split_kernel", "galois_bulk_kernel",
                    "basemul_vec_kernel", "basemul_pair_kernel",
                    "ntt_stream_kernel", "dyadic_mul_kernel",
                    "dyadic_mac_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def residues(rng, qs, shape, band=1):
    """Random int32 residues, row p in [0, band * qs[p])."""
    rows = [rng.integers(0, band * int(q), size=shape, dtype=np.int64)
            for q in qs]
    return torch.from_numpy(np.stack(rows).astype(np.int32)).cuda()


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


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


class SmClock:
    """The SM clock (MHz) as nvidia-smi reads it every 100 ms while the
    timings run; ``mhz`` is the highest reading (the fastest the card
    ran, so the integer bound is the least time)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        readings = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
        self.mhz = max(readings) if readings else None
        self.samples = len(readings)
        return False


def int_bound_ms(ops: int, mhz: float) -> float:
    return ops / (INT32_LANES * mhz * 1e6) * 1e3


BESIDE = []      # (label, kernel ms, byte bound ms, integer ops) off the path's shapes


def eager_ms(fn, reps=REPS, inner=5) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    eager calls between CUDA events, after a warm-up.  For a small kernel
    this is the wrapper's host cost per call, not the kernel's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def graph_ms(fn, reps=REPS, inner=10) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    the graph replayed ``reps`` times between CUDA events, median of the
    per-call mean.  Replay has no host work between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def interleaved_host_ms(fns: dict, rounds: int) -> dict:
    """Host-clock times of each request ending in a device synchronize,
    taken in turns: each round runs every request once, in order, so a
    change of the host's speed during the run lands on all of them alike.
    Returns {label: [ms of round 0, round 1, ...]}."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {label: [] for label in fns}
    for _ in range(rounds):
        for label, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
    return times


# ------------------------------------------------------------ phase 1

def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    info = build.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s for {sorted(info)}")
    for name, rec in info.items():
        log(f"[build] {name}: {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "error" in line.lower():
                log(f"[build]   {line.strip()}")
    for name in build.SOURCES:
        build.load(name)
        log(f"[build] {build.library_path(name).name}")
    log(f"[gpu] {gpu_line()}")


# ------------------------------------------------------------ phase 2

def phase_kernels(fs_pack, ks_primes) -> dict:
    """Each kernel against its plain version at the path's shapes."""
    from repro_torch.fhe import batched as FB
    from repro_torch.fhe import rns
    from repro_torch.kernels import dyadic_kernel, ntt_kernel, ref
    rng = np.random.default_rng(SEED)
    err = {}
    k = len(ks_primes)
    qs = fs_pack["qs"]

    def check(name, got, want, what):
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err[name] = max(err.get(name, 0), e)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: kernel != plain version "
                                 f"(max abs err {e})")

    # n = 128: the forward pass rows of a B = 1 / B = 8 multiply's
    # decompose (1024 / 8192), its inverse's (128 / 1024), an odd count
    packs = [(128, fs_pack["pack1"], rows) for rows in (37, 128, 1024, 8192)]
    packs.append((1024, FB.build_table_pack(rns.make_primes(1024, k), 1024, "cuda"), 1024))
    for n, t, rows in packs:
        for lazy in (False, True):
            x = residues(rng, [int(v) for v in t["qs"].cpu()], (rows, n),
                         band=2 if lazy else 1)
            xr = residues(rng, [int(v) for v in t["qs"].cpu()], (rows, n))
            for reduce_out in (False, True):
                for neg in (False, True):
                    what = (f"(B, n)=({rows}, {n}) lazy={lazy} reduce_out={reduce_out} "
                            f"negacyclic={neg}")
                    args = (t["qs"], t["tw"], t["twp"], t["psi"], t["psip"])
                    check("ntt_fwd_banks",
                          ntt_kernel.ntt_fwd_banks(xr, *args, negacyclic=neg,
                                                   lazy=lazy, reduce_out=reduce_out),
                          ref.ntt_fwd_banks_ref(xr, *args, neg, lazy=lazy,
                                                reduce_out=reduce_out), what)
                    iargs = (t["qs"], t["ninv"], t["ninv_p"], t["itw"], t["itwp"],
                             t["ipsin"], t["ipsinp"])
                    check("ntt_inv_banks",
                          ntt_kernel.ntt_inv_banks(x, *iargs, negacyclic=neg,
                                                   lazy=lazy, reduce_out=reduce_out),
                          ref.ntt_inv_banks_ref(x, *iargs, neg, lazy=lazy,
                                                reduce_out=reduce_out), what)
    for n in BIG_BANKS_NS:
        t = FB.build_table_pack(rns.make_primes(n, 3), n, "cuda")
        for lazy in (False, True):
            x = residues(rng, [int(v) for v in t["qs"].cpu()], (EDGE_B, n),
                         band=2 if lazy else 1)
            xr = residues(rng, [int(v) for v in t["qs"].cpu()], (EDGE_B, n))
            for reduce_out in (False, True):
                for neg in (False, True):
                    what = f"n={n} lazy={lazy} reduce_out={reduce_out} negacyclic={neg}"
                    args = (t["qs"], t["tw"], t["twp"], t["psi"], t["psip"])
                    kw = dict(lazy=lazy, reduce_out=reduce_out)
                    check("ntt_fwd_banks",
                          ntt_kernel.ntt_fwd_banks(xr, *args, negacyclic=neg, **kw),
                          ref.ntt_fwd_banks_ref(xr, *args, neg, **kw), what)
                    iargs = (t["qs"], t["ninv"], t["ninv_p"], t["itw"], t["itwp"],
                             t["ipsin"], t["ipsinp"])
                    check("ntt_inv_banks",
                          ntt_kernel.ntt_inv_banks(x, *iargs, negacyclic=neg, **kw),
                          ref.ntt_inv_banks_ref(x, *iargs, neg, **kw), what)
    check_twiddle(check, rng, fs_pack)
    sp_qs = [int(v) for v in qs.cpu()]
    ext = torch.stack([residues(rng, sp_qs, (BATCH, N)) for _ in range(k - 1)])
    keys = {"shared": torch.stack([residues(rng, sp_qs, (N,)) for _ in range(k - 1)]),
            "per-batch": torch.stack([residues(rng, sp_qs, (BATCH, N))
                                      for _ in range(k - 1)])}
    mus = FB.build_scalar_pack(ks_primes, "cuda")["mu"]
    for kind, evk in keys.items():
        for lazy in (False, True):
            check("dyadic_inner_banks",
                  dyadic_kernel.dyadic_inner_banks(ext, evk, qs, mus, lazy=lazy),
                  ref.dyadic_inner_banks_ref(ext, evk, qs, mus, lazy=lazy),
                  f"ext {tuple(ext.shape)} {kind} key lazy={lazy}")
    check_gathers(check, rng, [int(v) for v in qs.cpu()][:k - 1])
    for name, e in err.items():
        log(f"[kernels] {name}: bit-identical to its plain version (max abs err {e})")
    return err


def check_twiddle(check, rng, fs_pack) -> None:
    """The weight-row multiply, lazy and eager, on its vector path at the
    four-step pass's shape (k primes x the B = 8 multiply's 64 columns of
    2^14) and at B = 1 and 8 of the 2^14 ring, with x in [0, 2q) and over
    the whole u32 range; on its one-word path on a ring of 2 and on a
    view one word past a 16-byte boundary."""
    from repro_torch.kernels import ntt_kernel, ref
    qs, w, wp = fs_pack["qs"], fs_pack["tw"], fs_pack["twp"]
    k = qs.shape[0]
    ql = [int(v) for v in qs.cpu()]
    full = rng.integers(0, 1 << 32, (k, BATCH, N), dtype=np.uint64).astype(np.uint32)
    words = residues(rng, ql[:1], (k * BATCH * N + 1,))[0]
    cases = [(residues(rng, ql, (b, N), band=2), w, wp, f"B={b}")
             for b in ((k - 1) * BATCH, 1, BATCH)]
    cases += [(torch.from_numpy(full.view(np.int32)).cuda(), w, wp, "x over all u32"),
              (residues(rng, ql, (BATCH, 2), band=2), w[:, :2].contiguous(),
               wp[:, :2].contiguous(), "n=2 (one word a thread)"),
              (words[1:].view(k, BATCH, N), w, wp, "unaligned view (one word a thread)")]
    for x, wr, wpr, what in cases:
        for lazy in (False, True):
            check("twiddle_mul_banks",
                  ntt_kernel.twiddle_mul_banks(x, qs, wr, wpr, lazy=lazy),
                  ref.twiddle_mul_banks_ref(x, qs, wr, wpr, lazy=lazy),
                  f"(k, B, n)={tuple(x.shape)} {what} lazy={lazy}")


def gather_rows(n: int, amounts, natural: bool):
    """(len(amounts), n) int32 gather rows on the card for slot rotations."""
    from repro_torch.core.params import galois_eval_perm
    rows = np.stack([galois_eval_perm(pow(5, r, 2 * n), n, natural)
                     for r in amounts])
    return torch.from_numpy(rows.astype(np.int32)).cuda()


def check_gathers(check, rng, ct_primes) -> None:
    """The three gathers at the rotation path's shapes: k = 8 ciphertext
    primes, d = 8 digits over 8 + 1 primes, B = R = 8 (the hoisted
    rotation's digit gather and its c0 gather (1, k, 1, n), both fanned
    out), n = 2^14 natural order; once in bit-reversed order at n = 1024;
    and at n = 2^16 and, with 3 primes, 2^17: rows above one block's
    shared memory (the piece ring of the staged body, the split body of
    galois_banks); and at 2^14 and 2^16 on indices drawn from [-2n, 2n)."""
    from repro_torch.fhe import rns
    from repro_torch.kernels import galois_kernel, ref
    for n, natural in ((N, True), (1024, False), (N16, True), (N17, True)):
        k = 3 if n == N17 else len(ct_primes)
        qs = ct_primes if n == N else [int(q) for q in rns.make_primes(n, k)]
        sp = qs + [qs[0]]                    # k + 1 rows for the digit planes
        rows = gather_rows(n, ROT_AMOUNTS, natural)
        for b in (1, BATCH):
            x = residues(rng, qs, (b, n))
            for r in (0, BATCH - 1):
                check("galois_banks", galois_kernel.galois_banks(x, rows[r]),
                      ref.galois_banks_ref(x, rows[r]),
                      f"x {tuple(x.shape)} shared idx, n={n} natural={natural}")
        x = residues(rng, qs, (BATCH, n))
        check("galois_banks_multi", galois_kernel.galois_banks_multi(x, rows),
              ref.galois_banks_ref(x, rows),
              f"x {tuple(x.shape)} per-batch idx, n={n} natural={natural}")
        ext = torch.stack([residues(rng, sp, (BATCH, n)) for _ in range(k)])
        one = ext[:, :, :1].contiguous()
        c0 = one[:1].contiguous()
        for what, x, shared in (("non-shared", ext, False), ("shared", one, True),
                                ("c0 (d = 1) shared", c0, True),
                                ("c0 of the path (1, k, 1, n) shared",
                                 one[:1, :k].contiguous(), True)):
            check("galois_digits", galois_kernel.galois_digits(x, rows, shared=shared),
                  ref.galois_digits_banks_ref(x, rows),
                  f"x {tuple(x.shape)} {what} -> R={BATCH}, n={n} natural={natural}")
    # indices drawn from [-2n, 2n) through the split body, the whole-row
    # staged body (2^14) and the piece ring (2^16): an index in [-n, 0)
    # counts from the end of the row, one outside [-n, n) gives all ones
    for n in (N, N16):
        qs = ct_primes if n == N else [int(q) for q in rns.make_primes(n, len(ct_primes))]
        mixed = torch.from_numpy(rng.integers(-2 * n, 2 * n, (BATCH, n)).astype(np.int32)).cuda()
        x = residues(rng, qs, (BATCH, n))
        check("galois_banks", galois_kernel.galois_banks(x, mixed[0]),
              ref.galois_banks_ref(x, mixed[0]), f"x {tuple(x.shape)} indices in [-2n, 2n)")
        check("galois_banks_multi", galois_kernel.galois_banks_multi(x, mixed),
              ref.galois_banks_ref(x, mixed), f"x {tuple(x.shape)} indices in [-2n, 2n)")
        ext = torch.stack([residues(rng, qs, (BATCH, n)) for _ in range(2)])
        for x, shared in ((ext, False), (ext[:, :, :1].contiguous(), True)):
            check("galois_digits", galois_kernel.galois_digits(x, mixed, shared=shared),
                  ref.galois_digits_banks_ref(x, mixed),
                  f"x {tuple(x.shape)} shared={shared} indices in [-2n, 2n)")



# ------------------------------------------------------------ phase 3

def run_requests(ctx, zs):
    """The slice's traffic: 4 single multiply -> rescale requests and one
    batch of 8, every answer decrypted.  Returns (ciphertexts, answers,
    decoded slots, expected slots)."""
    cts = [ctx.encrypt(ctx.encode(z)) for z in zs]
    singles = [ctx.rescale(ctx.multiply(cts[2 * i], cts[2 * i + 1]))
               for i in range(len(zs) // 2)]
    rhs = [(i + 1) % len(zs) for i in range(len(zs))]
    batch = ctx.rescale_many(ctx.multiply_many(cts, [cts[j] for j in rhs]))
    answers = singles + batch
    expect = ([zs[2 * i] * zs[2 * i + 1] for i in range(len(zs) // 2)]
              + [zs[i] * zs[j] for i, j in enumerate(rhs)])
    decoded = [ctx.decrypt_decode(ct) for ct in answers]
    return cts, answers, decoded, expect


def phase_slice(zs) -> tuple:
    from repro_torch import kernels as K
    from repro_torch.fhe.ckks import CkksContext
    t0 = time.perf_counter()
    ctx = CkksContext(n=N, levels=LEVELS, scale_bits=28, seed=SEED)
    ctx.plan().prepare()
    torch.cuda.synchronize()
    log(f"[slice] context + tables + relin key on {ctx.device}: "
        f"{time.perf_counter() - t0:.2f} s, {len(ctx.qs)} primes + special")

    K.reset_counts()
    t0 = time.perf_counter()
    cts, answers, decoded, expect = run_requests(ctx, zs)
    torch.cuda.synchronize()
    counts = K.snapshot()
    log(f"[slice] cuda run: {time.perf_counter() - t0:.2f} s, counts {counts}")
    check_counts("multiply", counts)
    errs = [float(np.abs(d - e).max()) for d, e in zip(decoded, expect)]
    for d in decoded:
        if not np.all(np.isfinite(d)) or d.shape != (N // 2,):
            raise AssertionError("decoded slots are not finite of shape (n/2,)")
    log(f"[slice] max slot error {max(errs):.3e} (limit {SLOT_TOL:g})")
    if max(errs) >= SLOT_TOL:
        raise AssertionError(f"slot error {max(errs)} >= {SLOT_TOL}")
    single0, batch0 = answers[0], answers[len(zs) // 2]
    if not (torch.equal(single0.c0.data, batch0.c0.data)
            and torch.equal(single0.c1.data, batch0.c1.data)):
        raise AssertionError("batched multiply != single multiply for one pair")

    K.reset_counts()
    ctx.rescale(ctx.multiply(cts[0], cts[1]))
    torch.cuda.synchronize()
    per_op = {k: v["launches"] for k, v in K.snapshot().items()}
    log(f"[slice] launches for one multiply + rescale: {per_op}")
    return ctx, cts, answers, counts, per_op, max(errs)


def check_counts(path: str, counts: dict) -> None:
    """Every kernel of the path launched, and no plain version ran."""
    for name in PATH_KERNELS[path]:
        if counts[name]["launches"] == 0:
            raise AssertionError(f"{name}: kernel never launched on the {path} path")
    for name, c in counts.items():
        if c["plain_calls"] != 0:
            raise AssertionError(f"{name}: plain version ran {c['plain_calls']} "
                                 f"times on the {path} path on the card")


def same_ct(a, b) -> bool:
    """Residue stacks (the card's against the CPU's), scale and basis equal."""
    return (torch.equal(a.c0.data.cpu(), b.c0.data.cpu())
            and torch.equal(a.c1.data.cpu(), b.c1.data.cpu())
            and a.scale == b.scale and a.primes == b.primes)


def phase_cpu_parity(zs, cuda_cts, cuda_answers) -> None:
    from repro_torch.fhe.ckks import CkksContext
    t0 = time.perf_counter()
    ctx = CkksContext(n=N, levels=LEVELS, scale_bits=28, seed=SEED, device="cpu")
    ctx.plan().prepare()
    cts, answers, _, _ = run_requests(ctx, zs)
    for what, a_list, b_list in (("ciphertext", cuda_cts, cts),
                                 ("answer", cuda_answers, answers)):
        for i, (a, b) in enumerate(zip(a_list, b_list)):
            if not same_ct(a, b):
                raise AssertionError(f"{what} {i}: cuda run != cpu run")
    log(f"[parity] cuda == cpu bit for bit: {len(cts)} ciphertexts, "
        f"{len(answers)} answers ({time.perf_counter() - t0:.1f} s on the CPU)")


# ----------------------------------------------------------- phase 3b

def rotation_inputs():
    """Slot vectors, the matvec's input and matrix, from the seed."""
    rng = np.random.default_rng(SEED + 3)
    zs = [rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
          for _ in range(BATCH)]
    x = rng.uniform(-1, 1, MV_DIM)
    W = rng.uniform(-1, 1, (MV_DIM, MV_DIM)) / 8
    return zs, x, W


def rotation_context(device):
    """CkksContext at 2^14 with 8 + 1 primes, its plan prepared with every
    Galois key the rotation traffic needs (rotations 1..8, conjugation,
    the matvec's baby and giant steps), and the matvec's matrix pack."""
    from repro_torch.fhe import linalg
    from repro_torch.fhe.ckks import CkksContext
    _, _, W = rotation_inputs()
    ctx = CkksContext(n=N, levels=LEVELS, scale_bits=28, seed=SEED + 4,
                      device=device)
    M = linalg.PtMatrix.encode(ctx, W)
    ctx.plan().prepare(rotations=ROT_AMOUNTS, conjugate=True, matvecs=(M,))
    return ctx, M


def run_rotations(ctx, M):
    """The rotation path's traffic.  Returns (ciphertexts, named answers,
    the expected leading slots of each answer)."""
    from repro_torch.fhe import linalg
    zs, x, W = rotation_inputs()
    plan = ctx.plan()
    cts = [ctx.encrypt(ctx.encode(z)) for z in zs]
    v = ctx.encrypt(linalg.encode_vector(ctx, x, MV_DIM))
    ans, expect = {}, {}
    for r in (1, 7):
        ans[f"rotate {r}"] = ctx.rotate(cts[0], r)
        expect[f"rotate {r}"] = np.roll(zs[0], -r)
    ans["conjugate"] = ctx.conjugate(cts[0])
    expect["conjugate"] = np.conj(zs[0])
    for i, ct in enumerate(ctx.rotate_many(cts, ROT_AMOUNTS)):
        ans[f"rotate_many[{i}] by {ROT_AMOUNTS[i]}"] = ct
        expect[f"rotate_many[{i}] by {ROT_AMOUNTS[i]}"] = np.roll(zs[i], -ROT_AMOUNTS[i])
    for i, ct in enumerate(ctx.conjugate_many(cts)):
        ans[f"conjugate_many[{i}]"] = ct
        expect[f"conjugate_many[{i}]"] = np.conj(zs[i])
    for r, ct in zip(ROT_AMOUNTS, ctx.rotate_hoisted(cts[0], ROT_AMOUNTS)):
        ans[f"rotate_hoisted {r}"] = ct
        expect[f"rotate_hoisted {r}"] = np.roll(zs[0], -r)
    y = x @ W
    ans["matvec"] = linalg.matvec(plan, M, v)
    expect["matvec"] = y
    ans["rotate_sum"] = linalg.rotate_sum(plan, ans["matvec"], MV_DIM)
    padded = np.zeros(N // 2)
    padded[:MV_DIM] = y
    expect["rotate_sum"] = np.array([padded[(s + np.arange(MV_DIM)) % (N // 2)].sum()
                                     for s in range(N // 2)])
    return cts + [v], ans, expect


def phase_rotation():
    from repro_torch import kernels as K
    t0 = time.perf_counter()
    ctx, M = rotation_context("cuda")
    torch.cuda.synchronize()
    log(f"[rotation] context + {len(ctx._galois)} Galois keys + matrix pack on "
        f"{ctx.device}: {time.perf_counter() - t0:.2f} s")
    K.reset_counts()
    t0 = time.perf_counter()
    cts, ans, expect = run_rotations(ctx, M)
    torch.cuda.synchronize()
    counts = K.snapshot()
    log(f"[rotation] cuda run: {time.perf_counter() - t0:.2f} s, counts {counts}")
    check_counts("rotation", counts)
    worst = 0.0
    for name, ct in ans.items():
        d = ctx.decrypt_decode(ct)
        if not np.all(np.isfinite(d)) or d.shape != (N // 2,):
            raise AssertionError(f"{name}: decoded slots are not finite of shape (n/2,)")
        want = expect[name]
        e = float(np.abs(d[:len(want)] - want).max())
        worst = max(worst, e)
        if e >= SLOT_TOL:
            raise AssertionError(f"{name}: slot error {e} >= {SLOT_TOL}")
    log(f"[rotation] {len(ans)} answers, max slot error {worst:.3e} (limit {SLOT_TOL:g})")
    per_op = {}
    for what, req in (("rotate", lambda: ctx.rotate(cts[0], 1)),
                      (f"rotate_many of {BATCH}", lambda: ctx.rotate_many(cts[:BATCH], ROT_AMOUNTS)),
                      (f"rotate_hoisted R={BATCH}", lambda: ctx.rotate_hoisted(cts[0], ROT_AMOUNTS))):
        K.reset_counts()
        req()
        torch.cuda.synchronize()
        per_op[what] = {k: v["launches"] for k, v in K.snapshot().items() if v["launches"]}
        log(f"[rotation] launches per {what}: {per_op[what]}")
    return ctx, M, cts, ans, counts, worst, per_op


def phase_rotation_cpu_parity(cuda_cts, cuda_ans) -> None:
    t0 = time.perf_counter()
    ctx, M = rotation_context("cpu")
    cts, ans, _ = run_rotations(ctx, M)
    for i, (a, b) in enumerate(zip(cuda_cts, cts)):
        if not same_ct(a, b):
            raise AssertionError(f"rotation ciphertext {i}: cuda run != cpu run")
    for name, ct in ans.items():
        if not same_ct(cuda_ans[name], ct):
            raise AssertionError(f"{name}: cuda run != cpu run")
    log(f"[rotation parity] cuda == cpu bit for bit: {len(cts)} ciphertexts, "
        f"{len(ans)} answers ({time.perf_counter() - t0:.1f} s on the CPU)")


# ----------------------------------------------------------- phase 3e

def rot16_setup(device):
    """A context at 2^16 with 3 + 1 ciphertext primes, keys for rotations
    1 and 2 (the 4 x 4 matvec's baby and giant steps too), and the
    requests' ciphertexts.  Returns (context, matrix pack, ciphertexts,
    slot vectors, matvec input x, matrix W)."""
    from repro_torch.fhe import linalg
    from repro_torch.fhe.ckks import CkksContext
    rng = np.random.default_rng(SEED + 11)
    zs = [rng.uniform(-1, 1, N16 // 2) + 1j * rng.uniform(-1, 1, N16 // 2)
          for _ in ROT16_AMOUNTS]
    x = rng.uniform(-1, 1, ROT16_MV)
    W = rng.uniform(-1, 1, (ROT16_MV, ROT16_MV)) / ROT16_MV
    ctx = CkksContext(n=N16, levels=ROT16_LEVELS, scale_bits=28, seed=SEED + 12,
                      device=device)
    M = linalg.PtMatrix.encode(ctx, W)
    ctx.plan().prepare(rotations=ROT16_AMOUNTS, matvecs=(M,))
    cts = [ctx.encrypt(ctx.encode(z)) for z in zs]
    cts.append(ctx.encrypt(linalg.encode_vector(ctx, x, ROT16_MV)))
    return ctx, M, cts, zs, x, W


def run_rot16(ctx, M, cts, zs, x, W):
    """The rotation path at 2^16, where every gather row is longer than
    one block's shared memory: rotate, rotate_many, rotate_hoisted and the
    matvec.  Returns (named answers, expected leading slots)."""
    from repro_torch.fhe import linalg
    ans = {"rotate 1": ctx.rotate(cts[0], 1)}
    expect = {"rotate 1": np.roll(zs[0], -1)}
    for i, (r, ct) in enumerate(zip(ROT16_AMOUNTS, ctx.rotate_many(cts[:2], ROT16_AMOUNTS))):
        ans[f"rotate_many[{i}] by {r}"] = ct
        expect[f"rotate_many[{i}] by {r}"] = np.roll(zs[i], -r)
    for r, ct in zip(ROT16_AMOUNTS, ctx.rotate_hoisted(cts[0], ROT16_AMOUNTS)):
        ans[f"rotate_hoisted {r}"] = ct
        expect[f"rotate_hoisted {r}"] = np.roll(zs[0], -r)
    ans["matvec"] = linalg.matvec(ctx.plan(), M, cts[-1])
    expect["matvec"] = x @ W
    return ans, expect


def phase_rot16():
    from repro_torch import kernels as K
    t0 = time.perf_counter()
    setup = rot16_setup(None)
    ctx, cts = setup[0], setup[2]
    torch.cuda.synchronize()
    log(f"[rot16] context n={N16}, {len(ctx.qs)} primes + special, "
        f"{len(ctx._galois)} Galois keys on {ctx.device}: "
        f"{time.perf_counter() - t0:.2f} s")
    K.reset_counts()
    t0 = time.perf_counter()
    ans, expect = run_rot16(*setup)
    torch.cuda.synchronize()
    counts = K.snapshot()
    log(f"[rot16] cuda run: {time.perf_counter() - t0:.2f} s, counts "
        f"{ {k: v for k, v in counts.items() if v['launches'] or v['plain_calls']} }")
    check_counts("rot16", counts)
    worst = 0.0
    for name, ct in ans.items():
        d = ctx.decrypt_decode(ct)
        if not np.all(np.isfinite(d)) or d.shape != (N16 // 2,):
            raise AssertionError(f"rot16 {name}: decoded slots are not finite of "
                                 "shape (n/2,)")
        want = expect[name]
        e = float(np.abs(d[:len(want)] - want).max())
        worst = max(worst, e)
        if e >= SLOT_TOL:
            raise AssertionError(f"rot16 {name}: slot error {e} >= {SLOT_TOL}")
    log(f"[rot16] {len(ans)} answers, max slot error {worst:.3e} (limit {SLOT_TOL:g})")
    return cts, ans, counts


def phase_rot16_cpu_parity(cuda_cts, cuda_ans) -> None:
    t0 = time.perf_counter()
    setup = rot16_setup("cpu")
    cts = setup[2]
    ans, _ = run_rot16(*setup)
    for i, (a, b) in enumerate(zip(cuda_cts, cts)):
        if not same_ct(a, b):
            raise AssertionError(f"rot16 ciphertext {i}: cuda run != cpu run")
    for name, ct in ans.items():
        if not same_ct(cuda_ans[name], ct):
            raise AssertionError(f"rot16 {name}: cuda run != cpu run")
    log(f"[rot16 parity] cuda == cpu bit for bit: {len(cts)} ciphertexts, "
        f"{len(ans)} answers ({time.perf_counter() - t0:.1f} s on the CPU)")


# ----------------------------------------------------------- phase 3f

def eager_twin(plan):
    """The plan with the same tables and keys whose programs run eagerly
    (the module-level programs, no CUDA graph)."""
    twin = copy.copy(plan)
    twin._graphs = None
    return twin


def serve_setup(device):
    """The serving context at 2^14 with 8 + 1 primes and its 64 x 64
    matrix pack; the plan prepared at the full basis and one level down
    (on the card, every program's graph captured for every group size and
    the matvec composite); the trace of SERVE_N requests; then the Galois
    key of every rotation in the trace, drawn in request order, so the
    drains time no key generation.  Returns (context, pack, requests)."""
    from repro_torch.fhe import linalg
    from repro_torch.fhe.ckks import CkksContext
    from repro_torch.fhe.serve import synthetic_trace
    rng = np.random.default_rng(SEED + 13)
    ctx = CkksContext(n=N, levels=LEVELS, scale_bits=28, seed=SEED + 14, device=device)
    M = linalg.PtMatrix.encode(ctx, rng.uniform(-1, 1, (MV_DIM, MV_DIM)) / 8)
    plan = ctx.plan()
    for basis, mvs in ((ctx.qs, (M,)), (ctx.qs[:-1], ())):
        plan.prepare(basis=basis, rotations=(1,), conjugate=True,
                     batch_sizes=SERVE_SIZES, matvecs=mvs)
    reqs, _ = synthetic_trace(ctx, SERVE_N, seed=SEED, matrix=M)
    for req in reqs:
        if req.op == "rotate" and req.r % ctx.slots:
            g = plan.rotation_group_element(req.r)
            plan.galois_key(g, req.ct.primes)
            plan.eval_idx(g)
    return ctx, M, reqs


def mixed_queue(ctx, reqs):
    """Two multiplies of the trace, two conjugations at one basis (a
    uniform Galois group) and SERVE_DECAPS ML-KEM decaps at b = 1, one key
    and ciphertext each, interleaved."""
    from repro_torch.fhe.serve import FheRequest
    from repro_torch.pq import mlkem
    d, z, m = mlkem_inputs(SERVE_DECAPS)
    ek, dk = mlkem.keygen_batch(d, z, device="cpu")
    ct = mlkem.encaps_batch(ek, m, device="cpu")[1]
    ckks = [r for r in reqs if r.op == "multiply"][:2]
    full = [r.ct for r in reqs if r.ct.primes == ctx.qs][:2]
    out = []
    for i in range(SERVE_DECAPS):
        out.append(FheRequest(100 + i, "mlkem_decaps", payload={"dk": dk[i], "ct": ct[i]}))
        if i < len(ckks):
            out.append(FheRequest(200 + i, "multiply", ckks[i].ct, other=ckks[i].other))
        if i < len(full):
            out.append(FheRequest(300 + i, "conjugate", full[i]))
    return out


def same_answer(a, b) -> bool:
    """A CKKS answer (ciphertext) or an ML-KEM one (bytes) of two runs."""
    if hasattr(a, "c0"):
        return same_ct(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def eager_answer(eager, M, req):
    """One request on the eager plan: the single module-level program."""
    from repro_torch.fhe import linalg
    if req.op == "multiply":
        return eager.multiply(req.ct, req.other)
    if req.op == "rescale":
        return eager.rescale(req.ct)
    if req.op == "rotate":
        return eager.rotate(req.ct, req.r)
    if req.op == "conjugate":
        return eager.conjugate(req.ct)
    return linalg.matvec(eager, M, req.ct)


def phase_serve():
    """The serving engine at full width: the trace through ``run`` and
    ``run_async`` as a backlog and through ``run_async`` under Poisson
    arrivals at POISSON_LOAD of the backlog's measured rate, then the
    mixed CKKS + ML-KEM queue.  Every drain captures no graph and fails no
    request, async equals sync bit for bit, every answer equals the eager
    programs' on the card, every CKKS kernel launched and no plain
    version ran."""
    from repro_torch import kernels as K
    from repro_torch.fhe.evalplan import EvalPlan
    from repro_torch.fhe.serve import CkksServeEngine
    t0 = time.perf_counter()
    traces0 = EvalPlan.trace_count()
    torch.cuda.synchronize()
    reserved0, allocated0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    ctx, M, reqs = serve_setup(None)
    torch.cuda.synchronize()
    plan = ctx.plan()
    graphs = EvalPlan.trace_count() - traces0
    gib = lambda b: f"{b / 2**30:.3f} GiB"
    log(f"[serve] context, {len(ctx._galois)} Galois keys at two bases, {graphs} CUDA "
        f"graphs captured, {SERVE_N} requests: {time.perf_counter() - t0:.2f} s; memory "
        f"after the warm-up: reserved {gib(torch.cuda.memory_reserved())} (this phase "
        f"{gib(torch.cuda.memory_reserved() - reserved0)}), allocated "
        f"{gib(torch.cuda.memory_allocated())} (this phase "
        f"{gib(torch.cuda.memory_allocated() - allocated0)}: keys, tables, the graphs' "
        f"static inputs and outputs)")
    engine = CkksServeEngine(plan, batch_tile=SERVE_TILE)
    mixed_reqs = mixed_queue(ctx, reqs)       # its ML-KEM keys come from the CPU
    K.reset_counts()
    drains = {}
    sync = engine.run(reqs)
    drains["run (backlog)"] = dict(engine.stats)
    asy = engine.run_async(reqs)
    drains["run_async (backlog)"] = dict(engine.stats)
    rate = SERVE_N / drains["run_async (backlog)"]["wall_s"]
    arrivals = np.cumsum(np.random.default_rng(SEED + 15).exponential(
        1.0 / (POISSON_LOAD * rate), SERVE_N)).tolist()
    poisson = engine.run_async(reqs, arrivals)
    drains[f"run_async (Poisson, {POISSON_LOAD:g} x {rate:.1f} req/s)"] = dict(engine.stats)
    mixed = engine.run(mixed_reqs)
    drains["run (mixed CKKS + ML-KEM)"] = dict(engine.stats)
    torch.cuda.synchronize()
    counts = K.snapshot()
    check_counts("serve", counts)
    for label, st in drains.items():
        lat = st["latency_us"]
        log(f"[serve] {label}: {st['batched_ops']} requests in {st['dispatches']} groups "
            f"({st['padded']} pad rows, {st['identity']} identity), {st['wall_s'] * 1e3:.3f} "
            f"ms, {st['batched_ops'] / st['wall_s']:.1f} requests/s, "
            f"{st['key_switches'] / st['wall_s']:.1f} key switches/s, latency p50 "
            f"{lat['p50'] / 1e3:.3f} ms, p99 {lat['p99'] / 1e3:.3f} ms, fresh_traces "
            f"{st['fresh_traces']}, groups {st['groups']}")
        if st["fresh_traces"] != 0 or st["failed"]:
            raise AssertionError(f"serve {label}: fresh_traces {st['fresh_traces']}, "
                                 f"failed {st['failed']}")
    for name, out in (("run_async", asy), ("Poisson run_async", poisson)):
        if set(out) != set(sync) or not all(same_ct(out[r], sync[r]) for r in sync):
            raise AssertionError(f"serve: {name} answers != run's")
    eager = eager_twin(plan)
    for req in reqs:
        if not same_ct(sync[req.rid], eager_answer(eager, M, req)):
            raise AssertionError(f"serve request {req.rid} ({req.op}): graphed drain != "
                                 "the eager program on the card")
    for req in mixed_reqs:
        if req.op != "mlkem_decaps" and not same_ct(mixed[req.rid], eager_answer(eager, M, req)):
            raise AssertionError(f"serve mixed request {req.rid}: != the eager program")
    for req in reqs:
        d = ctx.decrypt_decode(sync[req.rid])
        if not np.all(np.isfinite(d)) or d.shape != (N // 2,):
            raise AssertionError(f"serve request {req.rid}: slots not finite of shape (n/2,)")
    log(f"[serve] every answer: async == sync bit for bit, == the eager programs on the "
        f"card; {len(mixed_reqs)} mixed requests; memory after the drains: reserved "
        f"{gib(torch.cuda.memory_reserved())}, the phase's peak allocated "
        f"{gib(torch.cuda.max_memory_allocated())} (process); launches "
        f"{ {k: v['launches'] for k, v in counts.items() if v['launches']} }")
    return ctx, M, reqs, sync, mixed, counts


def phase_serve_cpu_parity(cuda_reqs, cuda_out, cuda_mixed) -> None:
    """The same trace on device="cpu": every request's inputs equal, and a
    seeded subset of SERVE_CPU requests and the mixed queue answered bit
    (and byte) for bit the same."""
    from repro_torch.fhe.serve import CkksServeEngine
    t0 = time.perf_counter()
    ctx, _, reqs = serve_setup("cpu")
    for a, b in zip(cuda_reqs, reqs):
        if a.op != b.op or not same_ct(a.ct, b.ct) or (a.other is not None
                                                       and not same_ct(a.other, b.other)):
            raise AssertionError(f"serve request {a.rid}: cuda inputs != cpu inputs")
    subset = sorted(np.random.default_rng(SEED + 16).choice(SERVE_N, SERVE_CPU,
                                                             replace=False).tolist())
    engine = CkksServeEngine(ctx.plan(), batch_tile=SERVE_TILE)
    out = engine.run([reqs[i] for i in subset])
    mixed = engine.run(mixed_queue(ctx, reqs))
    for rid in subset:
        if not same_ct(cuda_out[rid], out[rid]):
            raise AssertionError(f"serve request {rid}: cuda run != cpu run")
    if set(mixed) != set(cuda_mixed) or not all(same_answer(cuda_mixed[r], mixed[r])
                                                for r in mixed):
        raise AssertionError("serve mixed queue: cuda run != cpu run")
    log(f"[serve parity] cuda == cpu: {SERVE_N} requests' inputs, the answers of "
        f"requests {subset} ({[reqs[i].op for i in subset]}) and the mixed queue's "
        f"{len(mixed)} answers, bytes of {SERVE_DECAPS} decaps included "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")


# ----------------------------------------------------------- phase 3g

def phase_tuner(k: int) -> int:
    """``autotune.ensure("serve_batch", k, N, SERVE_N, shards=SCALE_SHARDS)``
    measured on the card: its candidate table printed, its sidecar written
    to a temporary file and read back by a fresh copy of the module (the
    entry the two-shard engine resolves later); then a resolve of an
    uncached entry inside a CUDA graph capture, with measuring on, must
    take the default without measuring.  Returns the tuned tile."""
    import importlib
    import tempfile
    from repro_torch import obs
    from repro_torch.kernels import autotune

    def counters():
        return {k: v for k, v in obs.snapshot()["counters"].items()
                if k.startswith("autotune.")}
    per_shard = autotune.shard_batch(SERVE_N, SCALE_SHARDS)
    key = f"{torch.cuda.get_device_name(0)}|serve_batch|{k}|{N}|{per_shard}|uint32"
    with tempfile.TemporaryDirectory() as tmp:
        sidecar = os.path.join(tmp, "tiles.json")
        os.environ[autotune.ENV_CACHE] = sidecar
        obs.enable()
        try:
            autotune.clear()
            obs.reset()
            t0 = time.perf_counter()
            tile = autotune.ensure("serve_batch", k, N, SERVE_N, shards=SCALE_SHARDS)
            secs = time.perf_counter() - t0
            measured = counters()
            ev = autotune.table()["evidence"][key]
            want = {str(t) for t in {autotune.clamp(c, per_shard) for c in autotune.CANDIDATE_TILES}}
            if (measured.get("autotune.measurements") != 1 or ev["source"] != "measured"
                    or set(ev["candidates"]) != want):
                raise AssertionError(f"tuner: no complete measurement: {measured}, {ev}")
            table = ", ".join(f"tile {t} {s * 1e3:.4f} ms" for t, s in
                              sorted(ev["candidates"].items(), key=lambda ts: int(ts[0])))
            log(f"[tuner] serve_batch k={k} n={N} b={SERVE_N} over {SCALE_SHARDS} shards "
                f"(per-shard b={per_shard}): {per_shard} rows as ceil(b/t) banks forward "
                f"calls of t rows, median of 3: {table}; chosen {tile} ({secs:.2f} s "
                f"with the build) on {gpu_line()}")
            with open(sidecar) as f:
                disk = json.load(f)
            importlib.reload(autotune)       # a fresh process: the cache comes from the sidecar
            obs.reset()
            got = autotune.resolve_tile("serve_batch", k, N, SERVE_N, shards=SCALE_SHARDS)
            source = autotune.table()["evidence"][key]["source"]
            if disk["entries"].get(key) != tile or got != tile or source != "disk" \
                    or counters() != {"autotune.resolve.cache_hit": 1}:
                raise AssertionError(f"tuner sidecar: wrote {disk['entries'].get(key)}, read "
                                     f"{got} from {source}, counters {counters()}")
            os.environ[autotune.ENV_AUTOTUNE] = "1"
            obs.reset()
            x = torch.zeros(4, device="cuda")
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                inside = autotune.resolve_tile("serve_batch", k, N, SERVE_N)
                x += 1
            if inside != autotune.DEFAULT_TILE or counters() != {
                    "autotune.resolve.cache_miss": 1, "autotune.resolve.default": 1}:
                raise AssertionError(f"tuner: a resolve inside a capture gave {inside}, "
                                     f"counters {counters()}")
        finally:
            os.environ.pop(autotune.ENV_CACHE, None)
            os.environ.pop(autotune.ENV_AUTOTUNE, None)
            obs.disable()
            obs.reset()
    log(f"[tuner] sidecar read back by a fresh module (cache hit, source disk); a resolve "
        f"inside a graph capture took the default {autotune.DEFAULT_TILE} and measured nothing")
    return tile


def scaleout_traffic(plan, M, cts):
    """Batched programs at sizes the two-shard mesh pads: multiply_many ->
    rescale_many, mixed rotate_many and conjugate_many of SCALE_B,
    rotate_hoisted by SCALE_R amounts, the 64 x 64 matvec (7 live baby
    rotations, 7 giant ones)."""
    from repro_torch.fhe import linalg
    a, b = cts[:SCALE_B], cts[1:SCALE_B + 1]
    prod = plan.multiply_many(a, b)
    return {"multiply_many": prod, "rescale_many": plan.rescale_many(prod),
            "rotate_many": plan.rotate_many(a, ROT_AMOUNTS[:SCALE_B]),
            "conjugate_many": plan.conjugate_many(a),
            "rotate_hoisted": plan.rotate_hoisted(cts[0], ROT_AMOUNTS[:SCALE_R]),
            "matvec": [linalg.matvec(plan, M, cts[-1])]}


def phase_scaleout(rot: dict, srv: dict) -> dict:
    """Phase 3g: the tuner, then the batch-sharded EvalPlan on meshes of the
    card once and twice (and of two cards when there are two) against the
    unsharded plan, the two-shard serving engine with the tuned tile
    against the tile-8 unsharded drain, and fourstep_ntt_sharded against
    fourstep_ntt.  Counts are reset before the sharded runs and read after
    them; the unsharded answers are taken before."""
    from repro_torch import kernels as K
    from repro_torch.core import fourstep as fs
    from repro_torch.fhe.evalplan import EvalPlan
    from repro_torch.fhe.serve import CkksServeEngine
    from repro_torch.mesh import make_mesh
    t_phase = time.perf_counter()
    rctx, M, cts = rot["ctx"], rot["M"], rot["cts"]
    sctx = srv["ctx"]
    tile = phase_tuner(len(sctx.qs))

    meshes = [("the card once", ["cuda"]), ("the card twice", ["cuda"] * SCALE_SHARDS)]
    if torch.cuda.device_count() >= 2:
        meshes.append(("two cards", ["cuda:0", "cuda:1"]))
    else:
        log(f"[scaleout] two distinct cards: skipped, this machine has "
            f"{torch.cuda.device_count()} CUDA device")
    want = scaleout_traffic(rctx.plan(), M, cts)
    fsp = fs.make_fourstep_params(128, 128)
    a = residues(np.random.default_rng(SEED + 17), [fsp.q], (128 * 128,))[0]
    fs_want = {neg: fs.fourstep_ntt(a, fsp, negacyclic=neg) for neg in (False, True)}
    unsharded = CkksServeEngine(sctx.plan(), batch_tile=SERVE_TILE)
    torch.cuda.synchronize()

    K.reset_counts()
    traces0 = EvalPlan.trace_count()
    for label, devices in meshes:
        t0 = time.perf_counter()
        plan = EvalPlan(rctx, mesh=make_mesh(devices))
        got = scaleout_traffic(plan, M, cts)
        for name, ws in want.items():
            if len(got[name]) != len(ws) or not all(same_ct(g, w) for g, w in zip(got[name], ws)):
                raise AssertionError(f"scaleout {label}: {name} != the unsharded plan's")
        torch.cuda.synchronize()
        log(f"[scaleout] mesh of {label}, shards {plan.mesh_devices}: multiply_many -> "
            f"rescale_many, rotate_many, conjugate_many of {SCALE_B}, rotate_hoisted R="
            f"{SCALE_R}, the {MV_DIM} x {MV_DIM} matvec == the unsharded plan bit for bit "
            f"({len(plan._graphs)} graphs, {time.perf_counter() - t0:.2f} s)")

    plan2 = EvalPlan(sctx, mesh=make_mesh(["cuda"] * SCALE_SHARDS))
    engine = CkksServeEngine(plan2)
    if (engine.devices, engine.batch_tile, engine.group_tile) != (
            SCALE_SHARDS, tile, tile * SCALE_SHARDS):
        raise AssertionError(f"scaleout engine: devices {engine.devices}, tile "
                             f"{engine.batch_tile}, group tile {engine.group_tile}")
    gt = engine.group_tile
    sizes = tuple(range(gt, -(-SERVE_N // gt) * gt + 1, gt))
    t0 = time.perf_counter()
    for basis, mvs in ((sctx.qs, (srv["M"],)), (sctx.qs[:-1], ())):
        plan2.prepare(basis=basis, rotations=(1,), conjugate=True, batch_sizes=sizes,
                      matvecs=mvs)
    torch.cuda.synchronize()
    log(f"[scaleout] two-shard serving plan prepared for group sizes {sizes}: "
        f"{time.perf_counter() - t0:.2f} s, {len(plan2._graphs)} graphs, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    reqs = srv["reqs"]
    drains, stats = {}, {}
    for mode in ("run", "run_async"):
        drains[mode] = getattr(engine, mode)(reqs)
        stats[mode] = dict(engine.stats)
    fs_got = {}
    for copies in FOURSTEP_SHARDS:
        mesh = make_mesh(["cuda"] * copies)
        for neg in (False, True):
            fs_got[(copies, neg)] = fs.fourstep_ntt_sharded(a.view(128, 128), fsp, mesh,
                                                            axis="b", negacyclic=neg)
    torch.cuda.synchronize()
    counts = K.snapshot()
    fresh = EvalPlan.trace_count() - traces0
    check_counts("scaleout", counts)

    for mode, out in drains.items():
        st = stats[mode]
        matvecs = sum(c for g, c in st["groups"].items() if g.startswith("matvec"))
        rows = st["per_device_rows"]
        if (st["fresh_traces"] != 0 or st["failed"] or len(rows) != SCALE_SHARDS
                or len(set(rows)) != 1 or sum(rows) != st["batched_ops"] - matvecs + st["padded"]):
            raise AssertionError(f"scaleout engine {mode}: fresh_traces {st['fresh_traces']}, "
                                 f"failed {st['failed']}, per_device_rows {rows}")
        if set(out) != set(srv["out"]) or not all(same_ct(out[r], srv["out"][r]) for r in out):
            raise AssertionError(f"scaleout engine {mode}: answers != the tile-8 unsharded drain")
        log(f"[scaleout] two-shard engine {mode}: batch_tile {engine.batch_tile} (tuned), group "
            f"tile {gt}, {st['batched_ops']} requests in {st['dispatches']} groups "
            f"({st['padded']} pad rows), per_device_rows {rows}, fresh_traces 0, answers == "
            f"the tile-8 unsharded drain")
    times = {"two shards": [], "unsharded, tile 8": []}
    for _ in range(SCALE_ROUNDS):
        for label, eng in (("two shards", engine), ("unsharded, tile 8", unsharded)):
            eng.run_async(reqs)
            if eng.stats["fresh_traces"] or eng.stats["failed"]:
                raise AssertionError(f"scaleout timing, {label}: {eng.stats['failed']}, "
                                     f"fresh_traces {eng.stats['fresh_traces']}")
            times[label].append(eng.stats["wall_s"])
    med = {label: statistics.median(ts) for label, ts in times.items()}
    log(f"[scaleout] run_async of the {SERVE_N}-request trace, {SCALE_ROUNDS} interleaved "
        f"rounds, median: two shards on one card {med['two shards'] * 1e3:.3f} ms "
        f"({SERVE_N / med['two shards']:.1f} requests/s), unsharded at tile 8 "
        f"{med['unsharded, tile 8'] * 1e3:.3f} ms ({SERVE_N / med['unsharded, tile 8']:.1f} "
        f"requests/s); all rounds ms {({k: [round(t * 1e3, 3) for t in v] for k, v in times.items()})}")
    for (copies, neg), D in fs_got.items():
        if not torch.equal(D.t().reshape(-1), fs_want[neg]):
            raise AssertionError(f"fourstep_ntt_sharded over {copies} shards (negacyclic "
                                 f"{neg}) != fourstep_ntt")
    log(f"[scaleout] fourstep_ntt_sharded 128 x 128 over {FOURSTEP_SHARDS} shards, cyclic and "
        f"negacyclic == fourstep_ntt; {fresh} graphs captured in the counted run (the "
        f"sharded plans' first calls and the prepare); launches "
        f"{ {k: v['launches'] for k, v in counts.items() if v['launches']} }; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


# ----------------------------------------------------------- phase 3c

def mlkem_pack():
    from repro_torch.pq import mlkem
    return mlkem._pack(torch.device("cuda"))


def mlkem_path_rows(b: int) -> dict:
    """Rows (the B of (1, B, 256)) each ML-KEM kernel sees at batch b:
    keygen's 6b-row forward NTT and 9b-row basecase product, the 3b-row
    transforms and products of encrypt/decrypt, the b-row inverse of v."""
    return {"ntt_fwd_banks_u16": (6 * b, 3 * b),
            "ntt_inv_banks_u16": (3 * b, b),
            "dyadic_basemul_banks": (9 * b, 3 * b)}


def ring_rows(rng, rows: int, band: int = 1) -> torch.Tensor:
    from repro_torch.pq import mlkem
    x = rng.integers(0, band * mlkem.Q, (1, rows, mlkem.N), dtype=np.int64)
    return torch.from_numpy(x.astype(np.int16)).cuda()


def phase_mlkem_kernels() -> dict:
    """The u16 transforms (lazy and eager, reduce_out both ways) and the
    basecase product (lazy and eager) against their plain versions at
    every shape of the b = 1 and b = 256 paths and at an odd batch."""
    from repro_torch.kernels import dyadic_kernel, ntt_kernel, ref
    rng = np.random.default_rng(SEED + 5)
    t = mlkem_pack()
    fargs = (t["qs"], t["tw"], t["twp"], t["psi"], t["psip"])
    iargs = (t["qs"], t["ninv"], t["ninv_p"], t["itw"], t["itwp"], t["ipsin"], t["ipsinp"])
    gargs = (t["qs"], t["mu"], t["gamma"], t["gammap"])
    err = {}

    def check(name, got, want, what):
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err[name] = max(err.get(name, 0), e)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: kernel != plain version "
                                 f"(max abs err {e})")

    shapes = {name: sorted(set(mlkem_path_rows(1)[name] + mlkem_path_rows(MLKEM_B)[name]
                               + (MLKEM_ODD_B,)))
              for name in MLKEM_KERNELS}
    bodies = set()
    for lazy in (False, True):
        for rows in shapes["ntt_fwd_banks_u16"]:
            x = ring_rows(rng, rows)
            for reduce_out in (False, True):
                kw = dict(negacyclic=False, lazy=lazy, reduce_out=reduce_out)
                check("ntt_fwd_banks_u16", ntt_kernel.ntt_fwd_banks(x, *fargs, **kw),
                      ref.ntt_fwd_banks_ref(x, *fargs, **kw), f"B={rows} {kw}")
        for rows in shapes["ntt_inv_banks_u16"]:
            x = ring_rows(rng, rows, band=2 if lazy else 1)
            for reduce_out in (False, True):
                kw = dict(negacyclic=False, lazy=lazy, reduce_out=reduce_out)
                check("ntt_inv_banks_u16", ntt_kernel.ntt_inv_banks(x, *iargs, **kw),
                      ref.ntt_inv_banks_ref(x, *iargs, **kw), f"B={rows} {kw}")
        for a, b, g, what in basemul_cases(rng, t, shapes["dyadic_basemul_banks"]):
            body = basemul_body(a, b, g)
            check("dyadic_basemul_banks",
                  dyadic_kernel.dyadic_basemul_banks(a, b, *gargs[:2], *g, lazy=lazy),
                  ref.dyadic_basemul_banks_ref(a, b, *gargs[:2], *g, lazy=lazy),
                  f"{what} ({body} body) lazy={lazy}")
            bodies.add(body)
    if bodies != {"vector", "pair"}:
        raise AssertionError(f"dyadic_basemul_banks ran the bodies {bodies}, not both")
    for name, e in err.items():
        log(f"[mlkem kernels] {name} at B in {shapes[name]}: bit-identical to its "
            f"plain version (max abs err {e})")
    log("[mlkem kernels] dyadic_basemul_banks also at n = 4 and 2 and on a view at an "
        "odd word: both bodies (vector, pair) bit-identical to the plain version")
    return err


def basemul_cases(rng, t, path_rows):
    """(a, b, (gamma, gammap), what) of the basecase product: the path's
    (1, B, 256) rows, the smallest ring of the vector body (n = 4) and the
    pair body's (n = 2), on the first pairs' gamma words, and a view one
    word past a 4-byte boundary at the path's largest B."""
    from repro_torch.pq import mlkem
    g = (t["gamma"], t["gammap"])
    for rows in path_rows:
        yield ring_rows(rng, rows), ring_rows(rng, rows), g, f"(1, {rows}, 256)"
    for n in (4, 2):
        gn = tuple(x[:, :n // 2].contiguous() for x in g)
        a, b = (ring_rows(rng, MLKEM_ODD_B * mlkem.N // n).view(1, -1, n) for _ in range(2))
        yield a, b, gn, f"(1, {a.shape[1]}, {n})"
    rows = path_rows[-1]
    words = ring_rows(rng, rows + 1).view(-1)
    a = words[1:1 + rows * mlkem.N].view(1, rows, mlkem.N)
    yield a, ring_rows(rng, rows), g, f"(1, {rows}, 256) one word past a 4-byte boundary"


def basemul_body(a, b, g) -> str:
    """The body the library's launcher takes for a, b with gamma rows g
    (a fresh output is aligned): "vector" or "pair"."""
    from repro_torch.kernels import build
    k, bsz, n = a.shape
    aligned = all(x.data_ptr() % 4 == 0 for x in (a, b, *g))
    out = (ctypes.c_longlong * 5)()
    build.load("dyadic_basemul").dyadic_basemul_plan(
        k, bsz, n, int(aligned), torch.cuda.get_device_properties(0).multi_processor_count,
        out)
    return "vector" if out[0] else "pair"


def kat_vectors() -> dict:
    with open(KAT_PATH) as f:
        vs = json.load(f)["vectors"]
    return {key: np.stack([np.frombuffer(bytes.fromhex(v[key]), np.uint8) for v in vs])
            for key in vs[0]}


def rejection_keys(dk: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """FIPS 203's implicit-rejection key J(z || ct), from hashlib alone."""
    return np.stack([np.frombuffer(hashlib.shake_256(
        dk[i, -32:].tobytes() + ct[i].tobytes()).digest(32), np.uint8)
        for i in range(len(dk))])


def mlkem_inputs(b: int):
    """Seeds d, z and message randomness m, (b, 32) bytes each."""
    rng = np.random.default_rng(SEED + 6 + b)
    d, z, m = (rng.integers(0, 256, (b, 32), dtype=np.uint8) for _ in range(3))
    return d, z, m


def run_mlkem_round(d, z, m, device=None) -> dict:
    """keygen -> encaps -> decaps at batch b, and decaps of a tampered
    copy of every ciphertext (byte 17, bit 0 flipped)."""
    from repro_torch.pq import mlkem
    ek, dk = mlkem.keygen_batch(d, z, device=device)
    key, ct = mlkem.encaps_batch(ek, m, device=device)
    back = mlkem.decaps_batch(dk, ct, device=device)
    bad = ct.copy()
    bad[:, 17] ^= 0x01
    rej = mlkem.decaps_batch(dk, bad, device=device)
    return {"ek": ek, "dk": dk, "K": key, "ct": ct, "decaps": back, "bad": bad,
            "reject": rej}


def phase_mlkem() -> tuple:
    from repro_torch import kernels as K
    from repro_torch.pq import mlkem
    kat = kat_vectors()
    ek, dk = mlkem.keygen_batch(kat["d"], kat["z"])
    key, ct = mlkem.encaps_batch(kat["ek"], kat["m"])
    back = mlkem.decaps_batch(kat["dk"], kat["ct"])
    bad = kat["ct"].copy()
    bad[:, 17] ^= 0x01
    rej = mlkem.decaps_batch(kat["dk"], bad)
    for what, got, want in (("ek", ek, kat["ek"]), ("dk", dk, kat["dk"]),
                            ("K", key, kat["K"]), ("ct", ct, kat["ct"]),
                            ("decaps K", back, kat["K"]),
                            ("rejection K", rej, kat["K_reject_flip_ct_byte17_bit0"])):
        if not np.array_equal(got, want):
            raise AssertionError(f"ML-KEM KAT: {what} differs on the card")
    log(f"[mlkem] {len(kat['d'])} KAT vectors on the card: ek, dk, ct, K and the "
        "implicit-rejection key byte for byte")

    d, z, m = mlkem_inputs(MLKEM_B)
    K.reset_counts()
    t0 = time.perf_counter()
    out = run_mlkem_round(d, z, m)
    torch.cuda.synchronize()
    counts = K.snapshot()
    log(f"[mlkem] cuda round at b={MLKEM_B}: {time.perf_counter() - t0:.2f} s, counts "
        f"{ {k: v for k, v in counts.items() if v['launches'] or v['plain_calls']} }")
    check_counts("mlkem", counts)
    shapes = {"ek": (MLKEM_B, mlkem.EK_BYTES), "dk": (MLKEM_B, mlkem.DK_BYTES),
              "K": (MLKEM_B, 32), "ct": (MLKEM_B, mlkem.CT_BYTES)}
    for name, shape in shapes.items():
        if out[name].shape != shape or out[name].dtype != np.uint8:
            raise AssertionError(f"ML-KEM {name}: {out[name].dtype} {out[name].shape}, "
                                 f"expected uint8 {shape}")
    if not np.array_equal(out["decaps"], out["K"]):
        raise AssertionError("ML-KEM: decaps key != encaps key")
    want = rejection_keys(out["dk"], out["bad"])
    if not np.array_equal(out["reject"], want) or np.array_equal(want, out["K"]):
        raise AssertionError("ML-KEM: a tampered ciphertext did not give J(z || ct)")
    log(f"[mlkem] {MLKEM_B} handshakes: decaps == encaps keys, {MLKEM_B} tampered "
        "ciphertexts gave the rejection key J(z || ct)")

    per_op = {}
    for op, run in (("keygen", lambda: mlkem.keygen_batch(d, z)),
                    ("encaps", lambda: mlkem.encaps_batch(out["ek"], m)),
                    ("decaps", lambda: mlkem.decaps_batch(out["dk"], out["ct"]))):
        K.reset_counts()
        run()
        torch.cuda.synchronize()
        c = K.snapshot()
        per_op[op] = {k: v["launches"] for k, v in c.items() if v["launches"]}
        got = tuple(c[k]["launches"] for k in MLKEM_KERNELS)
        if got != MLKEM_LAUNCHES[op] or any(v["plain_calls"] for v in c.values()):
            raise AssertionError(f"ML-KEM {op}: launches {got}, expected "
                                 f"{MLKEM_LAUNCHES[op]}, and no plain call")
        log(f"[mlkem] launches per {op}: {per_op[op]}")
    return (d, z, m), out, counts, per_op


def phase_mlkem_cpu_parity(inputs, cuda_out) -> None:
    t0 = time.perf_counter()
    out = run_mlkem_round(*inputs, device="cpu")
    for name, want in out.items():
        if not np.array_equal(cuda_out[name], want):
            raise AssertionError(f"ML-KEM {name}: cuda run != cpu run")
    log(f"[mlkem parity] cuda == cpu byte for byte: ek, dk, K, ct, decaps and "
        f"rejection keys of {MLKEM_B} handshakes ({time.perf_counter() - t0:.1f} s "
        "on the CPU)")


def phase_mlkem_times(counts: dict, errs: dict) -> tuple:
    """The three ML-KEM kernels at their largest b = 256 shapes, then
    keygen, encaps and decaps latencies at b = 1 and b = 256."""
    from repro_torch.kernels import dyadic_kernel, ntt_kernel, ref
    from repro_torch.pq import mlkem
    rng = np.random.default_rng(SEED + 7)
    t = mlkem_pack()
    rows = mlkem_path_rows(MLKEM_B)
    x_f = ring_rows(rng, rows["ntt_fwd_banks_u16"][0])
    x_i = ring_rows(rng, rows["ntt_inv_banks_u16"][0])
    m_a = ring_rows(rng, rows["dyadic_basemul_banks"][0])
    m_b = ring_rows(rng, rows["dyadic_basemul_banks"][0])
    fargs = (t["qs"], t["tw"], t["twp"], t["psi"], t["psip"])
    iargs = (t["qs"], t["ninv"], t["ninv_p"], t["itw"], t["itwp"], t["ipsin"], t["ipsinp"])
    gargs = (t["qs"], t["mu"], t["gamma"], t["gammap"])
    kw = dict(negacyclic=False, lazy=True, reduce_out=True)   # the path's flags
    w = 2   # bytes per word
    tables = 2 * t["tw"].numel() * w                          # tw + twp
    cases = {
        "ntt_fwd_banks_u16": (
            lambda: ntt_kernel.ntt_fwd_banks(x_f, *fargs, **kw),
            lambda: ref.ntt_fwd_banks_ref(x_f, *fargs, **kw),
            None, tuple(x_f.shape), 2 * x_f.numel() * w + tables + w,
            banks_int_ops(x_f, t["tw"].shape[1], fwd=True, **kw)),
        "ntt_inv_banks_u16": (
            lambda: ntt_kernel.ntt_inv_banks(x_i, *iargs, **kw),
            lambda: ref.ntt_inv_banks_ref(x_i, *iargs, **kw),
            None, tuple(x_i.shape), 2 * x_i.numel() * w + tables + 3 * w,
            banks_int_ops(x_i, t["itw"].shape[1], fwd=False, **kw)),
        "dyadic_basemul_banks": (
            lambda: dyadic_kernel.dyadic_basemul_banks(m_a, m_b, *gargs, lazy=True),
            lambda: ref.dyadic_basemul_banks_ref(m_a, m_b, *gargs, lazy=True),
            None, tuple(m_a.shape),
            3 * m_a.numel() * w + 2 * t["gamma"].numel() * w + 2 * w,
            m_a.numel() // 2 * BASEMUL_OPS[True]),
    }
    out = time_kernels(cases, counts, errs)
    log("[times] library: none for the u16 transforms and the basecase "
        "product, which no single PyTorch call computes")

    d1, z1, m1 = mlkem_inputs(1)
    dB, zB, mB = mlkem_inputs(MLKEM_B)
    ek1, dk1 = mlkem.keygen_batch(d1, z1)
    ekB, dkB = mlkem.keygen_batch(dB, zB)
    ct1 = mlkem.encaps_batch(ek1, m1)[1]
    ctB = mlkem.encaps_batch(ekB, mB)[1]
    requests = {
        "keygen, b=1": lambda: mlkem.keygen_batch(d1, z1),
        "encaps, b=1": lambda: mlkem.encaps_batch(ek1, m1),
        "decaps, b=1": lambda: mlkem.decaps_batch(dk1, ct1),
        f"keygen, b={MLKEM_B}": lambda: mlkem.keygen_batch(dB, zB),
        f"encaps, b={MLKEM_B}": lambda: mlkem.encaps_batch(ekB, mB),
        f"decaps, b={MLKEM_B}": lambda: mlkem.decaps_batch(dkB, ctB),
    }
    samples = interleaved_host_ms(requests, LAT_ROUNDS)
    latency = {}
    for label, tms in samples.items():
        latency[label] = med = statistics.median(tms)
        q1, _, q3 = statistics.quantiles(tms, n=4)
        b = int(label.split("b=")[1])
        log(f"[times] mlkem {label}: median {med:.3f} ms over {len(tms)} interleaved "
            f"runs (min {min(tms):.3f}, quartiles {q1:.3f}-{q3:.3f}, max {max(tms):.3f}), "
            f"{b * 1e3 / med:.1f} requests per second")
    for b in (1, MLKEM_B):
        round_ms = sum(latency[f"{op}, b={b}"] for op in ("keygen", "encaps", "decaps"))
        log(f"[times] mlkem handshakes (keygen + encaps + decaps) at b={b}: "
            f"{round_ms:.3f} ms per batch, {b * 1e3 / round_ms:.1f} handshakes per second")
    label = f"decaps, b={MLKEM_B}"
    return out, [(requests[label], latency[label], f"mlkem {label}")]


# ----------------------------------------------------------- phase 3d

def ntt128_inputs():
    """The slice's inputs from the seed, as uint32 arrays: 10^5 NTT-128
    rows, the product pairs (2, 64, n) at n = 1024 and 4096, and the
    product sum's digits (2, 8, 64, 4096)."""
    from repro_torch.core.params import make_ntt_params
    rng = np.random.default_rng(SEED + 8)
    x = rng.integers(0, make_ntt_params(128).q, (NTT128_B, 128), dtype=np.uint32)
    pairs = {n: rng.integers(0, make_ntt_params(n).q, (2, PRODUCT_B, n),
                             dtype=np.uint32) for n in PRODUCT_NS}
    digits = rng.integers(0, make_ntt_params(MAC_N).q,
                          (2, MAC_DIGITS, PRODUCT_B, MAC_N), dtype=np.uint32)
    return x, pairs, digits


def product_request(a, b, p):
    """A negacyclic product: ntt, ntt, dyadic_mul, intt."""
    from repro_torch.kernels import ops
    return ops.intt(ops.dyadic_mul(ops.ntt(a, p), ops.ntt(b, p), p), p)


def run_ntt128(inputs, device=None) -> dict:
    """The slice's traffic through the single-prime ops, its inputs moved
    to ``device`` (None: the card).  Returns the named int32 results."""
    from repro_torch.convert import resolve_device, u32_to_tensor
    from repro_torch.core.params import make_ntt_params
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    x, pairs, digits = inputs
    p = make_ntt_params(128)
    xt = u32_to_tensor(x, dev)
    out = {"NTT-128 cyclic": ops.ntt(xt, p, negacyclic=False)}
    out["NTT-128 negacyclic"] = ops.ntt(xt, p)
    out["NTT-128 round trip"] = ops.intt(out["NTT-128 negacyclic"], p)
    for n, (a, b) in pairs.items():
        out[f"product n={n}"] = product_request(u32_to_tensor(a, dev),
                                                u32_to_tensor(b, dev),
                                                make_ntt_params(n))
    p = make_ntt_params(MAC_N)
    # every digit of each operand in one launch: (8, 64, n) rows
    A = out["digits A"] = ops.ntt(u32_to_tensor(digits[0], dev), p)
    B = out["digits B"] = ops.ntt(u32_to_tensor(digits[1], dev), p)
    acc = ops.dyadic_mul(A[0], B[0], p)
    for d in range(1, MAC_DIGITS):
        acc = ops.dyadic_mac(acc, A[d], B[d], p)
    out["product sum, NTT domain"] = acc
    out[f"product sum n={MAC_N}"] = ops.intt(acc, p)
    return out


def phase_ntt128_kernels() -> dict:
    """The four single-prime kernels against their plain versions at every
    shape of the path and at the edge ring sizes, lazy and eager, cyclic
    and negacyclic; the inverse takes the [0, 2q) band when lazy."""
    from repro_torch.core.params import make_ntt_params
    from repro_torch.kernels import dyadic_kernel, ntt_kernel, ref
    rng = np.random.default_rng(SEED + 9)
    err = {}

    def check(name, got, want, what):
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err[name] = max(err.get(name, 0), e)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: kernel != plain version "
                                 f"(max abs err {e})")

    def rows(q, shape, band=1):
        return torch.from_numpy(rng.integers(0, band * q, shape, dtype=np.int64)
                                .astype(np.int32)).cuda()

    ntt_shapes = ([(NTT128_B, 128), (1, 128), (UNEVEN_B, 128)]
                  + [(PRODUCT_B, n) for n in PRODUCT_NS]
                  + [(MAC_DIGITS * PRODUCT_B, MAC_N)] + [(EDGE_B, n) for n in EDGE_NS]
                  + [(RING_B, 1 << logn) for logn in range(1, 13)]
                  + [(EDGE_B, SINGLE_BANK_N)])
    mul_shapes = [(PRODUCT_B, n) for n in PRODUCT_NS] + [(EDGE_B, n) for n in EDGE_NS]
    for lazy in (False, True):
        for b, n in ntt_shapes:
            p = make_ntt_params(n)
            x, xi = rows(p.q, (b, n)), rows(p.q, (b, n), band=2 if lazy else 1)
            # below 64 and above 4096 words the wrappers launch the banks
            # kernels (one prime)
            fwd, inv = (("ntt_fwd_banks", "ntt_inv_banks") if ntt_kernel.on_banks(x)
                        else ("ntt_fwd", "ntt_inv"))
            for neg in (False, True):
                what = f"(B, n)=({b}, {n}) lazy={lazy} negacyclic={neg}"
                check(fwd, ntt_kernel.ntt_fwd(x, p, negacyclic=neg, lazy=lazy),
                      ref.ntt_fwd_ref(x, p, neg, lazy=lazy), what)
                check(inv, ntt_kernel.ntt_inv(xi, p, negacyclic=neg, lazy=lazy),
                      ref.ntt_inv_ref(xi, p, neg, lazy=lazy), what)
        # views one word past a 16-byte boundary: the row stream's bulk
        # copies need aligned rows, so these run as a one-prime bank
        for b, n in ((EDGE_B, 128), (3, MAC_N)):
            p = make_ntt_params(n)
            flat, flati = rows(p.q, (b * n + 1,)), rows(p.q, (b * n + 1,), band=2 if lazy else 1)
            x, xi = flat[1:].view(b, n), flati[1:].view(b, n)
            assert ntt_kernel.on_banks(x) and ntt_kernel.on_banks(xi)
            for neg in (False, True):
                what = f"(B, n)=({b}, {n}) unaligned view lazy={lazy} negacyclic={neg}"
                check("ntt_fwd_banks", ntt_kernel.ntt_fwd(x, p, negacyclic=neg, lazy=lazy),
                      ref.ntt_fwd_ref(x, p, neg, lazy=lazy), what)
                check("ntt_inv_banks", ntt_kernel.ntt_inv(xi, p, negacyclic=neg, lazy=lazy),
                      ref.ntt_inv_ref(xi, p, neg, lazy=lazy), what)
        for b, n in mul_shapes:
            p = make_ntt_params(n)
            acc, a, c = (rows(p.q, (b, n)) for _ in range(3))
            kw = dict(q=p.q, mu=p.barrett_mu, lazy=lazy)
            what = f"(B, n)=({b}, {n}) lazy={lazy}"
            check("dyadic_mul", dyadic_kernel.dyadic_mul(a, c, **kw),
                  ref.dyadic_mul_ref(a, c, p.q, p.barrett_mu, lazy=lazy), what)
            check("dyadic_mac", dyadic_kernel.dyadic_mac(acc, a, c, **kw),
                  ref.dyadic_mac_ref(acc, a, c, p.q, p.barrett_mu, lazy=lazy), what)
    for name, e in err.items():
        log(f"[ntt128 kernels] {name}: bit-identical to its plain version at "
            f"every shape (max abs err {e})")
    return err


def phase_ntt128() -> tuple:
    from repro_torch import kernels as K
    from repro_torch.convert import tensor_to_u32, u32_to_tensor
    from repro_torch.core import srm_sim
    from repro_torch.core.modmath import mulmod_np
    from repro_torch.core.ntt import brute_ntt_bitrev_np, negacyclic_convolve_np
    from repro_torch.core.params import make_ntt_params
    from repro_torch.kernels import ops
    inputs = ntt128_inputs()
    x, pairs, digits = inputs
    K.reset_counts()
    t0 = time.perf_counter()
    out = run_ntt128(inputs)
    torch.cuda.synchronize()
    counts = K.snapshot()
    log(f"[ntt128] cuda run: {time.perf_counter() - t0:.2f} s, counts "
        f"{ {k: v for k, v in counts.items() if v['launches'] or v['plain_calls']} }")
    check_counts("ntt128", counts)
    host = {k: tensor_to_u32(v) for k, v in out.items()}
    p = make_ntt_params(128)
    for k in ("NTT-128 cyclic", "NTT-128 negacyclic", "NTT-128 round trip"):
        if host[k].shape != x.shape or host[k].max() >= p.q:
            raise AssertionError(f"{k}: {host[k].shape}, expected {x.shape} in [0, q)")
    if not np.array_equal(host["NTT-128 round trip"], x):
        raise AssertionError("NTT-128: intt(ntt(x)) != x")
    brute = brute_ntt_bitrev_np(x[:NTT128_BRUTE], p.omega, p.q)
    if not np.array_equal(host["NTT-128 cyclic"][:NTT128_BRUTE], brute):
        raise AssertionError("NTT-128 != the brute-force oracle")
    srm_out, srm_stats = srm_sim.NTT128Pipeline(p).run(x[:NTT128_SRM])
    if not np.array_equal(host["NTT-128 cyclic"][:NTT128_SRM], srm_out):
        raise AssertionError("NTT-128 != the SRM pipeline model")
    log(f"[ntt128] {NTT128_B} NTT-128s (cyclic and negacyclic) on the card: the "
        f"round trip gives x back, {NTT128_BRUTE} rows equal the brute-force oracle, "
        f"{NTT128_SRM} equal the SRM pipeline model ({srm_stats})")
    for n, (a, b) in pairs.items():
        q = make_ntt_params(n).q
        got = host[f"product n={n}"]
        for i in range(PRODUCT_ROWS):
            if not np.array_equal(got[i], negacyclic_convolve_np(a[i], b[i], q)):
                raise AssertionError(f"product n={n} row {i} != the schoolbook product")
    q = make_ntt_params(MAC_N).q
    want = np.zeros(host["product sum, NTT domain"].shape, dtype=np.uint64)
    for d in range(MAC_DIGITS):
        want = (want + mulmod_np(host["digits A"][d], host["digits B"][d], q)) % q
    if not np.array_equal(host["product sum, NTT domain"], want.astype(np.uint32)):
        raise AssertionError("product sum (NTT domain) != numpy's exact sum")
    for i in range(PRODUCT_ROWS):
        conv = np.zeros(MAC_N, dtype=np.uint64)
        for d in range(MAC_DIGITS):
            conv = (conv + negacyclic_convolve_np(digits[0, d, i], digits[1, d, i], q)) % q
        if not np.array_equal(host[f"product sum n={MAC_N}"][i], conv.astype(np.uint32)):
            raise AssertionError(f"product sum row {i} != the schoolbook sum")
    log(f"[ntt128] products at n in {PRODUCT_NS} ({PRODUCT_B} pairs): {PRODUCT_ROWS} rows "
        f"each equal the schoolbook product; the {MAC_DIGITS}-digit product sum at "
        f"n={MAC_N} equals numpy on all {PRODUCT_B} rows in the NTT domain and the "
        f"schoolbook sum on {PRODUCT_ROWS}")
    dev = out["NTT-128 round trip"].device
    a, b = (u32_to_tensor(v, dev) for v in pairs[MAC_N])
    per_op = {}
    for what, req in (("NTT-128 batch", lambda: ops.ntt(out["NTT-128 round trip"], p,
                                                        negacyclic=False)),
                      (f"product n={MAC_N}",
                       lambda: product_request(a, b, make_ntt_params(MAC_N)))):
        K.reset_counts()
        req()
        torch.cuda.synchronize()
        per_op[what] = {k: v["launches"] for k, v in K.snapshot().items() if v["launches"]}
        log(f"[ntt128] launches per {what}: {per_op[what]}")
    return inputs, host, counts, per_op


def phase_ntt128_cpu_parity(inputs, cuda_host) -> None:
    from repro_torch.convert import tensor_to_u32
    t0 = time.perf_counter()
    out = run_ntt128(inputs, device="cpu")
    for name, v in out.items():
        if not np.array_equal(tensor_to_u32(v), cuda_host[name]):
            raise AssertionError(f"{name}: cuda run != cpu run")
    log(f"[ntt128 parity] cuda == cpu bit for bit: {', '.join(out)} "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")


def phase_ntt128_times(counts: dict, errs: dict) -> tuple:
    """The four kernels at the NTT-128 request's (10^5, 128) shape (the
    Barrett pair too, as a bandwidth probe), NTT-128s per second, the
    kernels at the products' shapes, and host-clock latencies of the
    NTT-128 request and the n = 4096 product."""
    from repro_torch.convert import tensor_to_u32, u32_to_tensor
    from repro_torch.core.params import make_ntt_params
    from repro_torch.kernels import dyadic_kernel, ntt_kernel, ops, ref
    rng = np.random.default_rng(SEED + 10)
    p = make_ntt_params(128)
    x, a, b, c = (torch.from_numpy(rng.integers(0, p.q, (NTT128_B, 128), dtype=np.int64)
                                   .astype(np.int32)).cuda() for _ in range(4))
    w = 4   # bytes per word
    tables = 2 * p.tw.size * w                      # tw + twp (or itw + itwp)
    mk = dict(q=p.q, mu=p.barrett_mu, lazy=True)
    stages = p.tw.shape[0]
    # integer instructions as for the banks (a one-prime bank of B rows):
    # lazy butterflies, the forward's final reduce, the inverse's exact
    # epilogue multiply
    path = dict(lazy=True, reduce_out=True)
    cases = {
        "ntt_fwd": (
            lambda: ntt_kernel.ntt_fwd(x, p, negacyclic=False, lazy=True),
            lambda: ref.ntt_fwd_ref(x, p, False, lazy=True),
            None, tuple(x.shape), 2 * x.numel() * w + tables,
            banks_int_ops(x, stages, fwd=True, negacyclic=False, **path)),
        "ntt_inv": (
            lambda: ntt_kernel.ntt_inv(x, p, negacyclic=True, lazy=True),
            lambda: ref.ntt_inv_ref(x, p, True, lazy=True),
            None, tuple(x.shape), 2 * x.numel() * w + tables + 2 * p.n * w,
            banks_int_ops(x, stages, fwd=False, negacyclic=True, **path)),
        "dyadic_mul": (
            lambda: dyadic_kernel.dyadic_mul(a, b, **mk),
            lambda: ref.dyadic_mul_ref(a, b, p.q, p.barrett_mu, lazy=True),
            None, tuple(a.shape), 3 * a.numel() * w),
        "dyadic_mac": (
            lambda: dyadic_kernel.dyadic_mac(c, a, b, **mk),
            lambda: ref.dyadic_mac_ref(c, a, b, p.q, p.barrett_mu, lazy=True),
            None, tuple(a.shape), 4 * a.numel() * w),
    }
    out = time_kernels(cases, counts, errs)
    log("[times] library: none for the single-prime NTT and the Barrett "
        "product and MAC, which no single PyTorch call computes")
    # rows 9-10's inputs as a one-prime bank on the banks launchers: the
    # route the row stream has to beat
    bank = ntt_kernel.single_prime_bank(p, x.device)
    for name, fn in (
            ("ntt_fwd", lambda: ntt_kernel.ntt_fwd_banks(
                x[None], bank["qs"], bank["tw"], bank["twp"], bank["psi"], bank["psip"],
                negacyclic=False, **path)),
            ("ntt_inv", lambda: ntt_kernel.ntt_inv_banks(
                x[None], bank["qs"], bank["ninv"], bank["ninv_p"], bank["itw"], bank["itwp"],
                bank["ipsin"], bank["ipsinp"], negacyclic=True, **path))):
        rec = next(r for r in out if r["name"] == name)
        log(f"[times] {name} {tuple(x.shape)} as a one-prime bank: {graph_ms(fn):.4f} ms "
            f"(the row stream {rec['ms']:.4f} ms)")
    fwd = next(r for r in out if r["name"] == "ntt_fwd")
    log(f"[times] NTT-128 at B={NTT128_B}: {NTT128_B / fwd['ms'] / 1e3:.1f} M NTT/s "
        f"(kernel {fwd['ms']:.4f} ms; byte bound {NTT128_B / fwd['bound_ms'] / 1e3:.1f} "
        "M NTT/s)")

    # the kernels at the product requests' shapes
    p4 = make_ntt_params(MAC_N)
    y, z, v = (torch.from_numpy(rng.integers(0, p4.q, (PRODUCT_B, MAC_N), dtype=np.int64)
                                .astype(np.int32)).cuda() for _ in range(3))
    y8 = torch.from_numpy(rng.integers(0, p4.q, (MAC_DIGITS * PRODUCT_B, MAC_N),
                                       dtype=np.int64).astype(np.int32)).cuda()
    k4 = dict(q=p4.q, mu=p4.barrett_mu, lazy=True)
    t4 = 2 * p4.tw.size * w
    for name, fn, nbytes, shape in (
            ("ntt_fwd", lambda: ntt_kernel.ntt_fwd(y8, p4, negacyclic=True, lazy=True),
             2 * y8.numel() * w + t4 + 2 * MAC_N * w, tuple(y8.shape)),
            ("ntt_inv", lambda: ntt_kernel.ntt_inv(y, p4, negacyclic=True, lazy=True),
             2 * y.numel() * w + t4 + 2 * MAC_N * w, tuple(y.shape)),
            ("dyadic_mul", lambda: dyadic_kernel.dyadic_mul(y, z, **k4),
             3 * y.numel() * w, tuple(y.shape)),
            ("dyadic_mac", lambda: dyadic_kernel.dyadic_mac(v, y, z, **k4),
             4 * y.numel() * w, tuple(y.shape))):
        log(f"[times] {name} {shape} (product path): kernel {graph_ms(fn):.4f} ms, "
            f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes), "
            f"eager call {eager_ms(fn):.4f} ms")
    # rings above 4096 words run as a one-prime bank (two passes), counted
    # on the banks kernels
    for n in EDGE_NS[1:]:
        pn = make_ntt_params(n)
        for rows in (EDGE_B, 132):
            e = torch.from_numpy(rng.integers(0, pn.q, (rows, n), dtype=np.int64)
                                 .astype(np.int32)).cuda()
            nbytes = 2 * e.numel() * w + 2 * pn.tw.size * w + 2 * n * w
            for name, kern in (("ntt_fwd", ntt_kernel.ntt_fwd), ("ntt_inv", ntt_kernel.ntt_inv)):
                ms = graph_ms(lambda: kern(e, pn, negacyclic=True, lazy=True))
                log(f"[times] {name} ({rows}, {n}) (one-prime bank): kernel {ms:.4f} ms, "
                    f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes), "
                    f"{ms * 1e3 / rows:.2f} us per row")

    xh = rng.integers(0, p.q, (NTT128_B, 128), dtype=np.uint32)
    ab = rng.integers(0, p4.q, (2, PRODUCT_B, MAC_N), dtype=np.uint32)
    ya, yb = (u32_to_tensor(t, x.device) for t in ab)
    requests = {
        f"NTT-128 batch, B={NTT128_B}, on the card":
            lambda: ops.ntt(x, p, negacyclic=False),
        f"NTT-128 batch, B={NTT128_B}, from and to host memory":
            lambda: tensor_to_u32(ops.ntt(u32_to_tensor(xh, x.device), p,
                                          negacyclic=False)),
        f"product n={MAC_N}, B={PRODUCT_B}, on the card":
            lambda: product_request(ya, yb, p4),
    }
    samples = interleaved_host_ms(requests, LAT_ROUNDS)
    latency = {}
    for label, tms in samples.items():
        latency[label] = med = statistics.median(tms)
        q1, _, q3 = statistics.quantiles(tms, n=4)
        rate = (f"{NTT128_B / med / 1e3:.3f} M NTT/s" if label.startswith("NTT")
                else f"{PRODUCT_B * 1e3 / med:.1f} products per second")
        log(f"[times] {label}: median {med:.3f} ms over {len(tms)} interleaved runs "
            f"(min {min(tms):.3f}, quartiles {q1:.3f}-{q3:.3f}, max {max(tms):.3f}), {rate}")
    profiles = [(requests[label], latency[label], label) for label in requests
                if "on the card" in label]
    return out, profiles


# ------------------------------------------------------------ phase 4

def phase_times(ctx, cts, fs_pack, ks_pack, per_op, counts, errs, rot) -> list:
    from repro_torch.fhe import batched as FB
    from repro_torch.fhe import linalg, rns
    from repro_torch.kernels import dyadic_kernel, galois_kernel, ntt_kernel, ref
    rng = np.random.default_rng(SEED + 2)
    kp1 = fs_pack["qs"].shape[0]
    k = kp1 - 1
    n1 = 128
    qlist = [int(v) for v in fs_pack["qs"].cpu()]
    t1 = fs_pack["pack1"]
    # the B = 8 multiply's decompose: k digits x B ciphertexts x n2 columns
    rows = k * BATCH * (N // n1)
    x_f = residues(rng, qlist, (rows, n1))
    x_i = residues(rng, qlist[:k], (BATCH * (N // n1), n1), band=2)
    x_t = residues(rng, qlist, (k * BATCH, N), band=2)
    ext = torch.stack([residues(rng, qlist, (BATCH, N)) for _ in range(k)])
    evk = torch.stack([residues(rng, qlist, (N,)) for _ in range(k)])
    tw1 = (t1["qs"], t1["tw"], t1["twp"], t1["psi"], t1["psip"])
    iw1 = tuple(t1[n][:k] for n in ("qs", "ninv", "ninv_p", "itw", "itwp",
                                     "ipsin", "ipsinp"))
    tw = (fs_pack["qs"], fs_pack["tw"], fs_pack["twp"])
    dk = (ks_pack["qs"], ks_pack["mu"])
    w = 4   # bytes per word
    cases = {
        "ntt_fwd_banks": (
            lambda: ntt_kernel.ntt_fwd_banks(x_f, *tw1, negacyclic=False,
                                             lazy=True, reduce_out=False),
            lambda: ref.ntt_fwd_banks_ref(x_f, *tw1, False, lazy=True,
                                          reduce_out=False),
            None, tuple(x_f.shape), 2 * x_f.numel() * w + 2 * t1["tw"].numel() * w + kp1 * w,
            banks_int_ops(x_f, t1["tw"].shape[1], fwd=True, negacyclic=False, lazy=True,
                          reduce_out=False)),
        "ntt_inv_banks": (
            lambda: ntt_kernel.ntt_inv_banks(x_i, *iw1, negacyclic=False,
                                             lazy=True, reduce_out=False),
            lambda: ref.ntt_inv_banks_ref(x_i, *iw1, False, lazy=True,
                                          reduce_out=False),
            None, tuple(x_i.shape), 2 * x_i.numel() * w + 2 * iw1[3].numel() * w + 3 * k * w,
            banks_int_ops(x_i, iw1[3].shape[1], fwd=False, negacyclic=False, lazy=True,
                          reduce_out=False)),
        "twiddle_mul_banks": (
            lambda: ntt_kernel.twiddle_mul_banks(x_t, *tw, lazy=True),
            lambda: ref.twiddle_mul_banks_ref(x_t, *tw, lazy=True),
            None, tuple(x_t.shape), 2 * x_t.numel() * w + 2 * fs_pack["tw"].numel() * w + kp1 * w),
        "dyadic_inner_banks": (
            lambda: dyadic_kernel.dyadic_inner_banks(ext, evk, *dk, lazy=True),
            lambda: ref.dyadic_inner_banks_ref(ext, evk, *dk, lazy=True),
            None, tuple(ext.shape), (ext.numel() + evk.numel() + ext[0].numel()) * w + 2 * kp1 * w),
    }
    # the rotation path's gathers: one half of a single rotate (k = 8
    # ciphertext primes), a mixed rotate_many of 8, and the hoisted R = 8
    # digit gather of one (8 digits, 8 + 1 primes) decomposition
    rows = gather_rows(N, ROT_AMOUNTS, True)
    g1 = residues(rng, qlist[:k], (1, N))
    g8 = residues(rng, qlist[:k], (BATCH, N))
    dig = torch.stack([residues(rng, qlist, (1, N)) for _ in range(k)])
    cases["galois_banks"] = (
        lambda: galois_kernel.galois_banks(g1, rows[0]),
        lambda: ref.galois_banks_ref(g1, rows[0]),
        lambda: torch.index_select(g1, 2, rows[0]),
        tuple(g1.shape), (2 * g1.numel() + N) * w)
    cases["galois_banks_multi"] = (
        lambda: galois_kernel.galois_banks_multi(g8, rows),
        lambda: ref.galois_banks_ref(g8, rows),
        lambda: torch.gather(g8, 2, rows.expand(g8.shape)),
        tuple(g8.shape), (2 * g8.numel() + rows.numel()) * w)
    cases["galois_digits"] = (
        lambda: galois_kernel.galois_digits(dig, rows, shared=True),
        lambda: ref.galois_digits_banks_ref(dig, rows),
        lambda: torch.index_select(dig.view(k * kp1, N), 1, rows.view(-1)),
        tuple(dig.shape), ((1 + BATCH) * dig.numel() + rows.numel()) * w)
    out = time_kernels(cases, counts, errs)
    log("[times] library: index_select / gather at the kernel's shape for the "
        "three gathers; none for the NTT banks, the Shoup weight-row multiply "
        "and the Barrett digit MAC, which no single PyTorch call computes")
    # beside the path's shapes: the weight-row multiply of a B = 1 request,
    # the hoisted rotation's c0 gather (1, k, 1, n) fanned out to R = 8 at
    # 2^14, and the gathers at 2^16 (the piece ring of the staged body; the
    # split body of galois_banks), the c0 gather too
    x1 = residues(rng, qlist, (k, N), band=2)
    rows16 = gather_rows(N16, ROT_AMOUNTS, True)
    qs16 = [int(q) for q in rns.make_primes(N16, kp1)]
    h1 = residues(rng, qs16[:k], (1, N16))
    h8 = residues(rng, qs16[:k], (BATCH, N16))
    dig16 = torch.stack([residues(rng, qs16, (1, N16)) for _ in range(k)])
    c0 = residues(rng, qlist[:k], (1, N))[None]
    c016 = residues(rng, qs16[:k], (1, N16))[None]
    for name, fn, lib_fn, nbytes, shape in (
            ("twiddle_mul_banks", lambda: ntt_kernel.twiddle_mul_banks(x1, *tw, lazy=True),
             None, 2 * x1.numel() * w + 2 * fs_pack["tw"].numel() * w + kp1 * w,
             tuple(x1.shape)),
            ("galois_digits c0", lambda: galois_kernel.galois_digits(c0, rows, shared=True),
             lambda: torch.index_select(c0.view(k, N), 1, rows.view(-1)),
             ((1 + BATCH) * c0.numel() + rows.numel()) * w, tuple(c0.shape)),
            ("galois_banks", lambda: galois_kernel.galois_banks(h1, rows16[0]),
             lambda: torch.index_select(h1, 2, rows16[0]),
             (2 * h1.numel() + N16) * w, tuple(h1.shape)),
            ("galois_banks_multi", lambda: galois_kernel.galois_banks_multi(h8, rows16),
             lambda: torch.gather(h8, 2, rows16.expand(h8.shape)),
             (2 * h8.numel() + rows16.numel()) * w, tuple(h8.shape)),
            ("galois_digits", lambda: galois_kernel.galois_digits(dig16, rows16, shared=True),
             lambda: torch.index_select(dig16.view(k * kp1, N16), 1, rows16.view(-1)),
             ((1 + BATCH) * dig16.numel() + rows16.numel()) * w, tuple(dig16.shape)),
            ("galois_digits c0", lambda: galois_kernel.galois_digits(c016, rows16, shared=True),
             lambda: torch.index_select(c016.view(k, N16), 1, rows16.view(-1)),
             ((1 + BATCH) * c016.numel() + rows16.numel()) * w, tuple(c016.shape))):
        lib = f", library {graph_ms(lib_fn):.4f} ms" if lib_fn is not None else ""
        log(f"[times] {name} {shape} (beside the path): kernel {graph_ms(fn):.4f} ms"
            f"{lib}, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} bytes)")
    # the banks at a B = 1 multiply's pass shapes (the decompose's forward
    # rows and the inverse's), and rings above 4096 words (two passes)
    x1f = residues(rng, qlist, (k * (N // n1), n1))
    x1i = residues(rng, qlist[:k], (N // n1, n1), band=2)
    time_banks_beside("B=1 pass", x1f, t1, fwd=True, negacyclic=False, lazy=True,
                      reduce_out=False)
    time_banks_beside("B=1 pass", x1i, {n: v[:k] for n, v in t1.items()}, fwd=False,
                      negacyclic=False, lazy=True, reduce_out=False)
    for n in BIG_BANKS_NS[2:]:
        tb = FB.build_table_pack(rns.make_primes(n, 3), n, "cuda")
        xb = residues(rng, [int(q) for q in tb["qs"].cpu()], (EDGE_B, n))
        for fwd in (True, False):
            time_banks_beside("two passes", xb, tb, fwd=fwd, negacyclic=True, lazy=True,
                              reduce_out=True)
    for what, n_launch in per_op.items():
        log(f"[times] launches per {what}: {n_launch}")

    a, b = cts[0], cts[1]
    rhs = [cts[(i + 1) % BATCH] for i in range(BATCH)]
    rctx, M = rot["ctx"], rot["M"]
    rcts = rot["cts"]
    # the plans' programs run as CUDA graphs; their eager twins run the
    # module-level programs on the same tables and keys
    plan, rplan = ctx.plan(), rctx.plan()
    eager, reager = eager_twin(plan), eager_twin(rplan)
    mv_ks = len(M.baby_set) - 1 + len(M.giant_set)
    # (label, request, key switches it pays)
    requests = [
        ("multiply + rescale, B=1", lambda: plan.rescale(plan.multiply(a, b)), 1),
        ("multiply + rescale, B=1, eager", lambda: eager.rescale(eager.multiply(a, b)), 1),
        (f"multiply + rescale, B={BATCH}",
         lambda: plan.rescale_many(plan.multiply_many(cts[:BATCH], rhs)), BATCH),
        (f"multiply + rescale, B={BATCH}, eager",
         lambda: eager.rescale_many(eager.multiply_many(cts[:BATCH], rhs)), BATCH),
        ("rotate, B=1", lambda: rplan.rotate(rcts[0], 1), 1),
        ("rotate, B=1, eager", lambda: reager.rotate(rcts[0], 1), 1),
        (f"rotate_many, B={BATCH}", lambda: rplan.rotate_many(rcts[:BATCH], ROT_AMOUNTS),
         BATCH),
        (f"rotate_hoisted, R={BATCH}", lambda: rplan.rotate_hoisted(rcts[0], ROT_AMOUNTS),
         BATCH),
        (f"matvec {MV_DIM}x{MV_DIM}", lambda: linalg.matvec(rplan, M, rcts[-1]), mv_ks),
        (f"matvec {MV_DIM}x{MV_DIM}, eager", lambda: linalg.matvec(reager, M, rcts[-1]),
         mv_ks),
    ]
    samples = interleaved_host_ms({label: req for label, req, _ in requests},
                                  LAT_ROUNDS)
    base = "rotate, B=1"
    latency = {}
    for label, req, ks in requests:
        t = samples[label]
        latency[label] = med = statistics.median(t)
        q1, _, q3 = statistics.quantiles(t, n=4)
        ratio = statistics.median(a / b for a, b in zip(t, samples[base]))
        log(f"[times] {label}: median {med:.3f} ms over {len(t)} interleaved "
            f"runs (min {min(t):.3f}, quartiles {q1:.3f}-{q3:.3f}, max "
            f"{max(t):.3f}), {ks * 1e3 / med:.1f} key switches per second, "
            f"{ratio:.3f}x a rotate of the same round (median)")
    # profiled after every latency is taken (the caller runs them): a
    # profiler session leaves per-launch overhead behind that would slow
    # later timings
    profiles = [(req, latency[label], label) for label, req, _ in requests
                if label.startswith(("multiply", "rotate, ", "matvec"))]
    return out, profiles


def time_banks_beside(label, x, t, *, fwd, negacyclic, lazy, reduce_out) -> None:
    """One banks transform off the path's table shapes: its device time,
    byte bound and integer instructions, kept in BESIDE for the integer
    bound at the end."""
    from repro_torch.kernels import ntt_kernel
    w = x.element_size()
    kw = dict(negacyclic=negacyclic, lazy=lazy, reduce_out=reduce_out)
    if fwd:
        name, tabs = "ntt_fwd_banks", ("tw", "twp", "psi", "psip")
        fn = lambda: ntt_kernel.ntt_fwd_banks(x, t["qs"], t["tw"], t["twp"], t["psi"],
                                              t["psip"], **kw)
    else:
        name, tabs = "ntt_inv_banks", ("itw", "itwp", "ipsin", "ipsinp")
        fn = lambda: ntt_kernel.ntt_inv_banks(x, t["qs"], t["ninv"], t["ninv_p"], t["itw"],
                                              t["itwp"], t["ipsin"], t["ipsinp"], **kw)
    weights = negacyclic
    nbytes = (2 * x.numel() + sum(t[a].numel() for a in tabs[:2 + 2 * weights])) * w
    ms = graph_ms(fn)
    ops = banks_int_ops(x, t[tabs[0]].shape[1], fwd=fwd, **kw)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    BESIDE.append((f"{name} {tuple(x.shape)} ({label})", ms, bound, ops))
    log(f"[times] {name} {tuple(x.shape)} ({label}): kernel {ms:.4f} ms, byte bound "
        f"{bound:.4f} ms ({nbytes} bytes), {ops} integer instructions")


def apply_int_bounds(records: list, mhz: float) -> None:
    """bound_ms of every record with an integer count (the NTT banks and
    the single-prime transforms): the larger of its byte bound and its
    integer bound at ``mhz``; bound_by names it.  Logs the records kept
    beside the path the same way."""
    for rec in records:
        if rec.get("int_ops"):
            rec["int_bound_ms"] = int_bound_ms(rec["int_ops"], mhz)
            rec["sm_clock_mhz"] = mhz
            if rec["int_bound_ms"] > rec["bytes_bound_ms"]:
                rec["bound_ms"], rec["bound_by"] = rec["int_bound_ms"], "operations"
            log(f"[bounds] {rec['name']} {tuple(rec['shape'])}: kernel {rec['ms']:.4f} ms, "
                f"bytes {rec['bytes_bound_ms']:.4f} ms, integer {rec['int_bound_ms']:.4f} "
                f"ms at {mhz:.0f} MHz, bound by {rec['bound_by']} "
                f"({rec['ms'] / rec['bound_ms']:.2f}x)")
    for label, ms, bound, ops in BESIDE:
        ib = int_bound_ms(ops, mhz)
        log(f"[bounds] {label}: kernel {ms:.4f} ms, bytes {bound:.4f} ms, integer "
            f"{ib:.4f} ms at {mhz:.0f} MHz ({ms / max(bound, ib):.2f}x the larger)")


def time_kernels(cases: dict, counts: dict, errs: dict) -> list:
    """The JSON record of each kernel: its CUDA-graph time, plain version,
    library call (or None), byte bound and eager call at the case's
    shape, and its launches on each path's counted run."""
    out = []
    for name, (kern, plain, library, shape, nbytes, *ops) in cases.items():
        ms = graph_ms(kern)
        plain_ms = graph_ms(plain, inner=1)
        wrapper_ms = eager_ms(kern)
        library_ms = graph_ms(library) if library is not None else None
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        by_path = {path: c[name]["launches"] for path, c in counts.items()}
        lib = f"{library_ms:.4f} ms" if library is not None else "none"
        log(f"[times] {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib}, bound {bound_ms:.4f} ms ({nbytes} bytes), eager call "
            f"{wrapper_ms:.4f} ms, launches by path {by_path}")
        out.append({"name": name, "route": "cuda", "source": SOURCE[name],
                    "replaces": REPLACES[name], "launches": sum(by_path.values()),
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "bytes_bound_ms": bound_ms, "int_ops": ops[0] if ops else None,
                    "library_ms": library_ms, "shape": list(shape),
                    "eager_ms": wrapper_ms, "launches_by_path": by_path})
    return out


def profile_request(req, lat_ms: float, label: str) -> None:
    """Where one request's time goes: the device kernels of one warm
    request under torch.profiler, their busy time against the request's
    measured latency, split into the port's kernels and the PyTorch glue
    between them.  A profile that recorded fewer port kernels than the
    wrappers launched in it is taken again, up to PROFILE_TRIES times."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels as K
    req()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        before = K.snapshot()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            req()
            torch.cuda.synchronize()
        launched = sum(c.launches - before[name]["launches"] for name, c in K.COUNTS.items())
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = [e for e in kern if any(f in e.name for f in DEVICE_FUNCTIONS)]
        if kern and len(ours) >= launched:
            break
        log(f"[trace] {label}: the profiler recorded {len(ours)} port kernels of the "
            f"{launched} the wrappers launched")
    else:
        log(f"[trace] {label}: short in {PROFILE_TRIES} profiles; device busy share "
            "not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    mine = sum(e.time_range.elapsed_us() for e in ours) / 1e3
    log(f"[trace] {label}: {len(kern)} device kernels ({len(ours)} of the "
        f"port's), busy {busy:.3f} ms of {lat_ms:.3f} ms "
        f"({100 * busy / lat_ms:.1f}% busy, {100 * (1 - busy / lat_ms):.1f}% idle); "
        f"port kernels {mine:.3f} ms, PyTorch glue {busy - mine:.3f} ms")
    by_name: dict = {}
    for e in kern:
        t = by_name.setdefault(e.name[:60], [0, 0.0])
        t[0] += 1
        t[1] += e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (cnt, ms) in top:
        log(f"[trace]   {ms:.3f} ms in {cnt} launches of {name}")


def main() -> int:
    global SEED
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of every phase's inputs (default %(default)s)")
    SEED = parser.parse_args().seed
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build()

    from repro_torch.fhe import batched as FB
    from repro_torch.fhe import rns
    primes = rns.make_primes(N, LEVELS + 2)
    ks_primes = primes[1:] + primes[:1]        # q_0 .. q_L, then special P
    t0 = time.perf_counter()
    fs_pack = rns.fourstep_basis_pack(tuple(ks_primes), N, torch.device("cuda"))
    ks_pack = FB.build_scalar_pack(ks_primes, "cuda")
    log(f"[tables] four-step pack for {len(ks_primes)} primes: "
        f"{time.perf_counter() - t0:.2f} s")

    errs = phase_kernels(fs_pack, ks_primes)
    rng = np.random.default_rng(SEED + 1)
    zs = [rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
          for _ in range(BATCH)]
    ctx, cts, answers, counts, per_op, slot_err = phase_slice(zs)
    phase_cpu_parity(zs, cts, answers)
    rctx, M, rcts, rans, rcounts, rot_err, rot_per_op = phase_rotation()
    phase_rotation_cpu_parity(rcts, rans)
    r16_cts, r16_ans, r16counts = phase_rot16()
    phase_rot16_cpu_parity(r16_cts, r16_ans)
    sctx, sM, s_reqs, s_out, s_mixed, scounts = phase_serve()
    phase_serve_cpu_parity(s_reqs, s_out, s_mixed)
    gcounts = phase_scaleout({"ctx": rctx, "M": M, "cts": rcts},
                             {"ctx": sctx, "M": sM, "reqs": s_reqs, "out": s_out})
    errs.update(phase_mlkem_kernels())
    mlkem_in, mlkem_out, mcounts, mlkem_per_op = phase_mlkem()
    phase_mlkem_cpu_parity(mlkem_in, mlkem_out)
    for name, e in phase_ntt128_kernels().items():
        errs[name] = max(errs.get(name, 0), e)
    ntt_in, ntt_out, ncounts, ntt_per_op = phase_ntt128()
    phase_ntt128_cpu_parity(ntt_in, ntt_out)
    per_op = {"multiply + rescale": {k: v for k, v in per_op.items() if v},
              **rot_per_op, **{f"mlkem {op}": c for op, c in mlkem_per_op.items()},
              **ntt_per_op}
    counts = {"multiply": counts, "rotation": rcounts, "rot16": r16counts,
              "serve": scounts, "scaleout": gcounts, "mlkem": mcounts, "ntt128": ncounts}
    with SmClock() as clock:
        kernels, profiles = phase_times(ctx, cts, fs_pack, ks_pack, per_op, counts,
                                        errs, {"ctx": rctx, "M": M, "cts": rcts})
        mlkem_kernels, mlkem_profiles = phase_mlkem_times(counts, errs)
        ntt_kernels, ntt_profiles = phase_ntt128_times(counts, errs)
    kernels += mlkem_kernels + ntt_kernels
    if clock.mhz is None:
        raise AssertionError("nvidia-smi read no SM clock during the timings")
    log(f"[clock] SM clock during the timings: highest of {clock.samples} readings "
        f"{clock.mhz:.0f} MHz")
    apply_int_bounds(kernels, clock.mhz)
    for req, lat_ms, label in profiles + mlkem_profiles + ntt_profiles:
        profile_request(req, lat_ms, label)
    log(f"[done] {time.perf_counter() - t_start:.1f} s, slot error "
        f"{slot_err:.3e} (multiply path), {rot_err:.3e} (rotation path); "
        f"ML-KEM-768 KATs and {MLKEM_B} handshakes byte-exact; {NTT128_B} "
        "NTT-128s and the products exact")
    log(f"[gpu] {gpu_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
