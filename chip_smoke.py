#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and run its main paths on one GPU.

    python3 chip_smoke.py

Phases (any mismatch raises, so the exit code is non-zero):
  1. build     compile every kernel from src/repro_torch/csrc (one nvcc per
               source, in parallel) and print the card's name and power limit
  2. kernels   hold each kernel against its plain PyTorch version on the
               card, at the shapes of the CKKS multiply -> rescale and
               rotation paths at n = 2^14 with 8 + 1 primes (and one
               bit-reversed gather case at n = 1024); results must be
               bit-identical
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
  4. times     per kernel (CUDA events around a CUDA-graph replay, so the
               device time) beside its memory bound, its eager call, its
               plain version and, for the gathers, the one PyTorch call that
               computes the same function; request latencies of both paths
               (interleaved rounds: median, quartiles, ratio to a rotate of
               the same round), and a torch.profiler breakdown of one
               request's device time

The last line of standard output is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the per-kernel JSON record.  Imports torch, numpy and
the port only.
"""
from __future__ import annotations

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
REPS = 25                        # timing repetitions, median reported
LAT_ROUNDS = 20                  # interleaved rounds of the request latencies

ROT_AMOUNTS = tuple(range(1, BATCH + 1))
MV_DIM = 64                      # bsgs_split(64) = (8, 8)

REPLACES = {
    "ntt_fwd_banks": "src/repro/kernels/ntt_kernel.py:306",
    "ntt_inv_banks": "src/repro/kernels/ntt_kernel.py:320",
    "twiddle_mul_banks": "src/repro/kernels/ntt_kernel.py:346",
    "dyadic_inner_banks": "src/repro/kernels/dyadic_kernel.py:175",
    "galois_banks": "src/repro/kernels/galois_kernel.py:50",
    "galois_banks_multi": "src/repro/kernels/galois_kernel.py:73",
    "galois_digits": "src/repro/kernels/galois_kernel.py:110",
}
SOURCE = {
    "ntt_fwd_banks": "src/repro_torch/csrc/ntt_banks.cu",
    "ntt_inv_banks": "src/repro_torch/csrc/ntt_banks.cu",
    "twiddle_mul_banks": "src/repro_torch/csrc/ntt_banks.cu",
    "dyadic_inner_banks": "src/repro_torch/csrc/dyadic_inner.cu",
    "galois_banks": "src/repro_torch/csrc/galois.cu",
    "galois_banks_multi": "src/repro_torch/csrc/galois.cu",
    "galois_digits": "src/repro_torch/csrc/galois.cu",
}
# the kernels each path must launch: multiply -> rescale runs the key
# switch; the rotation path runs the key switch and all three gathers
PATH_KERNELS = {
    "multiply": ("ntt_fwd_banks", "ntt_inv_banks", "twiddle_mul_banks",
                 "dyadic_inner_banks"),
    "rotation": tuple(SOURCE),
}
# device function names of the port's kernels, as the profiler sees them
DEVICE_FUNCTIONS = ("ntt_fwd_banks_kernel", "ntt_inv_banks_kernel",
                    "twiddle_mul_banks_kernel", "dyadic_inner_banks_kernel",
                    "galois_gather_kernel")


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

    packs = {128: fs_pack["pack1"],
             1024: FB.build_table_pack(rns.make_primes(1024, k), 1024, "cuda")}
    for n, t in packs.items():
        for lazy in (False, True):
            x = residues(rng, [int(v) for v in t["qs"].cpu()], (1024, n),
                         band=2 if lazy else 1)
            xr = residues(rng, [int(v) for v in t["qs"].cpu()], (1024, n))
            for reduce_out in (False, True):
                for neg in (False, True):
                    what = f"n={n} lazy={lazy} reduce_out={reduce_out} negacyclic={neg}"
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
    x = residues(rng, [int(v) for v in qs.cpu()], (BATCH, N), band=2)
    for lazy in (False, True):
        check("twiddle_mul_banks",
              ntt_kernel.twiddle_mul_banks(x, qs, fs_pack["tw"], fs_pack["twp"], lazy=lazy),
              ref.twiddle_mul_banks_ref(x, qs, fs_pack["tw"], fs_pack["twp"], lazy=lazy),
              f"(k, B, n)={tuple(x.shape)} lazy={lazy}")
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


def gather_rows(n: int, amounts, natural: bool):
    """(len(amounts), n) int32 gather rows on the card for slot rotations."""
    from repro_torch.core.params import galois_eval_perm
    rows = np.stack([galois_eval_perm(pow(5, r, 2 * n), n, natural)
                     for r in amounts])
    return torch.from_numpy(rows.astype(np.int32)).cuda()


def check_gathers(check, rng, ct_primes) -> None:
    """The three gathers at the rotation path's shapes: k = 8 ciphertext
    primes, d = 8 digits over 8 + 1 primes, B = R = 8, n = 2^14 natural
    order; and once in bit-reversed order at n = 1024."""
    from repro_torch.fhe import rns
    from repro_torch.kernels import galois_kernel, ref
    k = len(ct_primes)
    for n, natural in ((N, True), (1024, False)):
        qs = ct_primes if natural else [int(q) for q in rns.make_primes(n, k)]
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
                                ("c0 (d = 1) shared", c0, True)):
            check("galois_digits", galois_kernel.galois_digits(x, rows, shared=shared),
                  ref.galois_digits_banks_ref(x, rows),
                  f"x {tuple(x.shape)} {what} -> R={BATCH}, n={n} natural={natural}")



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


# ------------------------------------------------------------ phase 4

def phase_times(ctx, cts, fs_pack, ks_pack, per_op, counts, errs, rot) -> list:
    from repro_torch.fhe import linalg
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
            None, tuple(x_f.shape), 2 * x_f.numel() * w + 2 * t1["tw"].numel() * w + kp1 * w),
        "ntt_inv_banks": (
            lambda: ntt_kernel.ntt_inv_banks(x_i, *iw1, negacyclic=False,
                                             lazy=True, reduce_out=False),
            lambda: ref.ntt_inv_banks_ref(x_i, *iw1, False, lazy=True,
                                          reduce_out=False),
            None, tuple(x_i.shape), 2 * x_i.numel() * w + 2 * iw1[3].numel() * w + 3 * k * w),
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
    out = []
    for name, (kern, plain, library, shape, nbytes) in cases.items():
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
                    "library_ms": library_ms, "shape": list(shape),
                    "eager_ms": wrapper_ms, "launches_by_path": by_path})
    log("[times] library: index_select / gather at the kernel's shape for the "
        "three gathers; none for the NTT banks, the Shoup weight-row multiply "
        "and the Barrett digit MAC, which no single PyTorch call computes")
    for what, n_launch in per_op.items():
        log(f"[times] launches per {what}: {n_launch}")

    a, b = cts[0], cts[1]
    rhs = [cts[(i + 1) % BATCH] for i in range(BATCH)]
    rctx, M = rot["ctx"], rot["M"]
    rcts = rot["cts"]
    # (label, request, key switches it pays)
    requests = [
        ("multiply + rescale, B=1", lambda: ctx.rescale(ctx.multiply(a, b)), 1),
        (f"multiply + rescale, B={BATCH}",
         lambda: ctx.rescale_many(ctx.multiply_many(cts[:BATCH], rhs)), BATCH),
        ("rotate, B=1", lambda: rctx.rotate(rcts[0], 1), 1),
        (f"rotate_many, B={BATCH}", lambda: rctx.rotate_many(rcts[:BATCH], ROT_AMOUNTS),
         BATCH),
        (f"rotate_hoisted, R={BATCH}", lambda: rctx.rotate_hoisted(rcts[0], ROT_AMOUNTS),
         BATCH),
        (f"matvec {MV_DIM}x{MV_DIM}", lambda: linalg.matvec(rctx.plan(), M, rcts[-1]),
         len(M.baby_set) - 1 + len(M.giant_set)),
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
    # profiled after every latency is taken: a profiler session leaves
    # per-launch overhead behind that would slow later timings
    for label, req, _ in requests:
        if label.startswith(("multiply", "rotate, ", "matvec")):
            profile_request(req, latency[label], label)
    return out


def profile_request(req, lat_ms: float, label: str) -> None:
    """Where one request's time goes: the device kernels of one warm
    request under torch.profiler, their busy time against the request's
    measured latency, split into the port's kernels and the PyTorch glue
    between them."""
    from torch.profiler import ProfilerActivity, profile
    req()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        req()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log(f"[trace] {label}: the profiler recorded no device kernels; "
            "device busy share not measured")
        return
    ours = [e for e in kern if any(f in e.name for f in DEVICE_FUNCTIONS)]
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
    per_op = {"multiply + rescale": {k: v for k, v in per_op.items() if v},
              **rot_per_op}
    kernels = phase_times(ctx, cts, fs_pack, ks_pack, per_op,
                          {"multiply": counts, "rotation": rcounts}, errs,
                          {"ctx": rctx, "M": M, "cts": rcts})
    log(f"[done] {time.perf_counter() - t_start:.1f} s, slot error "
        f"{slot_err:.3e} (multiply path), {rot_err:.3e} (rotation path)")
    log(f"[gpu] {gpu_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
