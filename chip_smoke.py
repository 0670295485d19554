#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and run its main path on one GPU.

    python3 chip_smoke.py

Phases (any mismatch raises, so the exit code is non-zero):
  1. build   compile every kernel from src/repro_torch/csrc (one nvcc per
             source, in parallel) and print the card's name and power limit
  2. kernels hold each kernel against its plain PyTorch version on the
             card, at the shapes of the CKKS multiply -> rescale path at
             n = 2^14 with 8 + 1 primes; results must be bit-identical
  3. slice   CkksContext(n=2^14, levels=7) on the card: encrypt 8 slot
             vectors, answer 4 single multiply -> rescale requests and one
             multiply_many -> rescale_many batch of 8, decrypt_decode every
             answer.  Checks the slot error against the numpy product, that
             the same requests on device="cpu" give bit-identical residue
             stacks, and that every kernel launched and no plain version
             ran during the card's run
  4. times   per kernel (CUDA events around a CUDA-graph replay, so the
             device time) beside its memory bound and its plain version;
             the multiply + rescale latency at B = 1 and B = 8, and a
             torch.profiler breakdown of one request's device time

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

REPLACES = {
    "ntt_fwd_banks": "src/repro/kernels/ntt_kernel.py:306",
    "ntt_inv_banks": "src/repro/kernels/ntt_kernel.py:320",
    "twiddle_mul_banks": "src/repro/kernels/ntt_kernel.py:346",
    "dyadic_inner_banks": "src/repro/kernels/dyadic_kernel.py:175",
}
SOURCE = {
    "ntt_fwd_banks": "src/repro_torch/csrc/ntt_banks.cu",
    "ntt_inv_banks": "src/repro_torch/csrc/ntt_banks.cu",
    "twiddle_mul_banks": "src/repro_torch/csrc/ntt_banks.cu",
    "dyadic_inner_banks": "src/repro_torch/csrc/dyadic_inner.cu",
}


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


def host_ms(fn, reps=20) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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
    for name, e in err.items():
        log(f"[kernels] {name}: bit-identical to its plain version (max abs err {e})")
    return err


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
    for name, c in counts.items():
        if c["launches"] == 0:
            raise AssertionError(f"{name}: kernel never launched on the main path")
        if c["plain_calls"] != 0:
            raise AssertionError(f"{name}: plain version ran {c['plain_calls']} "
                                 "times on the cuda path")
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


def phase_cpu_parity(zs, cuda_cts, cuda_answers) -> None:
    from repro_torch.fhe.ckks import CkksContext
    t0 = time.perf_counter()
    ctx = CkksContext(n=N, levels=LEVELS, scale_bits=28, seed=SEED, device="cpu")
    ctx.plan().prepare()
    cts, answers, _, _ = run_requests(ctx, zs)
    for what, a_list, b_list in (("ciphertext", cuda_cts, cts),
                                 ("answer", cuda_answers, answers)):
        for i, (a, b) in enumerate(zip(a_list, b_list)):
            if not (torch.equal(a.c0.data.cpu(), b.c0.data)
                    and torch.equal(a.c1.data.cpu(), b.c1.data)
                    and a.scale == b.scale and a.primes == b.primes):
                raise AssertionError(f"{what} {i}: cuda run != cpu run")
    log(f"[parity] cuda == cpu bit for bit: {len(cts)} ciphertexts, "
        f"{len(answers)} answers ({time.perf_counter() - t0:.1f} s on the CPU)")


# ------------------------------------------------------------ phase 4

def phase_times(ctx, cts, fs_pack, ks_pack, per_op, counts, errs) -> list:
    from repro_torch.kernels import dyadic_kernel, ntt_kernel, ref
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
            tuple(x_f.shape), 2 * x_f.numel() * w + 2 * t1["tw"].numel() * w + kp1 * w),
        "ntt_inv_banks": (
            lambda: ntt_kernel.ntt_inv_banks(x_i, *iw1, negacyclic=False,
                                             lazy=True, reduce_out=False),
            lambda: ref.ntt_inv_banks_ref(x_i, *iw1, False, lazy=True,
                                          reduce_out=False),
            tuple(x_i.shape), 2 * x_i.numel() * w + 2 * iw1[3].numel() * w + 3 * k * w),
        "twiddle_mul_banks": (
            lambda: ntt_kernel.twiddle_mul_banks(x_t, *tw, lazy=True),
            lambda: ref.twiddle_mul_banks_ref(x_t, *tw, lazy=True),
            tuple(x_t.shape), 2 * x_t.numel() * w + 2 * fs_pack["tw"].numel() * w + kp1 * w),
        "dyadic_inner_banks": (
            lambda: dyadic_kernel.dyadic_inner_banks(ext, evk, *dk, lazy=True),
            lambda: ref.dyadic_inner_banks_ref(ext, evk, *dk, lazy=True),
            tuple(ext.shape), (ext.numel() + evk.numel() + ext[0].numel()) * w + 2 * kp1 * w),
    }
    out = []
    for name, (kern, plain, shape, nbytes) in cases.items():
        ms = graph_ms(kern)
        plain_ms = graph_ms(plain, inner=1)
        wrapper_ms = eager_ms(kern)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[times] {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({nbytes} bytes), eager call "
            f"{wrapper_ms:.4f} ms, {per_op[name]} launches per multiply + rescale")
        out.append({"name": name, "route": "cuda", "source": SOURCE[name],
                    "replaces": REPLACES[name], "launches": counts[name]["launches"],
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes",
                    "library_ms": None, "shape": list(shape),
                    "eager_ms": wrapper_ms})
    log("[times] library_ms is null for every kernel: no single PyTorch call "
        "computes a multi-prime NTT bank, a Shoup weight-row multiply or the "
        "Barrett digit MAC")

    a, b = cts[0], cts[1]
    rhs = [cts[(i + 1) % BATCH] for i in range(BATCH)]
    requests = {1: lambda: ctx.rescale(ctx.multiply(a, b)),
                BATCH: lambda: ctx.rescale_many(ctx.multiply_many(cts[:BATCH], rhs))}
    latency = {bsz: host_ms(req) for bsz, req in requests.items()}
    for bsz, lat in latency.items():
        log(f"[times] multiply + rescale at B={bsz}: {lat:.3f} ms, "
            f"{bsz * 1e3 / lat:.1f} key switches per second")
    # profiled after every latency is taken: a profiler session leaves
    # per-launch overhead behind that would slow later timings
    for bsz, req in requests.items():
        profile_request(req, latency[bsz], bsz)
    return out


def profile_request(req, lat_ms: float, bsz: int) -> None:
    """Where one request's time goes: the device kernels of one warm
    request under torch.profiler, their busy time against the request's
    measured latency, split into the port's four kernels and the PyTorch
    glue between them."""
    from torch.profiler import ProfilerActivity, profile
    req()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        req()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log(f"[trace] B={bsz}: the profiler recorded no device kernels; "
            "device busy share not measured")
        return
    ours = [e for e in kern if "_banks_kernel" in e.name]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    mine = sum(e.time_range.elapsed_us() for e in ours) / 1e3
    log(f"[trace] B={bsz}: {len(kern)} device kernels ({len(ours)} of the port's "
        f"four), busy {busy:.3f} ms of {lat_ms:.3f} ms "
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
    kernels = phase_times(ctx, cts, fs_pack, ks_pack, per_op, counts, errs)
    log(f"[done] {time.perf_counter() - t_start:.1f} s, slot error {slot_err:.3e}")
    log(f"[gpu] {gpu_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
