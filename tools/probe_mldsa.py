#!/usr/bin/env python3
"""Probe ML-DSA-65 signing (``pq/mldsa.py``) at the ``mldsa65-tls-sign``
cell's shapes.

    python3 tools/probe_mldsa.py [--slots S]          # kernel times (card)
    python3 tools/probe_mldsa.py --sweep S1 S2 ...    # slot-count sweep (card)

Kernel times: every kernel of a round (and keygen's samplers at b = 1) at
S slots (default 65,536) on random operands of the path's shapes and
layouts, CUDA events around 10 eager calls, the median of 15, beside the
kernel's bound (the larger of its bytes, each input read once and each
output written once, at 3.35 TB/s and its INT32 instructions on 132 x 64
lanes at 1980 MHz; a Keccak-f[1600] is 4320) and, where it fits, one call
of its plain version on the card at 4,096 rows.

Sweep: the cell's run (``bench/benchlib/systems/mldsa_stream.py``) at each
slot count: set-up, a 5 s window, the rate, the round time, slot- and
row-iterations a signature and the peak memory.

The cell's control runs through the benchmark's own tool:
``bench/tools/control.py --workload mldsa65-tls-sign``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import torch  # noqa: E402

BW, INT, PERM = 3.35e12, 132 * 64 * 1.98e9, 4320
Q = 8380417


def timed(fn, reps=10, rounds=15):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def once(fn):
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def kernel_times(S: int) -> None:
    from repro_torch.convert import from_reference
    from repro_torch.core.ringspec import MLDSA_RING, ring_table_pack
    from repro_torch.kernels import keccak_kernel, mldsa_kernel, ops, ref
    from repro_torch.pq import mldsa
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    rows = lambda *shape: torch.randint(0, Q, shape, generator=g, device=dev, dtype=torch.int32)
    byt = lambda *shape: torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    t = from_reference(ring_table_pack(MLDSA_RING), dev)
    rho, mu, w1, ct = byt(S, 64), byt(S, 64), byt(S, 768), byt(S, 48)
    kappa = torch.randint(0, 2000, (S,), generator=g, device=dev, dtype=torch.int32)
    y, w, cs = rows(S, 5, 256), rows(6, S, 256), rows(17, S, 256)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    acc = torch.rand(S, generator=g, device=dev) < 0.195        # FIPS 204's accept rate
    R = 2 * S
    dest = torch.where(acc, torch.cumsum(acc, 0) - 1, R)
    ring = byt(R + 1, 3309)
    rid = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    rit = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    msg, rnd, tr, key = byt(1 << 20, 132), byt(1 << 20, 32), byt(64), byt(32)
    refills = int(acc.sum())
    slots, count = torch.randperm(S, device=dev), torch.tensor([refills], device=dev)
    reqs = torch.randint(0, 1 << 20, (S,), generator=g, device=dev)
    mu_o, rho_o = byt(S + 1, 64), byt(S + 1, 64)
    x = {r: rows(1, r * S, 256) for r in (1, 5, 6, 17)}
    a_mac, s17, seed = rows(5, 6, 256), rows(1, 17, 256), byt(1, 128)
    pack = {k: {"qs": torch.full((k,), Q, dtype=torch.int32, device=dev),
                "mu": torch.full((k,), mldsa.MU, dtype=torch.int32, device=dev)} for k in (6, 17)}
    ext5 = y.transpose(0, 1)[:, None].expand(5, 6, S, 256)
    ext1 = x[1].reshape(S, 256)[None, None].expand(1, 17, S, 256)
    ntt_ops = lambda r, fwd: r * S * (128 * 8 * 8 + 256 * (1 if fwd else 4))
    ntt_bytes = lambda r: 2 * r * S * 1024
    p = 4096
    cases = {
        "keccak_expand_mask": (lambda: keccak_kernel.expand_mask(rho, kappa),
                               S * 5 * 1024, S * 25 * PERM,
                               lambda: ref.expand_mask_ref(rho[:p], kappa[:p])),
        "keccak_hash c-tilde": (lambda: keccak_kernel.keccak_hash(
            mu, w1, rate=136, suffix=0x1F, out_len=48), S * 880, S * 7 * PERM, None),
        "keccak_sample_in_ball": (lambda: keccak_kernel.sample_in_ball(ct), S * 1072, S * PERM,
                                  lambda: ref.sample_in_ball_ref(ct[:p])),
        f"keccak_mu_rho ({refills} refills)": (
            lambda: keccak_kernel.mu_rho(tr, key, msg, rnd, slots, reqs, count, mu_o, rho_o),
            refills * 292, refills * 3 * PERM, None),
        "keccak_rej_ntt_poly b = 1": (lambda: keccak_kernel.rej_ntt_poly(seed[:, :32]),
                                      30 * 1024, 30 * 5 * PERM,
                                      lambda: ref.rej_ntt_poly_ref(seed[:, :32])),
        "keccak_rej_bounded b = 1 x 11": (
            lambda: keccak_kernel.rej_bounded(seed[:, 32:96], n0=0, count=11), 11 * 1024,
            11 * 2 * PERM, lambda: ref.rej_bounded_ref(seed[:, 32:96], 0, 11)),
        "mldsa_w1_encode": (lambda: mldsa_kernel.w1_encode(w), S * (6 * 1024 + 768), 0,
                            lambda: ref.w1_encode_ref(w[:, :p].contiguous())),
        "mldsa_check": (lambda: mldsa_kernel.sign_check(y, w, cs, active), S * (28 * 1024 + 2),
                        0, None),
        "mldsa_emit": (lambda: mldsa_kernel.sign_emit(ct, y, w, cs, dest, kappa.long(), kappa,
                                                      ring, rid, rit),
                       S * 8 + refills * (28 * 1024 + 48 + 3309 + 12), 0, None),
        "ntt_fwd_banks (1, 5S, 256)": (lambda: ops.ntt_banks(x[5], t, negacyclic=False),
                                       ntt_bytes(5), ntt_ops(5, True), None),
        "ntt_fwd_banks (1, S, 256)": (lambda: ops.ntt_banks(x[1], t, negacyclic=False),
                                      ntt_bytes(1), ntt_ops(1, True), None),
        "ntt_inv_banks (1, 6S, 256)": (lambda: ops.intt_banks(x[6], t, negacyclic=False),
                                       ntt_bytes(6), ntt_ops(6, False), None),
        "ntt_inv_banks (1, 17S, 256)": (lambda: ops.intt_banks(x[17], t, negacyclic=False),
                                        ntt_bytes(17), ntt_ops(17, False), None),
        "dyadic_inner_banks A y": (lambda: ops.dyadic_inner_banks(
            ext5, a_mac, pack[6], bits=23), S * 11 * 1024, 0, None),
        "dyadic_inner_banks c s": (lambda: ops.dyadic_inner_banks(
            ext1, s17, pack[17], bits=23), S * 18 * 1024, 0, None),
    }
    for name, (fn, nbytes, int_ops, plain) in cases.items():
        ms = timed(fn)
        bound = 1e3 * max(nbytes / BW, int_ops / INT)
        print(json.dumps({"kernel": name, "slots": S, "ms": ms, "bound_ms": bound,
                          "by": "bytes" if nbytes / BW >= int_ops / INT else "operations",
                          "plain_ms": once(plain) if plain else None}), flush=True)


def sweep(seed: int, counts) -> None:
    from benchlib import spec
    from benchlib.systems import mldsa_stream
    for slots in counts:
        cell = spec.load("mldsa65-tls-sign", ROOT)
        cell.traffic = dict(cell.traffic, slots=slots)
        torch.cuda.reset_peak_memory_stats()
        run = mldsa_stream.Run(cell, seed + slots, "cuda")
        t0 = time.perf_counter()
        run.setup()
        setup_s = time.perf_counter() - t0
        win = run.window(5.0)
        c = win["counters"]
        print(json.dumps({"slots": slots, "setup_s": setup_s,
                          "requests_per_s": win["metrics"]["requests_per_s"],
                          "round_ms": 1e3 * win["window_s"] / c["rounds"],
                          "slot_iterations_per_signature": c["slot_iterations"] / c["signatures"],
                          "iterations_per_signature": c["row_iterations"] / c["signatures"],
                          "peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)
        del run
        torch.cuda.empty_cache()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--slots", type=int, default=65536)
    p.add_argument("--sweep", type=int, nargs="+")
    p.add_argument("--seed", type=int, default=3100000007)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_mldsa: the kernel times and the sweep run on the card")
    if args.sweep:
        sweep(args.seed, args.sweep)
    else:
        kernel_times(args.slots)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout)


if __name__ == "__main__":
    main()
