#!/usr/bin/env python3
"""Time the NTT transforms of one checkout of the port on the card.

    python3 tools/time_ntt_banks.py [--src DIR] [--label NAME] [--only TEXT ...]

DIR is the ``src`` directory of a checkout (default: this repository's),
so two trees can be timed in one machine call, in turns (A, B, B, A),
on one card: each builds its own kernels under its own ``build/``.
Cases: the u32 banks at the CKKS multiply's table shapes (B = 8) and at
a B = 1 request's (the B = 8 forward also with 0, 2 and 4 of its 7
stages, and one device copy of its words), the u16 banks at ML-KEM's b = 256 and b = 1 shapes,
the u32 banks at (3, 13, n) for n = 2^13 .. 2^17 (where the tree takes
n), and the single-prime ``ntt_fwd`` / ``ntt_inv`` at every shape of the
NTT-128 traffic: (10^5, 128) (and one device copy of its words), the
products' (512, 4096), (64, 4096) and (64, 1024), and (13 or 132, 8192 or
16384), each also through the k = 1 banks launchers (``single_prime_bank``)
up to 4096 words.  ``--only`` keeps the cases whose name contains one of
the texts.
Each time is the device time of one call: 10 calls captured in a CUDA
graph, the graph replayed 25 times between CUDA events, the median of
the per-call mean.  Prints one JSON line with the card's name and power
limit.  Imports torch, numpy and the checkout's ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def graph_ms(fn, reps=25, inner=10) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--only", action="append", default=[],
                    help="time only the cases whose name contains this text")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_ntt_banks: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.params import make_ntt_params
    from repro_torch.core.ringspec import MLKEM_RING, ring_table_pack
    from repro_torch.convert import from_reference
    from repro_torch.fhe import batched as FB
    from repro_torch.fhe import rns
    from repro_torch.kernels import ntt_kernel

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)

    def rows(qs, shape, dtype=np.int32):
        return torch.from_numpy(np.stack([rng.integers(0, int(q), shape) for q in qs])
                                .astype(dtype)).to(dev)

    def fwd(x, t, **kw):
        return lambda: ntt_kernel.ntt_fwd_banks(x, t["qs"], t["tw"], t["twp"], t["psi"],
                                                t["psip"], **kw)

    def inv(x, t, **kw):
        return lambda: ntt_kernel.ntt_inv_banks(x, t["qs"], t["ninv"], t["ninv_p"], t["itw"],
                                                t["itwp"], t["ipsin"], t["ipsinp"], **kw)

    n14 = 1 << 14
    primes = rns.make_primes(n14, 9)
    fs = rns.fourstep_basis_pack(tuple(primes), n14, dev)
    t1 = fs["pack1"]
    t1k = {k: v[:8] for k, v in t1.items()}
    qs = [int(q) for q in t1["qs"].cpu()]
    lazy = dict(negacyclic=False, lazy=True, reduce_out=False)
    cases = {}
    for b, tag in ((8, "B=8"), (1, "B=1")):
        xf = rows(qs, (8 * b * 128, 128))
        xi = rows(qs[:8], (b * 128, 128))
        cases[f"ntt_fwd_banks {tuple(xf.shape)} {tag}"] = fwd(xf, t1, **lazy)
        cases[f"ntt_inv_banks {tuple(xi.shape)} {tag}"] = inv(xi, t1k, **lazy)
    # the B = 8 forward with its stage tables cut to s rows: s = 0 moves the
    # bytes alone; the slope over s is the stages' own cost.  Beside it one
    # device copy of the same words (PyTorch's copy_), the bytes at the rate
    # this card reaches.
    xf = rows(qs, (8 * 8 * 128, 128))
    for st in (0, 2, 4):
        cut = dict(t1, tw=t1["tw"][:, :st].contiguous(), twp=t1["twp"][:, :st].contiguous())
        cases[f"ntt_fwd_banks {tuple(xf.shape)} B=8, {st} of 7 stages"] = fwd(xf, cut, **lazy)
    dst = torch.empty_like(xf)
    cases[f"copy_ {tuple(xf.shape)} (library)"] = lambda d=dst, src=xf: d.copy_(src)
    r = from_reference(ring_table_pack(MLKEM_RING), dev)
    path = dict(negacyclic=False, lazy=True, reduce_out=True)
    for b in (256, 1):
        xf = rows([MLKEM_RING.q], (6 * b, 256), np.int16)
        xi = rows([MLKEM_RING.q], (3 * b, 256), np.int16)
        cases[f"ntt_fwd_banks_u16 {tuple(xf.shape)} b={b}"] = fwd(xf, r, **path)
        cases[f"ntt_inv_banks_u16 {tuple(xi.shape)} b={b}"] = inv(xi, r, **path)
    for logn in range(13, 18):
        n = 1 << logn
        if n > ntt_kernel.MAX_N:
            continue
        t = FB.build_table_pack(rns.make_primes(n, 3), n, dev)
        x = rows([int(q) for q in t["qs"].cpu()], (13, n))
        neg = dict(negacyclic=True, lazy=True, reduce_out=True)
        cases[f"ntt_fwd_banks {tuple(x.shape)}"] = fwd(x, t, **neg)
        cases[f"ntt_inv_banks {tuple(x.shape)}"] = inv(x, t, **neg)
    # the single-prime transforms at the NTT-128 traffic's shapes: the
    # request's batch (rows 9-10), the products', and rings above 4096 words
    # (one row a block in csrc/ntt.cu before the row stream); each also as
    # a one-prime bank on the banks launchers where it takes one launch
    single = [(100_000, 128, False, "fwd"), (100_000, 128, True, "inv"),
              (100_000, 128, True, "fwd"), (100_000, 128, False, "inv"),
              (512, 4096, True, "fwd"), (64, 4096, True, "inv"), (64, 1024, True, "fwd"),
              (64, 1024, True, "inv")]
    single += [(b, n, True, d) for n in (8192, 16384) for b in (13, 132) for d in ("fwd", "inv")]
    for b, n, neg, d in single:
        p = make_ntt_params(n)
        x = rows([p.q], (b, n))[0]
        kind = "negacyclic" if neg else "cyclic"
        kern = ntt_kernel.ntt_fwd if d == "fwd" else ntt_kernel.ntt_inv
        cases[f"ntt_{d} ({b}, {n}) {kind}"] = (
            lambda x=x, p=p, neg=neg, kern=kern: kern(x, p, negacyclic=neg, lazy=True))
        if n > 4096:
            continue
        t = ntt_kernel.single_prime_bank(p, dev)
        path = dict(negacyclic=neg, lazy=True, reduce_out=True)
        cases[f"ntt_{d} ({b}, {n}) {kind}, k = 1 bank"] = (
            fwd(x[None], t, **path) if d == "fwd" else inv(x[None], t, **path))
    p = make_ntt_params(128)
    x = rows([p.q], (100_000, 128))[0]
    dst = torch.empty_like(x)
    cases["copy_ (100000, 128) (library)"] = lambda d=dst, src=x: d.copy_(src)
    if args.only:
        cases = {k: v for k, v in cases.items() if any(o in k for o in args.only)}
    times = {name: graph_ms(fn) for name, fn in cases.items()}
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "gpu": gpu, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
