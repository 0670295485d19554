#!/usr/bin/env python3
"""Time request latencies of the port on the card, one checkout or two.

    python3 tools/time_requests.py [--src DIR] [--label NAME]
                                   [--against DIR2 --against-label NAME2] [--rounds N]

DIR is the ``src`` directory of a checkout (default: this repository's).
With ``--against``, a second checkout's package is copied under
build/against/ as ``repro_torch_b`` (its own kernels built under
build/against/build/) and both run in one process: every round runs
each request on one tree, then on the other, so a change of the host's
speed lands on both alike, and the tree that goes first alternates from
round to round.  Requests, on the host clock around work that
ends in a device synchronize: CKKS multiply -> rescale at B = 1 and
B = 8 and a rotate by 1 on ``CkksContext(n=2^14, levels=7)``, ML-KEM-768
decaps at b = 1 and b = 256, and the host cost of one eager call of the
u32 banks forward at a B = 1 multiply's pass shape (9, 1024, 128): 200
calls back to back, one synchronize, over 200.  A tree whose EvalPlan
runs its programs as CUDA graphs (``EvalPlan._graphs``) also times the
three CKKS requests on the plan's eager twin (the same tables and keys,
the module-level programs), a 64 x 64 matvec graphed and eager, and the
serving engine (``fhe/serve.py``): ``run_async`` of a 32-request
``synthetic_trace`` as a backlog on a plan prepared for it at two bases
(group sizes 8 .. 32, the matvec pack); a request one tree lacks is
timed on the other alone.  Prints one JSON line: the card's name and
power limit, each tree's median and quartiles per request in ms, and,
with two trees, the median over rounds of the first tree's time over the
second's for the requests both have.  Imports torch, numpy and the
checkouts' packages only.
"""
from __future__ import annotations

import argparse
import copy
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 14
LEVELS = 7
BATCH = 8
MLKEM_B = 256
EAGER_CALLS = 200
SEED = 20250821
MV_DIM = 64
SERVE_N = 32
SERVE_SIZES = (8, 16, 24, 32)


def import_tree(src: str, name: str):
    """The ``repro_torch`` package of the checkout whose src is ``src``,
    imported as ``name`` (copied with its name replaced when it differs)."""
    if name != "repro_torch":
        dst = os.path.join(ROOT, "build", "against", "src")
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(src, "repro_torch"), os.path.join(dst, name),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for base, _, files in os.walk(os.path.join(dst, name)):
            for f in files:
                if f.endswith(".py"):
                    path = os.path.join(base, f)
                    with open(path) as fh:
                        text = fh.read()
                    with open(path, "w") as fh:
                        fh.write(text.replace("repro_torch", name))
        src = dst
    sys.path.insert(0, os.path.abspath(src))
    return lambda mod: importlib.import_module(f"{name}.{mod}")


def requests_of(mod) -> dict:
    """The timed requests on one tree's package, their inputs from SEED."""
    import numpy as np
    import torch
    rns, ckks = mod("fhe.rns"), mod("fhe.ckks")
    ntt_kernel, mlkem = mod("kernels.ntt_kernel"), mod("pq.mlkem")
    mod("kernels.build").build()
    rng = np.random.default_rng(SEED)
    ctx = ckks.CkksContext(n=N, levels=LEVELS, scale_bits=28, seed=SEED, device="cuda")
    ctx.plan().prepare(rotations=(1,))
    zs = [rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
          for _ in range(BATCH)]
    cts = [ctx.encrypt(ctx.encode(z)) for z in zs]
    rhs = [cts[(i + 1) % BATCH] for i in range(BATCH)]
    mk = {}
    for b in (1, MLKEM_B):
        d, z, m = (rng.integers(0, 256, (b, 32), dtype=np.uint8) for _ in range(3))
        ek, dk = mlkem.keygen_batch(d, z)
        mk[b] = (dk, mlkem.encaps_batch(ek, m)[1])
    primes = rns.make_primes(N, LEVELS + 2)
    pack = rns.fourstep_basis_pack(tuple(primes[1:] + primes[:1]), N,
                                   torch.device("cuda"))["pack1"]
    qs = [int(q) for q in pack["qs"].cpu()]
    x = torch.from_numpy(np.stack([rng.integers(0, q, (1024, 128)) for q in qs])
                         .astype(np.int32)).cuda()

    def eager_calls():
        for _ in range(EAGER_CALLS):
            ntt_kernel.ntt_fwd_banks(x, pack["qs"], pack["tw"], pack["twp"], pack["psi"],
                                     pack["psip"], negacyclic=False, lazy=True,
                                     reduce_out=False)

    plan = ctx.plan()
    reqs = {
        "multiply + rescale, B=1": lambda: plan.rescale(plan.multiply(cts[0], cts[1])),
        f"multiply + rescale, B={BATCH}": lambda: plan.rescale_many(
            plan.multiply_many(cts, rhs)),
        "rotate, B=1": lambda: plan.rotate(cts[0], 1),
        "decaps, b=1": lambda: mlkem.decaps_batch(*mk[1]),
        f"decaps, b={MLKEM_B}": lambda: mlkem.decaps_batch(*mk[MLKEM_B]),
        f"banks forward eager call (9, 1024, 128), per call of {EAGER_CALLS}": eager_calls,
    }
    if getattr(plan, "_graphs", None) is not None:
        reqs.update(graph_requests(mod, plan, cts, rhs, rng))
    return reqs


def graph_requests(mod, plan, cts, rhs, rng) -> dict:
    """The CKKS requests on the plan's eager twin, a matvec graphed and
    eager, and a serve drain, on a tree whose plans run CUDA graphs."""
    ckks, linalg, serve = mod("fhe.ckks"), mod("fhe.linalg"), mod("fhe.serve")
    eager = copy.copy(plan)
    eager._graphs = None
    sctx = ckks.CkksContext(n=N, levels=LEVELS, scale_bits=28, seed=SEED + 1, device="cuda")
    M = linalg.PtMatrix.encode(sctx, rng.uniform(-1, 1, (MV_DIM, MV_DIM)) / 8)
    splan = sctx.plan()
    for basis, mvs in ((sctx.qs, (M,)), (sctx.qs[:-1], ())):
        splan.prepare(basis=basis, rotations=(1,), conjugate=True,
                      batch_sizes=SERVE_SIZES, matvecs=mvs)
    trace, _ = serve.synthetic_trace(sctx, SERVE_N, seed=SEED, matrix=M)
    for req in trace:
        if req.op == "rotate" and req.r % sctx.slots:
            splan.galois_key(splan.rotation_group_element(req.r), req.ct.primes)
    engine = serve.CkksServeEngine(splan, batch_tile=8)
    v = sctx.encrypt(linalg.encode_vector(sctx, rng.uniform(-1, 1, MV_DIM), MV_DIM))
    seager = copy.copy(splan)
    seager._graphs = None
    return {
        "multiply + rescale, B=1, eager": lambda: eager.rescale(eager.multiply(cts[0], cts[1])),
        f"multiply + rescale, B={BATCH}, eager": lambda: eager.rescale_many(
            eager.multiply_many(cts, rhs)),
        "rotate, B=1, eager": lambda: eager.rotate(cts[0], 1),
        f"matvec {MV_DIM}x{MV_DIM}": lambda: linalg.matvec(splan, M, v),
        f"matvec {MV_DIM}x{MV_DIM}, eager": lambda: linalg.matvec(seager, M, v),
        f"serve run_async, {SERVE_N} requests (backlog)": lambda: engine.run_async(trace),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--against", default=None)
    ap.add_argument("--against-label", default="other tree")
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_requests: no CUDA device", file=sys.stderr)
        return 1
    trees = {args.label: requests_of(import_tree(args.src, "repro_torch"))}
    if args.against:
        trees[args.against_label] = requests_of(import_tree(args.against, "repro_torch_b"))
    labels = list(dict.fromkeys(label for reqs in trees.values() for label in reqs))
    for reqs in trees.values():
        for fn in reqs.values():
            fn()
    torch.cuda.synchronize()
    times = {tree: {label: [] for label in reqs} for tree, reqs in trees.items()}
    order = list(trees)
    for _ in range(args.rounds):
        order.reverse()             # each tree goes first in every other round
        for label in labels:
            for tree in order:
                reqs = trees[tree]
                if label not in reqs:
                    continue
                t0 = time.perf_counter()
                reqs[label]()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                per_call = label.startswith("banks forward")
                times[tree][label].append(ms / EAGER_CALLS if per_call else ms)
    out = {"gpu": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True, check=True).stdout.strip().splitlines()[0]}
    for tree, per in times.items():
        out[tree] = {}
        for label, t in per.items():
            q1, _, q3 = statistics.quantiles(t, n=4)
            out[tree][label] = {"median": statistics.median(t), "q1": q1, "q3": q3}
    if args.against:
        a, b = times[args.label], times[args.against_label]
        out[f"{args.label} / {args.against_label}"] = {
            label: statistics.median(x / y for x, y in zip(a[label], b[label]))
            for label in labels if label in a and label in b}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
