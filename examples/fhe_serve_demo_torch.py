"""fhe-serve on the PyTorch port: continuous-batching CKKS request
serving over one prepared EvalPlan.

The paper's throughput claim (Table I: 1.63M key-switch ops/s) assumes
the pipeline is kept saturated with back-to-back work.  This demo
drives ``fhe.serve.CkksServeEngine`` two ways:

 1. **Saturated drain, async vs sync.**  A mixed request trace —
    multiplies, rotations with different amounts, conjugations from
    several "clients" — runs through the double-buffered ``run_async``
    drain and through the synchronous ``run`` oracle.  Every answer is
    checked bit-exact between the two drains and against the single-op
    path.

 2. **Poisson arrivals, SLO view.**  The same engine replays a seeded
    ``synthetic_trace`` with Poisson inter-arrival times at a loaded
    operating point and reports per-request latency percentiles
    (arrival -> answer drained).

On the card the plan runs each batched program as a CUDA graph captured
by ``prepare`` (``fresh_traces`` stays 0) on the banks kernels.  Runs on
the card unless ``--device`` names another device.

Run:  PYTHONPATH=src python examples/fhe_serve_demo_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.fhe.ckks import CkksContext
from repro_torch.fhe.serve import CkksServeEngine, FheRequest, synthetic_trace


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_trace(ctx, rng, n_clients=24):
    """A mixed op trace: each client encrypts a vector and asks for one
    op; rotation amounts deliberately vary so the Galois group exercises
    the mixed-automorphism batch."""
    reqs, oracle = [], {}
    for rid in range(n_clients):
        z = rng.uniform(-1, 1, ctx.slots) + 1j * rng.uniform(-1, 1, ctx.slots)
        ct = ctx.encrypt(ctx.encode(z))
        kind = ("multiply", "rotate", "conjugate", "rotate")[rid % 4]
        if kind == "multiply":
            z2 = rng.uniform(-1, 1, ctx.slots) + 1j * rng.uniform(-1, 1, ctx.slots)
            reqs.append(FheRequest(rid, "multiply", ct, other=ctx.encrypt(ctx.encode(z2))))
            oracle[rid] = z * z2
        elif kind == "rotate":
            r = int(rng.integers(0, 6))             # mixes amounts, incl. identity
            reqs.append(FheRequest(rid, "rotate", ct, r=r))
            oracle[rid] = np.roll(z, -r)
        else:
            reqs.append(FheRequest(rid, "conjugate", ct))
            oracle[rid] = np.conj(z)
    return reqs, oracle


def same(a, b) -> bool:
    return torch.equal(a.c0.data, b.c0.data) and torch.equal(a.c1.data, b.c1.data)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    ctx = CkksContext(n=1024, levels=2, scale_bits=28, seed=17, device=dev)
    # batch_sizes pins the *_many programs at every padded batch size the
    # engine can produce, so no request group pays a capture in its
    # latency window (engine.stats['fresh_traces'] stays 0)
    tile = 8
    plan = ctx.plan().prepare(rotations=range(1, 6), conjugate=True,
                              batch_sizes=(tile, 2 * tile, 3 * tile, 4 * tile))
    engine = CkksServeEngine(plan, batch_tile=tile)

    reqs, oracle = make_trace(ctx, rng)
    engine.run(list(reqs))        # settle caches so the timed paths are warm
    engine.run_async(list(reqs))

    # --- saturated drain: ping-pong vs synchronous oracle -------------
    t0 = time.perf_counter()
    answers = engine.run_async(list(reqs))
    async_s = time.perf_counter() - t0
    s = engine.stats
    print(f"async drain: {len(reqs)} requests -> {s['dispatches']} dispatches "
          f"({s['identity']} identity short-circuits, {s['padded']} pad rows, "
          f"{s['fresh_traces']} fresh traces)")
    for key, cnt in sorted(s["groups"].items()):
        print(f"  group {key}: {cnt} ops in one dispatch")

    t0 = time.perf_counter()
    sync_answers = engine.run(list(reqs))
    sync_s = time.perf_counter() - t0

    # single-op replay: same ops, one dispatch per request
    t0 = time.perf_counter()
    singles = {}
    for req in reqs:
        if req.op == "multiply":
            singles[req.rid] = plan.multiply(req.ct, req.other)
        elif req.op == "rotate":
            singles[req.rid] = plan.rotate(req.ct, req.r)
        else:
            singles[req.rid] = plan.conjugate(req.ct)
    sync(dev)
    single_s = time.perf_counter() - t0

    exact = all(same(answers[r], singles[r]) and same(answers[r], sync_answers[r])
                for r in singles)
    err = max(float(np.max(np.abs(ctx.decrypt_decode(answers[req.rid]) - oracle[req.rid])))
              for req in reqs)
    print(f"async: {async_s * 1e3:.1f} ms  sync: {sync_s * 1e3:.1f} ms  "
          f"single-op: {single_s * 1e3:.1f} ms")
    print(f"bit-exact (async == sync == single-op): {'OK' if exact else 'FAIL'};"
          f" max slot error vs plaintext oracle: {err:.2e}")

    # --- Poisson arrivals: the SLO view -------------------------------
    n_req = 32
    rate = 0.7 * len(reqs) / max(async_s, 1e-9)   # ~70% of drain capacity
    preqs, arrivals = synthetic_trace(ctx, n_req, seed=5, rate=rate)
    engine.run_async(list(preqs), arrivals)       # warm arrival-path keys
    engine.run_async(preqs, arrivals)
    lat = engine.stats["latency_us"]
    print(f"poisson @ {rate:.0f} req/s: p50={lat['p50'] / 1e3:.1f} ms  "
          f"p99={lat['p99'] / 1e3:.1f} ms  mean={lat['mean'] / 1e3:.1f} ms "
          f"over {lat['count']} requests "
          f"(max queue depth {engine.stats['max_queue']}, "
          f"{len(engine.stats['failed'])} failed)")
    return {"exact": exact, "err": err, "fresh_traces": s["fresh_traces"],
            "latency": lat, "failed": len(engine.stats["failed"])}


if __name__ == "__main__":
    main()
