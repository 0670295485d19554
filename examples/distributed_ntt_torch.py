"""The paper's §IX scale-out on the PyTorch port, both software forms:

1. the *local* large-N path — a 2^14-point NTT over an RNS basis
   composed from 128x128 four-step passes on the fused multi-prime
   banks kernels (``kernels.ops.ntt_fourstep_banks``; the same dispatch
   ``RnsPoly``/key-switch use for every ring with N >= 2^13), and
2. the *sharded* path — the scheme-level scale-out through
   ``EvalPlan(mesh=...)``: the batch axis of a 2^10-ring ciphertext
   multiply sharded over 1/2/4/8 shards of one device
   (``make_mesh([device] * d)``), each count verified bit-exact against
   the single-device program and reported as a scaling table (devices /
   wall / throughput / speedup / efficiency).

The shards of a mesh over one device take turns on it, so no count can
gain; the table shows what the split costs there.  Runs on the card
unless ``--device`` names another device.

Run:  PYTHONPATH=src python examples/distributed_ntt_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.convert import resolve_device, tensor_to_u32, u32_to_tensor
from repro_torch.core import fourstep as fs
from repro_torch.core.params import fourstep_split, gen_ntt_primes
from repro_torch.fhe import batched as FB
from repro_torch.kernels import ops
from repro_torch.mesh import make_mesh


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def demo_large_n_banks(dev) -> bool:
    n, k = 1 << 14, 2
    n1, n2 = fourstep_split(n)
    primes = gen_ntt_primes(k, n, bits=30)
    fp = FB.build_fourstep_pack(primes, n, dev)
    rng = np.random.default_rng(0)
    x_np = np.stack([rng.integers(0, q, n, dtype=np.uint32) for q in primes])
    x = u32_to_tensor(x_np, dev)
    y = ops.ntt_fourstep_banks(x, fp)          # two kernel passes on the card
    back = tensor_to_u32(ops.intt_fourstep_banks(y, fp))
    ok = bool(np.array_equal(back, x_np))
    print(f"large-N banks four-step: n={n} = {n1}x{n2}, k={k} primes -> "
          f"roundtrip {'MATCH' if ok else 'MISMATCH'}")
    sched = fs.fourstep_schedule(n1, n2)
    print(f"  schedule: {sched['passes']} passes of "
          f"{sched['transforms_per_pass'][0]} NTT-{sched['transform_sizes'][0]} "
          f"unit transforms + 1 reorder (paper §IX: ~482 ns at 34 GHz)")
    assert ok
    return ok


def demo_sharded_evalplan(dev) -> list:
    """Batch-sharded CKKS multiply through ``EvalPlan(mesh=d x "b")``
    per shard count, in the ntt-aie efficiency-table shape."""
    from repro_torch.fhe.ckks import CkksContext
    from repro_torch.fhe.evalplan import EvalPlan

    ctx = CkksContext(n=1024, levels=2, seed=23, device=dev)
    B = 16
    rng = np.random.default_rng(5)

    def enc():
        z = rng.uniform(-1, 1, ctx.slots) + 1j * rng.uniform(-1, 1, ctx.slots)
        return ctx.encrypt(ctx.encode(z))

    cts = [enc() for _ in range(B)]
    bts = [enc() for _ in range(B)]
    counts = (1, 2, 4, 8)

    def run(plan):
        out = plan.multiply_many(cts, bts)
        sync(dev)
        return out

    print(f"sharded EvalPlan ckks multiply: n={ctx.n} B={B} over "
          f"shards of one device ({dev}) (mesh axis 'b')")
    print(f"{'devices':>8} {'time_us':>10} {'mul/s':>8} "
          f"{'speedup':>8} {'efficiency':>11} {'exact':>6}")
    ref, t1, rows = None, None, []
    for d in counts:
        plan = ctx.plan() if d == 1 else EvalPlan(ctx, mesh=make_mesh([dev] * d))
        out = run(plan)                              # capture + warm
        if ref is None:
            ref = out
        ok = all(torch.equal(a.c0.data, b.c0.data) and torch.equal(a.c1.data, b.c1.data)
                 for a, b in zip(ref, out))
        t0 = time.perf_counter()
        for _ in range(3):
            run(plan)
        us = (time.perf_counter() - t0) / 3 * 1e6
        if t1 is None:
            t1 = us
        print(f"{d:>8} {us:>10.0f} {B / (us / 1e6):>8.0f} "
              f"x{t1 / us:>7.2f} {t1 / (us * d) * 100:>10.0f}% "
              f"{'OK' if ok else 'FAIL':>6}")
        rows.append((d, us, ok))
        assert ok
    print("(the shards of a mesh over one device take turns on it: no count "
          "can gain, and the table shows what the split costs)")
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    dev = resolve_device(ap.parse_args(argv).device)
    return {"roundtrip": demo_large_n_banks(dev), "table": demo_sharded_evalplan(dev)}


if __name__ == "__main__":
    main()
