"""Faults planted in the program under a cell's run, each of which the
check must catch (``correct`` false):

  unchanged  a step returns its state unchanged (each key switch,
             product, rescale and NTT hands back its input)
  half       half of each batch left out (a group dispatched, or an NTT
             batch transformed, for its first half only)
  altered    an answer altered where it is produced: one word of the
             last answer of each group (its highest slot), of each
             matvec, and of every NTT row

No cell crosses chips, so there is no exchange to leave out.  The CPU
tests plant them under tiny twins of the cells; on the card, at a
cell's own size, run

    python3 bench/tools/faults.py --workload fig22-keyswitch --seeds 1 2 \\
        --seconds 3

which prints one JSON line per fault and seed with the compared numbers.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def bump(ct):
    """The ciphertext with one word changed."""
    from repro_torch.fhe.evalplan import Ciphertext
    c0 = ct.c0.data.clone()
    c0[0, 0] += 1
    return Ciphertext(dataclasses.replace(ct.c0, data=c0), ct.c1, ct.scale)


def unchanged(patch) -> None:
    from repro_torch.fhe.evalplan import Ciphertext, EvalPlan
    from repro_torch.kernels import ops
    for name in ("multiply_many", "galois_ks_many"):
        patch(EvalPlan, name, lambda self, cts, *rest: list(cts))
    patch(EvalPlan, "rescale_many", lambda self, cts: [
        Ciphertext(dataclasses.replace(c.c0, data=c.c0.data[:-1], primes=c.primes[:-1]),
                   dataclasses.replace(c.c1, data=c.c1.data[:-1], primes=c.primes[:-1]),
                   c.scale / c.primes[-1]) for c in cts])
    patch(EvalPlan, "hoisted_galois", lambda self, a, gs: [a for _ in gs])
    patch(ops, "ntt", lambda x, p, **kw: x.clone())


def half(patch) -> None:
    from repro_torch.fhe.serve import CkksServeEngine
    from repro_torch.kernels import ops
    dispatch, group = CkksServeEngine._dispatch, CkksServeEngine._matvec_group
    patch(CkksServeEngine, "_dispatch",
          lambda self, kind, reqs: dispatch(self, kind, reqs[: max(1, len(reqs) // 2)]))
    patch(CkksServeEngine, "_matvec_group",
          lambda self, reqs, failed: group(self, reqs[: max(1, len(reqs) // 2)], failed))
    ntt = ops.ntt

    def ntt_half(x, p, **kw):
        y = ntt(x, p, **kw)
        y[x.shape[0] // 2:] = 0
        return y
    patch(ops, "ntt", ntt_half)


def altered(patch) -> None:
    from repro_torch.fhe import linalg
    from repro_torch.fhe.serve import CkksServeEngine
    from repro_torch.kernels import ops
    dispatch, matvec, ntt = CkksServeEngine._dispatch, linalg.matvec, ops.ntt

    def last_bumped(self, kind, reqs):
        outs = list(dispatch(self, kind, reqs))
        outs[len(reqs) - 1] = bump(outs[len(reqs) - 1])
        return outs
    patch(CkksServeEngine, "_dispatch", last_bumped)
    patch(linalg, "matvec", lambda *a: bump(matvec(*a)))

    def ntt_bumped(x, p, **kw):
        y = ntt(x, p, **kw)
        y[:, 0] = (y[:, 0] + 1) % p.q
        return y
    patch(ops, "ntt", ntt_bumped)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}


def main() -> int:
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    import torch

    from benchlib import cli, spec
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", nargs="+", default=list(FAULTS), choices=list(FAULTS))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    cell = spec.load(args.workload, ROOT)
    for name in args.faults:
        for seed in args.seeds:
            undo = []

            def patch(obj, attr, value):
                undo.append((obj, attr, getattr(obj, attr)))
                setattr(obj, attr, value)
            FAULTS[name](patch)
            t0 = time.perf_counter()
            try:
                r = cli.run_cell(cell, seed, args.seconds, False, "cuda", t0)
                line = {"correct": r["correct"], "attempted": r["attempted"],
                        "failed": r["failed"],
                        "compared": {k: c["value"] for k, c in r["compared"].items()}}
            except Exception as e:          # a fault that crashes the run fails it too
                line = {"correct": False, "error": repr(e)[:300]}
            finally:
                for obj, attr, value in reversed(undo):
                    setattr(obj, attr, value)
            print(json.dumps({"workload": args.workload, "fault": name, "seed": seed, **line,
                              "seconds": time.perf_counter() - t0,
                              "device": torch.cuda.get_device_name()}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
