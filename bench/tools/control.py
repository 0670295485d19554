"""The control of a cell's check: the plain reference computed in float64
(a 53-bit mantissa for products of 30-bit residues) put in the
program's place, over the sample a run of the cell would compare, on
the run's own inputs.  It must come out not correct; prints one JSON
line per seed with the compared numbers.

    python3 bench/tools/control.py --workload fig22-keyswitch --seeds 1 2 3 \\
        --units 50
``--units``: the backlog chunks, or NTT calls, that a run's window holds.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import torch  # noqa: E402

from benchlib import spec  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--units", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    cell = spec.load(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = spec.system(cell.config["system"]).Run(cell, seed, args.device)
        run.keep_without_program(args.seconds, args.units)
        compared = run.check(control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": all(v <= lim for v, lim in compared.values()),
                          "compared": {k: v for k, (v, _) in compared.items()},
                          "kept": len(run.kept), "seconds": time.perf_counter() - t0,
                          "device": torch.cuda.get_device_name() if args.device == "cuda"
                          else args.device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
