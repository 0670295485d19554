"""Run one cell several times in turn, each a fresh ``bench/run.py``
process, and append one JSON line a run to ``--out``: the label, seed,
exit code, wall seconds, the result line and the end of standard error.
Then print each end-to-end metric's quartile spread per label
(``statistics.quantiles``, n = 4, over the median), as a bound is set
from them.

    python3 bench/tools/sets.py --workload ntt128-batch --out runs.jsonl \\
        --run A:0:11,12,13 --run T:1:21 --seconds 10

Each ``--run LABEL:TRACE:SEEDS`` runs the seeds, in order, under that
label with ``--trace TRACE``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def summary(lines) -> None:
    by: dict = {}
    for r in lines:
        if r["result"] and r["trace"] == 0:
            for name, m in r["result"]["metrics"].items():
                by.setdefault(name, {}).setdefault(r["label"], []).append(m["value"])
    for name, labels in by.items():
        for label, values in labels.items():
            if len(values) >= 2:
                print(f"{name} {label}: median {statistics.median(values)!r} spread "
                      f"{spread(values)!r} of {len(values)}", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--run", action="append", required=True, help="LABEL:TRACE:SEED,SEED,...")
    p.add_argument("--seconds", type=int, default=10)
    args = p.parse_args()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for spec in args.run:
        label, traced, seeds = spec.split(":")
        for seed in map(int, seeds.split(",")):
            cmd = [sys.executable, "bench/run.py", "--workload", args.workload, "--seed",
                   str(seed), "--seconds", str(args.seconds), "--trace", traced]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            result = None
            if proc.returncode == 0 and proc.stdout.strip():
                result = json.loads(proc.stdout.strip().splitlines()[-1])
            line = {"label": label, "seed": seed, "trace": int(traced), "rc": proc.returncode,
                    "wall": time.perf_counter() - t0, "result": result,
                    "stderr": proc.stderr[-3000:]}
            lines.append(line)
            with args.out.open("a") as f:
                f.write(json.dumps(line) + "\n")
            short = {k: v for k, v in (result or {}).items() if k != "breakdown"}
            print(f"{label} {seed} rc={proc.returncode} wall={line['wall']:.1f} "
                  f"{json.dumps(short)[:900]}", flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-2000:], flush=True)
    summary(lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
