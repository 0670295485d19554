#!/usr/bin/env python3
"""Where a serving cell's host time goes, by the program's ``obs`` spans,
and what tracing costs when it is on.

    python3 tools/serve_spans.py --workload fig22-keyswitch --seeds 11 12 13
                                 [--seconds 10] [--profile-s 2]

For each seed, one process builds the cell as ``bench/run.py`` does
(``bench/benchlib``: the same set-up, traffic and engine), then runs
four measured windows of ``--seconds`` in the order off, on, on, off:
"on" with ``obs.enable(forward_to_profiler=True)`` and no profiler
running (every span and ``host.gc`` recorded and forwarded), "off" with
obs disabled.  Then a traced sub-window of ``--profile-s`` under
``torch.profiler`` (``benchlib.trace.profiled``), and of it:

  * the cell's per-layer metrics, through their readers;
  * self time and idle time by span name, per request answered;
  * coverage: the serve layer's host and wait time and the plan's host
    time, times the requests, over the window's time under any span but
    ``host.gc`` (1 when the serve and plan spans hold all of it).

Prints one JSON line a seed, the card's name and power limit in each.
Runs on the card only.  Imports torch, numpy, ``bench/`` and the port.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def by_name(rec: dict, spans) -> dict:
    """name -> [self us, idle us] per request answered in the sub-window."""
    out: dict = {}
    for s, e, name in spans.innermost(rec):
        out.setdefault(name, [0, 0])[0] += e - s
    for name in out:
        out[name][1] = spans.idle_ns(rec, lambda n, want=name: n == want)
    req = rec["requests"]
    return {k: [v[0] / 1e3 / req, v[1] / 1e3 / req]
            for k, v in sorted(out.items(), key=lambda kv: -kv[1][0])}


def one_seed(cell, seed: int, seconds: float, profile_s: float, device="cuda") -> dict:
    from benchlib import spans, spec, trace
    from repro_torch import obs
    run = spec.system(cell.config["system"]).Run(cell, seed, device)
    t0 = time.perf_counter()
    run.setup()
    out = {"workload": cell.name, "seed": seed, "setup_s": time.perf_counter() - t0,
           "windows": []}
    metric = cell.traffic["throughput_metric"]
    for mode in ("off", "on", "on", "off"):
        gc.collect()
        if mode == "on":
            obs.enable(forward_to_profiler=True)
        try:
            win = run.window(seconds)
        finally:
            obs.disable()
            obs.clear()
            obs.reset()
        out["windows"].append([mode, win["metrics"][metric]])
    rec = run.profile(profile_s)
    rec["counters"] = win["counters"]
    lo, hi = rec["window"]
    metrics = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"], cell.root)(rec)
        if value is not None:
            metrics[m["name"]] = value
    served = sum(spans.us_per_request(rec, keep) or 0.0
                 for keep in (spans.serve_host, spans.serve_wait, spans.plan))
    under = spans.self_ns(rec, lambda n: n != "host.gc") / 1e3
    out.update(
        per_layer=metrics, requests=rec["requests"], window_us=(hi - lo) / 1e3,
        busy_us=trace.busy_ns(rec) / 1e3,
        under_spans_us=under, gc_us=spans.self_ns(rec, lambda n: n == "host.gc") / 1e3,
        coverage=served * rec["requests"] / under if under else None,
        by_name_us_per_request=by_name(rec, spans))
    run.free()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--profile-s", type=float, default=None)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]
    from benchlib import spec
    cell = spec.load(args.workload, ROOT)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for seed in args.seeds:
        out = one_seed(cell, seed, args.seconds, args.profile_s or cell.traffic["profile_s"])
        print(json.dumps(dict(out, gpu=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
