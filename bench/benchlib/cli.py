"""One run of one cell: set-up, the measured window, with ``--trace 1``
a profiled sub-window, then the check against the plain reference, and
the result as the last line of standard output.

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, each read by its own
reader under ``bench/metrics/`` (a reader that finds nothing to read
returns None and the metric is left out).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

import torch

from benchlib import spec, trace

# modules that must not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the program's tile funnel reads these; a run builds the engine as a
# user does, with nothing pinned and no sidecar
UNSET = ("SCE_NTT_TILE", "SCE_NTT_AUTOTUNE", "SCE_NTT_AUTOTUNE_CACHE")


def parse(argv):
    p = argparse.ArgumentParser(prog="bench/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class GcClock:
    """Python's collections while it is on: their count by generation
    and the seconds they paused the process (``gc.callbacks``)."""

    def __init__(self):
        self.counts, self.pause_s, self._t = [0, 0, 0], 0.0, None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pause_s += time.perf_counter() - self._t
            self.counts[info["generation"]] += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    """The run on ``device``; returns the result line's object."""
    system = spec.system(cell.config["system"])
    run = system.Run(cell, seed, device)
    log(f"[setup] process start to the inputs made: {time.perf_counter() - t_start:.3f} s")
    run.setup()
    gc.collect()                 # the window starts from a collected heap
    setup_s = time.perf_counter() - t_start
    with GcClock() as gcc:
        win = run.window(seconds)
    log(f"[bench] {cell.name} seed {seed}: set-up {setup_s:.3f} s, window "
        f"{win['window_s']:.3f} s, {win['attempted']} attempted, {win['failed']} failed; "
        f"collections by generation {gcc.counts} paused it {gcc.pause_s:.3f} s")
    records = None
    if traced:
        records = run.profile(cell.traffic["profile_s"])
        records["counters"] = win["counters"]
        records["gc"] = {"pause_s": gcc.pause_s, "counts": gcc.counts,
                         "window_s": win["window_s"]}
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.free()
    t_check = time.perf_counter()
    compared = run.check()
    log(f"[check] against the reference in {time.perf_counter() - t_check:.3f} s")
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"], cell.root)(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"]) is not None}
    result = {
        "correct": all(v <= lim for v, lim in compared.values()) and win["failed"] == 0,
        "attempted": win["attempted"], "failed": win["failed"], "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak},
    }
    if traced and records.get("window"):
        lo, hi = records["window"]
        result["device"].update(busy_s=trace.busy_ns(records) / 1e9, window_s=(hi - lo) / 1e9)
        result["breakdown"] = trace.breakdown(records)
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result


def main(argv, t_start: float, root: Path) -> int:
    args = parse(argv)
    for name in UNSET:
        os.environ.pop(name, None)
    if not (root / "src" / "repro_torch").is_dir():
        log(f"bench: the program (src/repro_torch) is not in {root}")
        return 2
    cell = spec.load(args.workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"bench: {args.workload} needs {cell.chips} CUDA device(s), found {found}; "
            "the benchmark runs only on the card")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    loaded = forbidden_modules()
    if loaded:
        log(f"bench: the run loaded {loaded}; the port must run without JAX or the "
            "JAX package")
        return 4
    for name, c in result["compared"].items():
        log(f"compared {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
