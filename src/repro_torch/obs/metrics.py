"""Process-wide metrics registry: counters, gauges, log-bucketed latency
histograms.

The registry backs the serve and EvalPlan ``stats`` dicts rather than
replacing them: the dicts keep their keys and values, and the
instrumented layers mirror the same increments here, plus what a flat
dict cannot hold: per-phase latency histograms (every ``obs.span`` feeds
one on exit), queue-depth gauge samples over the async drain and
per-request lifecycle deltas.  Everything is gated on ``obs.enabled()``:
a disabled call is one flag check and a return.

Histogram buckets are powers of two with an inclusive upper bound: a
value v lands in the smallest bucket 2**m >= v (4.0 -> 4.0, 4.0001 ->
8.0; v <= 0 -> 0.0), so the registry stays bounded under any latency
distribution.  One coarse lock guards every operation.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque

from repro_torch.obs import trace as _trace

# samples kept per gauge (the async drain samples queue depth once per
# admission cycle)
MAX_GAUGE_SAMPLES = 4096

_LOCK = threading.Lock()
_COUNTERS: dict[str, float] = {}
_GAUGES: dict[str, dict] = {}       # name -> {"value": v, "samples": deque}
_HISTS: dict[str, dict] = {}        # name -> {"buckets", "count", "sum", ...}


def bucket_le(v: float) -> float:
    """The inclusive upper bound of the log2 bucket ``v`` falls in."""
    if v <= 0.0:
        return 0.0
    return 2.0 ** math.ceil(math.log2(v))


def counter_add(name: str, n: float = 1) -> None:
    if not _trace._ENABLED:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def gauge_set(name: str, value: float) -> None:
    """Set a gauge and append a (ts_us, value) sample (bounded)."""
    if not _trace._ENABLED:
        return
    ts_us = (time.perf_counter_ns() - _trace._EPOCH_NS) / 1e3
    with _LOCK:
        g = _GAUGES.get(name)
        if g is None:
            g = _GAUGES[name] = {"value": value,
                                 "samples": deque(maxlen=MAX_GAUGE_SAMPLES)}
        g["value"] = value
        g["samples"].append((ts_us, value))


def observe(name: str, v: float) -> None:
    """Record one sample into the log-bucketed histogram ``name``."""
    if not _trace._ENABLED:
        return
    with _LOCK:
        h = _HISTS.get(name)
        if h is None:
            h = _HISTS[name] = {"buckets": {}, "count": 0, "sum": 0.0,
                                "min": float("inf"), "max": float("-inf")}
        le = bucket_le(v)
        h["buckets"][le] = h["buckets"].get(le, 0) + 1
        h["count"] += 1
        h["sum"] += v
        h["min"] = min(h["min"], v)
        h["max"] = max(h["max"], v)


def histogram_quantile(name: str, q: float) -> float | None:
    """Bucket-resolution quantile: the upper bound of the bucket that
    holds the q-quantile sample, or None if the histogram is empty."""
    with _LOCK:
        h = _HISTS.get(name)
        if h is None or h["count"] == 0:
            return None
        target = q * h["count"]
        seen = 0
        for le in sorted(h["buckets"]):
            seen += h["buckets"][le]
            if seen >= target:
                return le
        return max(h["buckets"])


def snapshot() -> dict:
    """JSON-ready copy of the whole registry."""
    with _LOCK:
        counters = dict(_COUNTERS)
        gauges = {name: {"value": g["value"],
                         "samples": [list(s) for s in g["samples"]]}
                  for name, g in _GAUGES.items()}
        hists = {}
        for name, h in _HISTS.items():
            n = h["count"]
            hists[name] = {
                "count": n,
                "sum": h["sum"],
                "mean": (h["sum"] / n) if n else 0.0,
                "min": h["min"] if n else None,
                "max": h["max"] if n else None,
                # string keys: JSON objects cannot key on floats
                "buckets": {repr(le): c for le, c in sorted(h["buckets"].items())},
            }
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def reset() -> None:
    """Drop every metric (a fresh capture)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
