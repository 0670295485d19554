"""The traced sub-window: torch.profiler over a stretch of the cell's
traffic, reduced to plain records that the per-layer readers take.

Records (all times in ns on the profiler's clock):
  window    (start, end) of the ``bench.window`` range around the traffic
  device    [(name, start, end)] every kernel, copy and fill on the card
            (the device's events but its copies of host ranges)
  spans     [(name, start, end)] host ranges: the program's ``obs`` spans
            (forwarded to the profiler) and the harness's ``bench.*``
  port      the port's kernel names (its ``csrc`` ``__global__`` functions)
"""
from __future__ import annotations

import contextlib
import re
from pathlib import Path

import torch

def port_kernels(root: Path) -> tuple[str, ...]:
    """The ``__global__`` function names of the program's CUDA sources."""
    names = set()
    for src in sorted((root / "src" / "repro_torch" / "csrc").glob("*.cu*")):
        text = re.sub(r"__launch_bounds__\([^)]*\)", "", src.read_text())
        names.update(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return tuple(sorted(names))


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def port_filter(port):
    """A predicate: is a device operation one of the port's kernels."""
    pattern = re.compile(r"\b(" + "|".join(map(re.escape, port)) + r")\b")
    seen: dict = {}

    def keep(name: str) -> bool:
        if name not in seen:
            seen[name] = bool(port) and pattern.search(name) is not None
        return seen[name]
    return keep


@contextlib.contextmanager
def profiled(records: dict, host: bool = True):
    """Profile the block and fill ``records`` with the window, device and
    span lists.  ``host`` also traces the host, with the program's
    spans forwarded, and bounds the window by the ``bench.window``
    range; without it only the card is traced (the host tracer's cost a
    call would otherwise show as device idle), and the window runs from
    a one-word fill launched before the block to one after it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs
    cuda = torch.cuda.is_available()
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    if host:
        obs.enable(forward_to_profiler=True)
        obs.clear()
    try:
        with profile(activities=activities) as prof:
            with record_function("bench.window"):
                if not host and cuda:
                    torch.zeros(1, device="cuda")
                yield
                if cuda:
                    if not host:
                        torch.zeros(1, device="cuda")
                    torch.cuda.synchronize()
    finally:
        obs.disable()
        obs.clear()
    device, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), start, end))
        elif e.is_user_annotation():
            if e.name() == "bench.window":
                window = (start, end)
            else:
                spans.append((e.name(), start, end))
    if not host and len(device) >= 2:
        device.sort(key=lambda d: d[1])
        window = (device[0][1], device[-1][2])
        device = device[1:-1]
    records.update(window=window, device=device, spans=spans)


def union(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """Merged intervals, clipped to [lo, hi]."""
    out: list = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_ns(trace: dict, keep=lambda name: True) -> int:
    lo, hi = trace["window"]
    return sum(e - s for s, e in union(
        [(s, e) for n, s, e in trace["device"] if keep(n)], lo, hi))


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of
    the card summed by the innermost host span open at their midpoint."""
    lo, hi = trace["window"]
    by_op: dict = {}
    for name, s, e in trace["device"]:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            key = name[:160]
            by_op[key] = by_op.get(key, 0) + (e - s)
    busy = union([(s, e) for _, s, e in trace["device"]], lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = e
    if hi > t:
        gaps.append((t, hi))
    # one sweep: span ends, span starts, then gap midpoints at equal times;
    # the innermost open span is the last one opened
    spans = [sp for sp in trace["spans"] if sp[2] > sp[1]]
    marks = [(e, 0, i) for i, (_, _, e) in enumerate(spans)]
    marks += [(s, 1, i) for i, (_, s, _) in enumerate(spans)]
    marks += [((s + e) // 2, 2, i) for i, (s, e) in enumerate(gaps)]
    by_span: dict = {}
    open_: list = []
    for _, kind, i in sorted(marks):
        if kind == 0:
            open_.remove(i)
        elif kind == 1:
            open_.append(i)
        else:
            name = spans[open_[-1]][0] if open_ else "(no span)"
            s, e = gaps[i]
            by_span[name] = by_span.get(name, 0) + (e - s)
    rank = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_span)}


def glue_busy_pct(rec: dict):
    """Share of the busy time in kernels that are not the port's own
    (copies and fills excluded), or None without a device trace."""
    if not rec.get("window") or not rec["device"]:
        return None
    port = port_filter(rec["port"])
    return 100.0 * busy_ns(rec, lambda n: not port(n) and not is_copy(n)) / busy_ns(rec)


def port_us_per_request(rec: dict):
    """Device time of the port's kernels per request answered, in us."""
    if not rec.get("window") or not rec["requests"]:
        return None
    ns = busy_ns(rec, port_filter(rec["port"]))
    return ns / 1e3 / rec["requests"] if ns else None


def idle_pct(rec: dict):
    """Share of the traced window with no operation on the card."""
    if not rec.get("window") or not rec["device"]:
        return None
    lo, hi = rec["window"]
    return 100.0 * (1 - busy_ns(rec) / (hi - lo))
