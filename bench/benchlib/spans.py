"""The host's time and the card's idle time by the program's own spans.

The program's ``obs`` spans reach ``rec["spans"]`` as profiler ranges of
one thread, so they nest.  At each instant of the traced window the
innermost open span is the one opened last; a span's self time is the
time it is innermost, which is its duration less the union of the spans
nested in it (``host.gc``, a collection, is a child like any other).
An idle interval of the card is split among the innermost spans open
during its parts, by overlap; a part under no span counts for none.
"""
from __future__ import annotations

from benchlib import trace


def innermost(rec: dict) -> list[tuple[int, int, str]]:
    """(start, end, name) segments of the window, each under the name of
    the innermost span open through it; time under no span is left out."""
    lo, hi = rec["window"]
    spans = sorted(((max(s, lo), min(e, hi), n) for n, s, e in rec["spans"]
                    if min(e, hi) > max(s, lo)), key=lambda sp: (sp[0], -sp[1]))
    # ends before starts at equal times; an outer span opens before the
    # inner one that starts with it (the sort above)
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    out: list = []
    open_: list = []
    t = lo
    for at, kind, i in marks:
        if open_ and at > t:
            out.append((t, at, spans[open_[-1]][2]))
        t = at
        if kind:
            open_.append(i)
        else:
            open_.remove(i)
    return out


def idle_gaps(rec: dict) -> list[tuple[int, int]]:
    """The window's intervals with no operation on the card."""
    lo, hi = rec["window"]
    gaps, t = [], lo
    for s, e in trace.union([(s, e) for _, s, e in rec["device"]], lo, hi):
        if s > t:
            gaps.append((t, s))
        t = e
    if hi > t:
        gaps.append((t, hi))
    return gaps


def self_ns(rec: dict, keep) -> int:
    """Self time of the spans whose names ``keep`` accepts."""
    return sum(e - s for s, e, name in innermost(rec) if keep(name))


def idle_ns(rec: dict, keep) -> int:
    """Idle time of the card while a span ``keep`` accepts is innermost."""
    gaps = idle_gaps(rec)
    total, j = 0, 0
    for s, e, name in innermost(rec):
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        if not keep(name):
            continue
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            total += min(e, gaps[k][1]) - max(s, gaps[k][0])
            k += 1
    return total


def _has(rec: dict, keep) -> bool:
    return bool(rec.get("window")) and any(keep(n) for n, _, _ in rec.get("spans", ()))


def us_per_request(rec: dict, keep):
    """Self time of the spans ``keep`` accepts per request answered in the
    sub-window, in us; None without such spans or requests."""
    if not _has(rec, keep) or not rec.get("requests"):
        return None
    return self_ns(rec, keep) / 1e3 / rec["requests"]


def idle_pct(rec: dict, keep):
    """Share of the window with the card idle and a span ``keep`` accepts
    innermost; None without a device trace or such spans."""
    if not _has(rec, keep) or not rec.get("device"):
        return None
    lo, hi = rec["window"]
    return 100.0 * idle_ns(rec, keep) / (hi - lo)


def serve(name: str) -> bool:
    return name.startswith("serve.")


def serve_host(name: str) -> bool:
    """The engine's own host work: every ``serve.*`` span but the wait."""
    return serve(name) and name != "serve.block"


def serve_wait(name: str) -> bool:
    return name == "serve.block"


def plan(name: str) -> bool:
    return name.startswith("plan.")
