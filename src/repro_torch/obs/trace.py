"""Nestable, thread-safe span tracer on monotonic clocks.

``span("serve.dispatch", kind=..., n=...)`` is a context manager that
records a (name, cat, start, duration, thread, depth, args) event into a
bounded process-wide buffer, which ``obs.export`` renders as Chrome
trace-event JSON (loadable in Perfetto), so a serve drain's wall time
splits into its screen / group / dispatch / block phases on a timeline.

  * Disabled (the default), ``span()`` checks one module-level flag and
    returns a shared no-op singleton: no allocation, no clock read, no
    lock.
  * Each thread keeps its own span stack (depth nests the rows); the
    event buffer is a bounded deque appended under a lock at span exit,
    so an unbounded run drops its oldest events instead of growing, and
    ``dropped()`` counts them.
  * A span records its event on exit whatever happened, tags an
    exception as ``error=<class>`` in its args, and never swallows it.
  * Timestamps: ``time.perf_counter_ns``, in microseconds from the
    module's load (Chrome trace-event ``ts`` / ``dur`` are µs).
  * ``enable(forward_to_profiler=True)`` also enters each span as a
    ``torch.profiler.record_function`` range (a few µs a span), so host
    spans line up with the card's kernels in a torch.profiler trace.

Every span is also a latency sample: on exit its duration goes to the
metrics registry's histogram ``<name>.us``.

While enabled, a ``gc.callbacks`` hook also records each of Python's
collections as a ``host.gc`` span (cat ``host``, its ``generation`` in
the args; forwarded like any span), so the pauses the collector takes
have a name on the timeline.  A collection may start inside any
allocation, also one made while this module holds its lock, so the hook
never waits on it: an event it cannot append at once waits in a side
queue that the next holder of the lock appends first.  ``host.gc`` feeds
no histogram (the registry's lock may be the one held).  ``disable()``
removes the hook.
"""
from __future__ import annotations

import gc
import threading
import time
from collections import deque

import torch

# bounded: a long soak must not exhaust the host through its own
# instrument; 262144 events is about 30 MB
MAX_EVENTS = 262_144

_ENABLED = False
_FORWARD = False
_EVENTS: deque = deque(maxlen=MAX_EVENTS)
_LOCK = threading.Lock()
_TLS = threading.local()
_EPOCH_NS = time.perf_counter_ns()      # trace time zero (µs offsets)
_DROPPED = 0                            # events lost to the maxlen bound
_GC_PENDING: deque = deque()            # host.gc events the hook could not append


def enabled() -> bool:
    return _ENABLED


def enable(*, forward_to_profiler: bool = False) -> None:
    """Turn span recording on process-wide.  ``forward_to_profiler=True``
    also enters every span as a ``torch.profiler.record_function`` range."""
    global _ENABLED, _FORWARD
    _FORWARD = bool(forward_to_profiler)
    _ENABLED = True
    if _GC_HOOK not in gc.callbacks:
        gc.callbacks.append(_GC_HOOK)


def disable() -> None:
    global _ENABLED, _FORWARD
    _ENABLED = False
    _FORWARD = False
    if _GC_HOOK in gc.callbacks:
        gc.callbacks.remove(_GC_HOOK)


def clear() -> None:
    """Drop every recorded event (a fresh capture)."""
    global _DROPPED
    with _LOCK:
        _GC_PENDING.clear()
        _EVENTS.clear()
        _DROPPED = 0


def _flush_gc() -> None:
    """Append the events the gc hook left waiting (``_LOCK`` held)."""
    while _GC_PENDING:
        _append(_GC_PENDING.popleft())


def _append(ev: tuple) -> None:
    """Append one event to the bounded buffer (``_LOCK`` held)."""
    global _DROPPED
    if len(_EVENTS) == MAX_EVENTS:
        _DROPPED += 1
    _EVENTS.append(ev)


def events() -> list[dict]:
    """The event buffer as plain dicts, oldest first: name, cat, ts_us,
    dur_us, tid, depth, args."""
    with _LOCK:
        _flush_gc()
        return [{"name": name, "cat": cat, "ts_us": ts, "dur_us": dur,
                 "tid": tid, "depth": depth, "args": args}
                for (name, cat, ts, dur, tid, depth, args) in _EVENTS]


def dropped() -> int:
    """Events lost to the ``MAX_EVENTS`` bound since the last clear."""
    return _DROPPED


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


class _NoopSpan:
    """The disabled path's context manager: one shared instance, so
    ``span(...)`` allocates nothing when tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "t0", "depth", "_range")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0
        self.depth = 0
        self._range = None

    def __enter__(self):
        stack = _stack()
        self.depth = len(stack)
        stack.append(self)
        if _FORWARD:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.args = dict(self.args, error=exc_type.__name__)
        ts_us = (self.t0 - _EPOCH_NS) / 1e3
        dur_us = (t1 - self.t0) / 1e3
        with _LOCK:
            _flush_gc()
            _append((self.name, self.cat, ts_us, dur_us,
                     threading.get_ident(), self.depth, self.args))
        from repro_torch.obs import metrics
        metrics.observe(f"{self.name}.us", dur_us)
        return False                # never swallow the exception


def span(name: str, cat: str = "repro_torch", **args):
    """Context manager timing one named phase; keyword args become the
    trace event's ``args`` (keep them JSON-serializable).  Returns the
    shared no-op singleton while tracing is disabled."""
    if not _ENABLED:
        return NOOP_SPAN
    return _Span(name, cat, args)


class _GcSpan:
    """The ``gc.callbacks`` hook: a collection, from its ``start`` to its
    ``stop``, as a ``host.gc`` span of the thread that triggered it (one
    collection runs at a time).  It takes no lock it would wait for."""

    def __init__(self):
        self.t0 = None
        self.depth = 0
        self.range = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.depth = len(_stack())
            if _FORWARD:
                self.range = torch.profiler.record_function("host.gc")
                self.range.__enter__()
            self.t0 = time.perf_counter_ns()
        elif self.t0 is not None:
            t1 = time.perf_counter_ns()
            if self.range is not None:
                self.range.__exit__(None, None, None)
                self.range = None
            ev = ("host.gc", "host", (self.t0 - _EPOCH_NS) / 1e3, (t1 - self.t0) / 1e3,
                  threading.get_ident(), self.depth, {"generation": info["generation"]})
            self.t0 = None
            if _LOCK.acquire(blocking=False):
                try:
                    _flush_gc()
                    _append(ev)
                finally:
                    _LOCK.release()
            else:
                _GC_PENDING.append(ev)


_GC_HOOK = _GcSpan()
