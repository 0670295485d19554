"""Exporters: Chrome trace-event JSON (loadable in Perfetto) and the
metrics snapshot.

``chrome_trace()`` renders the tracer's buffer in the Chrome trace-event
"JSON object format": each span is one complete event (``ph: "X"``) with
microsecond ``ts`` / ``dur``, the recording thread as ``tid`` and the
span's keyword args (and its depth) as ``args``.  Open the file in
https://ui.perfetto.dev or chrome://tracing.
"""
from __future__ import annotations

import json
import os

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


def chrome_trace() -> dict:
    """The event buffer as a Chrome trace-event JSON object (a dict)."""
    pid = os.getpid()
    return {
        "traceEvents": [{"name": ev["name"], "cat": ev["cat"], "ph": "X",
                         "ts": ev["ts_us"], "dur": ev["dur_us"], "pid": pid,
                         "tid": ev["tid"], "args": dict(ev["args"], depth=ev["depth"])}
                        for ev in _trace.events()],
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro_torch.obs",
                      "dropped_events": _trace.dropped()},
    }


def write_trace(path: str) -> None:
    """Write the trace JSON to ``path``."""
    with open(path, "w") as f:
        json.dump(chrome_trace(), f, indent=1)


def metrics_snapshot() -> dict:
    return _metrics.snapshot()


def write_metrics(path: str) -> None:
    """Write the metrics snapshot JSON to ``path``."""
    with open(path, "w") as f:
        json.dump(_metrics.snapshot(), f, indent=1, sort_keys=True)
