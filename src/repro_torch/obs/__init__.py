"""Runtime observability for the kernels -> EvalPlan -> serve stack:
span tracing (``obs.trace``), a metrics registry (``obs.metrics``) and
Chrome trace-event / JSON exporters (``obs.export``).

One switch governs everything: ``obs.enable()`` / ``obs.disable()``.
Disabled (the default), every instrumentation point is a single flag
check: ``span()`` returns a shared no-op singleton and registry calls
return at once, so the hot paths carry their probes permanently.

Typical capture::

    from repro_torch import obs
    obs.enable(); obs.clear(); obs.reset()
    engine.run_async(reqs, arrivals)
    obs.write_trace("drain_trace.json")      # -> ui.perfetto.dev
    obs.write_metrics("drain_metrics.json")  # counters/gauges/histograms

``obs.enable(forward_to_profiler=True)`` also enters each span as a
``torch.profiler.record_function`` range, so in a torch.profiler trace
the host spans line up with the card's kernels.
"""
from repro_torch.obs.trace import (NOOP_SPAN, clear, disable, dropped, enable,
                                   enabled, events, span)
from repro_torch.obs.metrics import (bucket_le, counter_add, gauge_set,
                                     histogram_quantile, observe, reset, snapshot)
from repro_torch.obs.export import (chrome_trace, metrics_snapshot, write_metrics,
                                    write_trace)

__all__ = [
    "NOOP_SPAN", "clear", "disable", "dropped", "enable", "enabled",
    "events", "span",
    "bucket_le", "counter_add", "gauge_set", "histogram_quantile",
    "observe", "reset", "snapshot",
    "chrome_trace", "metrics_snapshot", "write_metrics", "write_trace",
]
