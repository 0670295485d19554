"""Time the host waits for a dispatched group (``serve.block``, less any
collection inside it) per request answered in the profiled sub-window,
in us, in the hybrid key-switch cell, where the card paces the drain.
Moves ``requests_per_s``."""
from benchlib import spans


def read(rec):
    return spans.us_per_request(rec, spans.serve_wait)
