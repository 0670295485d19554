"""Host time of the plan layer per request answered in the profiled
sub-window, in us, in the hybrid key-switch cell: the self time of the
``plan.*`` spans.  Moves ``requests_per_s``."""
from benchlib import spans


def read(rec):
    return spans.us_per_request(rec, spans.plan)
