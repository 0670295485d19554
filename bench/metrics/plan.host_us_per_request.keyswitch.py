"""Host time of the plan layer per request answered in the profiled
sub-window, in us, in the key-switch cell: the self time of the
``plan.*`` spans (argument checks and lookups, stacks, the graph's input
copies, launch and output clones, unpacking).  Moves ``requests_per_s``."""
from benchlib import spans


def read(rec):
    return spans.us_per_request(rec, spans.plan)
