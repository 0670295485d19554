"""Host time of the serve layer per request answered in the profiled
sub-window, in us, in the key-switch cell: the self time of the engine's
``serve.*`` spans but ``serve.block`` (admission, grouping, a group's
dispatch less the plan's steps, delivery, a drain's open and close).
Moves ``requests_per_s``."""
from benchlib import spans


def read(rec):
    return spans.us_per_request(rec, spans.serve_host)
