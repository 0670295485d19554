"""Share of the profiled sub-window in which the card is idle and a
``plan.*`` span is the innermost open, in the key-switch cell.  Moves
``requests_per_s``."""
from benchlib import spans


def read(rec):
    return spans.idle_pct(rec, spans.plan)
