"""The plan layer's host time per matvec answered, in us, in the matvec
cell.  Moves ``matvecs_per_s``."""
from benchlib import spans


def read(rec):
    return spans.us_per_request(rec, spans.plan)
