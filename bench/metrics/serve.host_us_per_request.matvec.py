"""The serve layer's host time per matvec answered, in us, in the matvec
cell; it holds ``serve.matvec``'s self time, the host glue of
``linalg.matvec`` between the plan's programs.  Moves ``matvecs_per_s``."""
from benchlib import spans


def read(rec):
    return spans.us_per_request(rec, spans.serve_host)
