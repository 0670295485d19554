"""The same per matvec answered, in the matvec cell.  Moves
``matvecs_per_s``."""
from benchlib.trace import port_us_per_request as read  # noqa: F401
