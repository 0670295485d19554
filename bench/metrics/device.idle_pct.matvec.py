"""The same share in the matvec cell.  Moves ``matvecs_per_s``."""
from benchlib.trace import idle_pct as read  # noqa: F401
