"""The same share in the matvec cell (the plain MACs, the hoisted
rotations' glue).  Moves ``matvecs_per_s``."""
from benchlib.trace import glue_busy_pct as read  # noqa: F401
