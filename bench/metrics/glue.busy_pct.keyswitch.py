"""Share of the card's busy time in the profiled sub-window spent in kernels
that are not the port's own (the int64 PyTorch glue of the key switch and
the plan's programs), in the key-switch cell.  Moves ``requests_per_s``."""
from benchlib.trace import glue_busy_pct as read  # noqa: F401
