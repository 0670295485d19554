"""Share of the card's busy time in the profiled sub-window spent in kernels
that are not the port's own (the ML-DSA stream's PyTorch glue between
them: the prefix sums over the accept flags, the refill's scatters and
selects, the counters' sums), in the ML-DSA cell.  Moves
``requests_per_s``."""
from benchlib.trace import glue_busy_pct as read  # noqa: F401
