"""Share of the profiled sub-window in which no operation ran on the card,
in the ML-DSA cell.  Moves ``requests_per_s``."""
from benchlib.trace import idle_pct as read  # noqa: F401
