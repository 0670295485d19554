"""Share of the card's busy time in the profiled sub-window spent in kernels
that are not the port's own (the PyTorch glue of the key switch: the
2^16 four-step banks' transposes and gathers among them), in the hybrid
key-switch cell.  Moves ``requests_per_s``."""
from benchlib.trace import glue_busy_pct as read  # noqa: F401
