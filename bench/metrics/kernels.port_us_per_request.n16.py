"""Device time of the port's own kernels (its ``csrc`` functions) in the
profiled sub-window, per request answered in it, in microseconds, in the
hybrid key-switch cell.  Moves ``requests_per_s``."""
from benchlib.trace import port_us_per_request as read  # noqa: F401
