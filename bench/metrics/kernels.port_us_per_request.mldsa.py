"""Device time of the port's own kernels (its ``csrc`` functions: Keccak,
the u32 NTTs, the digit MAC and the codec) in the profiled sub-window,
per signature completed in it, in microseconds, in the ML-DSA cell.
Moves ``requests_per_s``."""
from benchlib.trace import port_us_per_request as read  # noqa: F401
