"""Device time of the port's own kernels (its ``csrc`` functions: Keccak,
the key's decode and the ciphertext's encode, the u16 NTTs and the
basecase product) in the profiled sub-window, per encapsulation completed
in it, in microseconds, in the ML-KEM cell.  Moves ``requests_per_s``."""
from benchlib.trace import port_us_per_request as read  # noqa: F401
