"""Share of the card's busy time in the profiled sub-window spent in kernels
that are not the port's own (ML-KEM's PyTorch glue between them: the
K-term sums of the basecase products and their reduction mod q, the copy
of the broadcast ŷ, decryption's codec), in the ML-KEM cell.  Moves
``requests_per_s``."""
from benchlib.trace import glue_busy_pct as read  # noqa: F401
