"""The same share in the NTT-128 cell (the card alone traced).  Moves
``ntt_per_s``."""
from benchlib.trace import idle_pct as read  # noqa: F401
