"""Share of the card's busy time in the profiled sub-window spent in the
``csrc/basis.cu`` kernels (the fast base conversions, and the mod-down
tails), in the hybrid key-switch cell.  Moves ``requests_per_s``."""
from benchlib import trace


def read(rec):
    if not rec.get("window") or not rec["device"] or not rec.get("basis_kernels"):
        return None
    busy = trace.busy_ns(rec)
    ns = trace.busy_ns(rec, trace.port_filter(rec["basis_kernels"]))
    return 100.0 * ns / busy if busy else None
