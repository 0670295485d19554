"""Share of the measured window in which Python's collections paused the
process (all generations, timed by ``gc.callbacks``), in the key-switch
cell.  The engine holds a chunk's answers until its drain returns, so a
full collection walks them while the card waits.  Moves
``requests_per_s``."""


def read(rec):
    g = rec.get("gc")
    return 100.0 * g["pause_s"] / g["window_s"] if g and g["window_s"] else None
