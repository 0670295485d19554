"""Slot-iterations the ML-DSA stream ran in the window, over the signatures
it completed there, from the stream's counters (on the device, read once
after the window).  Its floor is the inputs' own mean, about 5.1
iterations a signature (FIPS 204's expected repetitions); the window's
record also gives the iterations the completed signatures needed, so the
gap between the two is what the stream wastes on slots that run without
a request.  Moves ``requests_per_s``."""


def read(rec):
    c = rec.get("counters") or {}
    if not c.get("signatures") or "slot_iterations" not in c:
        return None
    return c["slot_iterations"] / c["signatures"]
