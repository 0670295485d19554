"""EvalPlan programs (CUDA-graph replays on the card) run per request
answered over the window (``stats['program_dispatches']``).  Moves
``requests_per_s``: fewer, larger programs amortise each replay."""


def read(rec):
    c = rec["counters"]
    return c["program_dispatches"] / c["requests"] if c["requests"] else None
