"""Key-switch digits decomposed per request answered over the window, in
the hybrid key-switch cell: the plan's ``decomposes`` times ceil((L + 1)
/ alpha), the digits of the full chain, where the cell's traffic keeps
every request (the adapter's ``ks_digits``); 4 at dnum = 4.  Moves
``requests_per_s``: each digit is a mod-up, alpha + ... forward
transforms and a pair of digit products."""


def read(rec):
    c = rec["counters"]
    if "ks_digits" not in c or not c["requests"]:
        return None
    return c["ks_digits"] / c["requests"]
