#!/usr/bin/env python3
"""Time the Galois gathers of one checkout of the port on the card.

    python3 tools/time_gathers.py [--src DIR] [--label NAME] [--only TEXT ...]

DIR is the ``src`` directory of a checkout (default: this repository's),
so two trees can be timed in one machine call, in turns (A, B, B, A), on
one card: each builds its own kernels under its own ``build/``.  Cases,
at the rotation path's shapes (natural-order rotation rows by 1 .. 8
slots): ``galois_digits`` of the hoisted R = 8 rotation, its digit
gather (8, 9, 1, n) and its c0 gather (1, 8, 1, n), both fanned out to
R = 8, and the non-shared (8, 9, 8, n); ``galois_banks_multi`` (8, 8, n)
of a mixed ``rotate_many`` of 8; ``galois_banks`` (8, 1, n) of a rotate;
each at n = 2^14 and 2^16, and beside each the one PyTorch call that
computes the same function (``index_select`` or ``gather``).  ``--only``
keeps the cases whose name contains one of the texts.  Each time is the
device time of one call (``time_ntt_banks.graph_ms``: 10 calls captured
in a CUDA graph, the graph replayed 25 times between CUDA events, the
median of the per-call mean); each case also names its byte bound (each
input read once, each output written once, at 3.35 TB/s).  Prints one
JSON line with the card's name and power limit.  Imports torch, numpy
and the checkout's ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from time_ntt_banks import graph_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--only", action="append", default=[],
                    help="time only the cases whose name contains this text")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_gathers: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.params import galois_eval_perm
    from repro_torch.fhe import rns
    from repro_torch.kernels import galois_kernel

    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    cases, words = {}, {}
    for logn in (14, 16):
        n = 1 << logn
        qs = [int(q) for q in rns.make_primes(n, 9)]
        rows = torch.from_numpy(np.stack([galois_eval_perm(pow(5, r, 2 * n), n, True)
                                          for r in range(1, 9)]).astype(np.int32)).to(dev)

        def stack(d, b, k=9):
            return torch.from_numpy(np.stack(
                [np.stack([rng.integers(0, q, (b, n)) for q in qs[:k]]) for _ in range(d)])
                .astype(np.int32)).to(dev)

        dig, c0, ext = stack(8, 1), stack(1, 1, 8), stack(8, 8)
        x8, x1 = stack(1, 8, 8)[0], stack(1, 1, 8)[0]
        flat = rows.view(-1)
        for name, x, kern, lib in (
                ("galois_digits", dig,
                 lambda x=dig, rows=rows: galois_kernel.galois_digits(x, rows, shared=True),
                 lambda x=dig, n=n, flat=flat: torch.index_select(x.view(-1, n), 1, flat)),
                ("galois_digits c0", c0,
                 lambda x=c0, rows=rows: galois_kernel.galois_digits(x, rows, shared=True),
                 lambda x=c0, n=n, flat=flat: torch.index_select(x.view(-1, n), 1, flat)),
                ("galois_digits non-shared", ext,
                 lambda x=ext, rows=rows: galois_kernel.galois_digits(x, rows, shared=False),
                 lambda x=ext, rows=rows: torch.gather(x, 3, rows[None, None].expand(x.shape))),
                ("galois_banks_multi", x8,
                 lambda x=x8, rows=rows: galois_kernel.galois_banks_multi(x, rows),
                 lambda x=x8, rows=rows: torch.gather(x, 2, rows.expand(x.shape))),
                ("galois_banks", x1,
                 lambda x=x1, rows=rows: galois_kernel.galois_banks(x, rows[0]),
                 lambda x=x1, rows=rows: torch.index_select(x, 2, rows[0]))):
            shared = x.ndim == 4 and x.shape[2] == 1
            out = x.numel() * (8 if shared else 1)
            idx = n if name == "galois_banks" else rows.numel()
            label = f"{name} {tuple(x.shape)}" + (" -> R=8" if shared else "")
            cases[label] = kern
            cases[f"{label} (library)"] = lib
            words[label] = x.numel() + idx + out
    if args.only:
        cases = {k: v for k, v in cases.items() if any(o in k for o in args.only)}
    times = {name: graph_ms(fn) for name, fn in cases.items()}
    bound = {name: w * 4 / HBM_BYTES_PER_S * 1e3 for name, w in words.items()
             if name in times}
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "gpu": gpu, "ms": times, "bound_ms": bound}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
