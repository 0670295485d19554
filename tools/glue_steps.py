#!/usr/bin/env python3
"""Where one key-switch group's device time goes, step by step, on the card.

    python3 tools/glue_steps.py [--src DIR] [--label NAME] [--seed N] [--n16]

DIR is the ``src`` directory of a checkout (default: this repository's),
so two trees can be read in one machine call, in turns, on one card.
The program is the key-switch cell's: ``galois_ks_many_banks`` over a
group of 32 ciphertexts at n = 2^14 with 8 + 1 primes (the four-step
path), one shared gather row and key, run eagerly (the plan's eager
twin runs the same module-level program; a graph replay runs the same
kernels).  ``--n16`` reads the n16-hybrid-keyswitch cell's group
instead: n = 2^16, 24 primes and 6 special primes, hybrid key
switching with dnum = 4 (digits of 6 primes).  One warm call runs under ``torch.profiler``, with a
``record_function`` range around each call of a function that names a
step (``STEPS``); each PyTorch op's device kernels go to the innermost
such range around the op, and the port's own kernels (the
``__global__`` functions of ``csrc/*.cu``) are their own rows.  Prints a table in ms a group and us a request, and one
JSON line with the card's name and power limit.  Imports torch, numpy
and the checkout's ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP = 32            # the engine's full group
# (n, ciphertext primes, special primes): the fig22 cell's group, and
# with --n16 the n16 cell's (alpha = K = 6 primes a digit)
FIG22 = (1 << 14, 8, 1)
N16 = (1 << 16, 24, 6)

# a function of the port -> the glue step its PyTorch ops belong to (the
# innermost such function around an op names its step)
STEPS = {
    "extend_centered": "base extension",
    "decompose_extend": "mod-up stack and transpose",
    "ntt_fourstep_banks": "four-step forward glue",
    "intt_fourstep_banks": "four-step inverse glue",
    "dyadic_inner_banks": "digit MAC glue (outputs only)",
    "mod_down_banks": "mod-down tail",
    "galois_ks_many_back": "final add of c0 and transposes",
    "galois_ks_many_front": "front: transposes",
    "decompose_intt": "digit iNTT glue",
}


def _device_functions(src: str) -> set[str]:
    """The ``__global__`` function names of the checkout's csrc (as the
    benchmark's ``bench/benchlib/trace.py`` finds them)."""
    names = set()
    csrc = os.path.join(src, "repro_torch", "csrc")
    for f in sorted(os.listdir(csrc)):
        if ".cu" in f:
            text = re.sub(r"__launch_bounds__\([^)]*\)", "",
                          open(os.path.join(csrc, f)).read())
            names |= set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return names


def _annotator(torch):
    """A ``sys.setprofile`` hook that opens a ``record_function`` range
    named by the step while a function of ``STEPS`` (of the port) runs,
    so each PyTorch op inside has the step among its profiler parents
    whatever the profiler records of Python calls."""
    open_ranges = []

    def hook(frame, event, arg):
        code = frame.f_code
        if (event == "call" and code.co_name in STEPS
                and "repro_torch" in code.co_filename):
            rf = torch.profiler.record_function(STEPS[code.co_name])
            rf.__enter__()
            open_ranges.append((frame, rf))
        elif event == "return" and open_ranges and open_ranges[-1][0] is frame:
            open_ranges.pop()[1].__exit__(None, None, None)
    return hook


def _frames(event):
    """The names of a profiler event's CPU parents, innermost first."""
    parent = event.cpu_parent
    while parent is not None:
        yield parent.name
        parent = parent.cpu_parent


def _step(event) -> str:
    return next((f for f in _frames(event) if f in STEPS.values()), "other glue")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--n16", action="store_true",
                    help="the n16 cell's hybrid group (2^16, 24 + 6 primes, dnum = 4)")
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("glue_steps: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.params import galois_eval_perm
    from repro_torch.fhe import batched as FB
    from repro_torch.fhe import rns
    from repro_torch.fhe.evalplan import galois_ks_many_banks

    N, k, K = N16 if args.n16 else FIG22
    made = rns.make_primes(N, k + K)
    # the largest K primes are P's (fhe/ckks.py), after the ciphertext's
    specials = tuple(made[:K]) if K > 1 else tuple(made[-1:])
    basis = tuple(made[K:]) if K > 1 else tuple(made[:-1])
    primes = basis + specials
    digits = -(-k // K)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def residues(qs, shape):
        return torch.from_numpy(np.stack([rng.integers(0, q, shape) for q in qs])
                                .astype(np.int32)).to(dev)

    c0 = residues(basis, (GROUP, N)).transpose(0, 1).contiguous()
    c1 = residues(basis, (GROUP, N)).transpose(0, 1).contiguous()
    keys = [torch.stack([residues(primes, (N,)) for _ in range(digits)]) for _ in range(2)]
    idx = torch.from_numpy(galois_eval_perm(5, N, natural=True).astype(np.int32)).to(dev)
    t = rns.scalar_pack(primes, dev)
    if K > 1:
        t = {**t, **FB.build_hybrid_pack(basis, specials, K, dev)}
    fsp = rns.fourstep_basis_pack(primes, N, dev)
    run = lambda: galois_ks_many_banks(c0, c1, idx, *keys, t, fsp)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sys.setprofile(_annotator(torch))
        try:
            run()
        finally:
            sys.setprofile(None)
        torch.cuda.synchronize()
    ours = _device_functions(src)
    events = prof.events()
    # the device's operations, less the steps' own ranges, which the
    # profiler may also draw on the device's timeline
    labels = set(STEPS.values())
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in labels]
    rows = collections.defaultdict(lambda: [0, 0.0])
    for e in device:
        name = next((f for f in ours if f in e.name), None)
        if name is not None:
            rows[f"kernel {name}"][0] += 1
            rows[f"kernel {name}"][1] += e.time_range.elapsed_us()
    linked = 0.0
    unplaced = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        for kern in e.kernels:
            if any(f in kern.name for f in ours):
                continue
            step = _step(e)
            rows[step][0] += 1
            rows[step][1] += kern.duration
            linked += kern.duration
            if step == "other glue":
                unplaced.append((kern.duration, e))
    busy = sum(e.time_range.elapsed_us() for e in device)
    glue = sum(e.time_range.elapsed_us() for e in device
               if not any(f in e.name for f in ours))
    print(f"[{args.label}] one group of {GROUP} (n = {N}, {k} + {K} primes): device busy "
          f"{busy / 1e3:.4f} ms, {busy / GROUP:.3f} us a request; PyTorch glue "
          f"{glue / 1e3:.4f} ms ({100 * glue / busy:.1f}%), of which linked to a step "
          f"{linked / 1e3:.4f} ms")
    for step, (launches, us) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        print(f"[{args.label}]   {step:<40} {launches:4d} launches  {us / 1e3:9.4f} ms  "
              f"{us / GROUP:8.3f} us/request  {100 * us / busy:5.1f}%")
    for us, e in sorted(unplaced, key=lambda p: -p[0])[:3]:
        print(f"[{args.label}]   unplaced: {e.name} {us:.1f} us, frames "
              f"{list(_frames(e))[:8]}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"label": args.label, "n": N, "busy_us": busy, "glue_us": glue,
                      "linked_us": linked, "group": GROUP,
                      "steps": {s: {"launches": n, "us": us} for s, (n, us) in rows.items()},
                      "card": card.stdout.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
