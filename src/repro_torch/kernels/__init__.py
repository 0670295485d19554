"""Hand-written Hopper kernels, their plain PyTorch versions and the
entry points over both.

Dispatch rule, in every wrapper: a tensor on the CPU goes to the plain
version; a CUDA tensor launches the kernel or raises.  Nothing catches
a build or launch failure to fall back.

``COUNTS`` records, per kernel, how many times its wrapper launched it
(``launches``) and how many times its plain version ran
(``plain_calls``), so a run can show which path it took.
"""
from __future__ import annotations

import dataclasses

KERNELS = ("ntt_fwd_banks", "ntt_inv_banks", "twiddle_mul_banks",
           "dyadic_inner_banks", "galois_banks", "galois_banks_multi",
           "galois_digits")


@dataclasses.dataclass
class Counts:
    launches: int = 0
    plain_calls: int = 0


COUNTS = {name: Counts() for name in KERNELS}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0
        c.plain_calls = 0


def snapshot() -> dict[str, dict[str, int]]:
    return {name: dataclasses.asdict(c) for name, c in COUNTS.items()}
