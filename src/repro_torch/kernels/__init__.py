"""Hand-written Hopper kernels, their plain PyTorch versions and the
entry points over both.

Dispatch rule, in every wrapper: a tensor on the CPU goes to the plain
version; a CUDA tensor launches the kernel or raises.  Nothing catches
a build or launch failure to fall back.  A ``meta`` tensor (shapes only,
a dry run's) passes the CUDA branch's checks and gets an empty output,
recorded in ``runtime.op_cost``'s counter and not in ``COUNTS``: nothing
is computed, so it is no fallback.

``COUNTS`` records, per kernel, how many times its wrapper launched it
(``launches``) and how many times its plain version ran
(``plain_calls``), so a run can show which path it took.  The two NTT
bank kernels count each lane apart (``ntt_fwd_banks`` for the int32 RNS
lane, ``ntt_fwd_banks_u16`` for the int16 small-ring lane, likewise the
inverse), so a run shows which instantiation it launched.  The
single-prime kernels (``ntt_fwd``, ``ntt_inv``, ``dyadic_mul``,
``dyadic_mac``: the paper's NTT-128 unit and its Barrett MM/MA) are
counted apart from the banks kernels.  ``extend_centered`` and
``mod_down_tail`` are the key switch's two RNS base conversions (the
mod-up and the mod-down's tail), which have no TPU kernel; ``base_conv``
is the fast base conversion of hybrid key switching (its mod-up and the
mod-down's conversion of the special primes), which the reference does
not have.  ``ntt_fourstep_banks`` and ``intt_fourstep_banks`` are the
four-step forward and inverse transforms' two passes each (one count a
call), which replace the reference's chains of XLA ops and bank kernels.
``keccak_hash``, ``keccak_sample_ntt`` and ``keccak_prf_cbd`` are
Keccak-f[1600]'s sponges (ML-KEM's H, G and J; SampleNTT; PRF fused
with CBD), which replace the reference's host ``hashlib`` calls;
``mlkem_decode_check`` and ``mlkem_encaps_tail`` are ML-KEM's byte codecs
around encryption (the key's decode with FIPS 203 §7.2's check; the
ciphertext's compress and encode), which replace its host numpy.
``keccak_expand_mask``, ``keccak_sample_in_ball``, ``keccak_rej_ntt_poly``,
``keccak_rej_bounded`` and ``keccak_mu_rho`` are ML-DSA's samplers
(ExpandMask, SampleInBall, ExpandA, ExpandS) and its signing stream's
refill hashes; ``mldsa_w1_encode``, ``mldsa_check`` and ``mldsa_emit``
its codec around the signing loop (w1Encode, the bounds, sigEncode
into the output ring).  None replaces a TPU kernel.

Faults of the device path have classes of their own (``DeviceFault``):
a build that fails (``build.BuildError``), a launcher that returns a CUDA
error (``LaunchError``), a wrapper that refuses a tensor its kernel does
not take (``KernelRefusal``, a ``ValueError``), and a CUDA graph that
cannot be captured (``GraphError``).  ``is_device_fault`` also knows
torch's own CUDA errors, so a caller that isolates a client's failure
(``fhe.serve``) can re-raise every fault of the card instead of
recording it against a request.
"""
from __future__ import annotations

import dataclasses

import torch

KERNELS = ("ntt_fwd_banks", "ntt_inv_banks", "twiddle_mul_banks",
           "dyadic_inner_banks", "galois_banks", "galois_banks_multi",
           "galois_digits", "ntt_fwd_banks_u16", "ntt_inv_banks_u16",
           "dyadic_basemul_banks", "ntt_fwd", "ntt_inv", "dyadic_mul",
           "dyadic_mac", "extend_centered", "mod_down_tail", "base_conv",
           "ntt_fourstep_banks", "intt_fourstep_banks", "keccak_hash",
           "keccak_sample_ntt", "keccak_prf_cbd", "mlkem_decode_check",
           "mlkem_encaps_tail", "keccak_expand_mask", "keccak_sample_in_ball",
           "keccak_rej_ntt_poly", "keccak_rej_bounded", "keccak_mu_rho",
           "mldsa_w1_encode", "mldsa_check", "mldsa_emit")


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


class DeviceFault(Exception):
    """Base of the port's device-path faults."""


class KernelRefusal(DeviceFault, ValueError):
    """A kernel wrapper refuses a tensor its kernel does not take."""


class LaunchError(DeviceFault, RuntimeError):
    """A kernel launcher returned a CUDA error."""


class GraphError(DeviceFault, RuntimeError):
    """A CUDA graph of a scheme program could not be captured."""


def is_device_fault(e: BaseException) -> bool:
    """True for a fault of the device path rather than of a request: the
    port's ``DeviceFault`` classes, torch's out-of-memory and accelerator
    (CUDA runtime) errors, and any other ``RuntimeError`` whose message
    names CUDA (some of torch's checks raise a plain one)."""
    return (isinstance(e, (DeviceFault, torch.OutOfMemoryError, torch.AcceleratorError))
            or (isinstance(e, RuntimeError) and "CUDA" in str(e)))
