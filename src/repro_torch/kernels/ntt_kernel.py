"""Wrappers of the NTT kernels: the multi-prime banks (``csrc/ntt_banks.cu``)
and the single-prime transforms (``csrc/ntt.cu``).

``ntt_fwd_banks`` / ``ntt_inv_banks`` / ``twiddle_mul_banks`` replace the
TPU kernels ``ntt_fwd_banks_pallas`` / ``ntt_inv_banks_pallas`` /
``twiddle_mul_banks_pallas`` of the reference's ``kernels/ntt_kernel.py``.
A CPU tensor goes to the plain version in ``kernels.ref``; a CUDA tensor
launches the kernel on the current stream or raises; a ``meta`` tensor
(shapes only: a dry run, ``runtime.op_cost``) passes the same checks and
gets an empty output of the kernel's shape, recorded as one launch with
its bytes and integer instructions (``meta_launch``).  Each wrapper checks
device, dtype, shape and contiguity, allocates its output with
``torch.empty`` and counts its launches in ``kernels.COUNTS``.

The two transforms take either lane, chosen by the dtype as the
reference chooses by uint32/uint16: int32 tensors run the RNS lane,
int16 tensors (ML-KEM's q = 3329 ring, ``core.ringspec``) the 16-bit
Shoup lane, launched as ``ntt_fwd_banks_u16`` / ``ntt_inv_banks_u16`` and
counted apart.  Every tensor of one call must share the lane: a u16 pack
run through the u32 formulas would give wrong numbers with no error, so
a mix is refused with ``KernelRefusal`` (a ``ValueError``) on every
device.

On the card a u32 ring of up to 4096 words is one launch of the
register-resident body; a larger one (up to ``MAX_N`` = 2^17) runs two
passes through a scratch tensor this module allocates, still one launcher
call and one count.

``ntt_fourstep_banks`` / ``intt_fourstep_banks`` are the four-step
forward and inverse transforms of rings of 2^10 .. 2^17 words on the
card: two passes of ``csrc/fourstep.cu`` each, in place of the
reference's chains of weight-row multiplies, bank passes, transposes and
bit-reversal gathers (which are their plain versions).

``ntt_fwd`` / ``ntt_inv`` replace the single-prime TPU kernels
``ntt_fwd_pallas`` / ``ntt_inv_pallas``: one prime's ``NTTParams``, a
(B, n) int32 batch, every log2(n) stage.  Their tables go to the tensor's
device once per (n, q, psi, device), as a one-prime bank in the TablePack
layout (``single_prime_bank``).  Rings of ``MIN_N_STREAM`` = 64 to
``MAX_N_SINGLE`` = 4096 words whose rows start on a 16-byte boundary
launch ``csrc/ntt.cu`` (the row stream, whose bulk copies need that
alignment); every other call, up to ``MAX_N``, runs that bank on the u32
banks launcher (its row body, and two passes through scratch above 4096
words) and counts one launch of ``ntt_fwd_banks`` / ``ntt_inv_banks``
(``on_banks``).  The single-prime lane is uint32 only, so an int16 tensor
is refused on every device.
"""
from __future__ import annotations

import torch

from repro_torch.convert import u32_to_tensor
from repro_torch.core.ntt import device_tables
from repro_torch.kernels import COUNTS, KernelRefusal, LaunchError, build, ref
from repro_torch.runtime import op_cost
from repro_torch.runtime.roofline import MUL_OPS, banks_int_ops

MAX_N = 1 << 17       # banks, u32 lane: two passes of at most 32 and 4096 words
MAX_N_ROW = 4096      # the largest ring one launch transforms (no scratch)
MAX_N_U16 = 4096      # banks, u16 lane: the largest ring it has (see below)
MIN_N_STREAM = 64     # csrc/ntt.cu: the smallest ring of a 16-byte-aligned tile row
MAX_N_SINGLE = 4096   # csrc/ntt.cu: the largest ring of one tile row
# csrc/fourstep.cu: the (n1, n2) splits of 2^10 .. 2^17 (core.params.fourstep_split)
FOURSTEP_SPLITS = tuple((1 << (s - s // 2), 1 << (s // 2)) for s in range(10, 18))


LANES = {torch.int32: "uint32", torch.int16: "uint16"}


def check_tensors(where: str, device: torch.device, *,
                  dtype: torch.dtype = torch.int32, **tensors) -> None:
    """Every tensor of ``dtype`` (int32 or int16 bit patterns),
    contiguous and on ``device`` (a CUDA device, or ``meta`` for a
    wrapper's meta branch)."""
    if device.type not in ("cuda", "meta"):
        raise KernelRefusal(f"{where}: CUDA tensors expected, got device {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise KernelRefusal(f"{where}: {name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise KernelRefusal(f"{where}: {name} must be {dtype} ({LANES[dtype]} "
                                f"bit patterns), got {t.dtype}")
        if not t.is_contiguous():
            raise KernelRefusal(f"{where}: {name} must be contiguous")


def check_lane(where: str, **tensors) -> torch.dtype:
    """The one lane dtype (int32 or int16) every tensor of a call shares;
    a mix, or any other dtype, is refused."""
    dtypes = {name: t.dtype for name, t in tensors.items()}
    lanes = set(dtypes.values())
    if len(lanes) != 1 or not lanes <= set(LANES):
        raise KernelRefusal(f"{where}: every tensor must be int32 (the uint32 lane) "
                            f"or every tensor int16 (the uint16 lane), got {dtypes}")
    return lanes.pop()


def check_shape(where: str, name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise KernelRefusal(f"{where}: {name} has shape {tuple(t.shape)}, "
                            f"expected {tuple(shape)}")


def _check_geometry(where: str, x: torch.Tensor, stages: int) -> tuple[int, int, int]:
    if x.ndim != 3:
        raise KernelRefusal(f"{where}: x must be (k, B, n), got {tuple(x.shape)}")
    k, b, n = x.shape
    if x.dtype == torch.int16 and n > MAX_N_U16:
        # a u16 ring (core.ringspec) has q < 2^12 and block 1 or 2, and
        # needs 2n / block | q - 1, so none has n > 4096
        raise KernelRefusal(f"{where}: n={n} on the u16 lane: its moduli lie below "
                            f"2^12, so 2n/block does not divide q - 1 for any n > "
                            f"{MAX_N_U16}")
    if n < 2 or n > MAX_N or n & (n - 1):
        raise KernelRefusal(f"{where}: n={n} must be a power of two in [2, {MAX_N}]: "
                            "above it the column pass would hold more than 32 "
                            "words a thread")
    if not 0 <= stages <= n.bit_length() - 1:
        raise KernelRefusal(f"{where}: {stages} stages for n={n}")
    return k, b, n


def meta_launch(where: str, out: torch.Tensor, reads, int_ops: int = 0,
                extra_bytes: int = 0) -> torch.Tensor:
    """A wrapper's meta branch, after the checks its CUDA branch makes:
    ``out`` (empty, the kernel's output shape and dtype) recorded in the
    op counter as one launch of ``where`` that reads ``reads`` and writes
    ``out`` once.  Shapes only: nothing is computed, and a CUDA or CPU
    tensor never reaches this."""
    op_cost.record_kernel(where, reads, [out], int_ops, extra_bytes)
    return out


def raise_on(where: str, rc: int) -> None:
    if rc != 0:
        raise LaunchError(f"{where}: kernel launch failed with CUDA error {rc}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _scratch(x: torch.Tensor) -> torch.Tensor | None:
    """The two-pass route's scratch tensor, for rings above ``MAX_N_ROW``."""
    return torch.empty_like(x) if x.shape[-1] > MAX_N_ROW else None


def _scratch_bytes(scratch: torch.Tensor | None) -> int:
    """The two-pass route's traffic through its scratch: written by the
    first pass, read by the second."""
    return 0 if scratch is None else 2 * scratch.numel() * scratch.element_size()


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def ntt_fwd_banks(x, qs, tw, twp, psi, psip, *, negacyclic: bool,
                  lazy: bool, reduce_out: bool):
    """x: (k, B, n) int32 or int16, row p reduced mod qs[p]; tw/twp
    (k, s, n/2) with s <= log2 n stages; psi/psip (k, n).  Returns the
    forward transform, bitrev order."""
    lane = check_lane("ntt_fwd_banks", x=x, qs=qs, tw=tw, twp=twp, psi=psi,
                      psip=psip)
    if x.device.type == "cpu":
        return ref.ntt_fwd_banks_ref(x, qs, tw, twp, psi, psip, negacyclic,
                                     lazy=lazy, reduce_out=reduce_out)
    where = "ntt_fwd_banks" + ("_u16" if lane == torch.int16 else "")
    stages = tw.shape[1] if tw.ndim == 3 else -1
    k, b, n = _check_geometry(where, x, stages)
    check_tensors(where, x.device, dtype=lane, x=x, qs=qs, tw=tw, twp=twp,
                  psi=psi, psip=psip)
    check_shape(where, "qs", qs, (k,))
    for name, t in (("tw", tw), ("twp", twp)):
        check_shape(where, name, t, (k, stages, n // 2))
    for name, t in (("psi", psi), ("psip", psip)):
        check_shape(where, name, t, (k, n))
    out = torch.empty_like(x)
    if x.device.type == "meta":
        scratch = _scratch(x)
        return meta_launch(where, out, [x, qs, tw, twp] + ([psi, psip] if negacyclic else []),
                           banks_int_ops(x, stages, fwd=True, negacyclic=negacyclic,
                                         lazy=lazy, reduce_out=reduce_out),
                           _scratch_bytes(scratch))
    lib = build.load("ntt_banks")
    if x.numel() == 0:
        return out
    scratch = _scratch(x)
    rc = getattr(lib, where)(x.data_ptr(), out.data_ptr(), qs.data_ptr(),
                             tw.data_ptr(), twp.data_ptr(), psi.data_ptr(),
                             psip.data_ptr(), k, b, n, stages, int(negacyclic),
                             int(lazy), int(reduce_out), _ptr(scratch), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


def ntt_inv_banks(x, qs, ninv, ninv_p, itw, itwp, post, postp, *,
                  negacyclic: bool, lazy: bool, reduce_out: bool):
    """x: (k, B, n) int32 or int16 in bitrev order; itw/itwp (k, s, n/2);
    ninv, ninv_p (k,); post/postp (k, n) psi^-i * n^-1 rows."""
    lane = check_lane("ntt_inv_banks", x=x, qs=qs, ninv=ninv, ninv_p=ninv_p,
                      itw=itw, itwp=itwp, post=post, postp=postp)
    if x.device.type == "cpu":
        return ref.ntt_inv_banks_ref(x, qs, ninv, ninv_p, itw, itwp, post,
                                     postp, negacyclic, lazy=lazy,
                                     reduce_out=reduce_out)
    where = "ntt_inv_banks" + ("_u16" if lane == torch.int16 else "")
    stages = itw.shape[1] if itw.ndim == 3 else -1
    k, b, n = _check_geometry(where, x, stages)
    check_tensors(where, x.device, dtype=lane, x=x, qs=qs, ninv=ninv,
                  ninv_p=ninv_p, itw=itw, itwp=itwp, post=post, postp=postp)
    for name, t in (("qs", qs), ("ninv", ninv), ("ninv_p", ninv_p)):
        check_shape(where, name, t, (k,))
    for name, t in (("itw", itw), ("itwp", itwp)):
        check_shape(where, name, t, (k, stages, n // 2))
    for name, t in (("post", post), ("postp", postp)):
        check_shape(where, name, t, (k, n))
    out = torch.empty_like(x)
    if x.device.type == "meta":
        # the epilogue reads the weight rows (negacyclic) or n^-1
        epi = [post, postp] if negacyclic else [ninv, ninv_p]
        scratch = _scratch(x)
        return meta_launch(where, out, [x, qs, itw, itwp] + epi,
                           banks_int_ops(x, stages, fwd=False, negacyclic=negacyclic,
                                         lazy=lazy, reduce_out=reduce_out),
                           _scratch_bytes(scratch))
    lib = build.load("ntt_banks")
    if x.numel() == 0:
        return out
    scratch = _scratch(x)
    rc = getattr(lib, where)(x.data_ptr(), out.data_ptr(), qs.data_ptr(),
                             ninv.data_ptr(), ninv_p.data_ptr(), itw.data_ptr(),
                             itwp.data_ptr(), post.data_ptr(), postp.data_ptr(),
                             k, b, n, stages, int(negacyclic), int(lazy),
                             int(reduce_out), _ptr(scratch), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


def twiddle_mul_banks(x, qs, w, wp, *, lazy: bool):
    """x: (k, B, n) int32 (any u32 representative); w/wp (k, n) weight
    rows + Shoup companions; qs (k,).  out = x * w mod q per prime row."""
    if x.device.type == "cpu":
        return ref.twiddle_mul_banks_ref(x, qs, w, wp, lazy=lazy)
    where = "twiddle_mul_banks"
    if x.ndim != 3:
        raise KernelRefusal(f"{where}: x must be (k, B, n), got {tuple(x.shape)}")
    k, b, n = x.shape
    check_tensors(where, x.device, x=x, qs=qs, w=w, wp=wp)
    check_shape(where, "qs", qs, (k,))
    check_shape(where, "w", w, (k, n))
    check_shape(where, "wp", wp, (k, n))
    out = torch.empty_like(x)
    if x.device.type == "meta":
        return meta_launch(where, out, [x, qs, w, wp], x.numel() * MUL_OPS[(4, lazy)])
    lib = build.load("ntt_banks")
    if x.numel() == 0:
        return out
    rc = lib.twiddle_mul_banks(x.data_ptr(), out.data_ptr(), qs.data_ptr(),
                               w.data_ptr(), wp.data_ptr(), k, b, n,
                               int(lazy), stream())
    raise_on(where, rc)
    COUNTS["twiddle_mul_banks"].launches += 1
    return out


def _fourstep_geometry(where: str, x, fp: dict) -> tuple[int, int, int, int, int]:
    """(k, B, n, n1, n2) of a four-step kernel call on the card, after its
    checks: x (k, B, n) int32 with contiguous rows, n = n1 * n2 a split the
    kernels take."""
    check_u32(where, x=x)
    n1, n2 = fp["pack1"]["tw"].shape[-1] * 2, fp["pack2"]["tw"].shape[-1] * 2
    if (n1, n2) not in FOURSTEP_SPLITS:
        raise KernelRefusal(f"{where}: a {n1} x {n2} split; the kernels take "
                            f"{', '.join(f'{a} x {b}' for a, b in FOURSTEP_SPLITS)}")
    if x.ndim != 3 or x.shape[-1] != n1 * n2:
        raise KernelRefusal(f"{where}: x must be (k, B, {n1 * n2}), got {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise KernelRefusal(f"{where}: x's rows must be contiguous")
    return (*x.shape, n1, n2)


def _fourstep_tables(where: str, x, t: dict, n1: int, n2: int) -> torch.Tensor:
    """Check a four-step call's tables ``t`` (k prime rows each: the
    moduli and n^-1 scalars (k,), weight rows (k, n), the column and row
    passes' stage tables (k, log2 m, m / 2), named ``*1`` for m = n1 and
    ``*2`` for m = n2) and return the call's output: laid out as x where x
    is dense (a batch-leading view's output is contiguous once swapped
    back), else contiguous."""
    k, _, n = x.shape
    stages = lambda m: (k, m.bit_length() - 1, m // 2)
    shapes = {"qs": (k,), "ninv1": (k,), "ninv_p1": (k,), "ninv2": (k,), "ninv_p2": (k,),
              **{name: (k, n) for name in ("psi", "psip", "tw", "twp", "itw", "itwp",
                                          "ipsi", "ipsip")},
              **{name: stages(n1) for name in ("tw1", "twp1", "itw1", "itwp1")},
              **{name: stages(n2) for name in ("tw2", "twp2", "itw2", "itwp2")}}
    check_tensors(where, x.device, **t)
    for name, v in t.items():
        check_shape(where, name, v, shapes[name])
    out = torch.empty_like(x)
    return out if out.stride(-1) == 1 else x.new_empty(x.shape)


def ntt_fourstep_banks(x, fp: dict, *, negacyclic: bool, lazy: bool):
    """x: (k, B, n) int32, row p reduced mod fp['qs'][p], contiguous rows
    and any strides over (prime, ring); fp: a FourStepPack of at least k
    primes with n = n1 * n2.  Returns the forward transform in natural
    order, in [0, q): the plain chain on the CPU (``ref.fourstep_chain``);
    on the card the two passes of ``csrc/fourstep.cu`` through a scratch
    tensor allocated here, one count, into an output laid out as x where
    x is dense (a batch-leading view's output is contiguous once swapped
    back), else contiguous.  The card takes the balanced splits of 2^10
    .. 2^17 (``FOURSTEP_SPLITS``)."""
    if x.device.type == "cpu":
        return ref.ntt_fourstep_banks_ref(x, fp, negacyclic, lazy=lazy)
    where = "ntt_fourstep_banks"
    k, b, n, n1, n2 = _fourstep_geometry(where, x, fp)
    # the tables the passes read, k prime rows each: psi and the step-3
    # twiddle (k, n), the column and row passes' stage tables
    t = {"qs": fp["qs"][:k], "psi": fp["psi"][:k], "psip": fp["psip"][:k],
         "tw1": fp["pack1"]["tw"][:k], "twp1": fp["pack1"]["twp"][:k],
         "tw": fp["tw"][:k], "twp": fp["twp"][:k],
         "tw2": fp["pack2"]["tw"][:k], "twp2": fp["pack2"]["twp"][:k]}
    out = _fourstep_tables(where, x, t, n1, n2)
    if x.device.type == "meta":
        # pass 1 reads x (and psi) and the tables, writes scratch; pass 2
        # reads scratch and its tables, writes out
        reads = [x] + [t[a] for a in ("qs", "tw1", "twp1", "tw", "twp", "tw2", "twp2")]
        ops = (banks_int_ops(x, n1.bit_length() - 1, fwd=True, negacyclic=negacyclic,
                             lazy=lazy, reduce_out=False)
               + x.numel() * MUL_OPS[(4, lazy)]
               + banks_int_ops(x, n2.bit_length() - 1, fwd=True, negacyclic=False,
                               lazy=lazy, reduce_out=True))
        return meta_launch(where, out, reads + ([t["psi"], t["psip"]] if negacyclic else []),
                           ops, 2 * x.numel() * x.element_size())
    lib = build.load("fourstep")
    if x.numel() == 0:
        return out
    scratch = x.new_empty((k, b, n))
    rc = lib.ntt_fourstep_banks(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        *(t[a].data_ptr() for a in ("qs", "psi", "psip", "tw1", "twp1", "tw", "twp", "tw2",
                                    "twp2")),
        k, b, n1, n2, x.stride(0), x.stride(1), out.stride(0), out.stride(1),
        int(negacyclic), int(lazy), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


def intt_fourstep_banks(x, fp: dict, *, negacyclic: bool, lazy: bool):
    """Inverse of ``ntt_fourstep_banks``.  x: (k, B, n) int32 in natural
    order (A_hat[k2*n1 + k1]), row p below fp['qs'][p] (below twice it
    when lazy), contiguous rows and any strides over (prime, ring).
    Returns the inverse transform in [0, q): the plain chain on the CPU
    (``ref.ifourstep_chain``); on the card the two passes of
    ``csrc/fourstep.cu`` (rows, then columns) through a scratch tensor
    allocated here, one count, laid out as ``ntt_fourstep_banks``' output.
    The card takes the splits ``FOURSTEP_SPLITS``."""
    if x.device.type == "cpu":
        return ref.intt_fourstep_banks_ref(x, fp, negacyclic, lazy=lazy)
    where = "intt_fourstep_banks"
    k, b, n, n1, n2 = _fourstep_geometry(where, x, fp)
    p1, p2 = fp["pack1"], fp["pack2"]
    # the row pass's tables (its inverse stages, n2^-1, the inverse
    # step-3 twiddle), then the column pass's (its inverse stages, n1^-1,
    # psi^-i), k prime rows each
    t = {"qs": fp["qs"][:k], "itw2": p2["itw"][:k], "itwp2": p2["itwp"][:k],
         "ninv2": p2["ninv"][:k], "ninv_p2": p2["ninv_p"][:k],
         "itw": fp["itw"][:k], "itwp": fp["itwp"][:k],
         "itw1": p1["itw"][:k], "itwp1": p1["itwp"][:k],
         "ninv1": p1["ninv"][:k], "ninv_p1": p1["ninv_p"][:k],
         "ipsi": fp["ipsi"][:k], "ipsip": fp["ipsip"][:k]}
    out = _fourstep_tables(where, x, t, n1, n2)
    if x.device.type == "meta":
        # pass 1 reads x and its tables, writes scratch; pass 2 reads
        # scratch and its tables (psi^-i when negacyclic), writes out
        reads = [x] + [v for name, v in t.items() if name not in ("ipsi", "ipsip")]
        ops = (banks_int_ops(x, n2.bit_length() - 1, fwd=False, negacyclic=False,
                             lazy=lazy, reduce_out=False)
               + x.numel() * MUL_OPS[(4, lazy)]
               + banks_int_ops(x, n1.bit_length() - 1, fwd=False, negacyclic=False,
                               lazy=lazy, reduce_out=not negacyclic)
               + (x.numel() * MUL_OPS[(4, False)] if negacyclic else 0))
        return meta_launch(where, out, reads + ([t["ipsi"], t["ipsip"]] if negacyclic else []),
                           ops, 2 * x.numel() * x.element_size())
    lib = build.load("fourstep")
    if x.numel() == 0:
        return out
    scratch = x.new_empty((k, b, n))
    rc = lib.intt_fourstep_banks(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), *(v.data_ptr() for v in t.values()),
        k, b, n1, n2, x.stride(0), x.stride(1), out.stride(0), out.stride(1),
        int(negacyclic), int(lazy), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


# ------------------------------------------------------ single prime

def check_u32(where: str, **tensors) -> None:
    """Every tensor int32 (uint32 bit patterns): the single-prime lane has
    no other, on any device."""
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise KernelRefusal(f"{where}: {name} must be int32 (uint32 bit "
                                f"patterns), the single-prime lane, got {t.dtype}")


def _check_single(where: str, x, p) -> tuple[int, int]:
    if x.ndim != 2:
        raise KernelRefusal(f"{where}: x must be (B, n), got {tuple(x.shape)}")
    b, n = x.shape
    if n != p.n:
        raise KernelRefusal(f"{where}: rows of {n} for params of n={p.n}")
    if n < 2 or n > MAX_N or n & (n - 1):
        raise KernelRefusal(f"{where}: n={n} must be a power of two in [2, {MAX_N}]: "
                            f"above {MAX_N_SINGLE} the ring runs on the u32 banks, "
                            f"which stop at {MAX_N}")
    return b, n


_BANKS: dict = {}


def single_prime_bank(p, device) -> dict:
    """Prime ``p``'s tables as a one-prime bank in the TablePack layout
    (``qs``, ``tw``/``twp``, ``psi``/``psip``, ``ninv``/``ninv_p``,
    ``itw``/``itwp``, ``ipsin``/``ipsinp``, each with a leading axis of 1),
    views of ``core.ntt.device_tables``: the tables ``csrc/ntt.cu`` reads,
    and the banks' route of ``ntt_fwd`` / ``ntt_inv``.  On a CUDA device,
    for a ring of the row stream, also the stage tables' thread-major
    copies (``twt``/``twpt``, ``itwt``/``itwpt``), which the library's
    ``ntt_thread_major`` builds once."""
    device = torch.device(device)
    key = (p.n, p.q, p.psi, str(device))
    if key not in _BANKS:
        t = device_tables(p, device)
        bank = {name: t[src][None] for name, src in (
            ("tw", "tw"), ("twp", "twp"), ("psi", "psi_pows"), ("psip", "psi_pows_p"),
            ("itw", "itw"), ("itwp", "itwp"), ("ipsin", "ipsi_ninv"),
            ("ipsinp", "ipsi_ninv_p"))}
        for name, v in (("qs", p.q), ("ninv", p.ninv), ("ninv_p", p.ninv_p)):
            bank[name] = u32_to_tensor([v], device)
        if device.type == "cuda" and MIN_N_STREAM <= p.n <= MAX_N_SINGLE:
            lib = build.load("ntt")
            for fwd, src, srcp, dst, dstp in ((1, "tw", "twp", "twt", "twpt"),
                                              (0, "itw", "itwp", "itwt", "itwpt")):
                bank[dst], bank[dstp] = torch.empty_like(bank[src]), torch.empty_like(bank[srcp])
                raise_on("ntt_thread_major", lib.ntt_thread_major(
                    bank[src].data_ptr(), bank[srcp].data_ptr(), bank[dst].data_ptr(),
                    bank[dstp].data_ptr(), p.n, fwd, stream()))
        _BANKS[key] = bank
    return _BANKS[key]


def on_banks(x: torch.Tensor) -> bool:
    """Whether ``ntt_fwd`` / ``ntt_inv`` of CUDA rows ``x`` (B, n) run as a
    one-prime bank on the banks launchers rather than on ``csrc/ntt.cu``:
    rings outside [``MIN_N_STREAM``, ``MAX_N_SINGLE``], and rows that do
    not start on a 16-byte boundary (the row stream moves them by bulk
    copy)."""
    n = x.shape[-1]
    return not MIN_N_STREAM <= n <= MAX_N_SINGLE or x.data_ptr() % 16 != 0


def _meta_single(where: str, x, p, *, fwd: bool, negacyclic: bool, lazy: bool):
    """The meta branch of ``ntt_fwd`` / ``ntt_inv``: recorded under the
    kernel the card would launch (the banks where the ring is outside the
    row stream's), reading x and the prime's tables (the stage tables and
    the weight rows or n^-1), which the wrapper holds itself."""
    check_tensors(where, x.device, x=x)
    n = x.shape[-1]
    name = where if MIN_N_STREAM <= n <= MAX_N_SINGLE else where + "_banks"
    stages = n.bit_length() - 1
    tables = 2 * stages * (n // 2) + (2 * n if negacyclic else 2 * (not fwd)) + 1
    return meta_launch(name, torch.empty_like(x), [x],
                       banks_int_ops(x, stages, fwd=fwd, negacyclic=negacyclic,
                                     lazy=lazy, reduce_out=True),
                       extra_bytes=4 * tables)


def ntt_fwd(x, p, *, negacyclic: bool, lazy: bool):
    """x: (B, n) int32 in [0, p.q); p: the prime's ``NTTParams``.
    Returns the forward transform in bitrev order, in [0, q) either way.
    On the card where ``on_banks``: one ``ntt_fwd_banks`` launch of a
    one-prime bank with ``reduce_out=True``, counted there."""
    where = "ntt_fwd"
    check_u32(where, x=x)
    if x.device.type == "cpu":
        return ref.ntt_fwd_ref(x, p, negacyclic, lazy=lazy)
    b, n = _check_single(where, x, p)
    if x.device.type == "meta":
        return _meta_single(where, x, p, fwd=True, negacyclic=negacyclic, lazy=lazy)
    if on_banks(x):
        t = single_prime_bank(p, x.device)
        return ntt_fwd_banks(x[None], t["qs"], t["tw"], t["twp"], t["psi"],
                             t["psip"], negacyclic=negacyclic, lazy=lazy,
                             reduce_out=True)[0]
    lib = build.load("ntt")
    check_tensors(where, x.device, x=x)
    t = single_prime_bank(p, x.device)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = lib.ntt_fwd(x.data_ptr(), out.data_ptr(), t["qs"].data_ptr(),
                     t["tw"].data_ptr(), t["twp"].data_ptr(), t["twt"].data_ptr(),
                     t["twpt"].data_ptr(), t["psi"].data_ptr(), t["psip"].data_ptr(), b, n,
                     int(negacyclic), int(lazy), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out


def ntt_inv(x, p, *, negacyclic: bool, lazy: bool):
    """x: (B, n) int32 in bitrev order, any representative below 2q.
    Returns natural order in [0, q): the epilogue multiplies by
    psi^-i * n^-1 (negacyclic) or n^-1 (cyclic) exactly.  On the card
    where ``on_banks``: one ``ntt_inv_banks`` launch of a one-prime bank
    with ``reduce_out=True``, counted there."""
    where = "ntt_inv"
    check_u32(where, x=x)
    if x.device.type == "cpu":
        return ref.ntt_inv_ref(x, p, negacyclic, lazy=lazy)
    b, n = _check_single(where, x, p)
    if x.device.type == "meta":
        return _meta_single(where, x, p, fwd=False, negacyclic=negacyclic, lazy=lazy)
    if on_banks(x):
        t = single_prime_bank(p, x.device)
        return ntt_inv_banks(x[None], t["qs"], t["ninv"], t["ninv_p"], t["itw"],
                             t["itwp"], t["ipsin"], t["ipsinp"],
                             negacyclic=negacyclic, lazy=lazy, reduce_out=True)[0]
    lib = build.load("ntt")
    check_tensors(where, x.device, x=x)
    t = single_prime_bank(p, x.device)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = lib.ntt_inv(x.data_ptr(), out.data_ptr(), t["qs"].data_ptr(),
                     t["ninv"].data_ptr(), t["ninv_p"].data_ptr(), t["itw"].data_ptr(),
                     t["itwp"].data_ptr(), t["itwt"].data_ptr(), t["itwpt"].data_ptr(),
                     t["ipsin"].data_ptr(), t["ipsinp"].data_ptr(), b, n, int(negacyclic),
                     int(lazy), stream())
    raise_on(where, rc)
    COUNTS[where].launches += 1
    return out
