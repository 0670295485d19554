"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain
C interface (one ``nvcc`` per source, all started together):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -I csrc
         -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The libraries go to ``build/kernels/`` at the repository root, keyed by a
hash of every source and header and of the flags, so a second run
reuses them.  Nothing here runs at import time; a missing ``nvcc`` or a
failed build raises ``BuildError`` and nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from repro_torch.kernels import DeviceFault

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("ntt_banks", "dyadic_inner", "galois", "dyadic_basemul", "ntt",
           "dyadic", "basis", "fourstep", "keccak", "mlkem_codec", "mldsa_codec")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint          # a uint32 scalar: a modulus, mu, n^-1 or its companion
# C signature of every launcher: (argtypes) -> cudaError_t as int
SIGNATURES = {
    "ntt_banks": {
        "ntt_fwd_banks": [_P] * 7 + [_I] * 7 + [_P, _P],
        "ntt_inv_banks": [_P] * 9 + [_I] * 7 + [_P, _P],
        "ntt_fwd_banks_u16": [_P] * 7 + [_I] * 7 + [_P, _P],
        "ntt_inv_banks_u16": [_P] * 9 + [_I] * 7 + [_P, _P],
        "twiddle_mul_banks": [_P] * 5 + [_I, _L, _I, _I, _P],
    },
    "dyadic_inner": {
        # ext, key0, key1 with their (digit, prime, batch) strides; out0, out1
        # with their (prime, batch) strides; qs, mus; d, k, b, n, lazy, and
        # the moduli's Barrett trait (32 or 23)
        "dyadic_inner_banks": [_P, _L, _L, _L] * 3 + [_P, _L, _L] * 2 + [_P, _P]
                              + [_I] * 6 + [_P],
    },
    "galois": {
        "galois_banks": [_P] * 3 + [_I] * 3 + [_P],
        "galois_banks_multi": [_P] * 3 + [_I] * 3 + [_P],
        "galois_digits": [_P] * 3 + [_I] * 5 + [_P],
        "galois_bulk_parts": [_L] + [_I] * 4,
    },
    "dyadic_basemul": {
        "dyadic_basemul_banks": [_P] * 7 + [_I] * 4 + [_P],
        "dyadic_basemul_plan": [_I] * 5 + [_P],
    },
    "ntt": {
        "ntt_fwd": [_P] * 9 + [_I] * 4 + [_P],
        "ntt_inv": [_P] * 11 + [_I] * 4 + [_P],
        "ntt_thread_major": [_P] * 4 + [_I, _I, _P],
    },
    "dyadic": {
        "dyadic_mul": [_P] * 3 + [_U, _U, _L, _P],
        "dyadic_mac": [_P] * 4 + [_U, _U, _L, _I, _P],
    },
    "basis": {
        "extend_centered": [_P] * 4 + [_I, _I, _L, _P],
        # x, out, then the conversion table's src, sq, w, wp, cnt, mat, copy, dst
        "base_conv": [_P] * 10 + [_I, _I, _I, _L, _P],
        # acc, extn, add (+ badd), out: a pointer and its (prime, batch) strides
        "mod_down_tail": [_P, _L, _L] * 3 + [_L, _P, _L, _L] + [_P] * 3
                         + [_I, _L, _I, _P],
    },
    "fourstep": {
        # x, out, scratch, qs, then psi, tw1, tw and tw2 with their companions;
        # k, b, n1, n2; the (prime, ring) strides of x and out; the flags
        "ntt_fourstep_banks": [_P] * 12 + [_I] * 4 + [_L] * 4 + [_I, _I, _P],
        # x, out, scratch, qs, then the row pass's stage tables, n2^-1 and
        # the inverse twiddle, the column pass's stage tables, n1^-1 and
        # psi^-i, each with its companion; the rest as the forward's
        "intt_fourstep_banks": [_P] * 16 + [_I] * 4 + [_L] * 4 + [_I, _I, _P],
    },
    "keccak": {
        # a, its row stride and length; b likewise; extra, rate, suffix;
        # out, out_len, rows
        "keccak_hash": [_P, _L, _I, _P, _L, _I, _I, _I, _I, _P, _I, _I, _P],
        "keccak_sample_ntt": [_P, _L, _P, _I, _I, _P],
        "keccak_prf_cbd": [_P, _L, _I, _I, _P, _I, _P],
        # rho and its stride, kappa, out, rows
        "keccak_expand_mask": [_P, _L, _P, _P, _I, _P],
        "keccak_sample_in_ball": [_P, _L, _P, _I, _P],
        "keccak_rej_ntt_poly": [_P, _L, _P, _I, _P],
        "keccak_rej_bounded": [_P, _L, _I, _I, _P, _I, _P],
        # tr, key, msg with its stride and length, rnd and its stride,
        # slots, reqs, count, mu_out, rho_out, rows
        "keccak_mu_rho": [_P, _P, _P, _L, _I, _P, _L] + [_P] * 5 + [_I, _P],
    },
    "mlkem_codec": {
        # ek and its row stride, t_hat, ok, rows
        "mlkem_decode_check": [_P, _L, _P, _P, _I, _P],
        # u, v, e, m and its stride, kr and its stride, ok, key, ct, rows
        "mlkem_encaps_tail": [_P] * 4 + [_L, _P, _L] + [_P] * 3 + [_I, _P],
    },
    "mldsa_codec": {
        # w, out, rows
        "mldsa_w1_encode": [_P, _P, _I, _P],
        # y, w, cs, active, ok, rows
        "mldsa_check": [_P] * 5 + [_I, _P],
        # ct and its stride, y, w, cs, dest, ids, kappa, ring, ring_ids,
        # ring_iters, rows, ring rows
        "mldsa_emit": [_P, _L] + [_P] * 9 + [_I, _L, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class BuildError(DeviceFault, RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def find_nvcc() -> str | None:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or shutil.which(os.path.join(cuda_home, "bin", "nvcc"))


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every named source that has no library yet, one ``nvcc``
    process per source, all running at once.  Returns, per source, the
    wall seconds until its build was collected and nvcc's output (the
    ``-Xptxas -v`` register and shared-memory report); a library that
    was already there reports 0.0 and no log."""
    todo = [n for n in names if not library_path(n).exists()]
    done = {n: {"seconds": 0.0, "log": ""} for n in names}
    if not todo:
        return done
    nvcc = find_nvcc()
    if nvcc is None:
        raise BuildError("nvcc not found: the CUDA kernels cannot be built "
                         "(set CUDA_HOME or put nvcc on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        done[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise BuildError("\n".join(errors))
    return done


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one source's library, built at first use,
    with every launcher's argtypes and restype declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as e:
                raise BuildError(f"cannot load {library_path(name)}: {e}") from e
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
