#!/usr/bin/env python3
"""Time ML-KEM's basecase product (``dyadic_basemul_banks``) of one
checkout of the port on the card, beside two yardsticks of the card's
fixed cost per call.

    python3 tools/time_basemul.py [--src DIR] [--label NAME] [--sweep] [--sass]

DIR is the ``src`` directory of a checkout (default: this repository's),
so two trees can be timed in one machine call, in turns (A, B, B, A), on
one card: each builds its own kernels under its own ``build/``.  Cases:
the kernel at the ML-KEM path's shapes (1, B, 256) for B = 2304 and 768
(keygen's and encrypt's products at b = 256) and 9 and 3 (the same at
b = 1), lazy and eager, each first checked bit for bit against the plain
version; beside each shape ``torch.add(a, b, out=c)`` on the same int16
tensors (the same bytes moved, no arithmetic), and an empty kernel of one
block and of the grids the vector body's variants launch at B = 2304.  The yardsticks are not library calls for this function.
Each time is the device time of one call (``time_ntt_banks.graph_ms``: 10
calls captured in a CUDA graph, the graph replayed 25 times between CUDA
events, the median of the per-call mean); each shape also names its byte
bound (each input read once, each output written once, at 3.35 TB/s).

``--sweep`` times launch variants of this repository's vector body
(``tools/basemul_probe.cu``, which includes ``csrc/dyadic_basemul.cu``):
2, 4 or 8 pairs a thread, 64, 128 or 256 threads a block, one item a
thread or a grid of at most one block a SM, lazy, at the same shapes,
each checked against the plain version first.  ``--sass`` counts the
instructions of the built library's vector body (``basemul_vec_kernel``,
lazy and eager): the whole function and its item loop, per pair (an item
is 2, 4 or 8 pairs), and the integer-ALU share (the source of
``chip_smoke.py``'s ``BASEMUL_OPS``).

Prints one JSON line with the card's name and power limit.  Imports
torch, numpy and the checkout's ``repro_torch`` only.  Needs nvcc for the
probe (``--sweep`` and the empty kernel) and cuobjdump for ``--sass``.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

from time_ntt_banks import graph_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
PROBE = os.path.join(ROOT, "tools", "basemul_probe.cu")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)
SHAPES = [(1, 2304, 256), (1, 768, 256), (1, 9, 256), (1, 3, 256)]
ALU = ("IMAD", "IADD3", "VIADDMNMX", "ISETP", "SEL", "LOP3", "SHF", "LEA", "VIADD",
       "IMNMX", "PRMT")
NOT_WORK = ("NOP", "BRA", "EXIT")


def cuda_tool(name: str) -> str:
    from shutil import which
    return which(name) or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                       "bin", name)


def load_probe():
    """Build tools/basemul_probe.cu into build/basemul_probe/ and bind it."""
    out = os.path.join(ROOT, "build", "basemul_probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libbasemul_probe.so")
    subprocess.run([cuda_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", CSRC,
                    "-o", lib, PROBE], check=True)
    probe = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    probe.basemul_variant.argtypes = [P] * 7 + [I] * 7 + [P]
    probe.empty_kernel.argtypes = [I, I, P]
    probe.basemul_variant.restype = probe.empty_kernel.restype = ctypes.c_int
    return probe


def sass_counts(lib: str) -> dict:
    """Instructions of basemul_vec_kernel in ``lib``: the whole function,
    its item loop (from the target of the backward branch to that
    branch), and both per pair, all and integer-ALU."""
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        mangled = block.split("\n", 1)[0].strip()
        name = subprocess.run([cuda_tool("c++filt"), mangled], capture_output=True,
                              text=True, check=True).stdout.strip()
        m = re.search(r"basemul_vec_kernel<(\w+), (\d+), (\w+)>", name)
        if not m:
            continue
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;\n]*)", block)]
        work = [(a, op) for a, op, _ in ins if op.split(".")[0] not in NOT_WORK]
        loop = None
        for a, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < a:
                loop = (int(t.group(1), 16), a)
        body = [o for a, o in work if loop is None or loop[0] <= a <= loop[1]]
        by = collections.Counter(o.split(".")[0] for o in body)
        alu = sum(by[o] for o in ALU)
        pairs = int(m.group(2))
        out[f"basemul_vec_kernel<{m.group(1)}, {m.group(2)}, {m.group(3)}>"] = {
            "function": len(work), "loop": len(body) if loop else None,
            "per_pair": len(body) / pairs, "alu_per_pair": alu / pairs,
            "by_opcode": dict(by.most_common(16))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--sweep", action="store_true",
                    help="also time launch variants of this tree's vector body")
    ap.add_argument("--sass", action="store_true",
                    help="count the built vector body's instructions")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_basemul: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, dyadic_kernel, ref
    from repro_torch.pq import mlkem

    dev = torch.device("cuda")
    t = mlkem._pack(dev)
    gargs = (t["qs"], t["mu"], t["gamma"], t["gammap"])
    rng = np.random.default_rng(20)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    times, bound, checked = {}, {}, []
    probe = load_probe()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in SHAPES:
        a, b = (torch.from_numpy(rng.integers(0, mlkem.Q, shape).astype(np.int16)).to(dev)
                for _ in range(2))
        c = torch.empty_like(a)
        nbytes = 3 * a.numel() * 2 + 2 * t["gamma"].numel() * 2 + 2 * 2
        bound[f"{shape}"] = nbytes / HBM_BYTES_PER_S * 1e3
        for lazy in (True, False):
            want = ref.dyadic_basemul_banks_ref(a, b, *gargs, lazy=lazy)
            if not torch.equal(dyadic_kernel.dyadic_basemul_banks(a, b, *gargs, lazy=lazy),
                               want):
                raise AssertionError(f"dyadic_basemul_banks {shape} lazy={lazy} != plain")
            times[f"dyadic_basemul_banks {shape} lazy={lazy}"] = graph_ms(
                lambda a=a, b=b, lazy=lazy: dyadic_kernel.dyadic_basemul_banks(
                    a, b, *gargs, lazy=lazy))
        times[f"torch.add {shape} (yardstick)"] = graph_ms(
            lambda a=a, b=b, c=c: torch.add(a, b, out=c))
        if not args.sweep:
            continue
        want = ref.dyadic_basemul_banks_ref(a, b, *gargs, lazy=True)
        ptrs = lambda a=a, b=b, c=c: [x.data_ptr() for x in (a, b, c, *gargs)]
        for pairs in (2, 4, 8):
            for threads in (64, 128, 256):
                for cap, what in ((0, "one item a thread"), (sms, "one block a SM")):
                    fn = lambda p=pairs, th=threads, cap=cap: probe.basemul_variant(
                        *ptrs(), shape[0], shape[1], shape[2], 1, p, th, cap, stream())
                    c.fill_(0)
                    if fn() != 0:
                        raise AssertionError(f"variant {pairs}/{threads}/{cap}: launch failed")
                    torch.cuda.synchronize()
                    if not torch.equal(c, want):
                        raise AssertionError(f"variant {pairs}/{threads}/{cap} != plain")
                    checked.append(f"{shape} {pairs}/{threads}/{what}")
                    times[f"variant {shape} {pairs} pairs, {threads} threads, {what}"] = \
                        graph_ms(fn)
    for blocks, threads in ((1, 32), (144, 256), (576, 128), (1152, 128), (2304, 64)):
        times[f"empty kernel <<<{blocks}, {threads}>>> (yardstick)"] = graph_ms(
            lambda b=blocks, th=threads: probe.empty_kernel(b, th, stream()))
    sass = sass_counts(str(build.library_path("dyadic_basemul"))) if args.sass else None
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "gpu": gpu, "ms": times, "bound_ms": bound,
                      "variants_checked": len(checked), "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
