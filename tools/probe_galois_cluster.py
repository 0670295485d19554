#!/usr/bin/env python3
"""Time two thread-block-cluster designs of the staged Galois gathers on the card.

    python3 tools/probe_galois_cluster.py [--only TEXT ...]

Builds ``tools/galois_cluster_probe.cu`` (nvcc with the port's flags,
into ``build/probe/``) and, at the rotation path's gather calls, times
beside the port's ``galois_banks_multi`` / ``galois_digits`` (lone
blocks, ``csrc/galois.cu``):

- ``dsmem c=C s=S``: a cluster of C blocks stages the source row across
  its blocks' shared memory and every block gathers through distributed
  shared memory (C = 1, 2, 4, 8 where a slice fits one block; in the
  fan-out mode the B gathered rows also split over S clusters, S = 1 and
  the S that puts a block on every SM);
- ``multicast c=C p=P``: the port's runs (its ``plan()``, rounded up to a
  multiple of C), C blocks a cluster sharing one multicast copy of the
  row (C = 1, 2, 4, 8);
- the one PyTorch call that computes the same function (``gather`` or
  ``index_select``) and the byte bound (each input read once, each output
  written once, at 3.35 TB/s).

Cases: ``galois_banks_multi`` (8, 8, n) of a mixed ``rotate_many`` of 8,
and the hoisted R = 8 rotation's digit gather (8, 9, 1, n) and c0 gather
(1, 8, 1, n) fanned out to R = 8, at n = 2^14 and 2^16 (natural-order
rotation rows by 1 .. 8 slots).  Every variant is first held bit for bit
against the library call; one that disagrees or is refused is reported
and not timed, and the tool exits 1 if one disagrees.  ``--only`` keeps
the cases whose name contains one of the texts.  Each time is
``time_ntt_banks.graph_ms`` (10 calls in a CUDA graph, replayed 25
times, the median per-call mean).  Prints a line per variant and one
JSON line with the card's name and power limit.
Imports torch, numpy and this checkout's ``repro_torch`` only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading

from time_ntt_banks import graph_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tools", "galois_cluster_probe.cu")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate (NVIDIA data sheet)
MAX_SLICE = (232448 - 16) // 16 * 4   # the probe's kMaxSlice
CLUSTERS = (1, 2, 4, 8)


def build_probe(build) -> ctypes.CDLL:
    """The probe's library, compiled as the port's sources are."""
    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libgalois_cluster_probe.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", lib_path, SOURCE]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for the probe:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(lib_path)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.probe_dsmem, lib.probe_multicast):
        fn.argtypes = [P, P, P, L, I, I, I, I, I, P]
        fn.restype = I
    lib.probe_opt_in.argtypes = []
    lib.probe_opt_in.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", action="append", default=[],
                    help="time only the cases whose name contains this text")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_galois_cluster: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.params import galois_eval_perm
    from repro_torch.fhe import rns
    from repro_torch.kernels import build, galois_kernel

    # the probe and the port's gathers compile at once
    port = {}
    worker = threading.Thread(target=lambda: port.setdefault("lib", build.load("galois")))
    worker.start()
    lib = build_probe(build)
    worker.join()
    if "lib" not in port:
        raise RuntimeError("the port's gathers did not build")
    if lib.probe_opt_in() != 0:
        raise RuntimeError("probe_opt_in failed")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(19)
    report = {}
    for logn in (14, 16):
        n = 1 << logn
        qs = [int(q) for q in rns.make_primes(n, 9)]
        rows = torch.from_numpy(np.stack([galois_eval_perm(pow(5, r, 2 * n), n, True)
                                          for r in range(1, 9)]).astype(np.int32)).to(dev)
        flat = rows.view(-1)

        def stack(d, b, k):
            return torch.from_numpy(np.stack(
                [np.stack([rng.integers(0, q, (b, n)) for q in qs[:k]]) for _ in range(d)])
                .astype(np.int32)).to(dev)

        x8, dig, c0 = stack(1, 8, 8)[0], stack(8, 1, 9), stack(1, 1, 8)
        cases = [
            (f"galois_banks_multi {tuple(x8.shape)}", x8, False,
             lambda x=x8: galois_kernel.galois_banks_multi(x, rows),
             lambda x=x8: torch.gather(x, 2, rows.expand(x.shape))),
            (f"galois_digits {tuple(dig.shape)} -> R=8", dig, True,
             lambda x=dig: galois_kernel.galois_digits(x, rows, shared=True),
             lambda x=dig: torch.index_select(x.view(-1, n), 1, flat)),
            (f"galois_digits c0 {tuple(c0.shape)} -> R=8", c0, True,
             lambda x=c0: galois_kernel.galois_digits(x, rows, shared=True),
             lambda x=c0: torch.index_select(x.view(-1, n), 1, flat)),
        ]
        for name, x, fan_out, port_fn, lib_fn in cases:
            if args.only and not any(o in name for o in args.only):
                continue
            src_rows = x.numel() // n
            B = rows.shape[0]
            want = lib_fn().reshape(-1)
            out = torch.empty_like(want)
            words = x.numel() + rows.numel() + want.numel()
            parts = port["lib"].galois_bulk_parts(src_rows, n, B, int(fan_out), sms)
            variants = {}
            for c in CLUSTERS:
                if 4 * -(-n // (4 * c)) > MAX_SLICE:
                    continue
                splits = {1}
                if fan_out:
                    splits.add(min(B, -(-sms // (src_rows * c))))
                for s in sorted(splits):
                    variants[f"dsmem c={c} s={s}"] = (lib.probe_dsmem, c, s)
            for c in CLUSTERS:
                variants[f"multicast c={c} p={-(-parts // c) * c}"] = (
                    lib.probe_multicast, c, -(-parts // c) * c)
            ms, wrong = {}, {}
            assert torch.equal(port_fn().reshape(-1), want), name
            ms[f"port (lone blocks, {parts} runs a row)"] = graph_ms(port_fn)
            ms["library"] = graph_ms(lib_fn)
            for label, (fn, c, arg) in variants.items():
                def call(fn=fn, c=c, arg=arg):
                    err = fn(x.data_ptr(), rows.data_ptr(), out.data_ptr(), src_rows, n, B,
                             int(fan_out), c, arg, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"cuda error {err}")
                out.fill_(0)
                try:
                    call()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    wrong[label] = f"refused: {e}"
                    print(f"[probe] {name} {label}: refused ({e})", flush=True)
                    continue
                if not torch.equal(out, want):
                    wrong[label] = "disagrees with the library call"
                    print(f"[probe] {name} {label}: WRONG", flush=True)
                    continue
                ms[label] = graph_ms(call)
            bound = words * 4 / HBM_BYTES_PER_S * 1e3
            for label, t in ms.items():
                print(f"[probe] {name} {label}: {t:.5f} ms ({t / bound:.2f}x bound)",
                      flush=True)
            report[name] = {"ms": ms, "bound_ms": bound, "not_timed": wrong}
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"gpu": gpu, "cases": report}))
    wrong = [k for r in report.values() for k, v in r["not_timed"].items()
             if not v.startswith("refused")]
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
