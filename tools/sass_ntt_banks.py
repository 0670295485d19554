#!/usr/bin/env python3
"""Count the SASS instructions of the NTT banks kernels, as built.

    python3 tools/sass_ntt_banks.py [LIBRARY]

Two reports.  First, what one butterfly costs as compiled: a probe
kernel runs a chain of 16 and of 32 of the banks' own operations
(``ntt_regs::Arith``: the forward and inverse butterfly, the stage
multiply used for the pre-weight and epilogue, and the band reduce) on
one pair of registers, for each lane (u32, u16) and mode (lazy, eager);
the instructions of the 32-chain less those of the 16-chain, over 16,
are the operation's own integer instructions (chip_smoke.py's
``BFLY_OPS`` and ``MUL_OPS`` come from this count).  Second, for each
instantiation of the row body at the main paths' rings (u32 and u16
lanes, n = 128 and 256, lazy and eager) and the column body at 2^17 in
LIBRARY (default: the newest build/kernels/libntt_banks-*.so, built by
``repro_torch.kernels.build``), the static instruction count, the count
by opcode, the butterflies one thread runs (the row body's last template
argument is its register bits: 4 for 16 words a thread, 2 for the
small-batch body's 4), and the static integer-ALU instructions per
butterfly over every branch (an upper bound of the stage loop's).
The probe is built under build/sass_probe/.  Needs the CUDA toolkit
(``nvcc``, ``cuobjdump``, ``c++filt``).
"""
from __future__ import annotations

import collections
import glob
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
CUDA_BIN = "/usr/local/cuda/bin"
ALU = ("IMAD", "IADD3", "VIADDMNMX", "ISETP", "SEL", "LOP3", "SHF", "LEA", "VIADD",
       "IMNMX", "PRMT")
NOT_WORK = ("NOP", "BRA", "EXIT")
# (kernel name fragment, butterflies per thread)
WANT = {"ntt_rows_kernel<unsigned int, true, true, 7, 7, 4>": 7 * 8,
        "ntt_rows_kernel<unsigned int, false, true, 7, 7, 4>": 7 * 8,
        "ntt_rows_kernel<unsigned int, true, false, 7, 7, 4>": 7 * 8,
        "ntt_rows_kernel<unsigned int, true, false, 7, 7, 2>": 7 * 2,
        "ntt_rows_kernel<unsigned short, true, true, 8, 8, 4>": 7 * 8,
        "ntt_rows_kernel<unsigned short, true, false, 8, 8, 4>": 7 * 8,
        "ntt_rows_kernel<unsigned int, true, true, 12, 17, 4>": 12 * 8,
        "ntt_cols_kernel<true, true, 5, 17>": 5 * 16}
OPS = ("fwd", "inv", "mul", "band")
PROBE = r"""
#include <cstdint>
#include "ntt_regs.cuh"
template <typename T, bool kLazy, int kOp, int kN>
__global__ void probe(uint32_t* d) {
  const ntt_regs::Arith<T, kLazy> a{d[0], d[1]};
  const int i = threadIdx.x;
  uint32_t x = d[i + 64], y = d[i + 128];
  const uint32_t w = d[i + 192], wp = d[i + 256];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if constexpr (kOp == 0) a.fwd(x, y, w, wp);
    else if constexpr (kOp == 1) a.inv(x, y, w, wp);
    else if constexpr (kOp == 2) x = a.mul(x, w, wp);
    else x = ntt_regs::Arith<T, kLazy>::band(x, a.q);
  }
  d[i + 64] = x;
  d[i + 128] = y;
}
"""


def tool(name: str) -> str:
    return shutil.which(name) or os.path.join(CUDA_BIN, name)


def functions(sass: str):
    """(demangled name, opcode list) of every function in a SASS dump."""
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        mangled = block.split("\n", 1)[0].strip()
        name = subprocess.run([tool("c++filt"), mangled], capture_output=True, text=True,
                              check=True).stdout.strip()
        yield name, re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                               block)


def probe_counts() -> None:
    out = os.path.join(ROOT, "build", "sass_probe")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "probe.cu")
    lines = [PROBE]
    for t in ("uint32_t", "uint16_t"):
        for lazy in ("true", "false"):
            for op in range(len(OPS)):
                for n in (16, 32):
                    lines.append(f"template __global__ void probe<{t}, {lazy}, {op}, {n}>"
                                 "(uint32_t*);")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    cubin = os.path.join(out, "probe.cubin")
    subprocess.run([tool("nvcc"), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", CSRC, "-o", cubin, src], check=True)
    sass = subprocess.run([tool("cuobjdump"), "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    kernels = {}
    for name, ops in functions(sass):
        m = re.search(r"probe<(unsigned \w+), (\w+), (\d), (\d+)>", name)
        if m:
            work = [o for o in ops if o.split(".")[0] not in NOT_WORK]
            kernels[(m.group(1), m.group(2), int(m.group(3)), int(m.group(4)))] = work
    for lane in ("unsigned int", "unsigned short"):
        for lazy in ("true", "false"):
            for k, op in enumerate(OPS):
                short, long_ = kernels[(lane, lazy, k, 16)], kernels[(lane, lazy, k, 32)]
                diff = collections.Counter(long_) - collections.Counter(short)
                print(f"probe {lane} {'lazy' if lazy == 'true' else 'eager'} {op}: "
                      f"{(len(long_) - len(short)) / 16:g} instructions each "
                      f"({dict(sorted((o, c / 16) for o, c in diff.items()))})")


def built_kernels(libs) -> None:
    sass = subprocess.run([tool("cuobjdump"), "-sass", libs[-1]], capture_output=True,
                          text=True, check=True).stdout
    for name, ops in functions(sass):
        hit = next((k for k in WANT if k in name), None)
        if hit is None:
            continue
        by = collections.Counter(o.split(".")[0] for o in ops)
        alu = sum(by[o] for o in ALU)
        print(f"{hit}: {len(ops)} instructions, {WANT[hit]} butterflies a thread, "
              f"{alu / WANT[hit]:.1f} integer-ALU instructions per butterfly "
              f"(static), {by['LDG'] / WANT[hit]:.2f} LDG per butterfly; "
              f"{dict(by.most_common(14))}")


def main() -> int:
    probe_counts()
    libs = sys.argv[1:] or sorted(glob.glob(os.path.join(ROOT, "build", "kernels",
                                                         "libntt_banks-*.so")),
                                  key=os.path.getmtime)[-1:]
    if not libs:
        print("sass_ntt_banks: no built libntt_banks library", file=sys.stderr)
        return 1
    built_kernels(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
