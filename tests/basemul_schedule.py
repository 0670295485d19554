"""The basecase product's launch schedule (``csrc/dyadic_basemul.cu``):
its integer constants parsed from the source and its ``plan()`` in
Python, and seeded operands on moduli of the u16 lane.
``test_torch_basemul_schedule.py`` emulates the kernels on this schedule
on the CPU; ``test_torch_gpu.py`` holds ``plan()`` against the library's
own (``dyadic_basemul_plan``) on the card."""
import re
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/dyadic_basemul.cu"
SMS = 132                   # an H100's SMs (the launcher reads the card's count)
QS = (3329, 2689, 3457)     # u16-lane moduli in the Barrett window (2^10, 2^12)


def _constants():
    """The launcher's integer constants as csrc/dyadic_basemul.cu defines them."""
    out = {}
    for name, expr in re.findall(r"^constexpr (?:int|long long) (k\w+) = ([^;]+);",
                                 SOURCE.read_text(), re.M):
        out[name] = eval(re.sub(r"(\d+)LL", r"\1", expr))
    return out


K = _constants()
PAIRS, VEC_THREADS = K["kPairs"], K["kVecThreads"]
WAVE_BLOCKS, MAX_THREADS = K["kWaveBlocks"], K["kMaxThreads"]
PAIR_THREADS, MAX_PAIR_BLOCKS, MAX_ITEMS = (K["kPairThreads"], K["kMaxPairBlocks"],
                                            K["kMaxItems"])


def plan(k, B, n, aligned=True, sms=SMS):
    """The launcher's plan(): (vector body, pairs an item, threads, items,
    blocks)."""
    rows, h = k * B, n // 2
    if h % PAIRS == 0 and aligned and rows * (h // PAIRS) < MAX_ITEMS:
        items = rows * (h // PAIRS)
        return 1, PAIRS, VEC_THREADS, items, min(-(-items // VEC_THREADS), sms * WAVE_BLOCKS)
    items = rows * h
    return 0, 1, PAIR_THREADS, items, min(-(-items // PAIR_THREADS), MAX_PAIR_BLOCKS)


def operands(k, B, n, seed):
    """a, b (k, B, n), qs, mus (k,), gamma, gammap (k, n/2), all uint16:
    residues below QS[p] on row p, mu = floor(2^26 / q), gammap the Shoup
    companion floor(gamma * 2^16 / q)."""
    rng = np.random.default_rng(seed)
    qs = np.array(QS[:k], np.uint16)
    mus = np.array([(1 << 26) // q for q in QS[:k]], np.uint16)
    g = np.stack([rng.integers(0, q, n // 2) for q in QS[:k]]).astype(np.uint16)
    gp = ((g.astype(np.int64) << 16) // qs[:, None]).astype(np.uint16)
    a, b = (np.stack([rng.integers(0, q, (B, n)) for q in QS[:k]]).astype(np.uint16)
            for _ in range(2))
    return a, b, qs, mus, g, gp
