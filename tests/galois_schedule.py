"""The staged Galois gathers' launch schedule (``csrc/galois.cu``): its
integer constants parsed from the source and its ``plan()`` in Python.
``test_torch_galois_staged.py`` emulates the kernel on this schedule on
the CPU; ``test_torch_gpu.py`` holds ``plan()`` against the library's own
(``galois_bulk_parts``) on the card."""
import re
from pathlib import Path

SOURCE = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/galois.cu"
SMS = 132           # an H100's SMs (the launcher reads the card's count)


def _constants():
    """The launcher's integer constants as csrc/galois.cu defines them."""
    out = {}
    for name, expr in re.findall(r"^constexpr (?:int|unsigned|uint32_t|long long) (k\w+) = ([^;]+);",
                                 SOURCE.read_text(), re.M):
        expr = re.sub(r"\bk\w+\b", lambda m: str(out[m.group(0)]), expr)
        out[name] = eval(expr.replace("/", "//"))
    return out


K = _constants()
BUFS, BAR_BYTES, MAX_SMEM = K["kBufs"], K["kBarBytes"], K["kMaxSmemBytes"]
ROW_WORDS, ROW_THREADS, ROW_VEC = K["kRowWords"], K["kRowThreads"], K["kRowVec"]
PIECE_WORDS, PIECE_THREADS, PIECE_VEC = K["kPieceWords"], K["kPieceThreads"], K["kPieceVec"]
TILE, PIECE_SMEM = K["kTile"], K["kPieceSmem"]
WAVE_FACTOR, RECEIVE, MIN_RUN = K["kWaveFactor"], K["kReceive"], K["kMinRun"]
CHUNK, MAX_BLOCKS = K["kChunkBytes"], K["kMaxBlocks"]


def plan(src_rows, n, batch, fan_out, sms=SMS):
    """The runs a source row's work is cut into, as the launcher's plan()."""
    rows = batch if fan_out else 1
    work = rows * (n // 4)
    if n > ROW_WORDS:
        return -(-work // TILE)
    return max(min(RECEIVE * rows, WAVE_FACTOR * sms // src_rows, work // MIN_RUN), 1)


def launch(src_rows, n, batch, fan_out, sms=SMS):
    """The launch: runs a row, blocks, grid, block size, shared memory."""
    parts = plan(src_rows, n, batch, fan_out, sms)
    pieces = n > ROW_WORDS
    return dict(parts=parts, pieces=pieces, blocks=src_rows * parts,
                grid=min(src_rows * parts, MAX_BLOCKS),
                threads=PIECE_THREADS if pieces else ROW_THREADS,
                smem=PIECE_SMEM if pieces else BAR_BYTES + 4 * n)


# the main path's calls: (source rows, n, B, fan-out) of a mixed rotate_many
# of 8, the hoisted R = 8 rotation's digit and c0 gathers, and R = 1's
# non-shared digit gather, with 8 + 1 primes at 2^14 and at 2^16, and a
# rotate_many of 8 at 2^17
PATH = [(64, 1 << 14, 8, False), (72, 1 << 14, 8, True), (8, 1 << 14, 8, True),
        (72, 1 << 14, 1, False),
        (64, 1 << 16, 8, False), (72, 1 << 16, 8, True), (8, 1 << 16, 8, True),
        (64, 1 << 17, 8, False)]
