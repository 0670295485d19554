"""A numpy emulation of the staged gathers (``csrc/galois.cu``:
``galois_bulk_kernel`` and its launcher's ``plan()``) against the
reference's Pallas kernels ``galois_banks_multi_pallas`` /
``galois_digits_pallas`` in interpret mode and the port's plain versions,
word for word.

The emulation follows the kernel's index maps, not its timing: how the
launcher cuts the output vectors a source row feeds into runs (more runs
when the source rows are too few to fill the card, in the fan-out mode
the B gathered rows split among them); which block stages which source
row, in which bulk-copy runs from which lanes, whole or piece by piece
through the ring of buffers, and which barrier parity each wait uses;
which block and thread write which 16-byte output vectors; every output
word written exactly once; and a full wave of blocks at the path's
shapes.  Indices follow the reference's ``jnp.take``: the kernel wraps
one in [-n, 0) to n + i (``wrap``: one unsigned min), and any other
outside [0, n) gives 0xFFFFFFFF.  The schedule
(constants and ``plan()``) is ``galois_schedule.py``'s, which the card's
tests hold against the library's own."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.galois_kernel import galois_banks_multi_pallas, galois_digits_pallas

from repro_torch.convert import tensor_to_u32, u32_to_tensor
from repro_torch.core.params import galois_eval_perm
from repro_torch.kernels import galois_kernel
from repro_torch.kernels import ref as TR

from galois_schedule import (BAR_BYTES, BUFS, CHUNK, MAX_BLOCKS, MAX_SMEM, PIECE_SMEM,
                             PATH, PIECE_THREADS, PIECE_VEC, PIECE_WORDS, ROW_WORDS, SMS, TILE,
                             launch, plan)

POISON = 0xA5A5A5A5


def chunks(nbytes):
    """(lane, offset, length) of the bulk copies of one fill: lane l of the
    first warp copies runs l, l + 32, ... of kChunkBytes."""
    return [(j % 32, at, min(CHUNK, nbytes - at)) for j, at in enumerate(range(0, nbytes, CHUNK))]


def emulate(x, idx, fan_out, sms=SMS, max_blocks=MAX_BLOCKS):
    """The kernel on source rows x (S, n) uint32 with idx (B, n) int32:
    out (S*B or S, n) uint32 and how often each output word was written."""
    S, n = x.shape
    B = idx.shape[0]
    L = launch(S, n, B, fan_out, sms)
    parts, pieces, blocks = L["parts"], L["pieces"], L["blocks"]
    T = L["threads"]
    nv = n // 4
    work = (B if fan_out else 1) * nv
    piece = PIECE_WORDS if pieces else n
    npieces = -(-n // piece)
    out = np.full((S * (B if fan_out else 1) * nv, 4), POISON, dtype=np.uint32)
    writes = np.zeros(out.shape, dtype=np.int64)
    idx_v = idx.astype(np.int64).reshape(-1, 4)
    grid = min(blocks, max_blocks)
    for g in range(grid):
        # the block's fills and waits per buffer: the m-th fill of a buffer
        # completes its barrier's phase m, which a wait finds by parity m & 1
        fills = np.zeros(BUFS, dtype=np.int64)
        waits = np.zeros(BUFS, dtype=np.int64)
        bufs = [None] * BUFS                             # (block item, piece, words)
        for q in range(g, blocks, grid):
            src, part = divmod(q, parts)
            w = np.arange(part * work // parts, (part + 1) * work // parts)
            i = idx_v[w if fan_out else (src % B) * nv + w]
            i = np.where(i < 0, i + n, i)                # wrap
            at = src * work + w

            def fill(h, b):
                """Buffer b <- piece h of the row, by the first warp's lanes."""
                lo, hi = h * piece, min(n, (h + 1) * piece)
                nbytes = 4 * (hi - lo)
                assert nbytes < 1 << 20                  # an mbarrier's tx-count
                assert b * piece * 4 + nbytes <= BUFS * PIECE_WORDS * 4 or not pieces
                got = np.zeros(nbytes // 4, dtype=np.int64)
                for lane, off, length in chunks(nbytes):
                    assert off % (32 * CHUNK) == lane * CHUNK
                    assert off % 16 == 0 and length % 16 == 0 and 0 < length <= CHUNK
                    assert (4 * lo + off) % 16 == 0      # the source stays 16-byte aligned
                    got[off // 4:(off + length) // 4] += 1
                assert (got == 1).all()                  # the runs cover the piece once
                assert fills[b] == waits[b]              # every thread has read the buffer
                bufs[b] = (q, h, x[src, lo:hi].copy())
                fills[b] += 1

            def wait(b, h):
                """Exactly one fill of the buffer is outstanding, so the parity
                of the wait count names its phase; it holds the piece wanted."""
                assert fills[b] == waits[b] + 1
                waits[b] += 1
                got_q, got_h, s = bufs[b]
                assert (got_q, got_h) == (q, h)
                return s

            if not pieces:
                fill(0, 0)
                s = wait(0, 0)
                ok = (i >= 0) & (i < n)
                out[at] = np.where(ok, s[np.where(ok, i, 0)], 0xFFFFFFFF)
                writes[at] += 1
                continue
            assert len(w) <= TILE
            u = np.arange(len(w)) // T                   # vector w_lo + t + u*T is thread
            assert u.max(initial=0) < PIECE_VEC          # t's u-th register vector
            for h in range(min(BUFS, npieces)):
                fill(h, h)
            acc = np.full((len(w), 4), 0xFFFFFFFF, dtype=np.uint32)
            hits = np.zeros((len(w), 4), dtype=np.int64)
            for h in range(npieces):
                s = wait(h % BUFS, h)
                off = i - h * piece
                inside = (off >= 0) & (off < len(s))
                acc[inside] = s[off[inside]]
                hits += inside
                if h + BUFS < npieces:
                    fill(h + BUFS, h % BUFS)             # after every thread has read it
            assert (hits == ((i >= 0) & (i < n))).all()  # each index in exactly one piece
            out[at] = acc
            writes[at] += 1
    return out.reshape(-1, n), writes.reshape(-1, n)


def _rows(n, R, seed, natural=True):
    """R gather rows: rotations where n is a ring size, else permutations."""
    if n >= 8 and n & (n - 1) == 0:
        return np.stack([galois_eval_perm(pow(5, r, 2 * n), n, natural)
                         for r in range(1, R + 1)]).astype(np.int32)
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) for _ in range(R)]).astype(np.int32)


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 1 << 32, shape, dtype=np.uint64) \
        .astype(np.uint32)


def _multi(x, rows, emulated=None):
    """galois_banks_multi on x (k, B, n): the emulation, the reference's
    Pallas kernel in interpret mode and the port's plain version."""
    k, B, n = x.shape
    out, writes = emulate(x.reshape(-1, n), rows, fan_out=False)
    ref = np.asarray(galois_banks_multi_pallas(jnp.asarray(x), jnp.asarray(rows), tile=1,
                                               interpret=True))
    return out.reshape(k, B, n), writes, ref


def _digits(x, rows, shared):
    d, k, b, n = x.shape
    R = rows.shape[0]
    out, writes = emulate(x.reshape(-1, n), rows, fan_out=shared)
    ref = np.asarray(galois_digits_pallas(jnp.asarray(x), jnp.asarray(rows), digits=d,
                                          shared=shared, tile=1, interpret=True))
    return out.reshape(d, k, R, n), writes, ref


def test_constants_fit_the_card():
    """A whole row and the piece ring fit one block's 227 KB, the barriers
    fit their room, and a tile is a whole number of warps."""
    assert BAR_BYTES >= 8 * BUFS and BAR_BYTES % 16 == 0
    assert BAR_BYTES + 4 * ROW_WORDS <= MAX_SMEM and ROW_WORDS % 4 == 0
    assert PIECE_SMEM <= MAX_SMEM and PIECE_WORDS * 4 % 16 == 0
    assert TILE == PIECE_THREADS * PIECE_VEC and PIECE_THREADS % 32 == 0
    assert galois_kernel.MAX_ROW == ROW_WORDS


@pytest.mark.parametrize("n", [4, 8, 12, 1024, 16384])
@pytest.mark.parametrize("R", [1, 3, 8])
def test_whole_rows_equal_reference(n, R):
    """Rows a block stages whole, per-row and fan-out, at small k."""
    rows = _rows(n, R, n + R)
    x = _words(n, (2, R, n))
    got, writes, want = _multi(x, rows)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)
    plain = TR.galois_banks_ref(u32_to_tensor(x, "cpu"), torch.from_numpy(rows))
    np.testing.assert_array_equal(got, tensor_to_u32(plain))
    ext = _words(n + 1, (2, 3, R, n))
    for xs, shared in ((ext, False), (ext[:, :, :1].copy(), R > 1)):
        got, writes, want = _digits(xs, rows, shared)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want)
        plain = TR.galois_digits_banks_ref(u32_to_tensor(xs, "cpu"), torch.from_numpy(rows))
        np.testing.assert_array_equal(got, tensor_to_u32(plain))


@pytest.mark.parametrize("n,R,k", [(ROW_WORDS + 4, 1, 1), (8 * PIECE_WORDS + 12, 3, 1)])
def test_piece_ring_equals_reference(n, R, k):
    """Rows longer than a block stages pass through the piece ring: a last
    piece that is short, and more pieces than buffers (refills)."""
    rows = _rows(n, R, n)
    x = _words(n, (k, R, n))
    got, writes, want = _multi(x, rows)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)
    one = _words(n + 1, (1, k, 1, n))
    got, writes, want = _digits(one, rows, shared=R > 1)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)


def test_out_of_range_index_gives_all_ones():
    """An index >= n gives 0xFFFFFFFF on both bodies, as in the reference."""
    for n in (16, ROW_WORDS + 8):
        rows = _rows(n, 3, n)
        rows[0, 0], rows[1, n // 2], rows[2, -1] = n, 2 * n + 3, 1 << 30
        x = _words(n, (1, 3, n))
        got, writes, want = _multi(x, rows)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, want)
        assert got[0, 0, 0] == got[0, 1, n // 2] == got[0, 2, -1] == 0xFFFFFFFF


@pytest.mark.parametrize("n", [16, 1024, ROW_WORDS + 8])
def test_negative_index_counts_from_the_end(n):
    """Indices drawn from [-2n, 2n): one in [-n, 0) reads word n + i and
    any other outside [0, n) gives 0xFFFFFFFF, on whole rows and on the
    piece ring, per row and fanned out, as the reference's kernels."""
    R = 3
    rows = np.random.default_rng(n).integers(-2 * n, 2 * n, (R, n)).astype(np.int32)
    x = _words(n, (1, R, n))
    got, writes, want = _multi(x, rows)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)
    wrapped = (rows >= -n) & (rows < 0)
    assert wrapped.any() and (got[0][wrapped] == x[0][wrapped.nonzero()[0],
                                                      rows[wrapped] + n]).all()
    one = _words(n + 1, (1, 2, 1, n))
    got, writes, want = _digits(one, rows, shared=True)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)


def test_grid_loops_when_blocks_exceed_the_launch():
    """More blocks than one launch starts: each takes q, q + grid, ...
    (emulated with a cap of 3 blocks), whole rows and the piece ring, with
    the same words as one block for each."""
    n, R = 64, 3
    rows = _rows(n, R, 1)
    x = _words(2, (5, R, n))
    want, _ = emulate(x.reshape(-1, n), rows, fan_out=False)
    got, writes = emulate(x.reshape(-1, n), rows, fan_out=False, max_blocks=3)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)
    x1 = _words(3, (6, n))
    got, writes = emulate(x1, rows, fan_out=True, max_blocks=3)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, emulate(x1, rows, fan_out=True)[0])
    n = 4 * PIECE_WORDS + 12                            # 5 pieces, the last short
    rows = _rows(n, R, 7)
    x = _words(4, (4, R, n))
    got, writes = emulate(x.reshape(-1, n), rows, fan_out=False, max_blocks=3)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got.reshape(4, R, n), _multi(x, rows)[2])
    one = _words(5, (5, n))
    got, writes = emulate(one, rows, fan_out=True, max_blocks=3)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got.reshape(1, 5, R, n), _digits(one[None, :, None], rows, True)[2])


@pytest.mark.parametrize("src_rows,n,B,fan_out", PATH)
def test_path_shapes_fill_the_card(src_rows, n, B, fan_out):
    """Every path call puts a block on at least 128 of the 132 SMs (the c0
    gather's 8 rows and a rotate_many's 64 single rows split into 16 and
    2 runs, not 17 and 3: a second block on a few SMs measured slower),
    fits its shared memory, and cuts its work into runs that cover each
    output vector once."""
    L = launch(src_rows, n, B, fan_out)
    assert L["grid"] >= 128
    assert L["smem"] <= MAX_SMEM
    work = (B if fan_out else 1) * n // 4
    edges = [p * work // L["parts"] for p in range(L["parts"] + 1)]
    assert edges[0] == 0 and edges[-1] == work and all(a <= b for a, b in zip(edges, edges[1:]))
    if L["pieces"]:
        assert max(b - a for a, b in zip(edges, edges[1:])) <= TILE


@pytest.mark.parametrize("n", [1 << 16, 1 << 17])
@pytest.mark.parametrize("fan_out", [False, True])
def test_piece_mapping_at_full_rows(n, fan_out):
    """The piece ring at 2^16 and 2^17 (the mapping alone): pieces that
    refill the ring, runs that each thread covers with its register
    vectors, and bulk-copy runs that tile every piece."""
    parts = plan(8, n, 8, fan_out)
    assert n > ROW_WORDS and n % PIECE_WORDS == 0
    assert n // PIECE_WORDS > BUFS                      # the ring refills buffers
    work = (8 if fan_out else 1) * n // 4
    runs = [(p + 1) * work // parts - p * work // parts for p in range(parts)]
    assert max(runs) <= PIECE_THREADS * PIECE_VEC and sum(runs) == work
    got = np.zeros(PIECE_WORDS, dtype=np.int64)
    for lane, at, length in chunks(4 * PIECE_WORDS):
        assert at % 16 == 0 and length == CHUNK and lane < 32
        got[at // 4:(at + length) // 4] += 1
    assert (got == 1).all()


@pytest.mark.parametrize("n", [4, 16, ROW_WORDS + 8, 1 << 17])
def test_wrap_is_one_unsigned_min(n):
    """csrc/galois.cu's wrap, min(u, u + n) on the unsigned index, is
    jnp.take's rule: n + i for i in [-n, 0), i itself in [0, n), and a
    value at or above n for every other int32 (so it gives 0xFFFFFFFF)."""
    i = np.concatenate([np.arange(-3 * n, 3 * n), [-(1 << 31), -(1 << 31) + 1, (1 << 31) - 1,
                                                     -n - 1, -n, n - 1, n]]).astype(np.int64)
    u = i.astype(np.int32).view(np.uint32).astype(np.uint64)
    got = np.minimum(u, (u + n) & 0xFFFFFFFF)
    inside = (i >= -n) & (i < n)
    assert (got[inside] == np.where(i < 0, i + n, i)[inside]).all()
    assert (got[~inside] >= n).all()
