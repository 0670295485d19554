"""A numpy emulation of the single-prime row stream (``csrc/ntt.cu``,
``ntt_stream_kernel``) against the reference's own Pallas kernels
(``ntt_fwd_pallas`` / ``ntt_inv_pallas`` in interpret mode) and the port's
plain version, word for word.

The emulation follows the kernel's index maps, not its arithmetic order:
the even split of B rows over the grid, the ring of tiles (which tile
lands in which slot, which barrier parity a wait uses, when a slot may be
refilled), the padded tile rows that the bulk copies fill and empty, the
lanes' rows and row-thread indices, the first phase's read from the tile,
the register schedule of ``csrc/ntt_regs.cuh`` with the twiddles read as
the kernel reads them (the staged (stages, n/2) table up to 512 words, the
thread-major copy that ``thread_major_kernel`` records above), the
swizzled exchange inside the tile row, and the results written back in
the last phase's layout.  It also counts the shared-memory bank conflicts
of the tile accesses."""
import numpy as np
import jax.numpy as jnp
import pytest

from repro.core.params import make_ntt_params as ref_params
from repro.kernels import ops as RO

from repro_torch.convert import tensor_to_u32, u32_to_tensor
from repro_torch.core.params import make_ntt_params
from repro_torch.kernels import ref as TR
from test_torch_ntt_banks import _Lane, deposit, group, n_phases, rotl, rotr, row_stride, swz

RB, R = 4, 16
SLOTS = 3           # csrc/ntt.cu kSlots
THREADS = 128       # csrc/ntt.cu kStreamThreads
WAVE = 7 * 132      # resident blocks the launcher might find (any count will do)


def block_threads(b, tpr, most=THREADS, want=4 * 132):
    """The launcher's block size: halved while fewer than ``want`` tiles."""
    least = max(tpr, 32)
    tpb = max(most, least)
    while tpb > least and -(-b // (tpb // tpr)) < want:
        tpb //= 2
    return tpb


def grid_blocks(b, rpb, wave=WAVE):
    return min(-(-b // rpb), wave)


def block_rows(g, grid, b):
    """Block g's rows [first, first + rows): the even split."""
    first = g * b // grid
    return first, (g + 1) * b // grid - first


def lanes(tpb, tpr):
    """(row in the tile, row-thread index) of each thread: a warp's rows
    take its lanes in turn while a row is narrower than a warp."""
    t = np.arange(tpb)
    warp, lane = t >> 5, t & 31
    if tpr < 32:
        rpw = 32 // tpr
        return warp * rpw + lane % rpw, lane // rpw
    return t // tpr, t % tpr


def ring_events(tiles, slots=SLOTS):
    """The order in which a block's warp 0 issues tile loads, waits on
    them, stores results and refills slots: ("load", t, slot), ("wait",
    t, slot, parity), ("store", t, slot), ("read", t) once tile t's store
    has read its slot (the wait_group.read 1 that follows the next store,
    or the final wait_group 0)."""
    ev = []
    ahead = slots - 1
    for t in range(min(ahead, tiles)):
        ev.append(("load", t, t % slots))
    for t in range(tiles):
        ev.append(("wait", t, t % slots, (t // slots) & 1))
        ev.append(("store", t, t % slots))
        if t >= 1:
            ev.append(("read", t - 1))
        if t + ahead < tiles:
            ev.append(("load", t + ahead, (t + ahead) % slots))
    if tiles:
        ev.append(("read", tiles - 1))
    return ev


def staged(n):
    """``ntt_regs.cuh``'s staged_table_bytes: the stage-table pair of a
    ring fits 24 KB of shared memory."""
    return (n.bit_length() - 1) * (n // 2) * 2 * 4 <= 24 * 1024


def phase_bits(fwd, k, L, g):
    """The pairing bits of phase k's stages, in the order they run."""
    return range(L - RB * k - 1, g - 1, -1) if fwd else range(RB * k, min(RB * (k + 1), L))


def staged_index(fwd, L, b, g, obase, lo):
    """(table row, columns) that ``row_phase`` reads for the butterflies
    ``lo`` (register indices) of pairing bit b: base column + constant."""
    H = 1 << (L - 1)
    if fwd:
        t = L - 1 - b
        return t, (rotl(obase, t, L) & (H - 1)) + (rotl(lo << g, t, L) & (H - 1))
    return L - 1 - b, (rotr(obase, b + 1, L) & (H - 1)) + (rotr(lo << g, b + 1, L) & (H - 1))


def thread_major_index(n, fwd):
    """(table row, column) arrays (log2 n, n/16, 8) of the thread-major
    copy as ``thread_major_kernel`` records it: thread i's m-th butterfly,
    in the order ``row_phase`` runs them, is entry (m // 8, i, m % 8)."""
    L = n.bit_length() - 1
    i = np.arange(n >> RB)
    rows = np.zeros((L, n >> RB, 8), dtype=np.int64)
    cols = np.zeros_like(rows)
    m = 0
    for k in range(n_phases(L, RB)):
        g = group(fwd, k, L, RB)
        obase = deposit(i, g, RB)[:, None]
        for b in phase_bits(fwd, k, L, g):
            lo = np.array([x for x in range(R) if not x >> (b - g) & 1])
            rows[m // 8], cols[m // 8] = staged_index(fwd, L, b, g, obase, lo[None, :])
            m += len(lo)
    return rows, cols


def _tables(p, fwd):
    names = ("tw", "twp", "psi_pows", "psi_pows_p") if fwd else \
        ("itw", "itwp", "ipsi_ninv", "ipsi_ninv_p")
    tb = {k: np.asarray(getattr(p, src), np.uint64)
          for k, src in zip(("tw", "twp", "w", "wp"), names)}
    tb["ninv"], tb["ninv_p"] = int(p.ninv), int(p.ninv_p)
    n = p.n
    if not staged(n):
        rows, cols = thread_major_index(n, fwd)
        tb["twt"], tb["twpt"] = tb["tw"][rows, cols], tb["twp"][rows, cols]
    return tb


def _tile(v, ln, tb, *, fwd, neg, L, i, srows):
    """One tile's register schedule: v (rows, TPR, 16) from the first
    phase's layout to the last's, exchanges through ``srows`` (rows,
    padded stride)."""
    n = 1 << L
    rr = np.arange(v.shape[0])[:, None, None]
    r = np.arange(R)[None, None, :]
    ii = i[None, :, None]
    for k in range(n_phases(L, RB)):
        g = group(fwd, k, L, RB)
        if k:
            g1 = group(fwd, k - 1, L, RB)
            s1 = swz(deposit(ii, g1, RB)) ^ swz(r << g1)
            s2 = swz(deposit(ii, g, RB)) ^ swz(r << g)
            assert s1.max() < n and s2.max() < n       # inside the tile row
            srows[rr, np.broadcast_to(s1, v.shape)] = v
            v = srows[rr, np.broadcast_to(s2, v.shape)]
        obase = deposit(ii, g, RB)
        for b in phase_bits(fwd, k, L, g):
            lo = np.array([x for x in range(R) if not x >> (b - g) & 1])
            hi = lo | (1 << (b - g))
            if "twt" in tb:                           # thread-major: (a, i, c), tm_phase
                a = L - 1 - b if fwd else b
                w, wp = tb["twt"][a][i][None], tb["twpt"][a][i][None]
            else:                                     # staged: base + C
                row, j = staged_index(fwd, L, b, g, obase, lo)
                w, wp = tb["tw"][row][j], tb["twp"][row][j]
            x0, x1 = (ln.fwd if fwd else ln.inv)(v[..., lo], v[..., hi], w, wp)
            v[..., lo], v[..., hi] = x0, x1
    return v


def emulate_stream(x, p, *, fwd, neg, lazy, wave=WAVE, rng=None):
    """The card's ``ntt_fwd`` / ``ntt_inv`` of x (B, n) uint32 through
    the row stream, block by block and tile by tile."""
    rng = rng or np.random.default_rng(0)
    b, n = x.shape
    L = n.bit_length() - 1
    tpr = n >> RB
    tb = _tables(p, fwd)
    ln = _Lane(p.q, 32, lazy)
    tpb = block_threads(b, tpr)
    rpb, SR = tpb // tpr, row_stride(L)
    lr, i = lanes(tpb, tpr)
    grid = grid_blocks(b, rpb, wave)
    g0, gl = group(fwd, 0, L, RB), group(fwd, n_phases(L, RB) - 1, L, RB)
    r = np.arange(R)
    out = np.full((b, n), 0xDEADBEEF, dtype=np.uint64)
    written = np.zeros(b, dtype=int)
    for g in range(grid):
        first, rows = block_rows(g, grid, b)
        tiles = -(-rows // rpb)
        # stale words in every slot: rows past the block's range run on them
        slots = rng.integers(0, 1 << 32, (SLOTS, rpb, SR), dtype=np.uint64)
        fills = np.zeros(SLOTS, dtype=int)
        for ev in ring_events(tiles):
            if ev[0] == "load":                       # one bulk copy a row
                _, t, s = ev
                nr = min(rpb, rows - t * rpb)
                slots[s, :nr, :n] = x[first + t * rpb: first + t * rpb + nr]
                fills[s] += 1
            elif ev[0] == "wait":
                _, t, s, parity = ev
                assert fills[s] == t // SLOTS + 1 and parity == (fills[s] - 1) & 1
                # each thread: its row lr, its 16 words at b0 + (r << g0)
                b0 = deposit(i, g0, RB)
                rd = b0[:, None] + (r[None, :] << g0)
                assert sorted(map(tuple, np.stack([np.repeat(lr, R), rd.ravel()], 1))) == \
                    [(a, c) for a in range(rpb) for c in range(n)]   # one owner a word
                v = np.zeros((rpb, tpr, R), dtype=np.uint64)
                v[lr, i] = slots[s][lr[:, None], rd]
                if fwd and neg:                       # the pre-weight, by word index
                    pre = deposit(np.arange(tpr), g0, RB)[:, None] + (r[None, :] << g0)
                    v = ln.mul(v, tb["w"][pre][None], tb["wp"][pre][None])
                srows = slots[s]
                v = _tile(v, ln, tb, fwd=fwd, neg=neg, L=L, i=np.arange(tpr), srows=srows)
                bl = deposit(np.arange(tpr), gl, RB)[:, None] + (r[None, :] << gl)
                if fwd:
                    v = ln.band(v, ln.q) if lazy else v
                else:
                    w = tb["w"][bl][None] if neg else np.uint64(tb["ninv"])
                    wp = tb["wp"][bl][None] if neg else np.uint64(tb["ninv_p"])
                    v = ln.band(ln.shoup_lazy(v, w, wp), ln.q)
                srows[np.arange(rpb)[:, None, None], bl[None]] = v
            elif ev[0] == "store":                    # rows in range only
                _, t, s = ev
                nr = min(rpb, rows - t * rpb)
                out[first + t * rpb: first + t * rpb + nr] = slots[s, :nr, :n]
                written[first + t * rpb: first + t * rpb + nr] += 1
    assert np.all(written == 1)
    return out.astype(np.uint32)


def _check(b, n, fwd, neg, lazy, wave=WAVE):
    p, rp = make_ntt_params(n), ref_params(n)
    assert (p.q, p.psi) == (rp.q, rp.psi)
    rng = np.random.default_rng(n + 3 * b + fwd + 2 * neg + 4 * lazy)
    x = rng.integers(0, (2 if (lazy and not fwd) else 1) * p.q, (b, n), dtype=np.uint32)
    got = emulate_stream(x, p, fwd=fwd, neg=neg, lazy=lazy, wave=wave, rng=rng)
    kw = dict(negacyclic=neg, lazy=lazy)
    op_r = RO.ntt if fwd else RO.intt
    want = np.asarray(op_r(jnp.asarray(x), rp, use_pallas=True, **kw))
    assert np.array_equal(got, want), "emulation != the reference's Pallas kernel"
    plain = (TR.ntt_fwd_ref if fwd else TR.ntt_inv_ref)(u32_to_tensor(x, "cpu"), p, neg,
                                                         lazy=lazy)
    assert np.array_equal(got, tensor_to_u32(plain)), "emulation != the port's plain version"


@pytest.mark.parametrize("n,b,wave", [(64, 40, 7), (128, 40, 3), (128, 8, WAVE),
                                      (256, 24, 5), (512, 16, 3), (1024, 16, 5),
                                      (4096, 8, 3)])
@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("neg", [False, True], ids=["cyclic", "negacyclic"])
@pytest.mark.parametrize("lazy", [False, True])
def test_stream_matches_reference_pallas(n, b, wave, fwd, neg, lazy):
    """Row counts that split unevenly over few blocks (a short last tile
    in some of them), the smallest and largest rings of the stream, both
    twiddle layouts; lazy inverses on [0, 2q) inputs."""
    _check(b, n, fwd, neg, lazy, wave)


@pytest.mark.parametrize("b", [1, 7, 13, 100, 528, 100_003])
@pytest.mark.parametrize("grid", [1, 5, 132, 528, 924])
def test_even_split_covers_every_row_once(b, grid):
    """The launcher never starts more blocks than rows; block g takes
    floor(b/G) or ceil(b/G) consecutive rows and every row exactly once."""
    grid = min(grid, b)
    spans = [block_rows(g, grid, b) for g in range(grid)]
    assert spans[0][0] == 0 and sum(r for _, r in spans) == b
    assert all(f + r == spans[k + 1][0] for k, (f, r) in enumerate(spans[:-1]))
    assert {r for _, r in spans} <= {b // grid, -(-b // grid)}


@pytest.mark.parametrize("tiles", range(0, 11))
@pytest.mark.parametrize("slots", [2, 3, 4])
def test_tile_ring_waits_only_on_issued_tiles_and_refills_read_slots(tiles, slots):
    """Every wait names a tile already issued, into the slot it waits on,
    with the parity of that slot's fill; a slot is loaded again only
    after the store of its previous tile has read it; every tile is
    loaded, waited on and stored once."""
    occupant, stored, read, fills = {}, set(), set(), {}
    counts = {"load": [], "wait": [], "store": []}
    for ev in ring_events(tiles, slots):
        kind, t = ev[0], ev[1]
        if kind == "load":
            s = ev[2]
            prev = occupant.get(s)
            assert prev is None or prev in read, (ev, prev)
            occupant[s] = t
            fills[s] = fills.get(s, 0) + 1
        elif kind == "wait":
            s, parity = ev[2], ev[3]
            assert occupant.get(s) == t and parity == (fills[s] - 1) & 1
        elif kind == "store":
            stored.add(t)
        elif kind == "read":
            assert t in stored
            read.add(t)
        if kind in counts:
            counts[kind].append(t)
    for kind in counts:
        assert sorted(counts[kind]) == list(range(tiles))
    assert read == set(range(tiles))


def _wavefronts(addresses_words, width_words):
    """Shared-memory wavefronts of one warp access: 32-bit accesses are one
    request for the warp, 16-byte ones one per quarter warp; each request
    takes as many wavefronts as the most distinct addresses in one bank
    (or bank quad)."""
    groups = [addresses_words] if width_words == 1 else \
        [addresses_words[q:q + 8] for q in range(0, 32, 8)]
    total = 0
    for grp in groups:
        banks = {}
        for a in set(grp):
            banks.setdefault((a // width_words) % (32 // width_words), set()).add(a)
        total += max(len(v) for v in banks.values())
    return total


@pytest.mark.parametrize("logn", range(6, 13))
def test_tile_accesses_bank_conflicts(logn):
    """In a block of the launcher's size, per warp and register: the
    forward's strided first read and the inverse's strided last write are
    free of bank conflicts; the 16-byte accesses (the inverse's first
    read, the forward's last write) take 1 wavefront per quarter warp at
    n = 64 and 2 at n = 128 (a warp's rows take its lanes in turn, and
    the padded stride puts neighbouring rows on other bank quads), 4 from
    n = 256 (a quarter warp's 16-word runs fall on two quads)."""
    n, L = 1 << logn, logn
    tpr, SR = n >> RB, row_stride(L)
    tpb = max(THREADS, tpr)
    lr, i = lanes(tpb, tpr)
    for fwd in (True, False):
        g = group(fwd, 0 if fwd else n_phases(L, RB) - 1, L, RB)   # the strided side
        for r in range(R):
            for w0 in range(0, tpb, 32):
                t = np.arange(w0, w0 + 32)
                words = (lr[t] * SR + deposit(i[t], g, RB) + (r << g)).tolist()
                assert _wavefronts(words, 1) == 1, (n, fwd, r)
        for u in range(R // 4):                                      # the contiguous side
            for w0 in range(0, tpb, 32):
                t = np.arange(w0, w0 + 32)
                words = (lr[t] * SR + (i[t] << RB) + 4 * u).tolist()
                assert _wavefronts(words, 4) == {4: 4, 8: 8}.get(tpr, 16), (n, u)


@pytest.mark.parametrize("n", [1024, 2048, 4096])
@pytest.mark.parametrize("fwd", [True, False], ids=["fwd", "inv"])
def test_thread_major_table_is_a_permutation(n, fwd):
    """The thread-major copy holds every (stage, column) of the table
    exactly once, so it moves the same bytes as the table; the rings that
    read it are those whose table pair is not staged."""
    assert not staged(n) and staged(512)
    rows, cols = thread_major_index(n, fwd)
    L = n.bit_length() - 1
    assert rows.shape == (L, n // 16, 8)
    flat = (rows * (n // 2) + cols).ravel()
    assert np.array_equal(np.sort(flat), np.arange(L * n // 2))
