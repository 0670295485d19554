"""A numpy emulation of the basecase product's launch schedule
(``csrc/dyadic_basemul.cu``: ``plan()``, ``basemul_vec_kernel`` and
``basemul_pair_kernel``) on the CPU.

The emulation follows the kernels' index maps, not their timing: which
items (2, 4 or 8 consecutive pairs of one row) each thread of the vector
body takes, grid-strided, under a grid that covers every item or one
capped at a block a SM, which pairs and words an item reads and writes, which prime its row belongs to (primes
change inside a block), and the one-pair body's grid-strided map.  Every
pair must be written exactly once.  On small shapes the emulation also
computes the words as the vector body does (u16 words taken from halves
of 32-bit words, packed back by byte permutation) and holds them against
the reference's ``dyadic_basemul_banks_ref`` and its Pallas kernel in
interpret mode, and against the port's plain version.  The schedule
(constants and ``plan()``) is ``basemul_schedule.py``'s, which the card's
tests hold against the library's own (``dyadic_basemul_plan``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RR
from repro.kernels.dyadic_kernel import dyadic_basemul_banks as basemul_pallas

from repro_torch.kernels import ref as TR

from basemul_schedule import (MAX_THREADS, PAIRS, SMS, VEC_THREADS, WAVE_BLOCKS,
                              operands, plan)

GRIDS = {"one item a thread": lambda items, threads: -(-items // threads),
         "one block a SM": lambda items, threads: min(-(-items // threads), SMS)}


def item_map(it, B, n, P):
    """Row, first pair and prime of items ``it`` of P pairs as the kernel
    computes them in 32 bits: row = it >> log2(n / 2P), p = row / B."""
    vpr = n // 2 // P
    it = it.astype(np.uint32)
    row = it >> np.uint32(vpr.bit_length() - 1)
    j = (it & np.uint32(vpr - 1)) * np.uint32(P)
    return row.astype(np.int64), j.astype(np.int64), (row // np.uint32(B)).astype(np.int64)


def item_words(row, j, n, P):
    """The (items, 2P) output words an item writes: pairs j .. j+P-1 of c0
    (words j ..) and of c1 (words n/2 + j ..)."""
    w = row[:, None] * n + j[:, None] + np.arange(P)[None]
    return np.concatenate([w, w + n // 2], axis=1)


def stride_items(items, G, T):
    """(block, item) of every loop turn of every thread of a grid of G
    blocks of T: thread g*T + t takes g*T + t, + G*T, ... below items."""
    GT = G * T
    assert items + GT < 1 << 32                     # the 32-bit item sums never wrap
    it = (np.arange(GT)[:, None] + GT * np.arange(-(-items // GT))[None]).ravel()
    it = it[it < items]
    return (it % GT) // T, it


FULL = 1 << 21      # words up to which every loop turn is emulated


def check_vector_body(k, B, n, P, G, T):
    """Every pair of (k, B, n) written once by a grid of G blocks of T
    threads taking items of P pairs: turn by turn up to FULL words; above
    it, the items near the ends and near every prime boundary.  Every
    item's prime is its row's.  Returns the number of blocks in which
    the prime changes between two threads of one turn."""
    vpr = n // 2 // P
    items = k * B * vpr
    GT = G * T
    first = np.arange(1, k) * B * vpr                   # first item of prime 1, 2, ...
    straddle = {int(f % GT // T) for f in first if f % T}
    full = k * B * n <= FULL
    if full:
        block, it = stride_items(items, G, T)
    else:
        w = 4 * T
        it = np.unique(np.concatenate([np.arange(w), np.arange(items - w, items)]
                                      + [np.arange(f - w, f + w) for f in first]))
        block = it % GT // T
    row, j, p = item_map(it, B, n, P)
    assert (p == row // B).all() and (p < k).all()
    words = item_words(row, j, n, P)
    if full:
        writes = np.bincount(words.ravel(), minlength=k * B * n)
        assert writes.shape == (k * B * n,) and (writes == 1).all()
    else:                      # the emulated items: each word once, inside the stack
        assert len(np.unique(words)) == words.size and words.max() < k * B * n
        assert -(-items // GT) * GT >= items
    for g in straddle:
        turns = it[block == g] // GT
        assert any(len(np.unique(p[(block == g) & (it // GT == m)])) > 1 for m in set(turns))
    return len(straddle)


def check_pair_body(k, B, n):
    """The one-pair body: thread (g, t) takes pairs g*T + t, + G*T, ...;
    every pair once (emulated turn by turn up to FULL words)."""
    _, _, T, total, G = plan(k, B, n, aligned=False)
    h = n // 2
    assert G * T * -(-total // (G * T)) >= total
    if total * 2 > FULL:
        return
    _, idx = stride_items(total, G, T)
    j, row = idx & (h - 1), idx >> (h.bit_length() - 1)
    assert (row // B < k).all()
    writes = np.bincount(np.concatenate([row * n + j, row * n + h + j]),
                         minlength=k * B * n)
    assert (writes == 1).all()


NS = [1 << e for e in range(1, 13)]
BS = [1, 3, 9, 33, 768, 2304, 100003]


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("k", [1, 3])
def test_every_pair_written_once(k, B, n, grid):
    """Each (k, B, n) on the body plan() gives it, under both grid choices
    of the vector body: one item a thread, and one block a SM whose
    threads loop over the items."""
    vec, P, T, items, _ = plan(k, B, n)
    if not vec:
        assert n // 2 % PAIRS != 0
        check_pair_body(k, B, n)
        return
    check_vector_body(k, B, n, P, GRIDS[grid](items, T), T)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_primes_change_inside_blocks(P):
    """Three primes of 1 and 33 rows of 256 words, one item a thread, and of
    100003 rows on a grid of a block a SM, items of 2, 4 or 8 pairs, blocks
    of 160 threads (no prime's item count is a multiple of it): prime
    boundaries fall inside blocks, and each item there takes its own row's
    prime."""
    for B, grid in ((1, "one item a thread"), (33, "one item a thread"),
                    (100003, "one block a SM")):
        items = 3 * B * 128 // P
        assert check_vector_body(3, B, 256, P, GRIDS[grid](items, 160), 160) > 0, B


def test_plan_at_the_path_shapes():
    """ML-KEM's shapes all take the vector body, one item a thread; a ring
    of 2 words and unaligned operands the pair body; the grid caps at one
    wave of WAVE_BLOCKS resident blocks a SM."""
    for B in (2304, 768, 9, 3):
        vec, P, T, items, grid = plan(1, B, 256)
        assert vec == 1 and items == B * 128 // P and grid == -(-items // T)
    assert plan(1, 9, 2)[0] == 0 and plan(1, 9, 2 * PAIRS)[0] == 1
    assert plan(1, 2304, 256, aligned=False)[0] == 0
    assert plan(3, 100003, 4096)[4] == SMS * WAVE_BLOCKS
    assert PAIRS in (2, 4, 8) and VEC_THREADS <= MAX_THREADS and VEC_THREADS % 32 == 0
    assert VEC_THREADS * WAVE_BLOCKS <= 2048


def _barrett16(x, y, q, mu, lazy):
    prod = x * y
    r = prod - (((prod >> 10) * mu) >> 16) * q
    r = np.where(r >= 2 * q, r - 2 * q, r)
    return r if lazy else np.where(r >= q, r - q, r)


def _shoup16(x, w, wp, q, lazy):
    r = (x * w - (((x * wp) & 0xFFFFFFFF) >> 16) * q) & 0xFFFFFFFF
    return r if lazy else np.where(r >= q, r - q, r)


def _pair(a0, a1, b0, b1, g, gp, q, mu, lazy):
    """basemul_pair on int64 lanes, modarith.cuh's op sequence."""
    if lazy:
        t = _shoup16(_barrett16(a1, b1, q, mu, True), g, gp, q, True)
        s0 = _barrett16(a0, b0, q, mu, True) + t
        c0 = np.where(s0 >= 2 * q, s0 - 2 * q, s0)
        s1 = _barrett16(a0, b1, q, mu, True) + _barrett16(a1, b0, q, mu, True)
        c1 = np.where(s1 >= 2 * q, s1 - 2 * q, s1)
        return np.where(c0 >= q, c0 - q, c0), np.where(c1 >= q, c1 - q, c1)
    t = _shoup16(_barrett16(a1, b1, q, mu, False), g, gp, q, False)
    s0 = _barrett16(a0, b0, q, mu, False) + t
    s1 = _barrett16(a0, b1, q, mu, False) + _barrett16(a1, b0, q, mu, False)
    return np.where(s0 >= q, s0 - q, s0), np.where(s1 >= q, s1 - q, s1)


def emulate_vector_body(a, b, qs, mus, g, gp, lazy, P, G, T):
    """The vector body's words on (k, B, n) uint16 operands: each item
    takes P/2 u32 words of a0, a1, b0, b1, gamma and gammap, computes each
    word's low and high halves as two pairs and packs them back."""
    k, B, n = a.shape
    h = n // 2
    _, it = stride_items(k * B * (h // P), G, T)
    row, j, p = item_map(it, B, n, P)
    aw, bw = a.reshape(-1).view(np.uint32), b.reshape(-1).view(np.uint32)
    gw, gpw = g.reshape(-1).view(np.uint32), gp.reshape(-1).view(np.uint32)
    out = np.zeros(a.size // 2, np.uint32)
    at = (row * n + j) // 2                     # the item's first u32 word
    gat = (p * h + j) // 2
    q, mu = qs[p].astype(np.int64), mus[p].astype(np.int64)
    for i in range(P // 2):
        words = [x[o + i].astype(np.int64) for x, o in ((aw, at), (aw, at + h // 2),
                                                        (bw, at), (bw, at + h // 2),
                                                        (gw, gat), (gpw, gat))]
        lo = _pair(*(w & 0xFFFF for w in words), q, mu, lazy)
        hi = _pair(*(w >> 16 for w in words), q, mu, lazy)
        out[at + i] = (lo[0] | (hi[0] << 16)).astype(np.uint32)           # __byte_perm 0x5410
        out[at + h // 2 + i] = (lo[1] | (hi[1] << 16)).astype(np.uint32)
    return out.view(np.uint16).reshape(a.shape)


def emulate_pair_body(a, b, qs, mus, g, gp, lazy):
    k, B, n = a.shape
    h = n // 2
    idx = np.arange(k * B * h)
    j, row = idx % h, idx // h
    p = row // B
    x = a.reshape(-1).astype(np.int64), b.reshape(-1).astype(np.int64)
    base = row * n
    c0, c1 = _pair(x[0][base + j], x[0][base + j + h], x[1][base + j], x[1][base + j + h],
                   g[p, j].astype(np.int64), gp[p, j].astype(np.int64),
                   qs[p].astype(np.int64), mus[p].astype(np.int64), lazy)
    out = np.zeros(a.size, np.uint16)
    out[base + j], out[base + j + h] = c0, c1
    return out.reshape(a.shape)


def _plain(a, b, qs, mus, g, gp, lazy):
    t = lambda x: torch.from_numpy(x.view(np.int16).copy())
    return TR.dyadic_basemul_banks_ref(t(a), t(b), t(qs), t(mus), t(g), t(gp),
                                       lazy=lazy).numpy().view(np.uint16)


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", [1, 3])
def test_emulated_words_equal_reference(k, n, lazy):
    """Both bodies word for word against the reference's plain version and
    the port's: the pair body on every ring (as on an unaligned view), the
    vector body with items of 2, 4 and 8 pairs wherever n/2 takes them
    (the library's 2 from 4 words), both grids."""
    B = 3
    ops = operands(k, B, n, k * n + lazy)
    want = np.asarray(RR.dyadic_basemul_banks_ref(*map(jnp.asarray, ops), lazy=lazy))
    np.testing.assert_array_equal(_plain(*ops, lazy), want)
    np.testing.assert_array_equal(emulate_pair_body(*ops, lazy), want)     # an unaligned view
    if n // 2 % PAIRS:
        assert plan(k, B, n)[0] == 0
    for P in [P for P in (2, 4, 8) if n // 2 % P == 0]:
        items = k * B * n // 2 // P
        for grid in GRIDS.values():
            np.testing.assert_array_equal(
                emulate_vector_body(*ops, lazy, P, grid(items, 64), 64), want)


@pytest.mark.parametrize("lazy", [False, True])
def test_emulated_vector_body_equals_the_pallas_kernel(lazy):
    """ML-KEM's ring at B = 9 and a three-prime stack at n = 64 against the
    reference's kernel in interpret mode."""
    for k, B, n in ((1, 9, 256), (3, 2, 64)):
        a, b, qs, mus, g, gp = operands(k, B, n, B + n)
        want = np.asarray(basemul_pallas(*map(jnp.asarray, (a, b, qs[:, None], mus[:, None],
                                                            g, gp)),
                                         tile=1, lazy=lazy, interpret=True))
        _, P, T, _, grid = plan(k, B, n)
        got = emulate_vector_body(a, b, qs, mus, g, gp, lazy, P, grid, T)
        np.testing.assert_array_equal(got, want)
