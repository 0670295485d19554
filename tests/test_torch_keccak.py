"""The port's Keccak layer on the CPU: the plain versions of
``csrc/keccak.cu`` through ``ops.keccak_*`` against ``hashlib`` and the
FIPS 203 oracle ``tests/mlkem_spec.py``.

SHA3-256, SHA3-512, SHAKE128 and SHAKE256 on seeded rows at every rate's
edges (71-73, 135-137, 167-169 bytes) and across multi-block squeezes;
two byte rows and a trailing byte absorbed as one message, strided rows;
SampleNTT (Alg. 7) in the CG order and transposed, with a stream that
needs a fourth SHAKE128 block; PRF_2 fused with CBD_2 (Alg. 8); and
what the wrappers refuse.
"""
import hashlib

import numpy as np
import pytest
import torch

import mlkem_spec as spec

from repro_torch import kernels as K
from repro_torch.kernels import keccak_kernel, ops, ref

torch.set_num_threads(2)

HASHES = {
    "sha3_256": (lambda a: ops.keccak_sha3_256(a), lambda x: hashlib.sha3_256(x).digest()),
    "sha3_512": (lambda a: ops.keccak_sha3_512(a), lambda x: hashlib.sha3_512(x).digest()),
    "shake128": (lambda a: keccak_kernel.keccak_hash(a, rate=168, suffix=0x1F, out_len=500),
                 lambda x: hashlib.shake_128(x).digest(500)),
    "shake256": (lambda a: ops.keccak_shake256(a, out_len=300),
                 lambda x: hashlib.shake_256(x).digest(300)),
}
EDGES = (0, 1, 32, 71, 72, 73, 135, 136, 137, 167, 168, 169, 1184)


def _rows(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("length", EDGES)
@pytest.mark.parametrize("name", sorted(HASHES))
def test_sponges_equal_hashlib(name, length):
    """Three seeded rows a length; the SHAKEs squeeze 500 bytes (three
    SHAKE128 blocks) and 300 (three SHAKE256 blocks)."""
    ours, theirs = HASHES[name]
    x = _rows(length, (3, length))
    got = ours(_t(x)).numpy()
    assert got.dtype == np.uint8
    for r in range(3):
        assert got[r].tobytes() == theirs(x[r].tobytes()), r


@pytest.mark.parametrize("la, lb", [(32, 32), (33, 0), (32, 1088), (71, 1), (135, 2)])
def test_two_rows_and_a_byte_are_one_message(la, lb):
    """a[r] || b[r] (|| extra) hashes as the concatenated bytes: G(m ||
    H(ek)), G(d || k) and J(z || c) in FIPS 203's shapes, and the rate
    edges where the domain byte and the last pad byte share a byte."""
    a, b = _rows(la, (4, la)), _rows(lb + 7, (4, lb))
    tb = _t(b) if lb else None
    for extra in (None, 3):
        tail = b"" if extra is None else bytes([extra])
        got = ops.keccak_sha3_512(_t(a), tb, extra=extra).numpy()
        j = keccak_kernel.keccak_hash(_t(a), tb, extra=extra, rate=136, suffix=0x1F,
                                      out_len=32).numpy()
        for r in range(4):
            msg = a[r].tobytes() + b[r].tobytes() + tail
            assert got[r].tobytes() == hashlib.sha3_512(msg).digest()
            assert j[r].tobytes() == hashlib.shake_256(msg).digest(32)


def test_strided_rows_are_read_where_they_are():
    """A column slice of wider rows (rho of an encapsulation key, the
    second half of G's output) hashes as its own bytes."""
    wide = _t(_rows(5, (6, 1184)))
    rho = wide[:, 1152:]
    assert not rho.is_contiguous()
    assert torch.equal(ops.keccak_sha3_256(rho), ops.keccak_sha3_256(rho.contiguous()))
    assert torch.equal(ops.keccak_sample_ntt(rho), ops.keccak_sample_ntt(rho.contiguous()))
    assert torch.equal(ops.keccak_prf_cbd(rho, n0=0, count=2),
                       ops.keccak_prf_cbd(rho.contiguous(), n0=0, count=2))


def test_permutation_constants():
    """The round constants' first and last words, and the rho offsets of
    FIPS 202's table (lanes x + 5y)."""
    assert ref.KECCAK_RC[0] == 1 and ref.KECCAK_RC[23] == 0x8000000080008008
    assert ref.KECCAK_RHO == (0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25,
                              39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14)
    assert sorted(ref.KECCAK_PI_SRC) == list(range(25)) and ref.KECCAK_PI_SRC[0] == 0


def _needs_four_blocks(seed: bytes) -> bool:
    buf = hashlib.shake_128(seed).digest(3 * 168)
    took = 0
    for o in range(0, len(buf), 3):
        d1 = buf[o] | ((buf[o + 1] & 15) << 8)
        d2 = (buf[o + 1] >> 4) | (buf[o + 2] << 4)
        took += (d1 < spec.Q) + (d2 < spec.Q)
    return took < spec.N


def four_block_rho(start: int = 0) -> tuple[np.ndarray, int, int]:
    """A seeded rho, and (i, j), whose SampleNTT stream needs a fourth
    SHAKE128 block (about one stream in 120)."""
    for s in range(start, start + 10_000):
        rho = _rows(s, (32,))
        for i in range(3):
            for j in range(3):
                if _needs_four_blocks(rho.tobytes() + bytes([j, i])):
                    return rho, i, j
    raise AssertionError("no stream needing four blocks")


@pytest.mark.parametrize("transpose", [False, True])
def test_sample_ntt_equals_the_oracle(transpose):
    """Every (row, i, j) of three seeded rows and of a row with a stream
    that needs a fourth block, in CG order ([r, i, j], or [r, j, i])."""
    rho4, i4, j4 = four_block_rho()
    rhos = np.concatenate([_rows(11, (3, 32)), rho4[None]])
    got = ops.keccak_sample_ntt(_t(rhos), transpose=transpose).numpy()
    assert got.shape == (4, 3, 3, 256) and got.dtype == np.int16
    cg = ref.cg_index().numpy()
    for r in range(4):
        for i in range(3):
            for j in range(3):
                want = np.array(spec.sample_ntt(rhos[r].tobytes() + bytes([j, i])))
                at = got[r, j, i] if transpose else got[r, i, j]
                assert np.array_equal(at[cg], want), (r, i, j)
    assert _needs_four_blocks(rho4.tobytes() + bytes([j4, i4]))


@pytest.mark.parametrize("n0, count", [(0, 3), (3, 4), (0, 6)])
def test_prf_cbd_equals_the_oracle(n0, count):
    """CBD_2(PRF_2(s, N)) for the nonces encryption (y: 0-2, e1 and e2:
    3-6) and key generation (s and e: 0-5) use."""
    seeds = _rows(20 + n0, (3, 32))
    got = ops.keccak_prf_cbd(_t(seeds), n0=n0, count=count).numpy()
    assert got.shape == (3, count, 256) and got.dtype == np.int16
    for r in range(3):
        for c in range(count):
            want = spec.sample_cbd(2, spec._prf(2, seeds[r].tobytes(), n0 + c))
            assert np.array_equal(got[r, c], want), (r, c)


def test_plain_calls_are_counted():
    x = _t(_rows(1, (2, 32)))
    K.reset_counts()
    ops.keccak_sha3_256(x)
    ops.keccak_sample_ntt(x)
    ops.keccak_prf_cbd(x, n0=0, count=1)
    c = K.snapshot()
    assert [c[k]["plain_calls"] for k in ("keccak_hash", "keccak_sample_ntt",
                                          "keccak_prf_cbd")] == [1, 1, 1]


def test_sponge_permutations():
    """The host's count: absorbed blocks (one more on a full block, for
    the padding) and squeezed blocks past the first."""
    perms = keccak_kernel.sponge_perms
    assert perms(1184, 136, 32) == 9 and perms(64, 72, 64) == 1
    assert perms(72, 72, 64) == 2 and perms(33, 168, 504) == 3
    assert perms(1120, 136, 32) == 9


@pytest.mark.parametrize("call, match", [
    (lambda x: ops.keccak_sha3_256(x.int()), "uint8"),
    (lambda x: ops.keccak_sha3_256(x[:, ::2]), "adjacent"),
    (lambda x: ops.keccak_sha3_512(x, x[:2]), "rows"),
    (lambda x: ops.keccak_sha3_512(x, extra=256), "not a byte"),
    (lambda x: keccak_kernel.keccak_hash(x, rate=100, suffix=6, out_len=8), "rate"),
    (lambda x: ops.keccak_shake256(x, out_len=0), "out_len"),
    (lambda x: ops.keccak_sample_ntt(x[:, :31]), "31 bytes"),
    (lambda x: ops.keccak_prf_cbd(x, n0=250, count=7), "nonces"),
])
def test_wrappers_refuse(call, match):
    with pytest.raises(K.KernelRefusal, match=match):
        call(_t(_rows(3, (3, 32))))


@pytest.mark.parametrize("name", ["keccak_hash", "keccak_sample_ntt", "keccak_prf_cbd"])
def test_meta_branch_records_one_launch(name):
    """On meta: the kernel's output shape, one launch in the op counter
    with the permutations' floor of integer instructions (G of 64 bytes:
    one a row; SampleNTT: three blocks a stream; PRF: one a stream), and
    no plain call or launch in ``kernels.COUNTS``."""
    from repro_torch.runtime import op_cost
    rows = torch.zeros((3, 32), dtype=torch.uint8, device="meta")
    call, shape, perms = {
        "keccak_hash": (lambda: keccak_kernel.keccak_hash(rows, rows, rate=72, suffix=6,
                                                          out_len=64), (3, 64), 3),
        "keccak_sample_ntt": (lambda: keccak_kernel.sample_ntt(rows, transpose=False),
                              (3, 3, 3, 256), 3 * 9 * 3),
        "keccak_prf_cbd": (lambda: keccak_kernel.prf_cbd(rows, n0=0, count=6),
                           (3, 6, 256), 3 * 6),
    }[name]
    K.reset_counts()
    with op_cost.OpCounter() as c:
        out = call()
    assert out.device.type == "meta" and tuple(out.shape) == shape
    assert c.kernels == {name: 1}
    assert c.cost.bytes >= out.numel() * out.element_size()
    assert all(v == {"launches": 0, "plain_calls": 0} for v in K.snapshot().values())
    assert c.cost.flops == perms * keccak_kernel.PERM_INT_OPS == perms * 4320
