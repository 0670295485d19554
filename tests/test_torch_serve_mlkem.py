"""Mixed-scheme serving on the port's engine: CKKS and ML-KEM-768
requests through one ``repro_torch.fhe.serve.CkksServeEngine`` on the CPU.
A mixed queue (CKKS multiplies and rescales, ML-KEM encaps and decaps)
gives the same answers, byte for byte, and the same ``stats`` as the
reference's engine (sync and async); the reference's own cases
(tests/test_serve_mlkem.py) on the port: schemes never share a dispatch,
every ML-KEM answer equals the FIPS 203 spec oracle's, a cross-scheme
request fails alone and a mixed batch is refused."""
import numpy as np
import pytest
import torch

import mlkem_spec as spec
from test_torch_serve import _eq, assert_same_stats, drain_both

from repro.fhe import serve as RS
from repro.fhe.ckks import CkksContext as RefContext

from repro_torch.convert import tensor_to_u32
from repro_torch.fhe import serve
from repro_torch.fhe.ckks import CkksContext
from repro_torch.fhe.evalplan import Ciphertext
from repro_torch.fhe.serve import CkksServeEngine, FheRequest
from repro_torch.pq import mlkem

torch.set_num_threads(2)


def _same_answer(r, p) -> bool:
    """A reference engine's answer and the port's: the same integers."""
    if isinstance(p, Ciphertext):
        return (np.array_equal(np.asarray(r.c0.data), tensor_to_u32(p.c0.data))
                and np.array_equal(np.asarray(r.c1.data), tensor_to_u32(p.c1.data))
                and r.scale == p.scale and r.primes == p.primes)
    if isinstance(p, tuple):
        return all(np.array_equal(np.asarray(a), b) for a, b in zip(r, p))
    return np.array_equal(np.asarray(r), p)


def _mixed_drains(Context, Serve, kw):
    """2 CKKS multiplies and a rescale, then 3 ML-KEM encaps and 2
    decaps, interleaved, drained by ``run`` then ``run_async``."""
    ctx = Context(n=64, levels=2, seed=31, **kw)
    rng = np.random.default_rng(32)
    ek, dk = mlkem.keygen_batch(*(rng.integers(0, 256, (2, 32), dtype=np.uint8)
                                  for _ in range(2)), device="cpu")
    m = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    ct = mlkem.encaps_batch(ek, m[:2], device="cpu")[1]
    cts = [ctx.encrypt(ctx.encode(rng.uniform(-1, 1, ctx.slots))) for _ in range(5)]
    reqs = [Serve.FheRequest(0, "multiply", cts[0], other=cts[1]),
            Serve.FheRequest(1, "mlkem_encaps", payload={"ek": ek[0], "m": m[0]}),
            Serve.FheRequest(2, "multiply", cts[2], other=cts[3]),
            Serve.FheRequest(3, "mlkem_decaps", payload={"dk": dk[0], "ct": ct[0]}),
            Serve.FheRequest(4, "mlkem_encaps", payload={"ek": ek[1], "m": m[1]}),
            Serve.FheRequest(5, "rescale", cts[4]),
            Serve.FheRequest(6, "mlkem_decaps", payload={"dk": dk[1], "ct": ct[1]}),
            Serve.FheRequest(7, "mlkem_encaps", payload={"ek": ek[0], "m": m[2]})]
    return drain_both(Serve.CkksServeEngine(ctx.plan(), batch_tile=4), reqs)


@pytest.fixture(scope="module")
def both_engines():
    return (_mixed_drains(RefContext, RS, {}),
            _mixed_drains(CkksContext, serve, {"device": "cpu"}))


@pytest.mark.parametrize("drain", [0, 1], ids=["run", "run_async"])
def test_mixed_queue_equals_reference(both_engines, drain):
    (ref_out, ref_stats), (out, stats) = both_engines[0][drain], both_engines[1][drain]
    assert set(out) == set(ref_out) == set(range(8))
    for rid in ref_out:
        assert _same_answer(ref_out[rid], out[rid]), rid
    assert_same_stats(stats, ref_stats)
    assert stats["groups"] == {"multiply@L2": 2, "rescale@L2": 1,
                               "mlkem_encaps@mlkem": 3, "mlkem_decaps@mlkem": 2}


MK_CTX = CkksContext(n=64, levels=2, seed=11, device="cpu")
MK_RNG = np.random.default_rng(23)


def _mlkem_material(b):
    d, z, m = (MK_RNG.integers(0, 256, (b, 32), dtype=np.uint8) for _ in range(3))
    ek, dk = mlkem.keygen_batch(d, z, device="cpu")
    return ek, dk, m


def _mk_queue(plan, n_ckks=5, n_mlkem=4):
    ek, dk, m = _mlkem_material(n_mlkem)
    reqs, expect, rid = [], {}, 0
    for i in range(max(n_ckks, n_mlkem)):
        if i < n_ckks:
            ca, cb = (MK_CTX.encrypt(MK_CTX.encode(
                MK_RNG.uniform(-1, 1, MK_CTX.slots) + 1j * MK_RNG.uniform(-1, 1, MK_CTX.slots)))
                for _ in range(2))
            reqs.append(FheRequest(rid, "multiply", ca, other=cb))
            expect[rid] = ("ckks", plan.multiply(ca, cb))
            rid += 1
        if i < n_mlkem:
            reqs.append(FheRequest(rid, "mlkem_encaps", payload={"ek": ek[i], "m": m[i]}))
            expect[rid] = ("mlkem", spec.encaps(bytes(ek[i]), bytes(m[i])))
            rid += 1
    return reqs, expect


def _mk_check(out, expect):
    for rid, (scheme, want) in expect.items():
        if scheme == "ckks":
            assert _eq(out[rid], want), rid
        else:
            assert (bytes(out[rid][0]), bytes(out[rid][1])) == want, rid


def test_mixed_scheme_queue_sync_and_async():
    plan = MK_CTX.plan()
    reqs, expect = _mk_queue(plan)
    eng = CkksServeEngine(plan, batch_tile=2)
    out = eng.run(list(reqs))
    _mk_check(out, expect)
    assert not eng.stats["failed"] and eng.stats["dispatches"] == 2
    assert eng.stats["groups"]["mlkem_encaps@mlkem"] == 4
    asy = eng.run_async(list(reqs))
    _mk_check(asy, expect)
    assert not eng.stats["failed"]


def test_mlkem_keygen_decaps_kinds():
    plan = MK_CTX.plan()
    ek, dk, m = _mlkem_material(3)
    key, ct = mlkem.encaps_batch(ek, m, device="cpu")
    reqs = [FheRequest(0, "mlkem_keygen", payload={"d": np.zeros(32, np.uint8),
                                                    "z": np.ones(32, np.uint8)})]
    reqs += [FheRequest(1 + i, "mlkem_decaps", payload={"dk": dk[i], "ct": ct[i]})
             for i in range(3)]
    out = CkksServeEngine(plan, batch_tile=2).run(reqs)
    assert (bytes(out[0][0]), bytes(out[0][1])) == spec.keygen(bytes(32), bytes([1] * 32))
    assert all(bytes(out[1 + i]) == bytes(key[i]) for i in range(3))


def test_cross_scheme_request_fails_alone_and_mixed_batch_is_refused():
    plan = MK_CTX.plan()
    reqs, expect = _mk_queue(plan, n_ckks=2, n_mlkem=2)
    ek, _, m = _mlkem_material(1)
    ckks_ct = MK_CTX.encrypt(MK_CTX.encode(MK_RNG.uniform(-1, 1, MK_CTX.slots)))
    bad = FheRequest(99, "mlkem_encaps", ct=ckks_ct, payload={"ek": ek[0], "m": m[0]})
    eng = CkksServeEngine(plan, batch_tile=2)
    out = eng.run(reqs + [bad])
    _mk_check(out, expect)
    assert 99 not in out and "cross-scheme" in eng.stats["failed"][99]
    with pytest.raises(ValueError, match="cross-scheme"):
        eng._dispatch("rescale", [FheRequest(0, "rescale", ckks_ct),
                                  FheRequest(1, "mlkem_encaps",
                                             payload={"ek": ek[0], "m": m[0]})])
    with pytest.raises(ValueError, match=r"mlkem_encaps.*ek"):
        FheRequest(0, "mlkem_encaps", payload={"m": b"\x00" * 32})
    with pytest.raises(ValueError, match="payload"):
        FheRequest(1, "mlkem_keygen")
    with pytest.raises(ValueError, match="ciphertext"):
        FheRequest(2, "rescale")
