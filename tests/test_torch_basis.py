"""The key switch's RNS base conversions: ``ops.extend_centered_banks``
(the mod-up) and ``ops.mod_down_tail_banks`` (the mod-down's tail, with
its addend).

On the CPU their plain path is held bit for bit against the reference's
``extend_centered`` / ``mod_down_banks`` and against the int64 PyTorch
chains they replace (kept here as written before), with edge residues
0, 1, (q-1)/2, (q+1)/2 and q-1 on the source and destination primes.
On the card (marked ``gpu``; they skip where no CUDA device is present)
each kernel is held against its plain version at the key-switch cell's
shapes (8 + 1 primes, B = 32, n = 2^14) and at the edge residues, and a
CUDA-graph capture of ``galois_ks_many_banks`` against the eager program
and the CPU:

    PYTHONPATH=src python -m pytest -q tests/test_torch_basis.py
"""
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import modmath as RM
from repro.fhe import batched as RB

from repro_torch import kernels as K
from repro_torch.convert import from_reference, tensor_to_u32, u32_to_tensor
from repro_torch.core.modmath import addmod, mulmod_shoup, submod, u32
from repro_torch.core.params import gen_ntt_primes
from repro_torch.fhe import batched as TB
from repro_torch.fhe import rns
from repro_torch.kernels import ops, ref

# two intra-op threads: the suite runs several test processes side by side
torch.set_num_threads(2)

KT = 9                                       # 8 basis primes + special P


def _primes(n, bits=30):
    return tuple(gen_ntt_primes(KT, n, bits=bits))


def _edges(q):
    return [0, 1, (q - 1) // 2, (q + 1) // 2, q - 1]


def _digits(rng, src, dst, b, n):
    """(d, B, n) uniform digits mod src; each row starts with the edge
    residues of its source prime and the values that land on a
    destination prime's edges (q_d - 1, q_d, q_d + 1 and q_s - q_d + e)."""
    out = np.stack([rng.integers(0, q, (b, n), dtype=np.int64) for q in src])
    for i, qs in enumerate(src):
        vals = _edges(qs) + [qs - 2]
        for qd in dst:
            vals += [qd - 1, qd, qd + 1, qs - qd - 1, qs - qd, qs - qd + 1]
        vals = [v for v in vals if 0 <= v < qs][:n]
        out[i, 0, :len(vals)] = vals
    return out.astype(np.uint32)


def _pairs(rng, qs, b, n):
    """(k, B, n) acc and extn, uniform mod q_j, each row starting with
    every pair of q_j's edge residues."""
    acc = np.stack([rng.integers(0, q, (b, n), dtype=np.int64) for q in qs])
    ext = np.stack([rng.integers(0, q, (b, n), dtype=np.int64) for q in qs])
    for j, q in enumerate(qs):
        e = _edges(q)
        pairs = [(x, y) for x in e for y in e][:n]
        acc[j, 0, :len(pairs)] = [x for x, _ in pairs]
        ext[j, 0, :len(pairs)] = [y for _, y in pairs]
    return acc.astype(np.uint32), ext.astype(np.uint32)


def _old_extend(coeffs, src_q, dst_qs):
    """The int64 chain ``fhe.batched.extend_centered`` ran for one digit
    before the mod-up had its own entry point."""
    c = coeffs.long()
    sq = u32(src_q).reshape(())
    c = torch.where(c > sq // 2, c - sq, c)
    qd = u32(dst_qs).reshape((-1,) + (1,) * c.ndim)
    return torch.remainder(c.unsqueeze(0), qd).int()


def _old_tail(acc, extn, t, addend, batch_leading):
    """The int64 chain ``mod_down_banks`` ran before the tail had its own
    entry point, with the programs' final ``addmod`` of c0."""
    k = extn.shape[0]
    qcol = u32(t["qs"][:k])[:, None, None]
    d = submod(acc[:k].long(), extn.long(), qcol)
    ks = mulmod_shoup(d, u32(t["pinv"])[:, None, None],
                      u32(t["pinv_p"])[:, None, None], qcol).int()
    if batch_leading:
        ks, qcol = ks.transpose(0, 1), qcol.transpose(0, 1)
    if addend is None:
        return ks
    axis = 0 if batch_leading else 1
    ba = addend.shape[axis]
    head = addmod(addend.long(), ks.narrow(axis, 0, ba).long(), qcol).int()
    return torch.cat([head, ks.narrow(axis, ba, ks.shape[axis] - ba)], dim=axis)


def _ref_tail(acc, extn, t, addend, batch_leading):
    """The reference's tail (``repro.fhe.batched.mod_down_banks``' last two
    ops) and its programs' ``addmod``, on uint32 arrays."""
    k = extn.shape[0]
    q = jnp.asarray(t["qs"][:k])[:, None, None]
    d = RM.submod(jnp.asarray(acc[:k]), jnp.asarray(extn), q)
    ks = np.asarray(RM.mulmod_shoup(d, jnp.asarray(t["pinv"])[:, None, None],
                                    jnp.asarray(t["pinv_p"])[:, None, None], q))
    if batch_leading:
        ks = ks.transpose(1, 0, 2)
    if addend is None:
        return ks
    qa = np.asarray(t["qs"][:k], dtype=np.uint32)[:, None, None]
    if batch_leading:
        qa = qa.transpose(1, 0, 2)
    ba = addend.shape[0 if batch_leading else 1]
    head = ks[:ba] if batch_leading else ks[:, :ba]
    head = np.asarray(RM.addmod(jnp.asarray(addend), jnp.asarray(head), jnp.asarray(qa)))
    return np.concatenate([head, ks[ba:] if batch_leading else ks[:, ba:]],
                          axis=0 if batch_leading else 1)


# (kind, d or k, B, n, variant): every B of 1, 2, 32, d = 1 and 8, n = 2^12
# and 2^14, foreign source primes, a destination prime below q_src / 2,
# the addend given (all columns or the first half) or not, both layouts
CASES = [
    ("extend", 1, 1, 1 << 12, "own"),
    ("extend", 8, 2, 1 << 12, "foreign"),
    ("extend", 8, 1, 1 << 14, "own"),
    ("extend", 1, 32, 1 << 12, "foreign"),
    ("extend", 8, 32, 1 << 12, "own"),
    ("extend", 1, 2, 1 << 14, "small-dst"),
    ("tail", 8, 1, 1 << 12, "none"),
    ("tail", 8, 2, 1 << 14, "add"),
    ("tail", 8, 32, 1 << 12, "add-leading"),
    ("tail", 8, 32, 1 << 12, "add-half"),
    ("tail", 8, 2, 1 << 14, "leading"),
    ("mod_down", 8, 2, 1 << 12, "add"),
    ("mod_down", 8, 2, 1 << 14, "add-leading"),
    ("mod_down", 8, 1, 1 << 14, "none"),
    ("decompose", 8, 1, 1 << 12, "own"),
    ("decompose", 8, 2, 1 << 14, "foreign"),
]


def _id(case):
    kind, d, b, n, var = case
    return f"{kind}-d{d}-B{b}-n{n.bit_length() - 1}-{var}"


def _tables(n):
    primes = _primes(n)
    rt = RB.build_table_pack(list(primes), n) if n < 1 << 13 else RB.build_scalar_pack(list(primes))
    rfs = RB.build_fourstep_pack(list(primes), n) if n >= 1 << 13 else None
    return primes, rt, rfs, from_reference(rt, "cpu"), rfs and from_reference(rfs, "cpu")


def _addend(rng, primes, b, n, var):
    """(addend as uint32 in the output's layout, batch_leading) for a tail
    variant; "add-half" covers the first half of the batch columns."""
    leading = "leading" in var
    if not var.startswith("add"):
        return None, leading
    ba = b // 2 if var == "add-half" else b
    rows = np.stack([rng.integers(0, q, (ba, n), dtype=np.int64) for q in primes[:-1]])
    rows[:, 0, :5] = [_edges(q) for q in primes[:-1]]
    rows = rows.astype(np.uint32)
    return (rows.transpose(1, 0, 2).copy() if leading else rows), leading


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plain_path_equals_reference(case):
    kind, d, b, n, var = case
    rng = np.random.default_rng(zlib.crc32(_id(case).encode()))
    K.reset_counts()
    if kind == "extend":
        dst = list(_primes(n))
        if var == "small-dst":
            dst = [12289, 3329] + dst[2:]
        src = list(_primes(n, bits=29))[:d] if var == "foreign" else list(_primes(n))[:d]
        ci = _digits(rng, src, dst, b, n)
        got = ops.extend_centered_banks(u32_to_tensor(ci, "cpu"),
                                        u32_to_tensor(np.array(src, np.uint32), "cpu"),
                                        u32_to_tensor(np.array(dst, np.uint32), "cpu"))
        want = np.stack([np.asarray(RB.extend_centered(jnp.asarray(ci[i]), jnp.uint32(src[i]),
                                                       jnp.asarray(np.array(dst, np.uint32))))
                         for i in range(d)], axis=1)               # (kt, d, B, n)
        assert got.shape == (len(dst), d, b, n)
        assert np.array_equal(tensor_to_u32(got), want)
        # the torch chain this replaced: one digit at a time, stacked
        qs = u32_to_tensor(np.array(src, np.uint32), "cpu")
        old = torch.stack([_old_extend(u32_to_tensor(ci[i], "cpu"), qs[i],
                                       u32_to_tensor(np.array(dst, np.uint32), "cpu"))
                           for i in range(d)], dim=1)
        assert torch.equal(got, old)
        assert K.snapshot()["extend_centered"]["launches"] == 0
        return
    primes, rt, rfs, pt, pfs = _tables(n)
    add, leading = _addend(rng, primes, b, n, var)
    add_t = None if add is None else u32_to_tensor(add, "cpu")
    if kind == "tail":
        acc, extn = _pairs(rng, primes[:-1], b, n)
        acc = np.concatenate([acc, rng.integers(0, primes[-1], (1, b, n)).astype(np.uint32)])
        acc_t, extn_t = u32_to_tensor(acc, "cpu"), u32_to_tensor(extn, "cpu")
        got = ops.mod_down_tail_banks(acc_t, extn_t, pt, addend=add_t, batch_leading=leading)
        assert got.is_contiguous()
        assert torch.equal(got, _old_tail(acc_t, extn_t, pt, add_t, leading))
        assert np.array_equal(tensor_to_u32(got), _ref_tail(acc, extn, rt, add, leading))
        assert K.snapshot()["mod_down_tail"]["plain_calls"] == 1
        return
    if kind == "mod_down":
        acc = np.stack([rng.integers(0, q, (b, n), dtype=np.int64) for q in primes])
        acc[:, 0, :5] = [_edges(q) for q in primes]
        acc = acc.astype(np.uint32)
        got = TB.mod_down_banks(u32_to_tensor(acc, "cpu"), pt, fsp=pfs, addend=add_t,
                                batch_leading=leading)
        ks = np.asarray(RB.mod_down_banks(jnp.asarray(acc), rt, fsp=rfs, use_pallas=False))
        want = ks.transpose(1, 0, 2) if leading else ks
        if add is not None:
            qa = np.array(primes[:-1], np.uint32)[:, None, None]
            qa = qa.transpose(1, 0, 2) if leading else qa
            want = np.asarray(RM.addmod(jnp.asarray(add), jnp.asarray(want), jnp.asarray(qa)))
        assert np.array_equal(tensor_to_u32(got), want)
        return
    # decompose: decompose_extend of digits mod src (foreign: a shard's
    # digits of another basis) against the reference's per-digit extension
    src = list(_primes(n, bits=29))[:d] if var == "foreign" else list(primes[:d])
    ci = _digits(rng, src, primes, b, n)
    got = TB.decompose_extend(u32_to_tensor(ci, "cpu"),
                              u32_to_tensor(np.array(src, np.uint32), "cpu"), pt, fsp=pfs)
    ext = np.stack([np.asarray(RB.extend_centered(jnp.asarray(ci[i]), jnp.uint32(src[i]),
                                                  jnp.asarray(rt["qs"])))
                    for i in range(d)])                          # (d, kt, B, n)
    fwd = (RB._fwd_banks(jnp.asarray(ext.transpose(1, 0, 2, 3)), rt, rfs,
                         dict(use_pallas=False, tile=None, lazy=True)))
    assert np.array_equal(tensor_to_u32(got), np.asarray(fwd).transpose(1, 0, 2, 3))


# ------------------------------------------------------------------ card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(seed, dst, n=1 << 14, b=32, d=8):
    rng = np.random.default_rng(seed)
    primes = _primes(n)
    ci = _digits(rng, primes[:d], dst, b, n)
    acc, extn = _pairs(rng, primes[:-1], b, n)
    acc = np.concatenate([acc, rng.integers(0, primes[-1], (1, b, n)).astype(np.uint32)])
    add = np.stack([rng.integers(0, q, (b, n), dtype=np.int64) for q in primes[:-1]])
    add = add.astype(np.uint32)
    dev = torch.device("cuda")
    return primes, {name: u32_to_tensor(v, dev) for name, v in
                    (("ci", ci), ("acc", acc), ("extn", extn), ("add", add))}


@pytest.mark.gpu
@pytest.mark.parametrize("edge", [False, True], ids=["random", "edges"])
def test_kernels_equal_plain_at_cell_shapes(edge):
    """Both kernels at the key-switch cell's shapes (d = 8 digits onto 8 + 1
    primes, B = 32, n = 2^14), each against its plain version on the same
    card tensors; "edges" adds a destination prime below q_src / 2 and
    unaligned views (the one-word bodies)."""
    cuda = _cuda()
    seed = int(np.random.SeedSequence().entropy % 2**32)
    primes = _primes(1 << 14)
    dst_primes = ([12289, 3329] + list(primes[2:])) if edge else list(primes)
    primes, x = _card_inputs(seed, dst_primes)
    t = rns.scalar_pack(primes, cuda)
    src = t["qs"][:8]
    dst = u32_to_tensor(np.array(dst_primes, np.uint32), cuda)
    K.reset_counts()
    got = ops.extend_centered_banks(x["ci"], src, dst)
    assert torch.equal(got, ref.extend_centered_ref(x["ci"], src, dst)), seed
    for leading in (False, True):
        add = x["add"].transpose(0, 1) if leading else x["add"]
        got = ops.mod_down_tail_banks(x["acc"], x["extn"], t, addend=add,
                                      batch_leading=leading)
        want = ref.mod_down_tail_ref(x["acc"][:8], x["extn"], t["qs"][:8], t["pinv"],
                                     t["pinv_p"], add, batch_leading=leading)
        assert torch.equal(got, want), (seed, leading)
    if edge:
        # odd words a row and views one word off alignment: the scalar bodies
        ci = x["ci"][:, :3, 1:-2]
        assert torch.equal(ops.extend_centered_banks(ci, src, dst),
                           ref.extend_centered_ref(ci.contiguous(), src, dst))
        acc, extn = x["acc"][:, :3, 1:-2], x["extn"][:, :3, 1:-2]
        add = x["add"][:, :2, 1:-2]
        got = ops.mod_down_tail_banks(acc, extn, t, addend=add)
        want = ref.mod_down_tail_ref(acc[:8], extn, t["qs"][:8], t["pinv"], t["pinv_p"],
                                     add, batch_leading=False)
        assert torch.equal(got, want)
    c = K.snapshot()
    assert c["extend_centered"]["launches"] >= 1 and c["mod_down_tail"]["launches"] >= 2


@pytest.mark.gpu
def test_galois_ks_many_graph_equals_eager_and_cpu():
    """``galois_ks_many_banks`` (B = 4, 8 + 1 primes, n = 2^14, mixed gather
    rows and per-ciphertext keys) captured in a CUDA graph and replayed
    equals the eager program on the card, which equals the CPU's."""
    from repro_torch.core.params import galois_eval_perm
    from repro_torch.fhe.evalplan import galois_ks_many_banks

    cuda = _cuda()
    n, b = 1 << 14, 4
    primes = _primes(n)
    rng = np.random.default_rng(int(np.random.SeedSequence().entropy % 2**32))
    c0 = np.stack([[rng.integers(0, q, n) for q in primes[:-1]] for _ in range(b)])
    c1 = np.stack([[rng.integers(0, q, n) for q in primes[:-1]] for _ in range(b)])
    keys = [np.stack([np.stack([rng.integers(0, q, (b, n)) for q in primes])
                      for _ in range(8)]) for _ in range(2)]
    idx = np.stack([galois_eval_perm(pow(5, r, 2 * n), n, natural=True)
                    for r in range(1, b + 1)])
    host = [torch.from_numpy(a.astype(np.int32)) for a in (c0, c1, idx, *keys)]

    def run(device, tensors):
        t = rns.scalar_pack(primes, device)
        fsp = rns.fourstep_basis_pack(primes, n, device)
        return galois_ks_many_banks(*tensors[:3], *tensors[3:], t, fsp)

    dev = [h.to(cuda) for h in host]
    eager = run(cuda, dev)
    torch.cuda.synchronize()
    static = [h.clone() for h in dev]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(cuda, static)                          # warm: tables and builds
    torch.cuda.current_stream().wait_stream(side)
    K.reset_counts()
    with torch.cuda.graph(graph):
        out = run(cuda, static)
    c = K.snapshot()
    # the mod-up of every digit, one extension in each mod-down, two tails
    assert c["extend_centered"]["launches"] == 3 and c["mod_down_tail"]["launches"] == 2
    assert all(v["plain_calls"] == 0 for v in c.values())
    for s, h in zip(static, dev):
        s.copy_(h)
    graph.replay()
    torch.cuda.synchronize()
    for g, e in zip(out, eager):
        assert torch.equal(g, e)
    cpu = run("cpu", host)
    for e, c in zip(eager, cpu):
        assert torch.equal(e.cpu(), c)
