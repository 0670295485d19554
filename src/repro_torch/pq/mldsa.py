"""ML-DSA-65 (FIPS 204) signing on the card, from input bytes to output
bytes, as a stream of fixed-shape slots.

The third scheme of the port, on the u32 lane: q = 8380417 lies below
the RNS window, so its Barrett products take the lane's 23-bit trait
(``core.modmath.BARRETT23_WINDOW``).  Every step runs on its device as
tensor work over all the slots at once, with no loop over rows:

  hashing  mu, rho'', c-tilde and the keys' hashes on Keccak-f[1600]
           (``ops.keccak_shake256``, ``ops.keccak_mu_rho``;
           ``csrc/keccak.cu`` on the card)
  sampling ExpandMask fused with its 20-bit unpack, SampleInBall, and for
           the key ExpandA and ExpandS (``ops.keccak_expand_mask``,
           ``keccak_sample_in_ball``, ``keccak_rej_ntt_poly``,
           ``keccak_rej_bounded``)
  ring     the complete n = 256 transforms of ``core.ringspec.MLDSA_RING``
           on the u32 banks (``ops.ntt_banks`` / ``ops.intt_banks``), and
           the products Â ŷ (l = 5 digits a row) and ĉ ŝ1, ĉ ŝ2, ĉ t̂0 on
           the shared-key digit MAC (``ops.dyadic_inner_banks``) with the
           k rows of the matrix, or the 17 rows of the key, on its prime
           axis: the SAME kernel entry points the CKKS stack uses
  codec    w1Encode, the bounds of Sign_internal and sigEncode
           (``ops.mldsa_w1_encode``, ``mldsa_check``, ``mldsa_emit``;
           ``csrc/mldsa_codec.cu``); the keys' codecs as tensor ops
           (``pq.codec``)

FIPS 204's NTT domain is in bit-reversed order, and so is the port's
(the constant-geometry network of ``MLDSA_RING``'s tree twiddles gives
FIPS 204's order exactly), so ExpandA's Â is used as sampled.

The slot stream (``SignStream``): the rejection loop of Sign_internal
runs a geometric number of iterations a request (5.1 on average), so a
batch run until its last row accepts would do about 10 times the work
at 65,536 rows.  Instead a fixed set of slots runs one iteration each a
round; a slot whose iteration passes every bound writes its signature,
its request's id and its iteration count to an output ring at a place
given by a prefix sum over the accept flags, and takes the next request
of a queue that lives on the device (the head index too); a rejected
slot advances kappa by l.  mu and rho'' run once a request, when it
enters its slot (``keccak_mu_rho``, whose threads past the refill count
do nothing).  No round reads anything back: the host learns how many
signatures completed when it reads ``counters()``.  Idle slots exist
only while a finite queue drains.

Inputs and outputs are uint8 tensors, as in ``pq.mlkem``: M' rows (the
internal interface, FIPS 204 Alg. 7; pure ML-DSA with an empty context
is M' = 0x00 0x00 || M) and per-request rnd of 32 bytes.  ``keygen_batch``
and ``sign_batch`` also take numpy arrays and return numpy arrays then.

Observability: spans ``mldsa.keygen`` and ``mldsa.sign`` (a round), and
inside them ``mldsa.hash``, ``mldsa.sample``, ``mldsa.ring``,
``mldsa.check`` and ``mldsa.refill`` around the launches of each kind
(host time: nothing waits for the card); counters ``mldsa.rounds`` and
``mldsa.keccak_perms`` (the permutations launched, from the shapes: 33
a slot-round at SampleInBall's least one block, and the refills' 3 a
request) counted on the host, and ``mldsa.slot_iterations``,
``mldsa.signatures`` and ``mldsa.row_iterations`` (the iterations the
completed signatures needed), which live on the device and reach
``obs`` when ``counters()`` reads them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.convert import from_reference, resolve_device
from repro_torch.core.modmath import barrett_precompute
from repro_torch.core.ringspec import MLDSA_RING, ring_table_pack
from repro_torch.kernels import ops
from repro_torch.kernels.keccak_kernel import (MASK_PERMS, REJ_BOUNDED_BLOCKS,
                                               REJ_NTT_BLOCKS, sponge_perms)
from repro_torch.pq import codec
from repro_torch.pq.codec import (DSA_CT_BYTES, DSA_D, DSA_ETA, DSA_ETA_BITS, DSA_K,
                                  DSA_L, DSA_SIG_BYTES, DSA_T1_BITS)

N = MLDSA_RING.n            # 256
Q = MLDSA_RING.q            # 8380417
K, L = DSA_K, DSA_L         # 6, 5
MU = barrett_precompute(Q, bits=23)

PK_BYTES = 32 + 32 * K * DSA_T1_BITS                        # 1952
SK_BYTES = 128 + 32 * ((K + L) * DSA_ETA_BITS + K * DSA_D)  # 4032
SIG_BYTES = DSA_SIG_BYTES                                   # 3309
_S_BYTES = 32 * (K + L) * DSA_ETA_BITS                      # s1 and s2 in sk
W1_BYTES = 32 * K * codec.DSA_W1_BITS                       # 768

# Keccak permutations: a slot-round's ExpandMask (l streams of 640
# bytes), c-tilde = H(mu || w1, 48) and SampleInBall at its least one
# block; a keygen row's H(xi || k || l, 128), ExpandA and ExpandS at
# their least blocks and tr = H(pk, 64)
ROUND_PERMS = L * MASK_PERMS + sponge_perms(64 + W1_BYTES, 136, DSA_CT_BYTES) + 1
KEYGEN_PERMS = (sponge_perms(34, 136, 128) + K * L * REJ_NTT_BLOCKS
                + (K + L) * REJ_BOUNDED_BLOCKS + sponge_perms(PK_BYTES, 136, 64))


def refill_perms(msg_len: int) -> int:
    """A request's mu = H(tr || M', 64) and rho'' = H(K || rnd || mu, 64)."""
    return sponge_perms(64 + msg_len, 136, 64) + sponge_perms(128, 136, 64)


# ------------------------------------------------------- inputs, outputs

def _inputs(first, device):
    """The entry point's device (a tensor's own, else ``device`` resolved)
    and whether results go back to the host as numpy."""
    if isinstance(first, torch.Tensor):
        if device is not None and torch.device(device) != first.device:
            raise ValueError(f"ML-DSA: inputs on {first.device}, device={device}")
        return first.device, False
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device, True


def _bytes_in(x, width, name: str, device) -> torch.Tensor:
    """(b, width) uint8 rows on ``device`` (width None: any); a tensor as
    it is, an array moved there."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(device)
    if x.dtype != torch.uint8 or x.ndim != 2 or (width is not None and x.shape[1] != width):
        raise ValueError(f"ML-DSA: {name} must be (b, {width or 'bytes'}) uint8, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"ML-DSA: {name} is on {x.device}, expected {device}")
    return x


def _out(host: bool, *ts):
    return tuple(t.cpu().numpy() for t in ts) if host else ts


# ------------------------------------------- kernel-routed ring algebra

_PACKS: dict = {}


def _pack(device) -> dict:
    """``ring_table_pack(MLDSA_RING)`` as int32 tensors on ``device``,
    moved once per device."""
    key = str(device)
    if key not in _PACKS:
        _PACKS[key] = from_reference(ring_table_pack(MLDSA_RING), device)
    return _PACKS[key]


def _rows_pack(device, rows: int) -> dict:
    """q and its Barrett mu for ``rows`` rows of the digit MAC's prime
    axis, made once per device."""
    key = (str(device), rows)
    if key not in _PACKS:
        _PACKS[key] = {"qs": torch.full((rows,), Q, dtype=torch.int32, device=device),
                       "mu": torch.full((rows,), MU, dtype=torch.int32, device=device)}
    return _PACKS[key]


def _ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT of every (..., 256) int32 row in ONE banks launch
    (residues in, FIPS 204's NTT order out)."""
    out = ops.ntt_banks(x.reshape(1, -1, N), _pack(x.device), negacyclic=False)
    return out.reshape(x.shape)


def _intt(x: torch.Tensor) -> torch.Tensor:
    out = ops.intt_banks(x.reshape(1, -1, N), _pack(x.device), negacyclic=False)
    return out.reshape(x.shape)


def _mac(ext: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(k, B, 256) = sum_d ext[d, i, b] * keys[d, i(, b)] mod q: ext (d,
    k, B, 256), any strides along its first three axes."""
    return ops.dyadic_inner_banks(ext, keys, _rows_pack(ext.device, ext.shape[1]), bits=23)


# ------------------------------------------------------------- keygen

def keygen_batch(xi, device=None):
    """Batched ML-DSA.KeyGen_internal (FIPS 204 Alg. 6) from per-row seeds
    xi (b, 32) uint8.  Returns (pk (b, 1952), sk (b, 4032)) uint8."""
    device, host = _inputs(xi, device)
    xi = _bytes_in(xi, 32, "xi", device)
    b = xi.shape[0]
    with obs.span("mldsa.keygen", b=b):
        with obs.span("mldsa.hash", b=b):
            kl = torch.tensor([[K, L]], dtype=torch.uint8, device=device).expand(b, 2)
            seed = ops.keccak_shake256(xi, kl, out_len=128)   # (rho, rho', K)
        rho, rho_p, key = seed[:, :32], seed[:, 32:96], seed[:, 96:]
        with obs.span("mldsa.sample", b=b):
            a_hat = ops.keccak_rej_ntt_poly(rho)              # (b, k, l, n)
            s = ops.keccak_rej_bounded(rho_p, n0=0, count=L + K)
        with obs.span("mldsa.ring", b=b):
            s1_hat = _ntt(s[:, :L])
            ext = s1_hat.transpose(0, 1)[:, None].expand(L, K, b, N)
            t = _intt(_mac(ext, a_hat.permute(2, 1, 0, 3))).transpose(0, 1)
            t = (t.long() + s[:, L:]) % Q
        t1, t0 = codec.power2round(t)
        pk = torch.cat([rho, codec.pack_bits(t1, DSA_T1_BITS).flatten(1)], 1)
        with obs.span("mldsa.hash", b=b):
            tr = ops.keccak_shake256(pk, out_len=64)
        sk = torch.cat([rho, key, tr,
                        codec.pack_bits(DSA_ETA - codec.centered(s), DSA_ETA_BITS).flatten(1),
                        codec.pack_bits((1 << (DSA_D - 1)) - t0, DSA_D).flatten(1)], 1)
    if obs.enabled():
        obs.counter_add("mldsa.keccak_perms", b * KEYGEN_PERMS)
    return _out(host, pk, sk)


@dataclasses.dataclass
class SigningKey:
    """One secret key as the signing loop reads it: Â as the digit MAC's
    keys (l, k, 256), the NTT-domain rows ŝ1, ŝ2, t̂0 as its one-digit
    keys (1, l + 2k, 256), all int32; tr (64,) and K (32,) uint8."""
    a_mac: torch.Tensor
    s_keys: torch.Tensor
    tr: torch.Tensor
    key: torch.Tensor


def expand_key(sk) -> SigningKey:
    """skDecode (FIPS 204 Alg. 25), ExpandA and the NTTs of s1, s2 and t0,
    once a key, on sk's device: sk (4032,) or (1, 4032) uint8."""
    sk = sk.reshape(-1)
    if sk.dtype != torch.uint8 or sk.numel() != SK_BYTES:
        raise ValueError(f"ML-DSA: sk must be {SK_BYTES} uint8 bytes, got {sk.dtype} "
                         f"{tuple(sk.shape)}")
    s = DSA_ETA - codec.unpack_bits(sk[128:128 + _S_BYTES], DSA_ETA_BITS)
    t0 = (1 << (DSA_D - 1)) - codec.unpack_bits(sk[128 + _S_BYTES:], DSA_D)
    rows = (torch.cat([s, t0]) % Q).int().reshape(L + 2 * K, N)
    a_hat = ops.keccak_rej_ntt_poly(sk[None, :32])[0]        # (k, l, n)
    return SigningKey(a_mac=a_hat.transpose(0, 1).contiguous(), s_keys=_ntt(rows)[None],
                      tr=sk[64:128], key=sk[32:64])


# ------------------------------------------------------- the slot stream

class SignStream:
    """Sign_internal over one key for a queue of requests, ``slots`` rows
    in flight (see the module docstring).

    sk: (4032,) uint8; msgs (P, m) and rnds (P, 32) uint8, the queue, on
    the device the stream runs on.  ``cycle`` runs the queue as a
    backlog that never empties (request r signs msgs[r % P]); without it
    the stream drains after P requests.  The output ring holds the last
    ``ring`` completions (default P): ``results()`` gives their request
    ids (-1 where none was written yet), signatures and iteration
    counts."""

    def __init__(self, sk, msgs, rnds, slots: int, *, cycle: bool = False, ring=None):
        dev = msgs.device
        msgs = _bytes_in(msgs, None, "msgs", dev)
        rnds = _bytes_in(rnds, 32, "rnds", dev)
        if rnds.shape[0] != msgs.shape[0] or slots < 1:
            raise ValueError(f"ML-DSA: {msgs.shape[0]} messages, {rnds.shape[0]} rnd rows, "
                             f"{slots} slots")
        self.key = expand_key(sk)
        self.msgs, self.rnds, self.cycle = msgs, rnds, cycle
        self.slots, self.queue = slots, msgs.shape[0]
        self.ring_rows = ring or self.queue
        self.rounds = 0
        S, R = slots, self.ring_rows
        z = lambda *shape, dt: torch.zeros(shape, dtype=dt, device=dev)
        self.mu, self.rho = z(S + 1, 64, dt=torch.uint8), z(S + 1, 64, dt=torch.uint8)
        self.kappa = z(S, dt=torch.int32)
        self.ids = torch.full((S,), -1, dtype=torch.int64, device=dev)
        self.active = z(S, dt=torch.bool)
        self.head, self.out_count = z(1, dt=torch.int64), z(1, dt=torch.int64)
        # slot_iterations, signatures, row_iterations, refills
        self._ctr = z(4, dt=torch.int64)
        self._folded = [0, 0, 0, 0]
        self.ring = z(R + 1, SIG_BYTES, dt=torch.uint8)
        self.ring_ids = torch.full((R + 1,), -1, dtype=torch.int64, device=dev)
        self.ring_iters = z(R + 1, dt=torch.int32)
        self._iota = torch.arange(S, device=dev)
        with obs.span("mldsa.refill", slots=S):
            self._refill(torch.ones(S, dtype=torch.bool, device=dev))

    def _refill(self, free: torch.Tensor) -> None:
        """Every free slot (accepted, or idle) takes the next request of the
        queue, or goes idle past a finite queue's end; the new requests'
        mu and rho'' are hashed into their slots."""
        S = self.slots
        rank = free.cumsum(0) - 1
        idx = self.head + rank
        valid = free if self.cycle else free & (idx < self.queue)
        self.ids = torch.where(free, torch.where(valid, idx, -1), self.ids)
        self.active = torch.where(free, valid, self.active)
        self.kappa = torch.where(free, 0, self.kappa)
        self.head += free.sum()
        # the valid slots are the first of the free ones in rank order
        pos = torch.where(valid, rank, S)
        slots = torch.full((S + 1,), S, dtype=torch.int64, device=free.device)
        slots.scatter_(0, pos, self._iota)
        reqs = torch.zeros((S + 1,), dtype=torch.int64, device=free.device)
        reqs.scatter_(0, pos, idx % self.queue)
        count = valid.sum().reshape(1)
        self._ctr[3:] += count
        ops.keccak_mu_rho(self.key.tr, self.key.key, self.msgs, self.rnds, slots[:S],
                          reqs[:S], count, self.mu, self.rho)

    def _round(self) -> None:
        S, key = self.slots, self.key
        mu, rho = self.mu[:S], self.rho[:S]
        with obs.span("mldsa.sample", slots=S):
            y = ops.keccak_expand_mask(rho, self.kappa)          # (S, l, n)
        with obs.span("mldsa.ring", slots=S):
            y_hat = _ntt(y)
            w = _intt(_mac(y_hat.transpose(0, 1)[:, None].expand(L, K, S, N), key.a_mac))
        with obs.span("mldsa.hash", slots=S):
            ct = ops.keccak_shake256(mu, ops.mldsa_w1_encode(w), out_len=DSA_CT_BYTES)
        with obs.span("mldsa.sample", slots=S):
            c = ops.keccak_sample_in_ball(ct)
        with obs.span("mldsa.ring", slots=S):
            c_hat = _ntt(c)
            cs = _intt(_mac(c_hat[None, None].expand(1, L + 2 * K, S, N), key.s_keys))
        with obs.span("mldsa.check", slots=S):
            ok = ops.mldsa_check(y, w, cs, self.active)
        with obs.span("mldsa.refill", slots=S):
            rank = ok.cumsum(0)
            done = rank[-1:]
            dest = torch.where(ok, (self.out_count + rank - 1) % self.ring_rows,
                               self.ring_rows)
            ops.mldsa_emit(ct, y, w, cs, dest, self.ids, self.kappa, self.ring,
                           self.ring_ids, self.ring_iters)
            iters = (self.kappa // L + 1).long()
            self._ctr[:3] += torch.cat([self.active.sum().reshape(1), done,
                                        (iters * ok).sum().reshape(1)])
            self.out_count += done
            self.kappa = torch.where(self.active & ~ok, self.kappa + L, self.kappa)
            self._refill(ok | ~self.active)

    def advance(self, rounds: int = 1) -> None:
        """Run ``rounds`` rounds: every slot one iteration of the loop."""
        for _ in range(rounds):
            with obs.span("mldsa.sign", slots=self.slots):
                self._round()
            self.rounds += 1
            if obs.enabled():
                obs.counter_add("mldsa.rounds")
                obs.counter_add("mldsa.keccak_perms", self.slots * ROUND_PERMS)

    def counters(self) -> dict:
        """The stream's counts so far, read from the device (one read-back):
        rounds, slot_iterations (active slot-rounds), signatures,
        row_iterations (the iterations the completed signatures needed)
        and refills (requests taken into slots).  Folds what changed
        since the last read into ``obs``."""
        got = self._ctr.tolist()
        if obs.enabled():
            delta = [a - b for a, b in zip(got, self._folded)]
            for name, d in zip(("slot_iterations", "signatures", "row_iterations"), delta):
                obs.counter_add(f"mldsa.{name}", d)
            obs.counter_add("mldsa.keccak_perms", delta[3] * refill_perms(self.msgs.shape[1]))
        self._folded = got
        return {"rounds": self.rounds, "slot_iterations": got[0], "signatures": got[1],
                "row_iterations": got[2], "refills": got[3]}

    def results(self):
        """(ids (R,) int64, signatures (R, 3309) uint8, iterations (R,)
        int32) of the output ring, on the device; id -1 where no signature
        was written yet.  Entry (out_count - 1) % R is the newest."""
        R = self.ring_rows
        return self.ring_ids[:R], self.ring[:R], self.ring_iters[:R]


def sign_batch(sk, msg, rnd, device=None):
    """Batched ML-DSA.Sign_internal (FIPS 204 Alg. 7) under one key: sk
    (4032,) or (1, 4032) uint8, msg (b, m) the M' rows, rnd (b, 32).  Runs
    a slot stream of b slots over the batch until it drains, reading its
    counter between steps of rounds.  Returns (signatures (b, 3309) uint8,
    iterations (b,) int32), row for row."""
    device, host = _inputs(msg, device)
    msg = _bytes_in(msg, None, "msg", device)
    rnd = _bytes_in(rnd, 32, "rnd", device)
    if not isinstance(sk, torch.Tensor):
        sk = torch.from_numpy(np.ascontiguousarray(sk, dtype=np.uint8))
    b = msg.shape[0]
    if b == 0:
        return _out(host, torch.zeros((0, SIG_BYTES), dtype=torch.uint8, device=device),
                    torch.zeros((0,), dtype=torch.int32, device=device))
    stream = SignStream(sk.to(device), msg, rnd, b)
    step = 1
    while stream.counters()["signatures"] < b:
        stream.advance(step)
        step = min(2 * step, 16)
    ids, sigs, iters = stream.results()
    order = torch.argsort(ids)
    return _out(host, sigs[order], iters[order])
