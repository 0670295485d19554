"""ML-DSA-65 as a TLS 1.3 server's CertificateVerify signer: the port's
``pq.mldsa.SignStream`` over one key, fed from a backlog that never
empties, rounds back to back with no synchronisation until the window
ends.

The key comes from a seeded xi through the port's keygen on the card.
The backlog is a pool of requests on the device, made from the seed in
set-up and cycled: each M' = 0x00 0x00 || 64 x 0x20 || the context
string || 0x00 || a 32-byte transcript hash (pure ML-DSA, empty
context), with its own 32-byte rnd.  Set-up runs the stream until every
slot holds a request past the first ``slots`` (each slot has turned over
once), so the window sees the steady state.  ``requests_per_s`` counts
the signatures completed inside the window over its wall time, read from
the stream's counters (on the device) once after the window's
synchronize.

The check makes the key anew with the plain reference's KeyGen_internal
from xi and holds the program's pk and sk to it byte for byte.  It takes
a seeded sample of the output ring among its newest completions and
holds each entry against the reference under the reference's key: its
signature byte for byte with Sign_internal on its request, the
reference's Verify on it, its iteration count, and entries missing.  It
reads every id of the ring's newest entries once and counts a request
held twice as missing, and holds the signatures counter (which
``requests_per_s`` reads) to the requests the backlog handed out.
``check(control=True)`` puts in the program's place the reference with
the bound on ||z|| left out; ``keep_without_program`` draws its sample
with no stream, for ``bench/tools/control.py``.

The traced sub-window records the signatures completed in it and the
iterations they needed, the stream's counters, the port's kernels and
the names of the Keccak kernels (``csrc/keccak.cu``) and of the ring's
(``csrc/ntt_regs.cuh``, where the banks' body is, ``csrc/ntt_banks.cu``
and ``csrc/dyadic_inner.cu``), which the ``*.mldsa`` readers take.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchlib import trace, traffic as T
from benchlib.systems.mlkem_bulk import kernels_of
from reference import mldsa as R

COUNTERS = ("rounds", "slot_iterations", "signatures", "row_iterations", "refills")
STATED = {"n": R.N, "q": R.Q, "zeta": R.ZETA, "d": R.D, "tau": R.TAU, "lambda": R.LAMBDA,
          "gamma1": R.GAMMA1, "gamma2": R.GAMMA2, "k": R.K, "l": R.L, "eta": R.ETA,
          "beta": R.BETA, "omega": R.OMEGA, "pk_bytes": R.PK_BYTES, "sk_bytes": R.SK_BYTES,
          "sig_bytes": R.SIG_BYTES}


def message_prefix(context: str) -> bytes:
    """M' before the transcript hash: pure ML-DSA's 0x00 0x00 (empty
    context), then RFC 8446's 64 spaces, the context string and 0x00."""
    return b"\x00\x00" + b" " * 64 + context.encode() + b"\x00"


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        cfg, mix = cell.config, cell.traffic
        self.mix = mix
        stated = {key: cfg[key] for key in STATED}
        if stated != STATED:
            raise ValueError(f"mldsa_stream runs ML-DSA-65 only, the configuration states "
                             f"{stated}")
        self.xi = T.stream(seed, T.SAMPLE).integers(0, 256, (1, 32), dtype=np.uint8)
        pool, dev = mix["pool"], self.device
        gen = torch.Generator(device=dev).manual_seed(T.torch_seed(seed, 9))
        prefix = torch.tensor(list(message_prefix(mix["context"])), dtype=torch.uint8,
                              device=dev)
        hashes = torch.randint(0, 256, (pool, mix["transcript_hash_bytes"]), generator=gen,
                               device=dev, dtype=torch.uint8)
        self.msgs = torch.cat([prefix.expand(pool, -1), hashes], 1)
        self.rnds = torch.randint(0, 256, (pool, 32), generator=gen, device=dev,
                                  dtype=torch.uint8)
        self.kept = None

    def setup(self) -> None:
        from repro_torch.pq import mldsa
        pk, sk = mldsa.keygen_batch(torch.from_numpy(self.xi).to(self.device))
        self.pk, self.sk = pk[0], sk[0]
        slots = self.mix["slots"]
        self.stream = mldsa.SignStream(self.sk, self.msgs, self.rnds, slots, cycle=True,
                                       ring=self.mix["ring"])
        while int(self.stream.ids.min()) < slots:        # every slot has turned over
            self.stream.advance(8)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        stream = self.stream
        c0 = stream.counters()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            stream.advance()
            if time.perf_counter() >= deadline:
                break
        self._sync()
        wall = time.perf_counter() - t0
        c1 = stream.counters()
        got = {k: c1[k] - c0[k] for k in COUNTERS}
        done = got["signatures"]
        print(f"[mldsa] window: {got}; slot-iterations a signature "
              f"{got['slot_iterations'] / max(done, 1)}, iterations a signature "
              f"{got['row_iterations'] / max(done, 1)}", file=sys.stderr, flush=True)
        return {"metrics": {"requests_per_s": done / wall}, "attempted": done, "failed": 0,
                "window_s": wall, "counters": got}

    def profile(self, seconds: float) -> dict:
        root = self.cell.root
        rec: dict = {"port": trace.port_kernels(root),
                     "keccak_kernels": kernels_of(root, "keccak.cu"),
                     "ring_kernels": kernels_of(root, "ntt_regs.cuh", "ntt_banks.cu",
                                                  "dyadic_inner.cu")}
        stream = self.stream
        c0 = stream.counters()
        with trace.profiled(rec, host=self.mix.get("profile_host", True)):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                stream.advance()
        c1 = stream.counters()
        rec["requests"] = c1["signatures"] - c0["signatures"]
        rec["row_iterations"] = c1["row_iterations"] - c0["row_iterations"]
        return rec

    def free(self) -> None:
        """Keep the sampled ring entries (on the host) and the key, and
        drop the stream."""
        if getattr(self, "stream", None) is not None:
            self._keep(self.stream)
            self.pk, self.sk = self.pk.cpu(), self.sk.cpu()
            del self.stream
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self, total: int) -> np.ndarray:
        """How far back from the newest of ``total`` completions each
        sampled ring entry lies, drawn with the seed."""
        newest = min(self.mix["ring"], total)
        return T.stream(self.seed, T.SAMPLE, 1).choice(newest, min(self.mix["sample"], newest),
                                                       replace=False)

    def _keep(self, stream) -> None:
        """The sampled entries as (request id, signature, iterations, M',
        rnd) rows; besides, the ring's newest entries that hold no request
        or one another entry holds too, and the signatures the counters
        count beyond the requests the backlog handed out (``head`` less the
        slots, in a cycled stream)."""
        ids, sigs, iters = stream.results()
        total = int(stream.out_count)
        back = self._sample(total)
        places = torch.from_numpy((total - 1 - back) % stream.ring_rows).to(ids.device)
        got = ids.index_select(0, places)
        req = torch.where(got >= 0, got, 0) % self.msgs.shape[0]
        rows = lambda t: map(bytes, t.index_select(0, req).cpu().numpy())
        self.kept = list(zip(got.tolist(), map(bytes, sigs.index_select(0, places).cpu().numpy()),
                             iters.index_select(0, places).tolist(), rows(self.msgs),
                             rows(self.rnds)))
        held = ids[:min(stream.ring_rows, total)]
        signatures = stream.counters()["signatures"]
        handed_out = int(stream.head) - stream.slots
        self.unaccounted = (len(held) - int(torch.unique(held[held >= 0]).numel())
                            + abs(signatures - handed_out) + abs(total - signatures))
        self.short = self.mix["sample"] - len(back)

    def keep_without_program(self, seconds: float, signatures: int) -> None:
        """What a run that completed ``signatures`` signatures would keep,
        with no program run, its completions taken in request order: the
        control's sample."""
        back = self._sample(signatures)
        got = signatures - 1 - back
        req = torch.from_numpy(got % self.msgs.shape[0]).to(self.device)
        rows = lambda t: map(bytes, t.index_select(0, req).cpu().numpy())
        self.kept = list(zip(got.tolist(), [None] * len(got), [None] * len(got),
                             rows(self.msgs), rows(self.rnds)))
        self.unaccounted, self.short = 0, self.mix["sample"] - len(back)

    def check(self, control: bool = False) -> dict:
        """Over the sampled entries: bytes that differ from the reference's
        Sign_internal, signatures its Verify rejects and iteration counts
        that differ, each under the key the reference's KeyGen_internal
        makes from xi, whose bytes the program's key is held to as well
        (differing bytes count as mismatched); entries missing, with the
        ring's entries that repeat a request and the signatures counted
        beyond the requests taken.  ``control`` signs with the reference
        without the bound on ||z|| in the program's place.
        ``mismatched_rows`` keeps how many entries had a byte wrong."""
        exact, low = R.MlDsa65(), R.MlDsa65(z_bound=False)
        pk, sk = exact.keygen(bytes(self.xi[0]))
        mismatched = bad_sig = bad_iter = rows = 0
        if not control:
            mine = [bytes(k.numpy()) for k in (self.pk, self.sk)] if hasattr(self, "pk") \
                else [b"", b""]
            mismatched += sum(_differ(a, b) for a, b in zip(mine, (pk, sk)))
        kept = self.kept if self.kept is not None else []
        missing = self.short + self.unaccounted if self.kept is not None \
            else self.mix["sample"]
        for i, sig, it, msg, rnd in kept:
            if i < 0:
                missing += 1
                continue
            want, n = exact.sign(sk, msg, rnd)
            got, got_n = low.sign(sk, msg, rnd) if control else (sig, it)
            wrong = _differ(got, want)
            mismatched += wrong
            rows += wrong > 0
            bad_iter += got_n != n
            bad_sig += not exact.verify(pk, msg, got)
        self.mismatched_rows = rows
        return {"mismatched_bytes": (mismatched, 0), "bad_signatures": (bad_sig, 0),
                "bad_iterations": (bad_iter, 0), "missing_rows": (missing, 0)}


def _differ(got: bytes, want: bytes) -> int:
    """Bytes that differ, a missing or extra byte counting as one."""
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
