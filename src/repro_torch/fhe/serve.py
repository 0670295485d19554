"""Continuous-batching CKKS serving engine over the batched EvalPlan
programs.

The paper's headline numbers are sustained throughput figures, from one
deeply pipelined dataflow kept saturated with back-to-back work and fed
by dual coefficient memories in ping-pong mode (§SRM): while the
pipeline consumes one buffer, the host fills the other.  This module is
that discipline at the request level.  The scheme layer runs each op as
one program (``fhe.evalplan``; on the card a CUDA graph), and the
batched ``*_many`` programs run B ciphertexts a dispatch; the engine
keeps those programs fed:

  queue -> group by (op kind, basis) -> pad to the batch tile
        -> one ``*_many`` dispatch per group -> unpack per request.

Two drains over the same grouping policy:

  ``run``        the synchronous oracle: group the whole queue, dispatch
                 one group at a time and wait for each before the next.
                 Every async answer is held bit for bit against it.
  ``run_async``  the ping-pong drain: admit requests from an arrival
                 stream, dispatch group i+1 while the card still computes
                 group i, and only then wait for group i.  At most two
                 batches are in flight.  A group's wait is a CUDA event
                 recorded right after its dispatch (nothing on the CPU).
                 Per-request latency (arrival -> drained) is recorded.

Grouping rules:

  * Ops batch only within a kind: multiply with multiply, rescale with
    rescale; rotate and conjugate share the Galois kind, and a group may
    mix rotation amounts.  ``matvec`` requests (BSGS matrix-vector
    products over an ``fhe.linalg.PtMatrix``) form their own kind, run
    one request at a time without padding.
  * Ciphertexts at different bases (levels) never batch: each basis is
    its own group.  The async drain takes the queue head's (kind, basis)
    and up to ``max_batch`` matching requests from anywhere in the queue,
    so a request at a new basis opens its own group on a later cycle
    instead of blocking the drain.
  * Per-request scales ride along on the host, so scale differences
    never split a group.
  * Schemes never batch together: ``mlkem_*`` requests (FIPS 203 keygen,
    encaps, decaps on ``repro_torch.pq.mlkem``, payload dicts and no
    ciphertext) group under a scheme tag, an ML-KEM request carrying a
    CKKS ciphertext fails alone at screening, and ``_dispatch`` refuses a
    mixed batch.

Padding: each group is padded to a multiple of ``batch_tile`` by
repeating its last request (pad rows' results are dropped), so the set
of graph signatures is the tile's multiples up to ``max_batch``: exactly
the ``batch_sizes`` to warm with ``EvalPlan.prepare``.  Identity
rotations (r = 0 mod slots) are answered on the host before any check.

Failure isolation: a request that fails validation (mismatched multiply
operands, exhausted level) or whose matvec pack raises inside its
composite is recorded in ``stats['failed']`` and sinks no other answer.
A fault of the card (a kernel that does not build, launch or take its
tensors, a CUDA graph that cannot be captured, a CUDA error of torch's,
``kernels.is_device_fault``) is not a request's failure: it raises out of
the drain, also when it surfaces at a later group's launch.

``synthetic_trace`` builds the seeded heavy-traffic workload (mixed op
kinds, mixed levels, optionally Poisson arrivals) both drains replay.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque

import numpy as np
import torch

from repro_torch import obs
from repro_torch.fhe import linalg
from repro_torch.fhe.evalplan import (Ciphertext, EvalPlan, check_level,
                                      check_same_basis)
from repro_torch.kernels import is_device_fault

# op kinds a request may carry; rotate/conjugate share the Galois batch.
# mlkem_* kinds are ML-KEM's requests: payload dicts, no ciphertext, and
# never batched with a CKKS kind
MLKEM_OPS = ("mlkem_keygen", "mlkem_encaps", "mlkem_decaps")
OPS = ("multiply", "rescale", "rotate", "conjugate", "matvec") + MLKEM_OPS

# the payload keys each ML-KEM kind needs
_MLKEM_PAYLOAD = {
    "mlkem_keygen": ("d", "z"),          # (32,) u8 seeds
    "mlkem_encaps": ("ek", "m"),         # (1184,) key, (32,) randomness
    "mlkem_decaps": ("dk", "ct"),        # (2400,) key, (1088,) ciphertext
}

# the reference's tile when nothing is pinned or cached (its autotune
# DEFAULT_TILE, clamped to a group of 32); the tile funnel (pin, cache,
# measure) comes with the port of kernels/autotune.py
DEFAULT_BATCH_TILE = 8


@dataclasses.dataclass
class FheRequest:
    """One homomorphic op on one ciphertext (plus an operand for
    multiply, a slot amount for rotate, a ``linalg.PtMatrix`` for
    matvec), or one ML-KEM op carrying a byte-array ``payload`` dict
    instead of a ciphertext (``ct=None``)."""
    rid: int
    op: str
    ct: Ciphertext | None = None
    other: Ciphertext | None = None      # multiply rhs
    r: int = 0                           # rotate amount
    matrix: "linalg.PtMatrix | None" = None   # matvec weight pack
    payload: dict | None = None          # ML-KEM byte-array inputs

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"request {self.rid}: unknown op {self.op!r} "
                             f"(expected one of {OPS})")
        if self.op in MLKEM_OPS:
            want = _MLKEM_PAYLOAD[self.op]
            if self.payload is None or any(k not in self.payload for k in want):
                raise ValueError(
                    f"request {self.rid}: {self.op} needs a payload dict "
                    f"with keys {want}")
            return          # ct is screened per drain
        if self.ct is None:
            raise ValueError(f"request {self.rid}: {self.op} needs a ciphertext")
        if self.op == "multiply" and self.other is None:
            raise ValueError(f"request {self.rid}: multiply needs 'other'")
        if self.op == "matvec" and not isinstance(self.matrix, linalg.PtMatrix):
            raise ValueError(
                f"request {self.rid}: matvec needs 'matrix' (a "
                f"linalg.PtMatrix), got "
                f"{type(self.matrix).__name__ if self.matrix is not None else None}")


def _pad(items: list, tile: int) -> list:
    """Pad to a tile multiple by repeating the last item (dropped on
    unpack), so group sizes are multiples of the tile."""
    return items + [items[-1]] * (-len(items) % tile)


def synthetic_trace(ctx, n_requests: int, *, seed: int = 0,
                    rate: float | None = None, drop_frac: float = 0.25,
                    kinds=("multiply", "rotate", "rescale", "conjugate"),
                    matrix: "linalg.PtMatrix | None" = None):
    """Deterministic heavy-traffic trace: ``n_requests`` requests of kinds
    drawn from ``kinds`` (``matvec`` joins when ``matrix`` is given) over
    mixed levels: a seeded ``drop_frac`` of the clients arrive one level
    down.  Rotation amounts include negative, identity and > slots values.
    The draws are the reference's, so the same context and seed give the
    same trace.

    Returns ``(requests, arrivals)``: arrivals is None for a backlog (all
    offered at t = 0), else the cumulative seconds of a Poisson process
    at ``rate`` requests per second."""
    rng = np.random.default_rng(seed)
    plan = ctx.plan()
    all_kinds = tuple(kinds) + (("matvec",) if matrix is not None else ())
    reqs = []
    for rid in range(n_requests):
        z = rng.uniform(-1, 1, ctx.slots) + 1j * rng.uniform(-1, 1, ctx.slots)
        ct = ctx.encrypt(ctx.encode(z))
        dropped = bool(rng.uniform() < drop_frac)
        if dropped:
            ct = plan.rescale(ct)
        kind = all_kinds[int(rng.integers(len(all_kinds)))]
        if kind == "rescale" and ct.level < 1:
            kind = "rotate"                      # nothing left to drop
        if kind == "matvec" and ct.primes != matrix.basis:
            kind = "rotate"                      # a pack is valid at one basis
        if kind == "multiply":
            z2 = rng.uniform(-1, 1, ctx.slots) + 1j * rng.uniform(-1, 1, ctx.slots)
            other = ctx.encrypt(ctx.encode(z2))
            if dropped:
                other = plan.rescale(other)
            reqs.append(FheRequest(rid, "multiply", ct, other=other))
        elif kind == "rotate":
            r = int(rng.integers(-2, ctx.slots + 3))   # negative/identity/wrap
            reqs.append(FheRequest(rid, "rotate", ct, r=r))
        elif kind == "rescale":
            reqs.append(FheRequest(rid, "rescale", ct))
        elif kind == "matvec":
            reqs.append(FheRequest(rid, "matvec", ct, matrix=matrix))
        else:
            reqs.append(FheRequest(rid, "conjugate", ct))
    arrivals = None
    if rate is not None:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests)).tolist()
    return reqs, arrivals


class CkksServeEngine:
    """Group-and-dispatch batching engine over one prepared ``EvalPlan``.

    ``run`` is the synchronous oracle drain, ``run_async`` the
    double-buffered one (same grouping, same answers bit for bit).
    ``max_batch`` caps an async group, so the padded group sizes are the
    multiples of ``batch_tile`` up to it: the ``batch_sizes`` a caller
    warms with ``EvalPlan.prepare``.

    stats (reset per run): ``mode``, ``dispatches`` (request groups
    dispatched), ``batched_ops`` (real requests in them), ``padded`` (pad
    rows), ``identity`` (answered on the host), ``failed`` (rid ->
    message), ``groups`` ("kind@L<level>" -> requests), ``devices`` /
    ``per_device_rows`` (one card: the batch rows it ran), ``fresh_traces``
    (CUDA graphs captured during the run: 0 after a covering warm-up),
    and the plan's counter deltas: ``program_dispatches`` (programs run;
    a matvec runs several), ``key_switches``, ``decomposes`` and
    ``hoisted_reuse`` (key switches that shared a paid decomposition).
    Both drains report ``latency_us`` (p50/p99/mean/max/count, arrival ->
    drained; empty on a drain of no requests), the async drain also
    ``max_queue`` (peak pending depth).  With ``obs`` enabled a drain also
    records its phase spans (``serve.screen`` / ``serve.group`` /
    ``serve.dispatch`` / ``serve.block`` under ``serve.run``), queue-depth
    gauge samples, per-request lifecycle histograms and the stats as
    ``serve.*`` counters."""

    def __init__(self, plan: EvalPlan, batch_tile: int | None = None,
                 max_batch: int | None = None):
        self.devices = 1      # one card (a plan over several is ROADMAP's scale-out)
        if batch_tile is None:
            batch_tile = DEFAULT_BATCH_TILE
        if batch_tile < 1:
            raise ValueError(f"batch_tile must be >= 1, got {batch_tile}")
        self.plan = plan
        self.batch_tile = batch_tile
        self.group_tile = batch_tile * self.devices
        self.max_batch = max_batch if max_batch is not None else 4 * self.group_tile
        if self.max_batch < self.group_tile:
            raise ValueError(f"max_batch {self.max_batch} < batch_tile "
                             f"{batch_tile} x {self.devices} device(s)")
        self.stats: dict = {}

    # ------------------------------------------------------------ policy

    @staticmethod
    def _kind(req: FheRequest) -> str:
        return "galois" if req.op in ("rotate", "conjugate") else req.op

    @staticmethod
    def _basis(req: FheRequest):
        """The group key's shape/scheme part: CKKS requests group by
        residue basis, ML-KEM requests by a scheme tag."""
        return req.ct.primes if req.ct is not None else ("mlkem", req.op)

    def _screen(self, req: FheRequest, done: dict, failed: dict) -> bool:
        """Admission: True if the request queues for dispatch.  Identity
        rotations are answered first, before any level check (they need
        no key and no dispatch); a validation failure lands in ``failed``."""
        if req.op in MLKEM_OPS:
            if req.ct is not None:
                failed[req.rid] = (
                    f"request {req.rid}: {req.op} is an ML-KEM op and "
                    f"cannot carry a CKKS ciphertext — cross-scheme "
                    f"requests never batch together")
                return False
            return True
        if req.op == "rotate" and req.r % (self.plan.n // 2) == 0:
            ct = req.ct
            done[req.rid] = Ciphertext(ct.c0, ct.c1, ct.scale)
            return False
        try:
            if req.op == "multiply":
                check_same_basis("multiply", req.ct, req.other)
                check_level("multiply", req.ct)
            elif req.op == "rescale":
                check_level("rescale", req.ct, need=1)
            else:
                # matvec's own checks (pack basis, empty pack) fire in its
                # group, which records them the same way
                check_level(req.op, req.ct)
        except ValueError as e:
            if is_device_fault(e):
                raise
            failed[req.rid] = str(e)
            return False
        return True

    def _group(self, requests):
        """(kind, basis) -> request list, for the synchronous drain."""
        groups: dict = defaultdict(list)
        done: dict[int, Ciphertext] = {}
        failed: dict[int, str] = {}
        with obs.span("serve.screen", n=len(requests)):
            admitted = [req for req in requests if self._screen(req, done, failed)]
        with obs.span("serve.group", n=len(admitted)):
            for req in admitted:
                groups[(self._kind(req), self._basis(req))].append(req)
        return groups, done, failed

    def _g_of(self, req: FheRequest) -> int:
        return (2 * self.plan.n - 1 if req.op == "conjugate"
                else self.plan.rotation_group_element(req.r))

    def _dispatch(self, kind: str, reqs: list) -> list:
        plan = self.plan
        schemes = {"mlkem" if r.op in MLKEM_OPS else "ckks" for r in reqs}
        if len(schemes) > 1:
            # the (kind, basis) key already separates schemes: reaching
            # here means a caller bypassed the grouping
            raise ValueError(
                f"_dispatch: cross-scheme batch {sorted(schemes)} — "
                f"CKKS and ML-KEM requests never batch together")
        with obs.span("serve.dispatch", kind=kind, n=len(reqs)):
            reqs = _pad(reqs, self.group_tile)
            if kind in MLKEM_OPS:
                return self._mlkem_dispatch(kind, reqs)
            if kind == "multiply":
                return plan.multiply_many([r.ct for r in reqs], [r.other for r in reqs])
            if kind == "rescale":
                return plan.rescale_many([r.ct for r in reqs])
            return plan.galois_ks_many([r.ct for r in reqs],   # may mix g
                                       [self._g_of(r) for r in reqs])

    def _mlkem_dispatch(self, kind: str, reqs: list) -> list:
        """One batched ML-KEM dispatch of a (padded) same-op group on the
        plan's device: payload rows stack into (b, ...) u8 arrays for the
        ``pq.mlkem`` batch entry points.  Per request: keygen -> (ek, dk),
        encaps -> (K, ct), decaps -> K."""
        from repro_torch.pq import mlkem

        def rows(key):
            return np.stack([np.asarray(r.payload[key], dtype=np.uint8) for r in reqs])

        device = self.plan.device
        if kind == "mlkem_keygen":
            ek, dk = mlkem.keygen_batch(rows("d"), rows("z"), device=device)
            return [(ek[i], dk[i]) for i in range(len(reqs))]
        if kind == "mlkem_encaps":
            key, ct = mlkem.encaps_batch(rows("ek"), rows("m"), device=device)
            return [(key[i], ct[i]) for i in range(len(reqs))]
        key = mlkem.decaps_batch(rows("dk"), rows("ct"), device=device)
        return [key[i] for i in range(len(reqs))]

    def _dispatched(self):
        """A CUDA event after the work queued so far on the card (None on
        the CPU, where every dispatch has finished when it returns)."""
        if self.plan.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    @staticmethod
    def _block_outs(outs: list, event) -> None:
        """Wait for a dispatched group: its event, recorded after its
        dispatch (ML-KEM answers are host arrays already)."""
        with obs.span("serve.block", n=len(outs)):
            if event is not None:
                event.synchronize()

    def _matvec_group(self, reqs: list, failed: dict):
        """Per-request matvec composites (no padding).  An exception a
        request raises (the documented ValueErrors, or a poisoned pack's
        TypeError / AttributeError inside ``linalg.matvec``) fails that
        request alone; a fault of the card raises out of the drain."""
        kept, outs = [], []
        for req in reqs:
            try:
                outs.append(linalg.matvec(self.plan, req.matrix, req.ct))
                kept.append(req)
            except Exception as e:
                if is_device_fault(e):
                    raise
                failed[req.rid] = (str(e) if isinstance(e, ValueError)
                                   else f"{type(e).__name__}: {e}")
        return kept, outs

    # ------------------------------------------------------- accounting

    def _init_stats(self, mode: str, failed: dict) -> dict:
        stats = self.stats = {
            "mode": mode, "dispatches": 0, "batched_ops": 0, "padded": 0,
            "identity": 0, "failed": failed, "groups": {},
            "devices": self.devices,
            "per_device_rows": [0] * self.devices}
        return stats

    def _account_group(self, stats, kind: str, reqs: list):
        stats["dispatches"] += 1
        stats["batched_ops"] += len(reqs)
        if kind != "matvec":                 # matvec never pads
            pad = -len(reqs) % self.group_tile
            stats["padded"] += pad
            rows = (len(reqs) + pad) // self.devices
            for d in range(self.devices):
                stats["per_device_rows"][d] += rows
        key = (f"{kind}@mlkem" if kind in MLKEM_OPS
               else f"{kind}@L{len(reqs[0].ct.primes) - 1}")
        stats["groups"][key] = stats["groups"].get(key, 0) + len(reqs)

    @staticmethod
    def _latency_summary(arr_t: dict, done_t: dict) -> dict:
        """p50/p99/mean/max/count of arrival -> drained latencies (µs);
        an empty dict when no request was drained."""
        lats = [(done_t[rid] - arr_t.get(rid, 0.0)) * 1e6 for rid in done_t]
        if not lats:
            return {}
        if obs.enabled():
            for v in lats:
                obs.observe("serve.lifecycle.drained_us", v)
        q = np.percentile(lats, (50, 99))
        return {"p50": float(q[0]), "p99": float(q[1]),
                "mean": float(np.mean(lats)), "max": float(np.max(lats)),
                "count": len(lats)}

    def _finish_stats(self, stats, before, traces_before, t0):
        for c in ("dispatches", "key_switches", "decomposes"):
            delta = self.plan.stats[c] - before.get(c, 0)
            stats["program_dispatches" if c == "dispatches" else c] = delta
        stats["hoisted_reuse"] = stats["key_switches"] - stats["decomposes"]
        stats["fresh_traces"] = self.plan.trace_count() - traces_before
        stats["wall_s"] = time.perf_counter() - t0
        if obs.enabled():
            for c in ("dispatches", "batched_ops", "padded", "identity",
                      "program_dispatches", "key_switches", "decomposes",
                      "hoisted_reuse", "fresh_traces"):
                obs.counter_add(f"serve.{c}", stats[c])
            obs.counter_add("serve.failed", len(stats["failed"]))
            obs.counter_add("serve.drains")
            obs.observe("serve.drain.wall_us", stats["wall_s"] * 1e6)

    @staticmethod
    def _check_rids(requests):
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("duplicate request ids")

    # ----------------------------------------------- synchronous drain

    def run(self, requests: list[FheRequest]) -> dict[int, Ciphertext]:
        """The synchronous oracle drain: one dispatch per (kind, basis)
        group, largest group first, waiting for each group before the
        next.  Invalid requests are left out of the result and reported
        in ``stats['failed']``."""
        self._check_rids(requests)
        t0 = time.perf_counter()
        before = dict(self.plan.stats)
        traces_before = self.plan.trace_count()
        with obs.span("serve.run", mode="sync", n=len(requests)):
            groups, out, failed = self._group(requests)
            stats = self._init_stats("sync", failed)
            stats["identity"] = len(out)
            # answered at screening; a backlog's arrivals are all t0
            now = time.perf_counter() - t0
            done_t = {rid: now for rid in (*out, *failed)}
            for (kind, basis), reqs in sorted(groups.items(), key=lambda kv: -len(kv[1])):
                if kind == "galois":
                    # canonical g order: the batch-key cache's pattern does
                    # not depend on arrival order
                    reqs = sorted(reqs, key=self._g_of)
                if kind == "matvec":
                    reqs, outs = self._matvec_group(reqs, failed)
                    if not reqs:
                        continue   # every request failed: nothing dispatched
                else:
                    outs = self._dispatch(kind, reqs)
                self._block_outs(outs, self._dispatched())
                done = time.perf_counter() - t0
                for req, ct in zip(reqs, outs):   # zip drops pad rows
                    out[req.rid] = ct
                    done_t[req.rid] = done
                self._account_group(stats, kind, reqs)
            now = time.perf_counter() - t0
            for rid in failed:     # matvec failures surface mid-drain
                done_t.setdefault(rid, now)
            stats["latency_us"] = self._latency_summary({}, done_t)
        self._finish_stats(stats, before, traces_before, t0)
        return out

    # ------------------------------------------- continuous-batch drain

    def _take_group(self, pending: deque):
        """The queue head fixes (kind, basis); up to ``max_batch`` matching
        requests join it from anywhere in the queue (FIFO within the
        group), the rest stay queued."""
        with obs.span("serve.group", pending=len(pending)):
            head = pending[0]
            key = (self._kind(head), self._basis(head))
            take: list = []
            rest: deque = deque()
            for req in pending:
                if len(take) < self.max_batch and (self._kind(req), self._basis(req)) == key:
                    take.append(req)
                else:
                    rest.append(req)
            pending.clear()
            pending.extend(rest)
        return key[0], take

    def _drain(self, batch, out, done_t, t0, stats):
        """Wait for an in-flight batch and deliver its answers."""
        kind, reqs, outs, event = batch
        self._block_outs(outs, event)
        done = time.perf_counter() - t0
        for req, ct in zip(reqs, outs):          # zip drops pad rows
            out[req.rid] = ct
            done_t[req.rid] = done
        self._account_group(stats, kind, reqs)

    def run_async(self, requests: list[FheRequest],
                  arrivals: list[float] | None = None) -> dict[int, Ciphertext]:
        """The ping-pong drain.  Each cycle admits every arrived request
        (screened at admission), takes the queue head's (kind, basis)
        group, dispatches it, and only then waits for the previous batch:
        at most two batches are in flight, and the host's screening,
        grouping and stacking of batch i+1 overlap the card's work on
        batch i.

        ``arrivals`` (seconds, per request) simulates an offered load:
        a request is admitted once its arrival time has passed, and its
        latency (arrival -> drained) goes into ``stats['latency_us']``.
        None is a backlog (everything available at t = 0).  Answers equal
        ``run``'s bit for bit whatever the arrival order: grouping only
        changes which dispatch a request rides."""
        self._check_rids(requests)
        n = len(requests)
        if arrivals is not None and len(arrivals) != n:
            raise ValueError(f"run_async: {n} requests vs {len(arrivals)} arrivals")
        t0 = time.perf_counter()
        before = dict(self.plan.stats)
        traces_before = self.plan.trace_count()
        out: dict[int, Ciphertext] = {}
        failed: dict[int, str] = {}
        stats = self._init_stats("async", failed)
        stats["max_queue"] = 0
        if arrivals is None:
            sched = [(0.0, req) for req in requests]
        else:
            sched = sorted(zip(arrivals, requests), key=lambda ar: ar[0])
        arr_t = {req.rid: a for a, req in sched}
        done_t: dict[int, float] = {}
        pending: deque = deque()
        inflight = None                 # (kind, reqs, outs, event): one batch
        i = 0                           # next arrival not yet admitted
        # per-request lifecycle times (arrival -> admitted -> grouped ->
        # dispatched -> drained), kept only while obs is on
        track = obs.enabled()
        adm_t: dict[int, float] = {}
        grp_t: dict[int, float] = {}
        disp_t: dict[int, float] = {}

        with obs.span("serve.run", mode="async", n=n):
            while i < n or pending or inflight:
                now = time.perf_counter() - t0
                if i < n and sched[i][0] <= now:
                    with obs.span("serve.screen"):
                        while i < n and sched[i][0] <= now:
                            _, req = sched[i]
                            i += 1
                            if self._screen(req, out, failed):
                                pending.append(req)
                                if track:
                                    adm_t[req.rid] = now
                            else:       # answered or failed at admission
                                done_t[req.rid] = now
                                if req.rid in out:
                                    stats["identity"] += 1
                stats["max_queue"] = max(stats["max_queue"], len(pending))
                obs.gauge_set("serve.queue_depth", len(pending))
                if pending:
                    kind, reqs = self._take_group(pending)
                    if track:
                        tg = time.perf_counter() - t0
                        for req in reqs:
                            grp_t[req.rid] = tg
                    if kind == "galois":
                        reqs = sorted(reqs, key=self._g_of)   # canonical g
                    if kind == "matvec":
                        reqs, outs = self._matvec_group(reqs, failed)
                    else:
                        outs = self._dispatch(kind, reqs)
                    event = self._dispatched()
                    if track and reqs:
                        td = time.perf_counter() - t0
                        for req in reqs:
                            disp_t[req.rid] = td
                    # ping-pong: the new batch is in flight before the old
                    # one is waited for
                    if reqs:
                        if inflight is not None:
                            self._drain(inflight, out, done_t, t0, stats)
                        inflight = (kind, reqs, outs, event)
                elif inflight is not None:
                    self._drain(inflight, out, done_t, t0, stats)
                    inflight = None
                else:
                    # idle: nap until the next arrival (short naps keep
                    # admission responsive)
                    wait = sched[i][0] - (time.perf_counter() - t0)
                    if wait > 0:
                        time.sleep(min(wait, 5e-4))
            if track:
                for rid in done_t:
                    a = arr_t.get(rid, 0.0)
                    ta = adm_t.get(rid)
                    if ta is None:
                        continue
                    obs.observe("serve.lifecycle.admitted_us", (ta - a) * 1e6)
                    tg = grp_t.get(rid)
                    if tg is None:
                        continue
                    obs.observe("serve.lifecycle.grouped_us", (tg - ta) * 1e6)
                    td = disp_t.get(rid)
                    if td is not None:
                        obs.observe("serve.lifecycle.dispatched_us", (td - tg) * 1e6)
            stats["latency_us"] = self._latency_summary(arr_t, done_t)
        self._finish_stats(stats, before, traces_before, t0)
        return out
