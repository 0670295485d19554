"""CKKS serving cells: encrypted operations through the port's
``CkksServeEngine`` over a prepared ``EvalPlan``, as a user builds them.

Set-up draws the context and the deployment's whole key set (the
configuration's, whatever the traffic uses) in a documented order
(``Inputs.key_order``) that the reference replays, warms the plan's CUDA
graphs at the engine's own group sizes, and makes the operand pool on
the device from the seed.  The pool holds uniform residues: key
switching costs the same on any residues, and its exact result is
defined on any of them.

The window drives ``run_async`` over backlog chunks, back to back.  From
each chunk it keeps a few answers, spread over the slots of the groups
(``traffic.slots``), so that the sample the check draws after the window
holds every slot of every (op, basis) class.
"""
from __future__ import annotations

import math
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from benchlib import trace, traffic as T
from reference.ckks import (CkksReference, KeySpec, chain, galois_element,
                            matvec_key_amounts)
from reference.modring import Arith


def rotation_amounts(config: dict, slots: int) -> list[int]:
    """The keyed rotation amounts: +-2^i below the slot count (``pow2``,
    the default Galois key set of Microsoft SEAL)."""
    if config["rotations"] != "pow2":
        raise ValueError(f"unknown rotation key set {config['rotations']!r}")
    steps = [1 << i for i in range(int(math.log2(slots)))]
    return steps + [-s for s in steps]


class Phases:
    """Logs the seconds each step of set-up took, to standard error."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        print(f"[setup] {what}: {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now


PREBUILT = 16       # backlog chunks built in set-up, cycled through the window


class Inputs:
    """What the seed fixes before the program is touched: the context's
    seed, the bases, the keys and their order, the matvec's matrix and
    the operand pool (on ``device``)."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        n = self.n = config["n"]
        self.ctx_seed = int(T.stream(seed, T.INPUTS, 0).integers(0, 2**63))
        self.P, qs = chain(n, config["levels"])
        self.qs = qs
        self.sizes = T.pool_sizes(mix)
        self.bases = (qs, qs[:-1])[: len(self.sizes)]          # of the pool
        self.amounts = rotation_amounts(config, n // 2)
        self.W = None
        if "matvec" in mix["ops"]:
            d_in, d_out = mix["matrix"]
            rng = T.stream(seed, T.INPUTS, 1)
            self.W = rng.uniform(-1, 1, (d_in, d_out)) * mix["matrix_scale"]
        # the deployment's keys: relinearization and the Galois set at
        # each key basis, and a matvec pack's steps at the full chain
        order = []
        for b in range(config["key_bases"]):
            basis = qs[: len(qs) - b]
            gs = {galois_element(n, r) for r in self.amounts} | {galois_element(n, None)}
            if self.W is not None and b == 0:
                gs |= {galois_element(n, r) for r in matvec_key_amounts(self.W.shape[0], self.W)}
            order += [KeySpec(None, basis)] + [KeySpec(g, basis) for g in sorted(gs)]
        self.key_order = order
        gen = torch.Generator(device=self.device).manual_seed(T.torch_seed(seed, 2))
        self.pool = []
        for basis, size in zip(self.bases, self.sizes):
            q = torch.tensor(basis, dtype=torch.int64, device=self.device)[:, None]
            words = torch.randint(0, 2**62, (size, 2, len(basis), self.n),
                                  generator=gen, device=self.device)
            self.pool.append((words % q).int())

    def lower_level(self) -> int:
        return len(self.bases[-1]) - 1

    def chunk(self, c: int):
        """The descriptors of backlog chunk c (cycled over the prebuilt)."""
        return T.chunk(self.mix, self.amounts, self.lower_level(), self.seed, c % PREBUILT)

    def operands(self, rows, which: str) -> torch.Tensor:
        """The int64 (k, len(rows), n) stack of one operand ("a" or "b")
        of the requests ``rows`` [(d, i)], all at one basis."""
        words = self.pool[rows[0][0].basis[rows[0][1]]]
        slot = torch.tensor([int(getattr(d, which)[i]) for d, i in rows], device=words.device)
        return words.index_select(0, slot).long().permute(1, 2, 0, 3)   # (2, k, B, n)


class Run:
    """One run of a CKKS serving cell on ``device``."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.mix = cell.traffic
        self.device = torch.device(device)
        self.inputs = Inputs(cell.config, self.mix, seed, device)
        self.counters = {"batched_ops": 0, "padded": 0, "program_dispatches": 0,
                         "fresh_traces": 0, "requests": 0}
        self.kept: list = []          # (class, slot, (d, i), answer)
        self.strata: set = set()      # (class, slot) offered in the kept chunks
        self.next_chunk = 0

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from repro_torch.fhe import linalg
        from repro_torch.fhe.ckks import CkksContext
        from repro_torch.fhe.evalplan import Ciphertext
        from repro_torch.fhe.rns import RnsPoly
        from repro_torch.fhe.serve import CkksServeEngine
        cfg, inp, mix = self.cell.config, self.inputs, self.mix
        clock = Phases()
        ctx = CkksContext(n=cfg["n"], levels=cfg["levels"], scale_bits=cfg["scale_bits"],
                          sigma=cfg["sigma"], seed=inp.ctx_seed, device=self.device)
        if (ctx.special, ctx.qs) != (inp.P, inp.qs):
            raise RuntimeError("the context's primes differ from the deployment's chain")
        plan = ctx.plan()
        engine = CkksServeEngine(plan)
        clock("context")
        for spec in inp.key_order:              # the documented draw order
            if spec.g is None:
                plan.relin_key(spec.basis)
            else:
                plan.galois_key(spec.g, spec.basis)
                plan.eval_idx(spec.g)
        clock(f"{len(inp.key_order)} keys")
        ops = set(mix["ops"])
        self.matrix = linalg.PtMatrix.encode(ctx, inp.W) if inp.W is not None else None
        sizes = tuple(range(engine.group_tile, engine.max_batch + 1, engine.group_tile))
        for b, basis in enumerate(inp.bases):
            plan.prepare(basis=basis,
                         rotations=mix.get("rotations", inp.amounts) if "rotate" in ops else (),
                         conjugate="conjugate" in ops, relin="multiply" in ops,
                         batch_sizes=sizes if ops - {"matvec"} else (),
                         matvecs=(self.matrix,) if self.matrix is not None and b == 0 else ())
            clock(f"prepare at {len(basis)} primes")
        self.cts = [[Ciphertext(RnsPoly(w[i, 0], basis, True), RnsPoly(w[i, 1], basis, True),
                                ctx.scale) for i in range(len(w))]
                    for w, basis in zip(inp.pool, inp.bases)]
        self.ctx, self.plan, self.engine = ctx, plan, engine
        # one drain of the mix warms every lazy path the window takes
        warm = T.requests(mix, inp.amounts, inp.lower_level(),
                          T.stream(self.seed, T.WARM), mix["warm_requests"])
        engine.run_async(self.build(warm, -len(warm)))
        self._sync()
        clock(f"warm drain of {len(warm)}")
        self.chunks = [self.build(inp.chunk(c), 0) for c in range(PREBUILT)]
        clock(f"{len(self.chunks)} chunks of requests")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build(self, d, rid0: int) -> list:
        """FheRequests of descriptors d, ids from rid0."""
        from repro_torch.fhe.serve import FheRequest
        out = []
        for i in range(len(d)):
            op, cts = T.OPS[d.op[i]], self.cts[d.basis[i]]
            out.append(FheRequest(rid0 + i, op, cts[d.a[i]],
                                  other=cts[d.b[i]] if op == "multiply" else None,
                                  r=int(d.r[i]), matrix=self.matrix))
        return out

    # ------------------------------------------------------------ window

    def _drain(self, c: int) -> tuple[list, dict]:
        """Drain backlog chunk c (the requests built in set-up, cycled)."""
        reqs = self.chunks[c % len(self.chunks)]
        out = self.engine.run_async(reqs)
        st = self.engine.stats
        for k in self.counters:
            if k != "requests":
                self.counters[k] += st[k]
        self.counters["requests"] += sum(r.rid in out for r in reqs)
        return reqs, out

    def _keep(self, c: int, d, reqs=None, out=None) -> None:
        """Keep (clone) the answers of ``keep_per_chunk`` requests of each
        class of chunk c, at the slots (c K + j) mod ``slots``, j < K,
        each drawn by the seed among the chunk's requests at its slot;
        without ``out`` (the control) keep the requests alone."""
        period, per = self.mix["slots"], self.mix["keep_per_chunk"]
        rng = T.stream(self.seed, T.SAMPLE, c)
        cls, slot = T.classes(d), T.slots(d, period)
        for k in np.unique(cls):
            at = {int(s): list(rng.permutation(np.flatnonzero((cls == k) & (slot == s))))
                  for s in np.unique(slot[cls == k])}
            self.strata.update((int(k), s) for s in at)
            for j in range(per):
                s = (c * per + j) % period
                if not at.get(s):
                    continue
                i = int(at[s].pop())
                ans = out.get(reqs[i].rid) if out is not None else None
                if ans is not None:
                    ans = (ans.c0.data.clone(), ans.c1.data.clone(), ans.primes, ans.scale)
                self.kept.append((int(k), s, (d, i), ans))

    def keep_without_program(self, seconds: float, chunks: int) -> None:
        """The requests a run of ``chunks`` backlog chunks would keep, with
        no program run: the control's sample."""
        for c in range(chunks):
            self._keep(c, self.inputs.chunk(c))

    def window(self, seconds: float) -> dict:
        offered = answered = 0
        t0 = time.perf_counter()
        while True:
            c = self.next_chunk
            reqs, out = self._drain(c)
            offered += len(reqs)
            answered += sum(r.rid in out for r in reqs)
            self._keep(c, self.inputs.chunk(c), reqs, out)
            del out
            self.next_chunk += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        if self.counters["fresh_traces"]:
            print(f"[bench] {self.counters['fresh_traces']} CUDA graphs captured inside the "
                  "window: set-up missed a shape", file=sys.stderr, flush=True)
        return {"metrics": {self.mix["throughput_metric"]: answered / wall},
                "attempted": offered, "failed": offered - answered,
                "window_s": wall, "counters": dict(self.counters)}

    def profile(self, seconds: float) -> dict:
        """The traced sub-window: more chunks of the same traffic under
        the profiler, whole chunks for ``seconds``."""
        rec: dict = {"port": trace.port_kernels(self.cell.root)}
        requests = 0
        with trace.profiled(rec):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                requests += len(self._drain(self.next_chunk)[1])
                self.next_chunk += 1
        rec["requests"] = requests
        return rec

    # ------------------------------------------------------------- check

    def sample(self) -> list:
        """The answers compared: ``sample_per_slot`` of each (class, slot)
        among those kept, drawn from the seed after the window."""
        rng = T.stream(self.seed, T.SAMPLE, 1 << 40)
        by = defaultdict(list)
        for x in self.kept:
            by[x[:2]].append(x)
        out = []
        for key in sorted(by):
            mine = by[key]
            out += [mine[i] for i in sorted(rng.permutation(len(mine))[: self.mix["sample_per_slot"]])]
        return out

    def free(self) -> None:
        """Drop the program's state (the answers kept for the check stay)."""
        for name in ("engine", "plan", "ctx", "cts", "matrix", "chunks"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """The compared numbers over the sample, each with its limit;
        ``control`` puts the reference in float64 in the program's place."""
        return judge(self.inputs, self.sample(), self.strata, control)


BLOCK = 32          # answers the reference works out together


def expected(ref: CkksReference, inp: Inputs, rows) -> tuple:
    """The reference's (c0, c1) stacks (k, B, n), basis and scale for the
    requests ``rows`` [(d, i)], all of one op, basis and amount."""
    d, i = rows[0]
    op, basis = T.OPS[d.op[i]], inp.bases[d.basis[i]]
    a0, a1 = inp.operands(rows, "a")
    scale = float(1 << inp.config["scale_bits"])
    if op == "multiply":
        b0, b1 = inp.operands(rows, "b")
        return (*ref.multiply(a0, a1, b0, b1, basis), basis, scale * scale)
    if op == "rescale":
        return (*ref.rescale(a0, a1, basis), basis[:-1], scale / basis[-1])
    if op == "matvec":
        return (*ref.matvec(inp.W, scale, a0, a1, basis), basis, scale * scale)
    r = None if op == "conjugate" else int(d.r[i])
    return (*ref.rotate(a0, a1, basis, galois_element(inp.n, r)), basis, scale)


def needed_keys(inp: Inputs, sample) -> set:
    out = set()
    for _, _, (d, i), _ in sample:
        op, basis = T.OPS[d.op[i]], inp.bases[d.basis[i]]
        if op == "multiply":
            out.add(KeySpec(None, basis))
        elif op == "matvec":
            out |= {KeySpec(galois_element(inp.n, r), basis)
                    for r in matvec_key_amounts(inp.W.shape[0], inp.W)}
        elif op != "rescale":
            r = None if op == "conjugate" else int(d.r[i])
            out.add(KeySpec(galois_element(inp.n, r), basis))
    return out


def judge(inp: Inputs, sample, strata: set, control: bool = False) -> dict:
    """Every sampled answer against the reference, in blocks of requests
    of one op, basis and amount: words that differ mod q, answers
    missing or at another basis or scale, and (class, slot) strata
    offered in the kept chunks with no answer in the sample (all limited
    to 0)."""
    cfg = inp.config
    make = lambda arith: CkksReference(
        n=inp.n, levels=cfg["levels"], seed=inp.ctx_seed, key_order=inp.key_order,
        needed=needed_keys(inp, sample), sigma=cfg["sigma"], device=inp.device, arith=arith)
    ref = make(Arith())
    other = make(Arith(exact=False)) if control else None
    groups = defaultdict(list)
    for x in sample:
        d, i = x[2]
        r = int(d.r[i]) if T.OPS[d.op[i]] == "rotate" else 0     # only a rotate reads r
        groups[(int(d.op[i]), int(d.basis[i]), r)].append(x)
    words = bad = 0
    for key in sorted(groups):
        items = groups[key]
        for lo in range(0, len(items), BLOCK):
            block = items[lo: lo + BLOCK]
            rows = [x[2] for x in block]
            want0, want1, basis, scale = expected(ref, inp, rows)
            if other is not None:
                got0, got1, _, _ = expected(other, inp, rows)
                answers = [(got0[:, j], got1[:, j], basis, scale) for j in range(len(block))]
            else:
                answers = [x[3] for x in block]
            q = torch.tensor(basis, dtype=torch.int64, device=inp.device)[:, None]
            for j, ans in enumerate(answers):
                if ans is None or tuple(ans[2]) != tuple(basis) or ans[3] != scale:
                    bad += 1
                    continue
                words += int((ans[0].long() % q != want0[:, j]).sum()
                             + (ans[1].long() % q != want1[:, j]).sum())
    missing = len(strata - {x[:2] for x in sample})
    return {"mismatched_words": (words, 0), "bad_answers": (bad, 0),
            "missing_slots": (missing, 0)}
