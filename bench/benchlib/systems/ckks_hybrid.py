"""CKKS serving cells under hybrid key switching: the ``ckks_serve``
cells' run (set-up, window, sample and check) on a context built with
``dnum`` key-switch digits (alpha = ceil((L + 1) / dnum) primes a digit,
K = alpha special primes), judged against ``reference.ckks_hybrid``.

The configuration adds ``dnum`` to ``ckks_serve``'s keys.  The keys are
drawn in ``ckks_serve``'s documented order, a key digit per run of alpha
chain primes.  The window's counters also carry ``ks_digits``, the key
switch's digits decomposed: the plan's ``decomposes`` times the digits of
the full chain, ceil((L + 1) / alpha), where the traffic keeps every
request there (``lower_share`` 0; else the counter is left out), and the traced
sub-window records the key switches it ran, the deployment's shape and
the names of the base-conversion kernels (``csrc/basis.cu``), which the
``basis.*`` readers take.
"""
from __future__ import annotations

import re
from collections import defaultdict

import torch

from benchlib import traffic as T
from benchlib.systems import ckks_serve as S
from reference.ckks import KeySpec, galois_element
from reference.ckks_hybrid import HybridReference, hybrid_chain
from reference.modring import Arith


def basis_kernels(root) -> tuple[str, ...]:
    """The ``__global__`` function names of the program's
    ``csrc/basis.cu`` (none if the file is not there)."""
    path = root / "src" / "repro_torch" / "csrc" / "basis.cu"
    if not path.exists():
        return ()
    text = re.sub(r"__launch_bounds__\([^)]*\)", "", path.read_text())
    return tuple(sorted(set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))))


class Inputs(S.Inputs):
    """``ckks_serve.Inputs`` over the hybrid chain: the K = alpha largest
    primes are P's, the next L + 1 the ciphertext chain."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        n = self.n = config["n"]
        self.ctx_seed = int(T.stream(seed, T.INPUTS, 0).integers(0, 2**63))
        self.alpha, self.Ps, qs = hybrid_chain(n, config["levels"], config["dnum"])
        self.P = None
        self.qs = qs
        self.sizes = T.pool_sizes(mix)
        self.bases = (qs, qs[:-1])[: len(self.sizes)]
        self.amounts = S.rotation_amounts(config, n // 2)
        self.W = None
        if "matvec" in mix["ops"]:
            raise ValueError("ckks_hybrid: the hybrid reference has no matvec")
        order = []
        for b in range(config["key_bases"]):
            basis = qs[: len(qs) - b]
            gs = {galois_element(n, r) for r in self.amounts} | {galois_element(n, None)}
            order += [KeySpec(None, basis)] + [KeySpec(g, basis) for g in sorted(gs)]
        self.key_order = order
        gen = torch.Generator(device=self.device).manual_seed(T.torch_seed(seed, 2))
        self.pool = []
        for basis, size in zip(self.bases, self.sizes):
            q = torch.tensor(basis, dtype=torch.int64, device=self.device)[:, None]
            words = torch.randint(0, 2**62, (size, 2, len(basis), self.n),
                                  generator=gen, device=self.device)
            self.pool.append((words % q).int())


class Run(S.Run):
    """One run of a hybrid CKKS serving cell on ``device``."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.mix = cell.traffic
        self.device = torch.device(device)
        self.inputs = Inputs(cell.config, self.mix, seed, device)
        self.counters = {"batched_ops": 0, "padded": 0, "program_dispatches": 0,
                         "fresh_traces": 0, "requests": 0}
        self.decomposes = 0           # the plan's decomposes over the drains
        self.kept: list = []
        self.strata: set = set()
        self.next_chunk = 0

    def setup(self) -> None:
        from repro_torch.fhe.ckks import CkksContext
        from repro_torch.fhe.evalplan import Ciphertext
        from repro_torch.fhe.rns import RnsPoly
        from repro_torch.fhe.serve import CkksServeEngine
        cfg, inp, mix = self.cell.config, self.inputs, self.mix
        clock = S.Phases()
        ctx = CkksContext(n=cfg["n"], levels=cfg["levels"], scale_bits=cfg["scale_bits"],
                          sigma=cfg["sigma"], seed=inp.ctx_seed, device=self.device,
                          dnum=cfg["dnum"])
        if (ctx.alpha, ctx.specials, ctx.qs) != (inp.alpha, inp.Ps, inp.qs):
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
        self.matrix = None
        sizes = tuple(range(engine.group_tile, engine.max_batch + 1, engine.group_tile))
        for basis in inp.bases:
            plan.prepare(basis=basis,
                         rotations=mix.get("rotations", inp.amounts) if "rotate" in ops else (),
                         conjugate="conjugate" in ops, relin="multiply" in ops,
                         batch_sizes=sizes)
            clock(f"prepare at {len(basis)} primes")
        self.cts = [[Ciphertext(RnsPoly(w[i, 0], basis, True), RnsPoly(w[i, 1], basis, True),
                                ctx.scale) for i in range(len(w))]
                    for w, basis in zip(inp.pool, inp.bases)]
        self.ctx, self.plan, self.engine = ctx, plan, engine
        warm = T.requests(mix, inp.amounts, inp.lower_level(),
                          T.stream(self.seed, T.WARM), mix["warm_requests"])
        engine.run_async(self.build(warm, -len(warm)))
        self._sync()
        clock(f"warm drain of {len(warm)}")
        self.chunks = [self.build(inp.chunk(c), 0) for c in range(S.PREBUILT)]
        clock(f"{len(self.chunks)} chunks of requests")

    def _drain(self, c: int):
        before = self.plan.stats["decomposes"]
        out = super()._drain(c)
        self.decomposes += self.plan.stats["decomposes"] - before
        return out

    def window(self, seconds: float) -> dict:
        win = super().window(seconds)
        if not self.mix["lower_share"]:
            chain = len(self.inputs.qs)
            win["counters"]["ks_digits"] = self.decomposes * -(-chain // self.inputs.alpha)
        return win

    def profile(self, seconds: float) -> dict:
        before = self.plan.stats["key_switches"]
        rec = super().profile(seconds)
        cfg = self.cell.config
        rec["key_switches"] = self.plan.stats["key_switches"] - before
        rec["deployment"] = {"n": cfg["n"], "levels": cfg["levels"], "dnum": cfg["dnum"]}
        rec["basis_kernels"] = basis_kernels(self.cell.root)
        return rec

    def check(self, control: bool = False) -> dict:
        return judge(self.inputs, self.sample(), self.strata, control)


def judge(inp: Inputs, sample, strata: set, control: bool = False) -> dict:
    """Every sampled answer against the hybrid reference, in blocks of
    ``ckks_serve.BLOCK`` requests of one op, basis and amount: words that
    differ mod q, answers missing or at another basis or scale, and
    (class, slot) strata offered in the kept chunks with no answer in the
    sample (all limited to 0).  ``control`` puts the reference in float64
    in the program's place."""
    cfg = inp.config
    make = lambda arith: HybridReference(
        n=inp.n, levels=cfg["levels"], dnum=cfg["dnum"], seed=inp.ctx_seed,
        key_order=inp.key_order, needed=S.needed_keys(inp, sample), sigma=cfg["sigma"],
        device=inp.device, arith=arith)
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
        for lo in range(0, len(items), S.BLOCK):
            block = items[lo: lo + S.BLOCK]
            rows = [x[2] for x in block]
            want0, want1, basis, scale = S.expected(ref, inp, rows)
            if other is not None:
                got0, got1, _, _ = S.expected(other, inp, rows)
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
            del want0, want1, answers
    missing = len(strata - {x[:2] for x in sample})
    return {"mismatched_words": (words, 0), "bad_answers": (bad, 0),
            "missing_slots": (missing, 0)}
