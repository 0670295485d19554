"""The paper's NTT-128 unit: batches of cyclic forward transforms over
one prime through the port's ``kernels.ops.ntt``, back to back, with no
synchronisation until the window ends.

The batches live on the device, made from the seed a batch a call and
cycled.  A batch is large enough that the card, not the host's dispatch
of a call, sets the rate.  The window keeps, every ``sample_every`` calls from a seeded
offset and at the last call, a seeded set of ``sample_rows`` output
rows (one gather); the check holds them against the plain transform.
"""
from __future__ import annotations

import time

import torch

from benchlib import trace, traffic as T
from reference.modring import Arith
from reference.ntt128 import CyclicNtt

VARIANTS = 16          # row sets the samples cycle through


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        cfg, mix = cell.config, cell.traffic
        self.q, self.n, self.mix = cfg["q"], cfg["n"], mix
        gen = torch.Generator(device=self.device).manual_seed(T.torch_seed(seed, 3))
        self.pool = torch.empty((mix["pool"], mix["rows"], self.n), dtype=torch.int32,
                                device=self.device)
        for batch in self.pool:       # a batch's 64-bit draws at a time
            batch.copy_(torch.randint(0, 2**62, batch.shape, generator=gen,
                                      device=self.device) % self.q)
        rng = T.stream(seed, T.SAMPLE)
        self.offset = int(rng.integers(0, mix["sample_every"]))
        self.rows = [torch.from_numpy(rng.choice(mix["rows"], mix["sample_rows"], replace=False))
                     .to(self.device) for _ in range(VARIANTS)]
        self.kept: list = []       # (call index, sampled output rows)

    def setup(self) -> None:
        from repro_torch.core.params import make_ntt_params
        from repro_torch.kernels import ops
        self.params = make_ntt_params(self.n, q=self.q)
        self.ops = ops
        self.batches = list(self.pool)         # the views, made once
        for x in self.batches[:2]:
            ops.ntt(x, self.params, negacyclic=False)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _rows(self, i: int) -> torch.Tensor:
        return self.rows[(i // self.mix["sample_every"]) % VARIANTS]

    def window(self, seconds: float) -> dict:
        batches, every, p = self.batches, self.mix["sample_every"], self.params
        ntt, count = self.ops.ntt, len(batches)
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            y = ntt(batches[i % count], p, negacyclic=False)
            if i % every == self.offset:
                self.kept.append((i, y.index_select(0, self._rows(i))))
            i += 1
            if time.perf_counter() >= deadline:
                break
        if (i - 1) % every != self.offset:
            self.kept.append((i - 1, y.index_select(0, self._rows(i - 1))))
        self._sync()
        wall = time.perf_counter() - t0
        return {"metrics": {"ntt_per_s": i * self.mix["rows"] / wall}, "attempted": i,
                "failed": 0, "window_s": wall, "counters": {"calls": i}}

    def keep_without_program(self, seconds: float, calls: int) -> None:
        """The call indices a run of ``calls`` calls would sample, with no
        program run: the control's sample."""
        every = self.mix["sample_every"]
        self.kept = [(i, None) for i in range(self.offset, calls, every)] + [(calls - 1, None)]

    def profile(self, seconds: float) -> dict:
        rec: dict = {"port": trace.port_kernels(self.cell.root)}
        batches, p, ntt, i = self.batches, self.params, self.ops.ntt, 0
        with trace.profiled(rec, host=self.mix.get("profile_host", True)):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                ntt(batches[i % len(batches)], p, negacyclic=False)
                i += 1
        rec["transforms"] = i * self.mix["rows"]
        rec["n"] = self.n
        return rec

    def free(self) -> None:
        self.__dict__.pop("ops", None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """Words of the sampled rows that differ from the plain transform;
        ``control`` puts the float64 transform in the program's place."""
        ref = CyclicNtt(self.q, self.n, self.device)
        low = CyclicNtt(self.q, self.n, self.device, Arith(exact=False)) if control else None
        words = missing = 0
        for i, got in self.kept:
            x = self.pool[i % len(self.pool)].index_select(0, self._rows(i))
            if low is not None:
                got = low(x)
            if got is None:
                missing += 1
                continue
            words += int((got.long() != ref(x)).sum())
        return {"mismatched_words": (words, 0),
                "missing_samples": (missing if self.kept else 1, 0)}
