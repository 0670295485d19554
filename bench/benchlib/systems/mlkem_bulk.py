"""ML-KEM-768 as the server half of TLS 1.3's X25519MLKEM768: batches of
clients' encapsulation keys, checked and encapsulated through the port's
``pq.mlkem.encaps_batch``, back to back, with no synchronisation until
the window ends (and each batch of the pool has run once).

The batches live on the device, made from the seed in set-up: each row a
key (t̂'s 768 coefficients uniform below q, ByteEncode12, then rho
uniform) and the server's randomness m.  In each batch a seeded set of
rows carries a key with one 12-bit coefficient at q or above, which
FIPS 203 §7.2's check must reject.  The window cycles the pool; each call
keeps, for its batch, the outputs of a seeded set of rows and of every
malformed row (one gather each of K, ct and the verdict), replacing what
an earlier call of that batch kept.  The check holds every kept row
against the plain reference, byte for byte, the verdicts included.

The traced sub-window records the encapsulations it ran, the port's
kernels and the names of the Keccak kernels (``csrc/keccak.cu``) and of
the ring's (``csrc/ntt_regs.cuh``, where the banks' body is,
``csrc/ntt_banks.cu`` and ``csrc/dyadic_basemul.cu``), which the
``keccak.*`` and ``ring.*`` readers take.
"""
from __future__ import annotations

import re
import time

import torch

from benchlib import trace, traffic as T
from reference import mlkem as R
from reference.mlkem import K, N, Q, MlKem768


def kernels_of(root, *sources) -> tuple[str, ...]:
    """The ``__global__`` function names of the program's named
    ``csrc`` sources (none of a source that is not there)."""
    names = set()
    for src in sources:
        path = root / "src" / "repro_torch" / "csrc" / src
        if path.exists():
            text = re.sub(r"__launch_bounds__\([^)]*\)", "", path.read_text())
            names.update(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return tuple(sorted(names))


def encode12(t: torch.Tensor) -> torch.Tensor:
    """FIPS 203 ByteEncode12 of (..., 256) values below 2^12 (FIPS order:
    coefficients 2i and 2i + 1 share bytes 3i .. 3i + 2)."""
    v = t.long().unflatten(-1, (N // 2, 2))
    lo, hi = v[..., 0], v[..., 1]
    b = torch.stack([lo & 255, (lo >> 8) | ((hi & 15) << 4), hi >> 4], -1)
    return b.flatten(-2).to(torch.uint8)


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        cfg, mix = cell.config, cell.traffic
        self.mix = mix
        stated = {key: cfg[key] for key in ("n", "q", "k", "eta1", "eta2", "du", "dv")}
        if stated != {"n": N, "q": Q, "k": K, "eta1": R.ETA1, "eta2": R.ETA2, "du": R.DU,
                      "dv": R.DV}:
            raise ValueError(f"mlkem_bulk runs ML-KEM-768 only, the configuration states "
                             f"{stated}")
        rows, pool = mix["batch"], mix["pool"]
        gen = torch.Generator(device=self.device).manual_seed(T.torch_seed(seed, 7))
        rng = T.stream(seed, T.SAMPLE)
        self.ek, self.m, self.rows = [], [], []
        for _ in range(pool):
            t = torch.randint(0, Q, (rows, K, N), generator=gen, device=self.device)
            bad = rng.choice(rows, mix["malformed_per_batch"], replace=False)
            at = rng.integers(0, K * N, len(bad))
            t.view(rows, K * N)[torch.from_numpy(bad).to(self.device),
                                torch.from_numpy(at).to(self.device)] = \
                torch.from_numpy(rng.integers(Q, 1 << 12, len(bad))).to(self.device)
            rho = torch.randint(0, 256, (rows, 32), generator=gen, device=self.device)
            self.ek.append(torch.cat([encode12(t).flatten(1), rho.to(torch.uint8)], 1))
            self.m.append(torch.randint(0, 256, (rows, 32), generator=gen,
                                        device=self.device).to(torch.uint8))
            others = rng.permutation(sorted(set(range(rows)) - set(bad.tolist())))
            kept = sorted(bad.tolist() + others[: mix["sample_per_batch"]].tolist())
            self.rows.append(torch.tensor(kept, device=self.device))
        self.kept: dict = {}       # pool batch -> (call index, K, ct, ok) of its rows

    def setup(self) -> None:
        from repro_torch.pq import mlkem
        self.encaps = mlkem.encaps_batch
        for ek, m in zip(self.ek, self.m):
            self.encaps(ek, m)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> dict:
        encaps, ek, m, rows = self.encaps, self.ek, self.m, self.rows
        pool = len(ek)
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            p = i % pool
            key, ct, ok = encaps(ek[p], m[p])
            r = rows[p]
            self.kept[p] = (i, key.index_select(0, r), ct.index_select(0, r),
                            ok.index_select(0, r))
            i += 1
            if i >= pool and time.perf_counter() >= deadline:      # each batch once at least
                break
        self._sync()
        wall = time.perf_counter() - t0
        done = i * self.mix["batch"]
        return {"metrics": {"requests_per_s": done / wall}, "attempted": done,
                "failed": 0, "window_s": wall, "counters": {"calls": i}}

    def keep_without_program(self, seconds: float, calls: int) -> None:
        """What a run of ``calls`` calls would keep, with no program run:
        the control's sample."""
        self.kept = {p: (p, None, None, None) for p in range(min(calls, len(self.ek)))}

    def profile(self, seconds: float) -> dict:
        root = self.cell.root
        rec: dict = {"port": trace.port_kernels(root),
                     "keccak_kernels": kernels_of(root, "keccak.cu"),
                     "ring_kernels": kernels_of(root, "ntt_regs.cuh", "ntt_banks.cu",
                                                  "dyadic_basemul.cu")}
        encaps, ek, m, i = self.encaps, self.ek, self.m, 0
        with trace.profiled(rec, host=self.mix.get("profile_host", True)):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                encaps(ek[i % len(ek)], m[i % len(ek)])
                i += 1
        rec["requests"] = i * self.mix["batch"]
        return rec

    def free(self) -> None:
        self.__dict__.pop("encaps", None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """Bytes of the kept rows' K and ct that differ from the reference
        (a rejected key's are zero), verdicts that differ from §7.2's, and
        the sampled rows no call kept; ``control`` puts the reference in
        float32 in the program's place."""
        exact, low = MlKem768(), MlKem768(lowp=True)
        mismatched = verdicts = missing = 0
        for p, r in enumerate(self.rows):
            if p not in self.kept:
                missing += len(r)
                continue
            _, key, ct, ok = self.kept[p]
            ek = self.ek[p].index_select(0, r).cpu().numpy()
            m = self.m[p].index_select(0, r).cpu().numpy()
            if control:
                got = [low.encaps(bytes(e), bytes(x)) for e, x in zip(ek, m)]
            else:
                got = list(zip(ok.cpu().tolist(), map(bytes, key.cpu().numpy()),
                               map(bytes, ct.cpu().numpy())))
            for (g_ok, g_key, g_ct), e, x in zip(got, ek, m):
                w_ok, w_key, w_ct = exact.encaps(bytes(e), bytes(x))
                verdicts += g_ok != w_ok
                mismatched += sum(a != b for a, b in zip(g_key + g_ct, w_key + w_ct))
                mismatched += abs(len(g_key + g_ct) - len(w_key + w_ct))
        return {"mismatched_bytes": (mismatched, 0), "bad_verdicts": (verdicts, 0),
                "missing_rows": (missing, 0)}

