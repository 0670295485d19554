"""Backend-aware batch-tile tuning: the one funnel that picks a tile per
``(backend, family, k, n, b, dtype)``.

``backend`` is ``"cpu"`` or the card's name as
``torch.cuda.get_device_name`` gives it, so a cache measured on one card
is never read on another.  The dtype part keeps scheme families apart: a
uint16 small-ring workload (ML-KEM) never reads the uint32 CKKS entry of
the same (family, k, n, b).

Resolution order (``resolve_tile``):

  1. an explicit ``tile=`` argument (clamped to the batch),
  2. the ``SCE_NTT_TILE`` env pin,
  3. a cached result (in-process, seeded from the optional JSON sidecar
     named by ``SCE_NTT_AUTOTUNE_CACHE``),
  4. a fresh measurement, only when ``SCE_NTT_AUTOTUNE=1``, the family
     has a runner and no CUDA graph is being captured on the current
     stream (a measurement inside ``fhe.evalplan``'s capture would be
     recorded into the graph and time nothing),
  5. the static default ``min(8, b)``.

Every path clamps to ``max(1, min(tile, b))``.  ``shards=`` resolves
against the per-shard batch ``ceil(b / shards)``: a plan split over a
mesh's "b" axis runs that many rows on each shard, so the cache key, the
clamp and the measured workload all describe the grid a shard runs.

The port's kernels take no tile (Pallas batch tiling has no counterpart
on the card), so one family has a runner: ``serve_batch``, the tile the
serving engine pads its groups to.  Its proxy is the reference's, the
banks forward transform on a k-prime TablePack at n, timed as
``ceil(b / t)`` calls of t rows.  Other families resolve pin > cache >
default.  ``ensure`` measures on a miss whatever the env flag says;
``table`` / ``dump`` snapshot the cache with each entry's evidence (the
candidate table in seconds).  A sidecar that is not JSON is ignored, as
the reference ignores it, and one that cannot be read or written raises;
a fault of the card during a measurement raises
(``kernels.is_device_fault``), any other failure of a candidate skips it.
"""
from __future__ import annotations

import functools
import json
import os
import re
import time
import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.convert import resolve_device
from repro_torch.kernels import is_device_fault

CANDIDATE_TILES = (1, 2, 4, 8, 16, 32)
DEFAULT_TILE = 8

ENV_PIN = "SCE_NTT_TILE"
ENV_CACHE = "SCE_NTT_AUTOTUNE_CACHE"
ENV_AUTOTUNE = "SCE_NTT_AUTOTUNE"

# (backend, family, k, n, b, dtype) -> best tile
_MEM: dict[tuple, int] = {}
# (same key) -> {"chosen": tile, "source": "measured" / "default" /
# "runner-error" / "disk" / "default-nonu32", "candidates": {tile: median s}}
_EVIDENCE: dict[tuple, dict] = {}
_DISK_LOADED = False
_KEY_PARTS = 6      # the persisted "be|fam|k|n|b|dtype" format


def clamp(tile: int, b: int) -> int:
    """The universal tile rule: at least 1, never wider than the batch."""
    b = int(b)
    if b <= 0:
        return 1
    return max(1, min(int(tile), b))


def _backend(device) -> str:
    device = resolve_device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _key(family: str, k: int, n: int, b: int, dtype: str = "uint32",
         device=None) -> tuple:
    return (_backend(device), family, int(k), int(n), int(b), str(dtype))


def _capture_clean() -> bool:
    """False while a CUDA graph is being captured on the current stream."""
    return not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def _env_pin() -> int | None:
    v = os.environ.get(ENV_PIN)
    if not v or not re.fullmatch(r"\s*[+-]?[0-9](_?[0-9])*\s*", v):
        return None         # unset or not an integer literal: no pin
    return int(v)


def _load_disk() -> None:
    global _DISK_LOADED
    if _DISK_LOADED:
        return
    _DISK_LOADED = True
    path = os.environ.get(ENV_CACHE)
    if not path or not os.path.exists(path):
        return
    with open(path) as f:
        try:
            data = json.load(f)
        except json.JSONDecodeError:
            return      # a corrupt sidecar never breaks dispatch
    stale = 0
    evidence = data.get("evidence", {})
    for ks, tile in data.get("entries", {}).items():
        parts = ks.split("|")
        if len(parts) != _KEY_PARTS:
            # a pre-dtype (5-part) entry could hand a u16 family a tile
            # tuned for the other lane width: skip it loudly
            stale += 1
            continue
        be, fam, k, n, b, dt = parts
        key = (be, fam, int(k), int(n), int(b), dt)
        _MEM[key] = int(tile)
        ev = evidence.get(ks, {})
        _EVIDENCE[key] = {"chosen": int(tile), "source": "disk",
                          "candidates": {int(t): float(s) for t, s in
                                         ev.get("candidates", {}).items()}}
    if stale:
        warnings.warn(
            f"autotune: ignoring {stale} old-format entr"
            f"{'y' if stale == 1 else 'ies'} in {path!r} (expected "
            f"{_KEY_PARTS}-part 'backend|family|k|n|b|dtype' keys); "
            "re-measure to refresh the cache", stacklevel=2)


def _save_disk() -> None:
    path = os.environ.get(ENV_CACHE)
    if path:
        dump(path)


def table() -> dict:
    """JSON-ready snapshot of the tuning state: ``entries`` (key -> tile,
    the stable sidecar format), ``evidence`` (per entry: the chosen tile,
    how it was chosen, the candidate tile -> median seconds table of a
    measurement), the pin, and the default device's backend name."""
    return {
        "backend": _backend(None) if torch.cuda.is_available() else "cpu",
        "pin": _env_pin(),
        "entries": {"|".join(str(p) for p in key): tile
                    for key, tile in sorted(_MEM.items())},
        "evidence": {
            "|".join(str(p) for p in key): {
                "chosen": ev.get("chosen"),
                "source": ev.get("source"),
                "candidates": {str(t): s for t, s in
                               sorted(ev.get("candidates", {}).items())},
            }
            for key, ev in sorted(_EVIDENCE.items())
        },
    }


def dump(path: str) -> None:
    with open(path, "w") as f:
        json.dump(table(), f, indent=1, sort_keys=True)


def clear() -> None:
    """Drop the in-process cache (tests)."""
    global _DISK_LOADED
    _MEM.clear()
    _EVIDENCE.clear()
    _DISK_LOADED = True     # don't resurrect entries from disk


def shard_batch(b: int, shards: int = 1) -> int:
    """The per-shard batch of a ``shards``-way split: ``ceil(b / shards)``
    (the last shard may run padded)."""
    b, shards = int(b), max(1, int(shards))
    return -(-b // shards) if b > 0 else b


def _cached_or_default(family, k, n, b, dtype, device, measure_now: bool) -> int:
    """Steps 3-5 of the funnel for a per-shard batch ``b``."""
    _load_disk()
    key = _key(family, k, n, b, dtype, device)
    hit = _MEM.get(key)
    if hit is not None:
        obs.counter_add("autotune.resolve.cache_hit")
        return clamp(hit, b)
    obs.counter_add("autotune.resolve.cache_miss")
    if measure_now and family in _RUNNERS and _capture_clean():
        return clamp(measure(family, k, n, b, dtype=dtype, device=device), b)
    obs.counter_add("autotune.resolve.default")
    return clamp(DEFAULT_TILE, b)


def resolve_tile(family: str, k: int, n: int, b: int,
                 tile: int | None = None, *, shards: int = 1,
                 dtype: str = "uint32", device=None) -> int:
    """The tile for ``family`` at (k primes, ring n, batch b) on ``device``
    (the card unless the caller names another): explicit > pin > cache >
    (gated) measure > default, against the per-shard batch."""
    b = shard_batch(b, shards)
    if tile is not None:
        obs.counter_add("autotune.resolve.explicit")
        return clamp(tile, b)
    pin = _env_pin()
    if pin is not None:
        obs.counter_add("autotune.resolve.pin")
        return clamp(pin, b)
    return _cached_or_default(family, k, n, b, dtype, device,
                              os.environ.get(ENV_AUTOTUNE) == "1")


def ensure(family: str, k: int, n: int, b: int, *, shards: int = 1,
           dtype: str = "uint32", device=None) -> int:
    """Measure on a miss (benchmarks): pin > cache > measure > default,
    against the per-shard batch like ``resolve_tile``."""
    b = shard_batch(b, shards)
    pin = _env_pin()
    if pin is not None:
        obs.counter_add("autotune.resolve.pin")
        return clamp(pin, b)
    return _cached_or_default(family, k, n, b, dtype, device, True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(family: str, k: int, n: int, b: int, *, reps: int = 3,
            dtype: str = "uint32", device=None) -> int:
    """Time every candidate tile <= b on the family's proxy workload on
    ``device`` and cache the argmin of each candidate's fastest pass (the
    median is recorded as evidence).  A non-u32 dtype caches the static
    default: the runners are u32 workloads."""
    device = resolve_device(device)
    key = _key(family, k, n, b, dtype, device)
    if dtype != "uint32":
        _MEM[key] = clamp(DEFAULT_TILE, b)
        _EVIDENCE[key] = {"chosen": _MEM[key], "source": "default-nonu32",
                          "candidates": {}}
        _save_disk()
        return _MEM[key]
    try:
        run = _RUNNERS[family](int(k), int(n), int(b), device)
    except Exception as e:
        if is_device_fault(e):
            raise
        _MEM[key] = clamp(DEFAULT_TILE, b)
        _EVIDENCE[key] = {"chosen": _MEM[key], "source": "runner-error",
                          "candidates": {}}
        return _MEM[key]
    cands = sorted({clamp(t, b) for t in CANDIDATE_TILES})
    best_tile, best_t = clamp(DEFAULT_TILE, b), float("inf")
    candidates: dict[int, float] = {}
    with obs.span("autotune.measure", family=family, k=int(k), n=int(n),
                  b=int(b), dtype=dtype):
        for t in cands:
            try:
                run(t)                      # build + warm
                _sync(device)
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    run(t)
                    _sync(device)
                    times.append(time.perf_counter() - t0)
            except Exception as e:
                if is_device_fault(e):
                    raise
                continue
            candidates[t] = float(sorted(times)[len(times) // 2])
            if min(times) < best_t:
                best_tile, best_t = t, min(times)
    _MEM[key] = best_tile
    _EVIDENCE[key] = {"chosen": best_tile,
                      "source": "measured" if candidates else "runner-error",
                      "candidates": candidates}
    if obs.enabled():
        obs.counter_add("autotune.measurements")
        keystr = "|".join(str(p) for p in key)
        for t, s in candidates.items():
            obs.gauge_set(f"autotune.candidate_s.{keystr}.tile{t}", s)
        obs.gauge_set(f"autotune.chosen.{keystr}", best_tile)
    _save_disk()
    return best_tile


# -------------------------------------------------------------- runners
#
# A runner builds its workload once and returns ``fn(tile)``; ops and the
# pack builder are imported here, not at the top (ops' package imports
# this module's package).

@functools.lru_cache(maxsize=8)
def _pack(k: int, n: int, device: str) -> dict:
    from repro_torch.core.params import gen_ntt_primes
    from repro_torch.fhe.batched import build_table_pack
    return build_table_pack(gen_ntt_primes(k, n), n, device)


def _run_serve_batch(k: int, n: int, b: int, device: torch.device):
    """The banks forward transform over ``b`` rows of each of k primes as
    ``ceil(b / t)`` calls of t rows (the reference's batch-shaped proxy)."""
    from repro_torch.kernels import ops
    t = _pack(k, n, str(device))
    rng = np.random.default_rng(0xC0FFEE)
    qs = t["qs"].cpu().numpy().astype(np.int64)
    x = torch.from_numpy(np.stack([rng.integers(0, q, size=(b, n)) for q in qs])
                         .astype(np.int32)).to(device)

    rows: dict[int, torch.Tensor] = {}

    def run(tile: int):
        if tile not in rows:            # on the warm-up call, not a timed one
            rows[tile] = x[:, :tile].contiguous()
        out = None
        for _ in range(-(-b // tile)):
            out = ops.ntt_banks(rows[tile], t)
        return out
    return run


_RUNNERS = {"serve_batch": _run_serve_batch}
