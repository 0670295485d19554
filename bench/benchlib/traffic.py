"""The one traffic generator.  A mix is a JSON file of parameters under
``bench/traffic/``; this module turns it and a seed into the requests a
window offers.  Nothing here reads the program.

Encrypted-operation mixes (the CKKS serving cells) are described per
request by an op code, the basis it sits at (0 the full chain, 1 one
level down), the pool slots of its operands and a rotation amount.
Every draw comes from ``stream(seed, ...)``, so a seed fixes the work;
each chunk holds the mix's ops and levels in exact proportions, in an
order the seed shuffles, so seeds change the order of the work and not
its amount.

Parameters of an ``fhe_requests`` mix:
  ops          op name -> weight (multiply, rescale, rotate, conjugate, matvec)
  rotations    the rotation amounts rotates draw from (default: every
               amount the configuration keys); each must be keyed
  lower_share  share of requests one level down
  chunk        requests a backlog chunk holds, all due at its start;
               the chunks run back to back
  pool         ciphertexts the operands are drawn from, split evenly
               over the bases in use
  slots        the period of the engine's group slots: request k of a
               class in a chunk rides slot k mod ``slots`` of its group
Parameters of an ``ntt_rows`` mix: ``rows`` per batch, ``pool`` batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np

OPS = ("multiply", "rescale", "rotate", "conjugate", "matvec")

# streams of draws under one seed
CHUNK, INPUTS, SAMPLE, WARM = 1, 4, 5, 6


def stream(seed: int, *words: int) -> np.random.Generator:
    """A generator for one stream of a run's draws.  Any whole seed,
    negative or past 64 bits, maps to its own entropy."""
    s = seed % (1 << 128)
    return np.random.default_rng([s & (2**64 - 1), s >> 64, *words])


def torch_seed(seed: int, *words: int) -> int:
    """A seed for a ``torch.Generator`` from the same streams."""
    return int(stream(seed, INPUTS, *words).integers(0, 2**62))


@dataclasses.dataclass
class Requests:
    """Descriptors of a batch of encrypted-operation requests."""
    op: np.ndarray            # index into OPS
    basis: np.ndarray         # 0 full chain, 1 one level down
    a: np.ndarray             # pool slot of the operand, at its basis
    b: np.ndarray             # pool slot of multiply's second operand
    r: np.ndarray             # rotation amount (rotate only)

    def __len__(self) -> int:
        return len(self.op)


def exact_counts(weights: dict, count: int) -> dict:
    """Split ``count`` over ``weights`` in exact proportions (largest
    remainder, ties to the earlier name)."""
    total = sum(weights.values())
    raw = {k: count * w / total for k, w in weights.items()}
    out = {k: int(v) for k, v in raw.items()}
    for k in sorted(raw, key=lambda k: -(raw[k] - out[k]))[: count - sum(out.values())]:
        out[k] += 1
    return out


def pool_sizes(mix: dict) -> tuple[int, ...]:
    """Ciphertexts at each basis in use."""
    bases = 2 if mix.get("lower_share", 0) > 0 else 1
    return (mix["pool"] // bases,) * bases


def requests(mix: dict, amounts, lower_level: int, rng: np.random.Generator,
             count: int) -> Requests:
    """``count`` requests of the mix.  ``amounts`` are the rotation
    amounts keyed in the configuration; ``lower_level`` the level of the
    lower basis (a rescale there at level 0 becomes a rotate)."""
    for op in mix["ops"]:
        if op not in OPS:
            raise ValueError(f"unknown op {op!r} in the mix (known: {OPS})")
    counts = exact_counts(mix["ops"], count)
    op = rng.permutation(np.repeat([OPS.index(k) for k in counts], list(counts.values())))
    basis = np.zeros(count, dtype=np.int64)
    lower = int(round(mix.get("lower_share", 0) * count))
    basis[rng.permutation(count)[:lower]] = 1
    if lower_level < 1:
        op[(basis == 1) & (op == OPS.index("rescale"))] = OPS.index("rotate")
    sizes = np.array(pool_sizes(mix))
    a = rng.integers(0, sizes[basis])
    b = rng.integers(0, sizes[basis])
    used = mix.get("rotations", list(amounts))
    if set(used) - set(amounts):
        raise ValueError(f"rotations {sorted(set(used) - set(amounts))} are not keyed")
    r = np.asarray(used, dtype=np.int64)[rng.integers(0, len(used), count)]
    return Requests(op=op, basis=basis, a=a, b=b, r=r)


def chunk(mix: dict, amounts, lower_level: int, seed: int, index: int) -> Requests:
    """Backlog chunk ``index`` of a run."""
    return requests(mix, amounts, lower_level, stream(seed, CHUNK, index), mix["chunk"])


def classes(d: Requests) -> np.ndarray:
    """Each request's (op, basis) class, numbered op * 2 + basis."""
    return d.op * 2 + d.basis


def slots(d: Requests, period: int) -> np.ndarray:
    """Each request's slot in its group: its rank among the chunk's
    requests of its class, mod ``period`` (a backlog's groups take a
    class's requests in queue order)."""
    cls = classes(d)
    out = np.empty(len(d), dtype=np.int64)
    for c in np.unique(cls):
        idx = np.flatnonzero(cls == c)
        out[idx] = np.arange(len(idx)) % period
    return out
