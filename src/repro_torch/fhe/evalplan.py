"""Device-resident CKKS evaluation plan (paper Fig 1 / Fig 22).

An ``EvalPlan`` precomputes, per prime basis, the stacked tables the bank
kernels consume (TablePack for single-kernel rings, FourStepPack + scalar
pack past ``ops.FOURSTEP_MIN_N``), the stacked ``(k, k+1, n)``
relinearization and Galois key digits and the NTT-domain Galois gather
rows, then runs each scheme op as one program over raw (k, n) residue
stacks:

  multiply   -> ``multiply_banks``  (tensor product + fused batched_keyswitch)
  rescale    -> ``rescale_banks``   (both halves through one mod_down_banks)
  rotate/conjugate -> ``galois_ks_banks`` (NTT-domain gather + key switch)
  R rotations of one ct -> ``hoisted_rotations_banks`` (one digit
                decomposition, R digit gathers, R key inner products,
                one mod-down over all 2R halves)

The ``*_many`` twins take (B, k, n) leading-batch stacks: B ciphertexts
at one basis ride one pass of every kernel, bit-identical to a loop of
the single-ciphertext programs.  A Galois batch carries a gather row and
key digits per ciphertext, so one pass can mix rotation amounts.
Batching never crosses bases.

Compiled programs.  The module-level functions are the plain eager
programs.  On the card, ``EvalPlan``'s methods run each of them as a CUDA
graph, the counterpart of the reference's ``jax.jit``: the first call for
a signature (the program, its basis, the shapes of its tensor arguments:
B, R, L, uniform against mixed Galois) runs the program once eagerly on
a side stream, so every kernel is built and every lazily cached table
exists, then captures it; every later call copies its tensors into the
graph's static inputs, replays the graph and clones the outputs out.
Every tensor argument is an input, keys and gather rows included, so
one capture covers every rotation amount and every pattern of group
elements at that shape, and no graph reads a tensor a cache may free;
only the basis's tables are captured as they are.  A plan's graphs on
one device share one memory pool (they replay in order on one stream
and their outputs are cloned out).  ``EvalPlan.trace_count()`` counts
the captures in the process, and ``prepare(warm_jit=True,
batch_sizes=...)`` captures ahead of traffic.  A capture or replay that fails raises; nothing falls back
to the eager program.  On the CPU the programs run eagerly.

Scale-out.  ``EvalPlan(ctx, mesh=mesh.make_mesh(devices))`` splits every
batched program over the mesh's "b" axis, as the reference's
``shard_map`` twins do: ``multiply_many``, ``rescale_many`` and
``galois_ks_many`` cut their (B, k, n) stacks into equal shards (a mixed
Galois batch builds each shard's own key stacks and gather rows), and
``hoisted_galois`` cuts its R rotations while every shard takes the whole
ciphertext and pays its own decomposition.  No shard reads another's
rows, so the answers equal the unsharded plan's bit for bit.  A batch is
padded to a multiple of the axis size by repeating its last entry; pad
rows are computed and dropped, and the counters charge the logical batch.
Tables, keys and gather rows are copied to each device once and cached.
Each shard runs that device's CUDA graph for its shapes: shards on one
card run in turn and share a graph, shards on different cards run on
each card's current stream, and their outputs are copied to the plan's
device.  A mesh of one device is sharded too.

A "k" axis of s > 1 shards splits the RNS prime axis, as the reference's
``_shard_k`` does: a program whose ciphertext has a multiple of s primes
runs over it, any other runs unsharded on the plan's device.  Over "k"
go ``multiply``, ``rescale`` and ``apply_galois`` always, and the
``*_many`` programs and ``hoisted_galois`` when the mesh has no "b" axis.
Shard j owns the block ``basis[j*m:(j+1)*m]`` (m = k/s) and runs on its
device with the tables of its shard basis: the block, then the prime the
program drops (P for a key switch, the last prime for a rescale), so
``mod_down_banks`` reads that basis's own P^-1 rows.  A key switch splits
at its one cross-prime step: each shard runs its block up to the digit
iNTTs (the ``*_front`` programs), the plan gathers the s blocks of
coefficient digits onto every shard's device (the exchange: a
``torch.cat`` on one card, peer copies across cards), and each shard
extends all k digits onto its shard basis and finishes there (the
``*_back`` programs: forward banks, digit MACs with its rows of the key,
the mod-down by P, which every shard computes for itself).  A rescale
copies the dropped prime's rows to every shard and needs no exchange.
Graphs and tables are keyed by the shard basis, so shards on one card
never replay each other's.  The outputs, concatenated on the prime axis
on the plan's device, equal the unsharded plan's bit for bit, the lazy
[0, 2q) representatives included.  ``plain_mac`` and ``accumulate`` stay
on the plan's device.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import kernels as K
from repro_torch import obs
from repro_torch.core.modmath import addmod, mulmod_barrett, u32
from repro_torch.core.params import galois_eval_perm
from repro_torch.fhe import batched as FB
from repro_torch.fhe import rns
from repro_torch.fhe.batched import mod_down_banks
from repro_torch.fhe.rns import RnsPoly
from repro_torch.kernels import ops
from repro_torch.mesh import canonical


@dataclasses.dataclass
class Ciphertext:
    c0: RnsPoly
    c1: RnsPoly
    scale: float

    @property
    def primes(self):
        return self.c0.primes

    @property
    def level(self) -> int:
        return len(self.primes) - 1


# ------------------------------------------------------- scheme-API checks

def _ct_desc(ct: Ciphertext) -> str:
    return f"primes={ct.primes} (level {ct.level}, scale {ct.scale:g})"


def check_same_basis(op: str, a: Ciphertext, b: Ciphertext,
                     check_scale: bool = False):
    """Raise ``ValueError`` when two operands disagree on basis — or on
    scale, for ops like ``add`` that require it."""
    if a.primes != b.primes:
        raise ValueError(
            f"{op}: operand bases differ — lhs {_ct_desc(a)} vs rhs "
            f"{_ct_desc(b)}; rescale / level-align both operands first "
            "(mixed bases never combine or batch)")
    if check_scale and abs(a.scale - b.scale) > 1e-9 * abs(a.scale):
        raise ValueError(
            f"{op}: operand scales differ — lhs {_ct_desc(a)} vs rhs "
            f"{_ct_desc(b)}; rescale or scale-match the operands first")


def check_level(op: str, ct: Ciphertext, need: int = 0):
    """``rescale`` needs a modulus to drop (need=1); every op needs a
    non-empty basis."""
    if ct.level < need:
        raise ValueError(
            f"{op}: prime chain exhausted — ciphertext has "
            f"{len(ct.primes)} modulus(es) left ({_ct_desc(ct)}) but "
            f"{op} needs level >= {need}; build the CkksContext with "
            "more levels for deeper circuits")


# ------------------------------------------------------------ programs

def _tensor_product(a0, a1, b0, b1, q, mu):
    """(d0, d1, d2) = (a0*b0, a0*b1 + a1*b0, a1*b1) as int64 u32 values,
    for NTT-form halves broadcasting against the (.., k, 1) columns q/mu."""
    a0, a1, b0, b1 = a0.long(), a1.long(), b0.long(), b1.long()
    d0 = mulmod_barrett(a0, b0, q, mu)
    d1 = addmod(mulmod_barrett(a0, b1, q, mu), mulmod_barrett(a1, b0, q, mu), q)
    d2 = mulmod_barrett(a1, b1, q, mu)
    return d0, d1, d2


def multiply_front(a0, a1, b0, b1, t, fsp=None):
    """A multiply up to its one cross-prime step: the tensor product and
    the digit iNTTs of d2.  a0/a1/b0/b1: (k, n) NTT-form halves over t's
    first k primes.  Returns (d0, d1, ci): the int64 (k, n) d0 and d1 and
    d2's (k, 1, n) coefficient digits."""
    k = a0.shape[0]
    q = u32(t["qs"][:k])[:, None]
    mu = u32(t["mu"][:k])[:, None]
    d0, d1, d2 = _tensor_product(a0, a1, b0, b1, q, mu)
    return d0, d1, FB.decompose_intt(d2.int()[:, None], t, fsp=fsp)


def multiply_back(ci, d0, d1, evk_b, evk_a, src_qs, t, fsp=None):
    """The rest of a multiply: the key switch of the digits ci (mod
    ``src_qs``) onto t's primes and the sums with d0/d1.  evk_b/evk_a:
    (d, kt, n) over t's kt primes.  Returns the (c0, c1) stacks over all
    of them but P."""
    k = d0.shape[0]
    q = u32(t["qs"][:k])[:, None]
    ks0, ks1 = FB.keyswitch_digits(ci, src_qs, evk_b, evk_a, t, fsp=fsp)
    return (addmod(d0, ks0[:, 0].long(), q).int(),
            addmod(d1, ks1[:, 0].long(), q).int())


def multiply_banks(a0, a1, b0, b1, evk_b, evk_a, t, fsp=None):
    """Ciphertext tensor + relinearization.  a0/a1/b0/b1: (k, n) NTT-form
    halves; evk_b/evk_a: (k, k+1, n) relin key digits; t (+ fsp) the
    basis+special tables.  Returns the (c0, c1) stacks."""
    d0, d1, ci = multiply_front(a0, a1, b0, b1, t, fsp)
    return multiply_back(ci, d0, d1, evk_b, evk_a, t["qs"], t, fsp)


def rescale_banks(c0, c1, t, fsp=None):
    """Rescale by the last basis prime: both halves ride one fused
    ``mod_down_banks`` as a batch of two.  t's basis is the ciphertext
    basis itself (its last prime is the one dropped)."""
    acc = torch.stack([c0, c1], dim=1)                 # (k+1, 2, n)
    out = mod_down_banks(acc, t, fsp=fsp)
    return out[:, 0], out[:, 1]


def multiply_many_front(a0, a1, b0, b1, t, fsp=None):
    """``multiply_front`` of B ciphertexts: a0/a1/b0/b1 (B, k, n).  Returns
    the (B, k, n) d0 and d1 and the (k, B, n) digits."""
    k = a0.shape[1]
    q = u32(t["qs"][:k])[None, :, None]
    mu = u32(t["mu"][:k])[None, :, None]
    d0, d1, d2 = _tensor_product(a0, a1, b0, b1, q, mu)
    return d0, d1, FB.decompose_intt(d2.int().transpose(0, 1).contiguous(), t, fsp=fsp)


def multiply_many_back(ci, d0, d1, evk_b, evk_a, src_qs, t, fsp=None):
    k = d0.shape[1]
    q = u32(t["qs"][:k])[None, :, None]
    ks0, ks1 = FB.keyswitch_digits(ci, src_qs, evk_b, evk_a, t, fsp=fsp)
    return (addmod(d0, ks0.transpose(0, 1).long(), q).int(),
            addmod(d1, ks1.transpose(0, 1).long(), q).int())


def multiply_many_banks(a0, a1, b0, b1, evk_b, evk_a, t, fsp=None):
    """B tensor products + relinearization in one pass of every kernel.
    a0/a1/b0/b1: (B, k, n); evk_b/evk_a: (k, k+1, n) shared by the batch.
    Returns (B, k, n) stacks."""
    d0, d1, ci = multiply_many_front(a0, a1, b0, b1, t, fsp)
    return multiply_many_back(ci, d0, d1, evk_b, evk_a, t["qs"], t, fsp)


def rescale_many_banks(c0, c1, t, fsp=None):
    """Rescale B ciphertexts by the last basis prime: all 2B halves ride
    one fused ``mod_down_banks``.  c0/c1: (B, k+1, n)."""
    B, kp1, n = c0.shape
    acc = torch.stack([c0, c1], dim=1)                  # (B, 2, k+1, n)
    acc = acc.reshape(2 * B, kp1, n).transpose(0, 1)    # (k+1, 2B, n)
    out = mod_down_banks(acc, t, fsp=fsp)
    out = out.transpose(0, 1).reshape(B, 2, kp1 - 1, n)
    return out[:, 0], out[:, 1]


def galois_ks_front(c0, c1, idx, t, fsp=None):
    """A rotation up to its one cross-prime step: the NTT-domain gather on
    both halves and the digit iNTTs of the permuted c1.  c0/c1 (k, n); idx
    (n,).  Returns (c0g, ci): the gathered c0 and c1's (k, 1, n) digits."""
    c0g = ops.galois_banks(c0, idx)
    c1g = ops.galois_banks(c1, idx)
    return c0g, FB.decompose_intt(c1g[:, None], t, fsp=fsp)


def galois_ks_back(ci, c0g, evk_b, evk_a, src_qs, t, fsp=None):
    k = c0g.shape[0]
    q = u32(t["qs"][:k])[:, None]
    ks0, ks1 = FB.keyswitch_digits(ci, src_qs, evk_b, evk_a, t, fsp=fsp)
    return addmod(c0g.long(), ks0[:, 0].long(), q).int(), ks1[:, 0]


def galois_ks_banks(c0, c1, idx, evk_b, evk_a, t, fsp=None):
    """Slot rotation / conjugation: NTT-domain gather on both halves (no
    iNTT/NTT round trip), then the key switch of the permuted c1 under
    the Galois key.  c0/c1 (k, n); idx (n,); evk_b/evk_a (k, k+1, n)."""
    c0g, ci = galois_ks_front(c0, c1, idx, t, fsp)
    return galois_ks_back(ci, c0g, evk_b, evk_a, t["qs"], t, fsp)


def galois_ks_many_front(c0, c1, idx, t, fsp=None):
    """``galois_ks_front`` of B ciphertexts: c0/c1 (B, k, n), idx (n,) or
    (B, n).  Returns the (B, k, n) gathered c0 and the (k, B, n) digits."""
    c0g = ops.galois_banks(c0, idx, batch_leading=True)
    c1g = ops.galois_banks(c1, idx, batch_leading=True)
    return c0g, FB.decompose_intt(c1g.transpose(0, 1).contiguous(), t, fsp=fsp)


def galois_ks_many_back(ci, c0g, evk_b, evk_a, src_qs, t, fsp=None):
    k = c0g.shape[1]
    q = u32(t["qs"][:k])[None, :, None]
    ks0, ks1 = FB.keyswitch_digits(ci, src_qs, evk_b, evk_a, t, fsp=fsp)
    return (addmod(c0g.long(), ks0.transpose(0, 1).long(), q).int(),
            ks1.transpose(0, 1))


def galois_ks_many_banks(c0, c1, idx, evk_b, evk_a, t, fsp=None):
    """B rotations / conjugations in one pass.  c0/c1: (B, k, n).  A mixed
    batch passes (B, n) gather rows and (k, k+1, B, n) per-ciphertext key
    digits; a uniform one the shared (n,) row and (k, k+1, n) digits.
    Returns (B, k, n) stacks."""
    c0g, ci = galois_ks_many_front(c0, c1, idx, t, fsp)
    return galois_ks_many_back(ci, c0g, evk_b, evk_a, t["qs"], t, fsp)


def hoisted_front(c1, t, fsp=None):
    """The hoisted rotations' one decomposition up to its cross-prime
    step: c1's (k, 1, n) coefficient digits, in a tuple."""
    return (FB.decompose_intt(c1[:, None], t, fsp=fsp),)


def hoisted_back(ci, c0, idx, evk_b, evk_a, src_qs, t, fsp=None):
    """The rest of ``hoisted_rotations_banks`` from c1's digits ci (mod
    ``src_qs``) onto t's primes."""
    k = c0.shape[0]
    R = idx.shape[0]
    q = u32(t["qs"][:k])[:, None, None]
    y = FB.decompose_extend(ci, src_qs, t, fsp=fsp)         # (d, k+1, 1, n)
    # shared-mode gathers: the one decomposition (and c0, as a single
    # "digit") fan out to the R gather rows inside the kernel
    yg = ops.galois_digits_banks(y, idx)                    # (d, k+1, R, n)
    acc0 = ops.dyadic_inner_banks(yg, evk_b, t)             # (k+1, R, n)
    acc1 = ops.dyadic_inner_banks(yg, evk_a, t)
    ks = mod_down_banks(torch.cat([acc0, acc1], dim=1), t, fsp=fsp)
    ks0, ks1 = ks[:, :R], ks[:, R:]
    c0g = ops.galois_digits_banks(c0[None, :, None], idx)[0]
    return addmod(c0g.long(), ks0.long(), q).int(), ks1


def hoisted_rotations_banks(c0, c1, idx, evk_b, evk_a, t, fsp=None):
    """R rotations of ONE ciphertext with the key-switch front half
    hoisted: c1's digit decomposition runs once, and each rotation
    gathers those digits in the evaluation domain (the automorphism
    commutes with the per-prime decomposition, so this is bit-identical
    to decomposing each rotated c1).

    c0/c1: (k, n); idx: (R, n) gather rows; evk_b/evk_a: (k, k+1, R, n)
    per-rotation key digits.  Returns (k, R, n) stacks, rotation r in
    batch column r."""
    (ci,) = hoisted_front(c1, t, fsp)
    return hoisted_back(ci, c0, idx, evk_b, evk_a, t["qs"], t, fsp)


def plain_mac_banks(b0, b1, diags, rows, group, qs, mus, *, groups: int):
    """BSGS multiply-accumulate (the ``fhe.linalg.matvec`` inner sums):
    inner_g = sum over the diagonals d of group g of
    diags[d] * babies[rows[d]], for every giant group at once.

    b0/b1: (R, k, n) halves of the baby rotations; diags: (D, k, n)
    plaintext diagonals; rows/group: (D,) int64 device tensors, diagonal
    d's row in the baby stack and its giant group in [0, groups);
    qs/mus: (k, 1) int64 Barrett columns.  Returns (groups, k, n) stacks.
    The int64 sum of canonical residues (< 2^31 each) is exact, so this
    is the same residue as any order of modular adds."""
    d = diags.long()
    out = []
    for b in (b0, b1):
        p = mulmod_barrett(d, b[rows].long(), qs, mus)
        acc = torch.zeros((groups,) + tuple(p.shape[1:]), dtype=torch.int64,
                          device=p.device)
        acc.index_add_(0, group, p)
        out.append(torch.remainder(acc, qs).int())
    return tuple(out)


def accumulate_banks(parts0, parts1, qs):
    """Modular sum of L ciphertext halves: parts0/parts1 are nonempty
    lists of (k, n) canonical stacks, qs the (k, 1) prime column.  The
    int64 sum is exact, so this equals any order of modular adds."""
    return tuple(torch.remainder(torch.stack(parts).long().sum(0), qs).int()
                 for parts in (parts0, parts1))


class _Graph:
    """One captured program: its static input buffers, the CUDA graph,
    its static outputs, and the kernel launches one replay makes."""

    def __init__(self, name: str, fn, inputs: tuple, consts: tuple, pool):
        self.inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device)
                            for x in inputs)
        for s, x in zip(self.inputs, inputs):
            s.copy_(x)
        # eager warm-up on a side stream: builds the kernels and fills every
        # lazily cached table (a host copy is illegal during a capture)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.inputs, *consts)
        torch.cuda.current_stream().wait_stream(side)
        # a captured launch runs at each replay, not at the capture, so the
        # capture's counts are taken back and added at every replay instead
        before = {k: c.launches for k, c in K.COUNTS.items()}
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = fn(*self.inputs, *consts)
        except Exception as e:
            raise K.GraphError(f"{name}: CUDA graph capture failed: {e}") from e
        self.launches = {}
        for k, c in K.COUNTS.items():
            if c.launches != before[k]:
                self.launches[k] = c.launches - before[k]
                c.launches = before[k]

    def replay(self, inputs: tuple) -> tuple:
        for s, x in zip(self.inputs, inputs):
            s.copy_(x)
        self.graph.replay()
        for k, n in self.launches.items():
            K.COUNTS[k].launches += n
        return tuple(o.clone() for o in self.outputs)


class EvalPlan:
    """Precomputed device tables + stacked keys for one CkksContext.

    ``stats`` counts, per plan:
      dispatches   scheme programs run
      key_switches key-switch inner products applied (the paper's Fig 22
                   op, the unit of its key-switch rate)
      decomposes   RNS digit decompositions paid; R hoisted rotations
                   count R key switches but 1 decompose
    and mirrors them into the ``plan.*`` counters of ``obs``.

    ``mesh`` (``repro_torch.mesh.Mesh``) splits the batched programs over
    its "b" axis and the RNS primes over its "k" axis (module docstring,
    "Scale-out"); ``k_programs`` counts the scheme programs that ran over
    "k" since the last ``reset_stats``.
    """

    _traces = 0      # CUDA graphs captured in the process (trace_count)

    def __init__(self, ctx, mesh=None):
        self.ctx = ctx
        self.n = ctx.n
        self.device = ctx.device
        self.natural = self.n >= ops.FOURSTEP_MIN_N
        self.mesh = mesh
        self._shards = None          # the device of each "b" shard, or None
        self._kdevs = None           # the device of each "k" shard (s > 1), or None
        if mesh is not None:
            bad = set(mesh.axis_names) - {"b", "k"}
            if bad:
                raise ValueError(
                    f"EvalPlan: unknown mesh axis name(s) {sorted(bad)} — the "
                    "scale-out convention shards the ciphertext batch axis over "
                    "'b' and the RNS prime axis over 'k'")
            # a shard on the plan's own device uses the plan's tables
            here = canonical(self.device)
            local = lambda ds: tuple(self.device if canonical(d) == here else d
                                     for d in ds)
            if "b" in mesh.axis_names:
                self._shards = local(mesh.axis_devices("b"))
            if mesh.shape.get("k", 1) > 1:
                self._kdevs = local(mesh.axis_devices("k"))
        self._keys: dict = {}        # ('relin', basis) | ('galois', g, basis)
        self._batch_keys: dict = {}  # (gs, basis, device) -> stacked, bounded LRU
        self._idx: dict = {}         # g -> (n,) int32 gather row
        self._replicas: dict = {}    # (key, device) -> a key or row on that device
        self._rescale_tables: dict = {}
        self._kslices: dict = {}     # (key, rows, device) -> a key's rows for a "k" shard
        # signature -> _Graph on the card; None runs every program eagerly
        self._graphs: dict | None = {} if self.device.type == "cuda" else None
        self._pools: dict = {}       # device -> the memory pool its graphs share
        self.reset_stats()

    @property
    def mesh_devices(self) -> int:
        """Shards of the mesh's "b" axis (1 unsharded): the serve engine's
        group multiplier and the tuner's ``shards=``."""
        return len(self._shards) if self._shards is not None else 1

    def _pad_batch(self, items: list) -> list:
        """``items`` padded to a multiple of the "b" axis size by repeating
        its last entry.  Callers zip results against the original list, so
        pad rows are computed and dropped."""
        return list(items) + [items[-1]] * (-len(items) % self.mesh_devices)

    def reset_stats(self):
        self.stats = {"dispatches": 0, "key_switches": 0, "decomposes": 0}
        self.k_programs = 0
        return self

    @staticmethod
    def trace_count() -> int:
        """CUDA graphs captured in the process, by every plan.  A serve
        loop compares deltas: a request that pays a capture inside its
        latency window shows as growth, and a ``prepare`` that covers the
        traffic keeps the delta at 0."""
        return EvalPlan._traces

    def _count(self, dispatches=1, key_switches=0, decomposes=0):
        self.stats["dispatches"] += dispatches
        self.stats["key_switches"] += key_switches
        self.stats["decomposes"] += decomposes
        if obs.enabled():
            obs.counter_add("plan.dispatches", dispatches)
            obs.counter_add("plan.key_switches", key_switches)
            obs.counter_add("plan.decomposes", decomposes)

    def _call(self, name: str, fn, inputs: tuple, consts: tuple, key):
        """``fn(*inputs, *consts)`` on the inputs' device: eagerly on the
        CPU, else through the plan's CUDA graph for (name, key, the device,
        the inputs' shapes and dtypes), captured on first use.  ``key``
        names what ``consts`` depend on (the basis, a static count); every
        tensor that varies between calls is in ``inputs``."""
        device = inputs[0].device
        if device.type != "cuda":
            return fn(*inputs, *consts)
        with torch.cuda.device(device):     # that card's stream, graphs and pool
            if self._graphs is None:
                return fn(*inputs, *consts)
            sig = (name, key, str(device),
                   tuple((tuple(x.shape), x.dtype) for x in inputs))
            graph = self._graphs.get(sig)
            if graph is None:
                pool = self._pools.get(str(device))
                if pool is None:
                    pool = self._pools[str(device)] = torch.cuda.graph_pool_handle()
                graph = self._graphs[sig] = _Graph(name, fn, inputs, consts, pool)
                EvalPlan._traces += 1
            return graph.replay(inputs)

    def _program(self, name: str, fn, inputs: tuple, consts: tuple, key, **span):
        """``_call`` inside the ``plan.program`` span."""
        with obs.span("plan.program", program=name, **span):
            return self._call(name, fn, inputs, consts, key)

    def _run(self, name: str, fn, count: int, args, key, *, out_axis: int = 0,
             **span):
        """A batched program over ``count`` rows (ciphertexts, or the
        hoisted program's rotations).  ``args(device, rows)`` gives the
        (inputs, consts) of the rows ``rows`` (a slice) on ``device``.
        Unsharded, one program of every row on the plan's device; over a
        mesh's "b" axis (``count`` a multiple of its size, see
        ``_pad_batch``), shard i's rows run on its device, and the outputs
        are concatenated along ``out_axis`` on the plan's device."""
        if self._shards is None:
            return self._program(name, fn, *args(self.device, slice(None)), key, **span)
        per = count // len(self._shards)
        parts = [self._program(name, fn, *args(d, slice(i * per, (i + 1) * per)), key,
                               shard=i, **span)
                 for i, d in enumerate(self._shards)]
        return self._collect(parts, out_axis)

    def _collect(self, parts, axis: int) -> tuple:
        """The shards' outputs ``parts`` (a tuple each, in shard order)
        concatenated along ``axis`` on the plan's device."""
        return tuple(torch.cat([self._on(p[j], self.device) for p in parts], dim=axis)
                     for j in range(len(parts[0])))

    def _on(self, x: torch.Tensor, device) -> torch.Tensor:
        """``x`` on ``device``: itself if it lies there, else a copy."""
        return x if canonical(x.device) == canonical(device) else x.to(device)

    # ------------------------------------------------ the "k" axis

    def _over_k(self, basis: tuple[int, ...]) -> bool:
        """Whether a program at ``basis`` runs over the "k" axis: the prime
        count must be a multiple of its size (the reference's rule)."""
        return self._kdevs is not None and len(basis) % len(self._kdevs) == 0

    def _kshards(self, basis: tuple[int, ...], rescale: bool = False):
        """(j, device, rows, shard basis) of each "k" shard with output
        rows: shard j of s owns the rows ``rows`` (a slice) of the block
        [j*m, (j+1)*m) (m = k/s) that the program keeps (a rescale keeps
        all but the last), and its shard basis is their primes followed by
        the prime the program drops."""
        k, s = len(basis), len(self._kdevs)
        m = k // s
        keep, drop = (k - 1, basis[-1]) if rescale else (k, self.ctx.special)
        for j, d in enumerate(self._kdevs):
            rows = slice(j * m, min((j + 1) * m, keep))
            if rows.start < rows.stop:
                yield j, d, rows, basis[rows] + (drop,)

    def _kslice(self, key, value, rows: slice, device):
        """The rows of a (k, k+1, ...) key stack ``value`` (cached under
        ``key``) that the "k" shard owning ``rows`` reads: every digit, its
        block's primes and P (row k), on ``device``, made once."""
        ckey = (key, rows.start, rows.stop, str(device))
        if ckey not in self._kslices:
            k = value[0].shape[0]
            self._kslices[ckey] = tuple(
                torch.cat([v[:, rows], v[:, k:k + 1]], dim=1).to(device) for v in value)
        return self._kslices[ckey]

    def _run_k(self, name: str, front, back, basis, args, *, axis: int = 0, **span):
        """A key-switch program over the "k" axis (module docstring,
        "Scale-out").  ``args(device, rows)`` gives a shard's (front
        inputs, back inputs): its block's rows on ``device``, and what its
        back reads besides the exchanged digits and the front's other
        outputs.  Every front runs, then the exchange, then every back;
        graphs are keyed by (basis, shard basis).  Returns the outputs
        concatenated along the prime axis ``axis`` on the plan's device."""
        shards = []
        for j, d, rows, sb in self._kshards(basis):
            fin, bin_ = args(d, rows)
            tables = self._packs(sb, d)
            out = self._program(f"{name}/front", front, fin, tables, (basis, sb),
                                kshard=j, **span)
            shards.append((j, d, sb, tables, out, bin_))
        # the exchange: every shard's (m, B, n) coefficient digits, as one
        # (k, B, n) stack on each shard's device
        digits = [out[-1] for *_, out, _ in shards]
        gathered = {d: torch.cat([self._on(c, d) for c in digits])
                    for d in dict.fromkeys(d for _, d, *_ in shards)}
        # the digits' primes: the whole basis, as a (k,) column on each device
        parts = [self._program(f"{name}/back", back, (gathered[d], *out[:-1], *bin_),
                               (rns.scalar_pack(basis, d)["qs"], *tables), (basis, sb),
                               kshard=j, **span)
                 for j, d, sb, tables, out, bin_ in shards]
        self.k_programs += 1
        return self._collect(parts, axis)

    def _rescale_k(self, name: str, fn, basis, halves, *, axis: int, **span):
        """A rescale over the "k" axis: each shard mod-downs its rows of the
        halves (their prime axis ``axis``) by the dropped prime, whose rows
        it takes as an input.  No exchange."""
        k = len(basis)
        parts = []
        for j, d, rows, sb in self._kshards(basis, rescale=True):
            ins = tuple(self._on(torch.cat([h.narrow(axis, rows.start, rows.stop - rows.start),
                                            h.narrow(axis, k - 1, 1)], dim=axis), d)
                        for h in halves)
            parts.append(self._program(name, fn, ins, self._packs(sb, d), (basis, sb),
                                       kshard=j, **span))
        self.k_programs += 1
        return self._collect(parts, axis)

    @staticmethod
    def _stack(arrs) -> torch.Tensor:
        with obs.span("plan.stack", n=len(arrs)):
            return torch.stack(arrs)

    # ------------------------------------------------------------ tables

    def _packs(self, full: tuple[int, ...], device):
        """(t, fsp) for a basis whose last prime is the special/dropped
        one; past the four-step threshold t is just the scalar columns."""
        if self.natural:
            return (rns.scalar_pack(full, device),
                    rns.fourstep_basis_pack(full, self.n, device))
        return rns.basis_pack(full, self.n, device), None

    def keyswitch_tables(self, basis: tuple[int, ...], device=None):
        """The key-switch tables of ``basis`` on ``device`` (the plan's by
        default)."""
        return self._packs(basis + (self.ctx.special,),
                           self.device if device is None else device)

    def rescale_tables(self, basis: tuple[int, ...], device=None):
        device = self.device if device is None else device
        key = (basis, str(device))
        if key not in self._rescale_tables:
            if self.natural:
                # the FourStepPack has no basis-relative rows, so rescale
                # shares a slice of the key-switch pack (basis + special)
                _, ks_fsp = self.keyswitch_tables(basis, device)
                self._rescale_tables[key] = (
                    rns.scalar_pack(basis, device),
                    FB.slice_fourstep_pack(ks_fsp, slice(0, len(basis))))
            else:
                self._rescale_tables[key] = self._packs(basis, device)
        return self._rescale_tables[key]

    # -------------------------------------------------------------- keys

    def _replica(self, key, value, device):
        """``value`` (a tensor or a tuple of them, cached on the plan's
        device under ``key``) on ``device``, copied there once."""
        if device is None or device == self.device:
            return value
        rkey = (key, str(device))
        if rkey not in self._replicas:
            self._replicas[rkey] = (tuple(v.to(device) for v in value)
                                    if isinstance(value, tuple) else value.to(device))
        return self._replicas[rkey]

    def _stacked(self, key, make, device, rows):
        if key not in self._keys:
            evk = make()
            self._keys[key] = (torch.stack([p[0].data for p in evk]),
                               torch.stack([p[1].data for p in evk]))
        if rows is not None:
            return self._kslice(key, self._keys[key], rows, device)
        return self._replica(key, self._keys[key], device)

    def relin_key(self, basis: tuple[int, ...], device=None, rows=None):
        """(k, k+1, n) stacked relinearization key digit tensors; with
        ``rows`` (a "k" shard's block) the (k, m+1, n) rows it reads."""
        return self._stacked(("relin", basis),
                             lambda: self.ctx.relin_keys(basis), device, rows)

    def galois_key(self, g: int, basis: tuple[int, ...], device=None, rows=None):
        """(k, k+1, n) stacked Galois key digit tensors for sigma_g (a "k"
        shard's rows with ``rows``)."""
        return self._stacked(("galois", g, basis),
                             lambda: self.ctx.galois_keys(g, basis), device, rows)

    # A mixed batch's stacked keys are (k, k+1, B, n) x2 per pattern of
    # group elements, so their cache is a bounded LRU: traffic that
    # repeats a pattern stays resident, random traffic evicts.
    _BATCH_KEY_CACHE_MAX = 32

    def _galois_batch_key(self, gs: tuple[int, ...], basis: tuple[int, ...],
                          device=None, rows=None):
        """(k, k+1, B, n) per-ciphertext key stacks + (B, n) gather rows
        for a batch of automorphisms gs on ``device`` (the plan's by
        default), cached per (gs, basis, device, rows); with ``rows`` (a
        "k" shard's block) the key rows that shard reads."""
        key = (gs, basis, str(self.device if device is None else device),
               None if rows is None else (rows.start, rows.stop))
        if key in self._batch_keys:
            self._batch_keys[key] = self._batch_keys.pop(key)   # LRU touch
        else:
            if len(self._batch_keys) >= self._BATCH_KEY_CACHE_MAX:
                self._batch_keys.pop(next(iter(self._batch_keys)))
            keys = [self.galois_key(g, basis, device, rows) for g in gs]
            self._batch_keys[key] = (
                torch.stack([kb for kb, _ in keys], dim=2),    # (k, k+1, B, n)
                torch.stack([ka for _, ka in keys], dim=2),
                torch.stack([self.eval_idx(g, device) for g in gs]))
        return self._batch_keys[key]

    def eval_idx(self, g: int, device=None) -> torch.Tensor:
        """(n,) int32 NTT-domain gather row for sigma_g in this ring's
        frequency order (natural past the four-step threshold, bitrev
        below it), on ``device`` (the plan's by default)."""
        if g not in self._idx:
            perm = galois_eval_perm(g, self.n, self.natural)
            self._idx[g] = torch.from_numpy(perm.astype("int32")).to(self.device)
        return self._replica(("idx", g), self._idx[g], device)

    def rotation_group_element(self, r: int) -> int:
        return pow(5, r, 2 * self.n)

    def prepare(self, basis: tuple[int, ...] | None = None, rotations=(),
                conjugate: bool = False, relin: bool = True,
                warm_jit: bool = True, batch_sizes=(), hoisted_sets=(),
                matvecs=()):
        """Build every table, key and gather row a serving loop will need,
        so no request pays keygen or table construction.  ``rotations``
        and ``conjugate`` name the single and batched rotations to key,
        ``relin`` the relinearization key, ``hoisted_sets`` the
        rotation-amount sets of ``rotate_hoisted``, ``matvecs``
        ``fhe.linalg.PtMatrix`` packs (their baby and giant steps, at the
        pack's own basis).  Keys are drawn from the context's generator in
        the reference's order, so the same prepare gives the same keys.

        ``warm_jit`` (on the card) also captures the CUDA graph of each
        program on a zero ciphertext, as the reference compiles them: the
        single programs, the ``*_many`` programs at every B of
        ``batch_sizes`` (a serving engine's padded group sizes; uniform and
        mixed Galois), ``rotate_hoisted`` per set, and each matvec's whole
        composite.  One prepare covers one basis.  On a mesh the tables,
        keys and gather rows are also copied to every shard's device (over
        a "k" axis, the rows each shard reads, and its shard bases'
        tables).  The counters are reset on exit."""
        basis = tuple(basis if basis is not None else self.ctx.qs)
        gs = [g for g in (self.rotation_group_element(r) for r in rotations)
              if g != 1]
        if conjugate:
            gs.append(2 * self.n - 1)
        hoist_gs = {self.rotation_group_element(r)
                    for rset in hoisted_sets for r in rset} - {1}
        # the plan's device first: its keys are drawn in the reference's order
        devices = dict.fromkeys((self.device,) + (self._shards or ()))
        for d in devices:
            self.keyswitch_tables(basis, d)
            self.rescale_tables(basis, d)
            if relin:
                self.relin_key(basis, d)
            for g in gs + sorted(hoist_gs - set(gs)):
                self.galois_key(g, basis, d)
                self.eval_idx(g, d)
        self._prepare_k(basis, gs + sorted(hoist_gs - set(gs)), relin)
        warm = warm_jit and self._graphs is not None
        if warm:
            z = RnsPoly(torch.zeros((len(basis), self.n), dtype=torch.int32,
                                    device=self.device), basis, True)
            zct = Ciphertext(z, z, 1.0)
            if relin:
                self.multiply(zct, zct)
            if len(basis) > 1:
                self.rescale(zct)
            if gs:
                self.apply_galois(zct, gs[0])
            for B in batch_sizes:
                cts = [zct] * B
                if relin:
                    self.multiply_many(cts, cts)
                if len(basis) > 1:
                    self.rescale_many(cts)
                if gs:                          # uniform batch (shared key)...
                    self.galois_ks_many(cts, [gs[0]] * B)
                if len(set(gs)) > 1 and B > 1:  # ...and the mixed signature
                    self.galois_ks_many(cts, [gs[i % len(gs)] for i in range(B)])
            for rset in hoisted_sets:
                self.rotate_hoisted(zct, list(rset))
        for M in matvecs:
            mv_basis = tuple(M.basis)
            for d in devices:
                self.keyswitch_tables(mv_basis, d)
                for r in set(M.baby_set) | set(M.giant_set):
                    g = self.rotation_group_element(r)
                    if g != 1:
                        self.galois_key(g, mv_basis, d)
                        self.eval_idx(g, d)
            self._prepare_k(mv_basis, {self.rotation_group_element(r)
                                       for r in set(M.baby_set) | set(M.giant_set)} - {1},
                            relin=False)
            if warm:
                # the whole composite on a zero ciphertext: the hoisted baby
                # pass, the MAC, the giant rotate_many and the final sum, as
                # matvec issues them (linalg imports this module)
                from repro_torch.fhe import linalg
                z = RnsPoly(torch.zeros((len(mv_basis), self.n), dtype=torch.int32,
                                        device=self.device), mv_basis, True)
                linalg.matvec(self, M, Ciphertext(z, z, 1.0))
        return self.reset_stats()

    def _prepare_k(self, basis, gs, relin: bool):
        """The "k" shards' tables, key rows and gather rows at ``basis``
        (the keys drawn already), when programs there run over "k"."""
        if not self._over_k(basis):
            return
        for _, d, rows, sb in self._kshards(basis):
            self._packs(sb, d)
            rns.scalar_pack(basis, d)
            if relin:
                self.relin_key(basis, d, rows)
            for g in gs:
                self.galois_key(g, basis, d, rows)
                self.eval_idx(g, d)
        if len(basis) > 1:
            for _, d, _, sb in self._kshards(basis, rescale=True):
                self._packs(sb, d)

    # ------------------------------------------------------- scheme ops

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        check_same_basis("multiply", a, b)
        check_level("multiply", a)
        basis = a.primes
        if self._over_k(basis):
            def args(d, rows):
                return (tuple(self._on(x.data[rows], d) for x in (a.c0, a.c1, b.c0, b.c1)),
                        self.relin_key(basis, d, rows))
            c0, c1 = self._run_k("multiply", multiply_front, multiply_back, basis, args)
        else:
            t, fsp = self.keyswitch_tables(basis)
            eb, ea = self.relin_key(basis)
            c0, c1 = self._program("multiply", multiply_banks,
                                   (a.c0.data, a.c1.data, b.c0.data, b.c1.data, eb, ea),
                                   (t, fsp), basis)
        self._count(1, key_switches=1, decomposes=1)
        return Ciphertext(RnsPoly(c0, basis, True), RnsPoly(c1, basis, True),
                          a.scale * b.scale)

    def rescale(self, a: Ciphertext) -> Ciphertext:
        check_level("rescale", a, need=1)
        basis = a.primes
        if self._over_k(basis):
            c0, c1 = self._rescale_k("rescale", rescale_banks, basis,
                                     (a.c0.data, a.c1.data), axis=0)
        else:
            t, fsp = self.rescale_tables(basis)
            c0, c1 = self._program("rescale", rescale_banks, (a.c0.data, a.c1.data),
                                   (t, fsp), basis)
        self._count(1)
        rest = basis[:-1]
        return Ciphertext(RnsPoly(c0, rest, True), RnsPoly(c1, rest, True),
                          a.scale / basis[-1])

    def _common_basis(self, op: str, cts) -> tuple[int, ...]:
        basis = cts[0].primes
        for ct in cts[1:]:
            if ct.primes != basis:
                raise ValueError(
                    f"{op}: batch mixes bases — {sorted({c.primes for c in cts}, key=len)}; "
                    "batched dispatch requires every ciphertext at the "
                    "same basis (group by level first)")
        return basis

    def multiply_many(self, As, Bs) -> list[Ciphertext]:
        """B tensor+relinearize products in one ``multiply_many_banks``
        pass; bit-identical to a loop of ``multiply``."""
        if len(As) != len(Bs):
            raise ValueError(f"multiply_many: {len(As)} lhs vs {len(Bs)} rhs")
        if not As:
            return []
        for a, b in zip(As, Bs):
            check_same_basis("multiply_many", a, b)
            check_level("multiply_many", a)
        basis = self._common_basis("multiply_many", list(As) + list(Bs))
        Ap, Bp = self._pad_batch(As), self._pad_batch(Bs)
        halves = [self._stack([ct.c0.data for ct in Ap]), self._stack([ct.c1.data for ct in Ap]),
                  self._stack([ct.c0.data for ct in Bp]), self._stack([ct.c1.data for ct in Bp])]
        if self._shards is None and self._over_k(basis):
            def kargs(d, rows):
                return (tuple(self._on(h[:, rows].contiguous(), d) for h in halves),
                        self.relin_key(basis, d, rows))
            c0, c1 = self._run_k("multiply_many", multiply_many_front, multiply_many_back,
                                 basis, kargs, axis=1, n=len(As))
        else:
            def args(d, rows):
                return ((*(self._on(h[rows], d) for h in halves), *self.relin_key(basis, d)),
                        self.keyswitch_tables(basis, d))
            c0, c1 = self._run("multiply_many", multiply_many_banks, len(Ap), args, basis,
                               n=len(As))
        self._count(1, key_switches=len(As), decomposes=len(As))
        return [Ciphertext(RnsPoly(r0, basis, True), RnsPoly(r1, basis, True),
                           a.scale * b.scale)
                for r0, r1, a, b in zip(c0, c1, As, Bs)]

    def rescale_many(self, cts) -> list[Ciphertext]:
        """Rescale B ciphertexts (one basis) as one fused mod-down over
        all 2B halves."""
        if not cts:
            return []
        for ct in cts:
            check_level("rescale_many", ct, need=1)
        basis = self._common_basis("rescale_many", cts)
        pad = self._pad_batch(cts)
        halves = [self._stack([ct.c0.data for ct in pad]), self._stack([ct.c1.data for ct in pad])]
        if self._shards is None and self._over_k(basis):
            c0, c1 = self._rescale_k("rescale_many", rescale_many_banks, basis, halves,
                                     axis=1, n=len(cts))
        else:
            def args(d, rows):
                return tuple(self._on(h[rows], d) for h in halves), self.rescale_tables(basis, d)
            c0, c1 = self._run("rescale_many", rescale_many_banks, len(pad), args, basis,
                               n=len(cts))
        self._count(1)
        rest = basis[:-1]
        return [Ciphertext(RnsPoly(r0, rest, True), RnsPoly(r1, rest, True),
                           ct.scale / basis[-1])
                for r0, r1, ct in zip(c0, c1, cts)]

    def galois_ks_many(self, cts, gs) -> list[Ciphertext]:
        """B automorphisms (one basis, group elements gs, possibly mixed)
        in one ``galois_ks_many_banks`` pass.  A uniform batch keeps the
        shared (k, k+1, n) key and (n,) gather row; a mixed one stacks a
        key and a row per ciphertext."""
        if len(cts) != len(gs):
            raise ValueError(f"galois_ks_many: {len(cts)} cts vs {len(gs)} gs")
        if not cts:
            return []
        for ct in cts:
            check_level("galois_ks_many", ct)
        basis = self._common_basis("galois_ks_many", cts)
        pad, pad_gs = self._pad_batch(cts), self._pad_batch(gs)
        halves = [self._stack([ct.c0.data for ct in pad]), self._stack([ct.c1.data for ct in pad])]
        uniform = len(set(pad_gs)) == 1

        def keys(d, gs, rows=None):
            if uniform:
                return (*self.galois_key(gs[0], basis, d, rows), self.eval_idx(gs[0], d))
            return self._galois_batch_key(tuple(gs), basis, d, rows)
        if self._shards is None and self._over_k(basis):
            def kargs(d, rows):
                eb, ea, idx = keys(d, pad_gs, rows)
                return ((*(self._on(h[:, rows].contiguous(), d) for h in halves), idx),
                        (eb, ea))
            c0, c1 = self._run_k("galois_ks_many", galois_ks_many_front, galois_ks_many_back,
                                 basis, kargs, axis=1, n=len(cts))
        else:
            def args(d, rows):
                eb, ea, idx = keys(d, pad_gs[rows])
                return ((*(self._on(h[rows], d) for h in halves), idx, eb, ea),
                        self.keyswitch_tables(basis, d))
            c0, c1 = self._run("galois_ks_many", galois_ks_many_banks, len(pad), args, basis,
                               n=len(cts))
        self._count(1, key_switches=len(cts), decomposes=len(cts))
        return [Ciphertext(RnsPoly(r0, basis, True), RnsPoly(r1, basis, True),
                           ct.scale)
                for r0, r1, ct in zip(c0, c1, cts)]

    def apply_galois(self, a: Ciphertext, g: int) -> Ciphertext:
        check_level("apply_galois", a)
        basis = a.primes
        if self._over_k(basis):
            def args(d, rows):
                return ((self._on(a.c0.data[rows], d), self._on(a.c1.data[rows], d),
                         self.eval_idx(g, d)), self.galois_key(g, basis, d, rows))
            c0, c1 = self._run_k("galois_ks", galois_ks_front, galois_ks_back, basis, args)
        else:
            t, fsp = self.keyswitch_tables(basis)
            eb, ea = self.galois_key(g, basis)
            c0, c1 = self._program("galois_ks", galois_ks_banks,
                                   (a.c0.data, a.c1.data, self.eval_idx(g), eb, ea),
                                   (t, fsp), basis)
        self._count(1, key_switches=1, decomposes=1)
        return Ciphertext(RnsPoly(c0, basis, True), RnsPoly(c1, basis, True),
                          a.scale)

    def rotate(self, a: Ciphertext, r: int) -> Ciphertext:
        g = self.rotation_group_element(r)
        if g == 1:                       # identity automorphism: no launch
            return Ciphertext(a.c0, a.c1, a.scale)
        return self.apply_galois(a, g)

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        return self.apply_galois(a, 2 * self.n - 1)

    # R rotations of ONE ciphertext pay ONE digit decomposition: the
    # primitive the ``fhe.linalg`` BSGS matvec baby steps run on.

    def hoisted_galois(self, a: Ciphertext, gs) -> list[Ciphertext]:
        """Apply R automorphisms ``gs`` (need not be distinct) to ``a`` in
        one ``hoisted_rotations_banks`` pass; bit-identical to
        ``[self.apply_galois(a, g) for g in gs]``."""
        gs = tuple(gs)
        if not gs:
            return []
        check_level("hoisted_galois", a)
        basis = a.primes
        pad_gs = tuple(self._pad_batch(gs))
        if self._shards is None and self._over_k(basis):
            def kargs(d, rows):
                eb, ea, idx = self._galois_batch_key(pad_gs, basis, d, rows)
                return ((self._on(a.c1.data[rows], d),),
                        (self._on(a.c0.data[rows], d), idx, eb, ea))
            c0, c1 = self._run_k("hoisted_galois", hoisted_front, hoisted_back, basis, kargs,
                                 n=len(gs))
        else:
            def args(d, rows):
                # the rotations split; every shard takes the whole ciphertext
                eb, ea, idx = self._galois_batch_key(pad_gs[rows], basis, d)
                return ((self._on(a.c0.data, d), self._on(a.c1.data, d), idx, eb, ea),
                        self.keyswitch_tables(basis, d))
            c0, c1 = self._run("hoisted_galois", hoisted_rotations_banks, len(pad_gs), args,
                               basis, out_axis=1, n=len(gs))
        self._count(1, key_switches=len(gs), decomposes=1)
        return [Ciphertext(RnsPoly(r0, basis, True), RnsPoly(r1, basis, True),
                           a.scale)
                for r0, r1, _ in zip(c0.unbind(1), c1.unbind(1), gs)]

    def rotate_hoisted(self, a: Ciphertext, rs) -> list[Ciphertext]:
        """Rotate one ciphertext by every amount in ``rs`` with the
        decomposition hoisted.  Identity amounts (r = 0 mod slots) are
        answered host-side, like ``rotate``."""
        gs = [self.rotation_group_element(r) for r in rs]
        live = [i for i, g in enumerate(gs) if g != 1]
        out = [Ciphertext(a.c0, a.c1, a.scale) for _ in gs]
        if live:
            rotated = self.hoisted_galois(a, tuple(gs[i] for i in live))
            for i, ct in zip(live, rotated):
                out[i] = ct
        return out

    def rotate_many(self, cts, rs) -> list[Ciphertext]:
        """Rotate B ciphertexts by per-ciphertext amounts ``rs`` in one
        pass (identity rotations are returned as they are, like
        ``rotate``; the rest batch through ``galois_ks_many``)."""
        if len(cts) != len(rs):
            raise ValueError(f"rotate_many: {len(cts)} cts vs {len(rs)} rs")
        gs = [self.rotation_group_element(r) for r in rs]
        live = [i for i, g in enumerate(gs) if g != 1]
        out = [Ciphertext(ct.c0, ct.c1, ct.scale) for ct in cts]
        if live:
            rotated = self.galois_ks_many([cts[i] for i in live],
                                          [gs[i] for i in live])
            for i, ct in zip(live, rotated):
                out[i] = ct
        return out

    def conjugate_many(self, cts) -> list[Ciphertext]:
        return self.galois_ks_many(cts, [2 * self.n - 1] * len(cts))

    # ------------------------------------------------ matvec composites

    def plain_mac(self, b0, b1, M):
        """``plain_mac_banks`` of the baby halves b0/b1 (R, k, n) with the
        ``fhe.linalg.PtMatrix`` pack M's diagonals: (G, k, n) stacks."""
        diags, rows, group, gis = M.mac_pack()
        qs, mus = rns._basis_consts(M.basis, self.device)
        groups = len(gis)
        return self._program("plain_mac",
                             functools.partial(plain_mac_banks, groups=groups),
                             (b0, b1, diags, rows, group), (qs, mus), (M.basis, groups))

    def accumulate(self, parts0, parts1, basis: tuple[int, ...]):
        """``accumulate_banks``: the modular sums of L (k, n) halves."""
        qs = rns._basis_consts(basis, self.device)[0]
        L = len(parts0)
        return self._program("accumulate",
                             lambda *xs: accumulate_banks(xs[:L], xs[L:], qs),
                             (*parts0, *parts1), (), basis)
