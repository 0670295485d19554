"""Op counting over ``meta`` tensors, the port's counterpart of the
reference's ``runtime/hlo_cost.py``.

The reference asks XLA for the compiled program's HLO and walks it; the
port has no compiler to ask, so it runs the program once on ``meta``
tensors (shapes and dtypes, no data) under ``OpCounter``, a
``TorchDispatchMode`` that sees every aten op the eager program
dispatches, and counts:

  flops       2*M*N*K for each product (the rules of
              ``torch.utils.flop_counter``'s registry: mm, bmm, addmm,
              baddbmm, convolutions, attention), one per output element
              for each elementwise op of ``hlo_cost``'s set (add ...
              sin; ``ELEMENTWISE``), and each hand-written kernel's
              integer instructions (``record_kernel``)
  bytes       inputs plus output of each dispatched op.  Eager PyTorch
              fuses nothing: every op reads its inputs from memory and
              writes its output there, so this is what the port really
              moves, not XLA's fusion convention (which counts a fusion
              once).  Views and ``empty`` allocations move nothing.
  collectives each collective where it happens: ``repro_torch.mesh``'s
              ``all_gather`` and ``psum`` (``pmean`` is a ``psum``) call
              ``record_collective``, and so may any program that
              exchanges data by other means (the four-step all-to-all,
              the key switch's digit exchange).  Each is a per-device
              figure with its ring-model traffic (``runtime.roofline``).
  kernels     each hand-written kernel's wrapper, given ``meta``
              tensors, returns an empty output and calls
              ``record_kernel``: one launch, the bytes of each input read
              and each output written once, its integer instructions.

flops and bytes are the whole program's (divide by the devices for a
per-device figure); collectives are per device, as each device runs each
one.  ``repeated(n)`` counts the ops inside it n times: a mesh's shard
branch on ``meta`` runs one shard for all of its identical shards
(``repeated_call`` carries the count into the branch's backward).

``hlo_cost``'s while-loop trip counts do not arise: the port's layer
loops are Python loops, so each iteration dispatches its own ops and is
counted as it runs.

Besides the cost, the counter keeps what a dry run's memory model reads:
which of the program's arguments it reads (``read``; ``jax.jit`` drops an
argument the program does not read, and the reference's argument bytes
count only the rest), and the peak of the bytes of the tensors the pass
has allocated and not yet freed (``peak``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.runtime.roofline import ring_traffic

ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "exp", "log", "rsqrt", "sqrt", "tanh", "sigmoid", "pow", "where", "eq",
    "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "floor", "ceil", "round",
    "clamp", "clamp_min", "clamp_max", "sign", "cos", "sin",
})
# allocations that write nothing
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided"})


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_traffic: float = 0.0
    coll_counts: dict = dataclasses.field(default_factory=dict)
    coll_bytes: dict = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.coll_traffic += o.coll_traffic
        for k, v in o.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v
        for k, v in o.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0) + v
        return self

    def scaled(self, f: float) -> "Cost":
        return Cost(self.flops * f, self.bytes * f, self.coll_traffic * f,
                    {k: v * f for k, v in self.coll_counts.items()},
                    {k: v * f for k, v in self.coll_bytes.items()})


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sid(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (shared by its views)."""
    return t.untyped_storage()._cdata


_ACTIVE: list["OpCounter"] = []


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside ``with OpCounter(args) as c:``.

    ``args``: name -> tensor of the program's arguments, whose reads
    ``read`` records (a view of an argument reads it where a non-view op
    or a kernel consumes the view).  ``kernels``: name -> launches (their
    integer instructions are in ``cost.flops``).  ``peak``: the most
    bytes the pass's own tensors held at once (arguments not included)."""

    def __init__(self, args: dict | None = None):
        super().__init__()
        self.cost = Cost()
        self.kernels: dict[str, int] = {}
        self.read: set[str] = set()
        self.live = 0
        self.peak = 0
        self._scale = 1
        self._args = {_sid(t): name for name, t in (args or {}).items()}
        self._alive: dict[int, list] = {}      # storage -> [bytes, tensors holding it]

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def per_device(self, n: int) -> Cost:
        """flops and bytes split over ``n`` devices, collectives as
        counted (per device)."""
        c = self.cost
        return Cost(c.flops / n, c.bytes / n, c.coll_traffic, dict(c.coll_counts),
                    dict(c.coll_bytes))

    # ------------------------------------------------------ recording
    def _mark_read(self, tensors) -> None:
        for t in tensors:
            name = self._args.get(_sid(t))
            if name is not None:
                self.read.add(name)

    def _hold(self, t: torch.Tensor, allocated: bool) -> None:
        """``t`` holds its storage: a storage the pass ``allocated`` is
        live from the first tensor that holds it to the death of the last
        (a view, or an ``_unsafe_view`` of a copy, outlives the tensor it
        came from).  Arguments and tensors made before the pass are not
        the pass's."""
        sid = _sid(t)
        entry = self._alive.get(sid)
        if entry is None:
            if not allocated or sid in self._args:
                return
            entry = self._alive[sid] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, sid)

    def _release(self, sid: int) -> None:
        entry = self._alive.get(sid)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._alive[sid]
            self.live -= entry[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        fresh = not func.is_view and all(r.alias_info is None for r in func._schema.returns)
        for o in outs:
            self._hold(o, fresh)
        if func.is_view:
            return out
        ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        if self._args:
            self._mark_read(ins)
        if name in _NO_TRAFFIC:
            return out
        s = self._scale
        self.cost.bytes += s * (sum(map(nbytes, ins)) + sum(map(nbytes, outs)))
        packet = func._overloadpacket
        if packet in flop_registry:
            self.cost.flops += s * flop_registry[packet](*args, **kwargs, out_val=out)
        elif name.rstrip("_") in ELEMENTWISE and outs:
            self.cost.flops += s * outs[0].numel()
        return out

    def kernel(self, name: str, reads, writes, int_ops: int, extra_bytes: int) -> None:
        s = self._scale
        self.kernels[name] = self.kernels.get(name, 0) + s
        self.cost.flops += s * int_ops
        self.cost.bytes += s * (sum(map(nbytes, reads)) + sum(map(nbytes, writes))
                                + extra_bytes)
        self._mark_read(reads)

    def collective(self, op: str, nbytes_: float, n: int) -> None:
        if n <= 1:
            return
        c = self.cost
        c.coll_counts[op] = c.coll_counts.get(op, 0) + 1
        c.coll_bytes[op] = c.coll_bytes.get(op, 0) + nbytes_
        c.coll_traffic += ring_traffic(op, nbytes_, n)


def active() -> OpCounter | None:
    return _ACTIVE[-1] if _ACTIVE else None


def record_kernel(name: str, reads, writes, int_ops: int = 0,
                  extra_bytes: int = 0) -> None:
    """One launch of kernel ``name`` (a wrapper's ``meta`` branch): each
    tensor of ``reads`` read once, each of ``writes`` written once, plus
    ``extra_bytes`` of tables the wrapper holds itself."""
    c = active()
    if c is not None:
        c.kernel(name, reads, writes, int_ops, extra_bytes)


def record_collective(op: str, nbytes_: float, n: int) -> None:
    """One collective ``op`` of ``nbytes_`` per device over ``n`` devices."""
    c = active()
    if c is not None:
        c.collective(op, nbytes_, n)


@contextlib.contextmanager
def repeated(n: int):
    """Count the ops inside ``n`` times (collectives once: they are per
    device already)."""
    c = active()
    if c is None or n == 1:
        yield
        return
    c._scale *= n
    try:
        yield
    finally:
        c._scale //= n


class _Repeated(torch.autograd.Function):
    """``fn(*inputs)`` counted n times, its backward too."""

    @staticmethod
    def forward(ctx, n, fn, *inputs):
        ins = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
        # the inner graph keeps what it saves: under an enclosing
        # checkpoint's hooks the backward below would recompute the whole
        # checkpointed unit inside ``repeated(n)``
        with torch.enable_grad(), repeated(n), \
                torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
            outs = fn(*ins)
        ctx.n, ctx.ins, ctx.outs = n, ins, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if o.requires_grad and g is not None]
        need = [t for t in ctx.ins if t.requires_grad]
        got = iter(())
        if pairs and need:
            with repeated(ctx.n):
                got = iter(torch.autograd.grad([o for o, _ in pairs], need,
                                               [g for _, g in pairs], allow_unused=True))
        return (None, None, *[next(got) if t.requires_grad else None for t in ctx.ins])


def repeated_call(n: int, fn, *inputs: torch.Tensor) -> tuple:
    """``fn(*inputs)`` (a tuple of tensors) with its ops, and under
    autograd its backward's, counted ``n`` times."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Repeated.apply(n, fn, *inputs)
    with repeated(n):
        return tuple(fn(*inputs))
