"""A device mesh: named axes over a list of devices, the port's
counterpart of a ``jax.sharding.Mesh``, with partition specs (``P``),
``NamedSharding`` and the collectives of a shard program.

``EvalPlan(ctx, mesh=make_mesh(devices))`` splits every batched program
over the mesh's "b" axis, ``core.fourstep.fourstep_ntt_sharded`` splits
a four-step transform's columns over one named axis, and a model built
with ``MeshCtx(mesh=...)`` runs its shard branches over ("data",
"model") style axes.  Each entry of an axis is one shard; a device may
be listed more than once and then carries several shards, which run on
it in turn.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.runtime import op_cost


def canonical(device) -> torch.device:
    """``device`` with its index filled in: a CUDA device without one is
    the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` in row-major order over axes ``axis_names`` of sizes
    ``sizes``.  Hashable, so programs and tables can be cached per mesh."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def axis_devices(self, axis: str) -> tuple[torch.device, ...]:
        """The device of each shard along ``axis`` (index 0 on the other
        axes)."""
        i = self.axis_names.index(axis)
        grid = np.arange(len(self.devices)).reshape(self.sizes)
        line = np.moveaxis(grid, i, 0).reshape(self.sizes[i], -1)[:, 0]
        return tuple(self.devices[j] for j in line)


def make_mesh(devices, axis_names=("b",), shape=None) -> Mesh:
    """A mesh over ``devices`` (anything ``torch.device`` takes; one may
    repeat).  ``shape`` defaults to one axis over all of them."""
    devices = tuple(canonical(d) for d in devices)
    axis_names = tuple(axis_names)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError(f"make_mesh: axes {axis_names} need a shape")
        shape = (len(devices),)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"make_mesh: axes {axis_names} for shape {shape}")
    if math.prod(shape) != len(devices) or not devices:
        raise ValueError(f"make_mesh: mesh shape {shape} needs {math.prod(shape)} "
                         f"devices, got {len(devices)}")
    return Mesh(devices, axis_names, shape)


# ------------------------------------------------- specs and shards
#
# The models' multi-device branches run as the reference's ``shard_map``
# bodies do, one shard after another in one process: each shard's inputs
# are its blocks (``NamedSharding.blocks``), moved to its device; an
# ``all_gather`` is a ``torch.cat`` (or a ``torch.stack``, untiled) in
# shard order, a ``psum`` a sum in ascending shard index along the axes,
# a ``pmean`` that sum over the axes' size, and ``axis_index`` the
# shard's index along the axes.  Every helper takes and returns one value
# per shard, in the mesh's row-major device order.  ``all_gather`` and
# ``psum`` record one collective each in an active ``runtime.op_cost``
# counter: its bytes per device and the axes' size.

class P(tuple):
    """A partition spec, the counterpart of ``jax.sharding.PartitionSpec``:
    one entry per leading dim, each ``None`` (replicated), an axis name or
    a tuple of names (the dim split over their product, the first name
    major).  Dims past the spec's length are replicated.  As the
    reference's, an entry of one name is that name and an empty one
    ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if e is None or isinstance(e, str):
                return e
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def check_spec(mesh: Mesh, spec) -> None:
    """Raises where ``spec`` names an axis ``mesh`` does not have, or one
    axis twice."""
    named = [a for e in spec for a in _names(e)]
    unknown = [a for a in named if a not in mesh.axis_names]
    if unknown or len(set(named)) != len(named):
        raise ValueError(f"spec {tuple(spec)} on a mesh with axes {mesh.axis_names}: "
                         f"{'unknown axes ' + str(unknown) if unknown else 'an axis twice'}")


def coords(mesh: Mesh, i: int) -> dict[str, int]:
    """Shard ``i``'s index along each axis."""
    return dict(zip(mesh.axis_names, (int(c) for c in np.unravel_index(i, mesh.sizes))))


def axis_index(mesh: Mesh, axes, i: int) -> int:
    """Shard ``i``'s index along ``axes`` (a name or a tuple of names,
    the first major), as ``jax.lax.axis_index``."""
    c = coords(mesh, i)
    names = _names(axes)
    return int(np.ravel_multi_index([c[a] for a in names],
                                    [mesh.shape[a] for a in names])) if names else 0


def axis_size(mesh: Mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in _names(axes))


def axis_group(mesh: Mesh, axes, i: int) -> list[int]:
    """The shards that share shard ``i``'s index on every axis but
    ``axes``, in ascending index along ``axes``."""
    c = coords(mesh, i)
    names = _names(axes)
    out = []
    for k in range(axis_size(mesh, names)):
        kc = dict(c, **dict(zip(names, (int(v) for v in np.unravel_index(
            k, [mesh.shape[a] for a in names])))))
        out.append(int(np.ravel_multi_index([kc[a] for a in mesh.axis_names],
                                            mesh.sizes)))
    return out


def all_gather(vals: list, mesh: Mesh, axes, dim: int = 0, tiled: bool = True) -> list:
    """Each shard's value: its group's values along ``axes`` concatenated
    along ``dim`` in shard order (stacked on a new leading dim where
    ``tiled`` is false), on the shard's device."""
    out = []
    for i in range(len(vals)):
        d = mesh.devices[i]
        parts = [vals[j].to(d) for j in axis_group(mesh, axes, i)]
        out.append(torch.cat(parts, dim=dim) if tiled else torch.stack(parts))
    op_cost.record_collective("all-gather", op_cost.nbytes(out[0]), axis_size(mesh, axes))
    return out


def psum(vals: list, mesh: Mesh, axes) -> list:
    """Each shard's value: the sum of its group's values along ``axes``,
    added in ascending shard index (((v_0 + v_1) + v_2) + ...), on the
    shard's device.  A group's sum is computed once."""
    op_cost.record_collective("all-reduce", op_cost.nbytes(vals[0]), axis_size(mesh, axes))
    sums: dict[tuple, torch.Tensor] = {}
    out = []
    for i in range(len(vals)):
        group = tuple(axis_group(mesh, axes, i))
        if group not in sums:
            acc = vals[group[0]]
            for j in group[1:]:
                acc = acc + vals[j].to(acc.device)
            sums[group] = acc
        out.append(sums[group].to(mesh.devices[i]))
    return out


def pmean(vals: list, mesh: Mesh, axes) -> list:
    """``psum`` over ``axes`` divided by their size."""
    n = axis_size(mesh, axes)
    return [v / n for v in psum(vals, mesh, axes)]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor laid out over ``mesh`` by ``spec``, the counterpart of
    ``jax.sharding.NamedSharding``.  The port keeps the whole tensor on
    the mesh's first device (``place``); ``blocks`` gives the block each
    shard holds, which the shard branches compute on."""
    mesh: Mesh
    spec: P

    def __post_init__(self):
        check_spec(self.mesh, self.spec)

    def _splits(self, shape) -> list[int]:
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {tuple(self.spec)} for a rank-{len(shape)} shape")
        splits = [axis_size(self.mesh, e) for e in self.spec]
        splits += [1] * (len(shape) - len(splits))
        for dim, (size, k) in enumerate(zip(shape, splits)):
            if size % k:
                raise ValueError(f"shape {shape}: dim {dim} ({size}) does not divide "
                                 f"over {k} shards of {tuple(self.spec)}")
        return splits

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of the block each shard holds."""
        return tuple(s // k for s, k in zip(tuple(shape), self._splits(shape)))

    def index(self, i: int, shape) -> tuple[slice, ...]:
        """The slices of the whole tensor that shard ``i`` holds."""
        block = self.shard_shape(shape)
        out = []
        for dim, b in enumerate(block):
            k = axis_index(self.mesh, self.spec[dim], i) if dim < len(self.spec) else 0
            out.append(slice(k * b, (k + 1) * b))
        return tuple(out)

    def blocks(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Each shard's block of ``x`` on its device, in mesh order."""
        return [x[self.index(i, x.shape)].to(d) for i, d in enumerate(self.mesh.devices)]

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor on the mesh's first device."""
        return x.to(self.mesh.devices[0])

    def assemble(self, vals: list, device) -> torch.Tensor:
        """The whole tensor from the shards' blocks, on ``device``: each
        block taken from the first shard that holds it (a value the spec
        does not split along an axis is that axis's shards' common one)."""
        splits = [axis_size(self.mesh, e) for e in self.spec]
        first: dict[tuple, torch.Tensor] = {}
        for i, v in enumerate(vals):
            key = tuple(axis_index(self.mesh, e, i) for e in self.spec)
            first.setdefault(key, v)

        def cat(prefix: tuple):
            dim = len(prefix)
            if dim == len(splits):
                return first[prefix].to(device)
            return torch.cat([cat(prefix + (k,)) for k in range(splits[dim])], dim=dim)
        return cat(())
