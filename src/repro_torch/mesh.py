"""A device mesh: named axes over a list of devices, the port's
counterpart of a ``jax.sharding.Mesh``.

``EvalPlan(ctx, mesh=make_mesh(devices))`` splits every batched program
over the mesh's "b" axis, and ``core.fourstep.fourstep_ntt_sharded``
splits a four-step transform's columns over one named axis.  Each entry
of an axis is one shard; a device may be listed more than once and then
carries several shards, which run on it in turn.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


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
