"""Production mesh construction: the reference's (16, 16) ("data",
"model") pod and its (2, 16, 16) ("pod", "data", "model") pair of pods,
as ``repro_torch.mesh.Mesh``es.

``devices=None`` takes the visible cards and raises where there are
fewer than the mesh needs (as the reference raises short of host
devices); a list may repeat a device — the card or the CPU listed 256
times is the counterpart of the reference's simulated host devices, its
shards then running in turn."""
from __future__ import annotations

import math

import torch

from repro_torch.mesh import Mesh, make_mesh
from repro_torch.models.common import MeshCtx


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ndev = math.prod(shape)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) > ndev:           # more devices than the mesh takes
        devices = devices[:ndev]
    elif len(devices) < ndev:
        raise RuntimeError(
            f"mesh {shape} needs {ndev} devices, have {len(devices)} — pass "
            f"devices= (a device may repeat, e.g. devices=['cuda'] * {ndev}, "
            "whose shards then run in turn)")
    return make_mesh(devices, axes, shape)


def make_mesh_ctx(*, multi_pod: bool = False, devices=None) -> MeshCtx:
    mesh = make_production_mesh(multi_pod=multi_pod, devices=devices)
    dp = ("pod", "data") if multi_pod else ("data",)
    return MeshCtx(mesh=mesh, dp=dp, fsdp="data", tp="model", sp="model")
