"""Pipeline parallelism (GPipe schedule) over a mesh axis.

The layer stack is split into n_stages contiguous groups, one on each
device of the mesh axis ``axis`` (``repro_torch.mesh.make_mesh``; a
device may repeat, and its stages then run on it in turn).
Microbatches stream through the stages: stage s processes microbatch m
at tick t = s + m, and hands its output to stage s + 1 with
``.to(next_device)``, where the reference ``ppermute``s it.  A tick's
stages that hold no microbatch (the bubble) compute nothing.
Differentiable: autograd through the schedule gives the backward
pipeline (each ``.to`` carries its gradient back to the stage before).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def pipeline_apply(stage_params, x_mb, block_fn, mesh, axis: str = "pod"):
    """Run microbatched inputs through a pipelined layer stack.

    stage_params: a tensor or nest of dicts of tensors with leading dim
      n_stages; stage s applies its slice, moved to the axis's s-th
      device, via ``block_fn(stage_slice, x) -> y``.
    x_mb: (M, mb, S, D) microbatched activations.
    Returns (M, mb, S, D) outputs on ``x_mb``'s device.
    """
    devices = mesh.axis_devices(axis)
    nstages = mesh.shape[axis]
    M = x_mb.shape[0]
    T_ticks = M + nstages - 1                     # GPipe ticks

    def stage_slice(s):
        if isinstance(stage_params, dict):
            return T.map_tree(lambda a: a[s].to(devices[s]), stage_params)
        return stage_params[s].to(devices[s])
    sp = [stage_slice(s) for s in range(nstages)]

    outs = [None] * M
    sent = [None] * nstages                       # each stage's output of the last tick
    for t in range(T_ticks):
        recv = [None] + sent[:-1]
        sent = [None] * nstages
        for s in range(nstages):
            m = t - s
            if not 0 <= m < M:                    # bubble
                continue
            inp = x_mb[m].to(devices[s]) if s == 0 else recv[s].to(devices[s])
            sent[s] = block_fn(sp[s], inp)
        if sent[-1] is not None:                  # the last stage banks its microbatch
            outs[t - (nstages - 1)] = sent[-1].to(x_mb.device)
    return torch.stack(outs)
