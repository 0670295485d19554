"""Logical-to-physical sharding rules.

Derives partition specs for parameter/optimizer/cache/batch trees from
leaf *names* (path-based rules), with divisibility-guarded axes: an axis
is only used when the dim size divides the mesh axis product (e.g.
minicpm's 36 heads or smollm's 9 heads fall back to replicated-TP while
FSDP still applies; long_500k's batch=1 falls back to replicated-DP).

The rules are the reference's, word for word; they read a mesh's
``shape`` only.  A tree is a nest of dicts whose leaves have ``shape``
(tensors, on ``meta`` too; or anything with a ``shape``); a leaf without
one (a cache's ``len`` counter) counts as a scalar.  ``to_named`` turns
a tree of specs into ``repro_torch.mesh.NamedSharding``s.
"""
from __future__ import annotations

import math
import re

from repro_torch import tree as T
from repro_torch.mesh import Mesh, NamedSharding, P
from repro_torch.models.common import ModelConfig, MeshCtx


def path_str(path_tuple) -> str:
    """Normalize a tree path to 'a.b.c' so name rules can match."""
    return ".".join(str(k) for k in path_tuple)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _map_with_path(fn, tree, is_leaf=None):
    flat = T.flatten_with_path(tree, is_leaf)
    return T.unflatten([p for p, _ in flat], [fn(p, leaf) for p, leaf in flat])


def _axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return int(math.prod(mesh.shape[a] for a in axes))


def _maybe(mesh: Mesh, axes, dim: int):
    """axes if dim divisible by their product else None."""
    if axes is None or mesh is None:
        return None
    return axes if dim % _axis_size(mesh, axes) == 0 else None


def param_pspecs(shapes_tree, cfg: ModelConfig, mctx: MeshCtx):
    """shapes_tree: the parameter tree (``Model.tree()``, on ``meta`` for
    a shapes-only build).  Returns the matching tree of ``P``."""
    mesh, fsdp, tp = mctx.mesh, mctx.fsdp, mctx.tp

    def rule(path: str, shape: tuple[int, ...]) -> P:
        nd = len(shape)

        def lead(*tail):
            return P(*([None] * (nd - len(tail)) + list(tail)))

        m = lambda ax, d: _maybe(mesh, ax, d)
        if path.endswith("embed"):
            return P(m(tp, shape[0]), m(fsdp, shape[1]))
        if path.endswith("lm_head"):
            return P(m(fsdp, shape[0]), m(tp, shape[1]))
        if re.search(r"\bw[qkv]\b|'w[qkv]'", path) or path.endswith(("wq", "wk", "wv")):
            return lead(m(fsdp, shape[-3]), m(tp, shape[-2]), None)
        if path.endswith("wo"):
            return lead(m(tp, shape[-3]), None, m(fsdp, shape[-1]))
        if "moe" in path and path.endswith(("w_up", "w_gate")):
            if cfg.moe is not None and cfg.moe.impl == "capacity":
                # expert-parallel layout
                return lead(m(tp, shape[-3]), m(fsdp, shape[-2]), None)
            return lead(m(fsdp, shape[-3]), None, m(tp, shape[-1]))
        if "moe" in path and path.endswith("w_down"):
            if cfg.moe is not None and cfg.moe.impl == "capacity":
                return lead(m(tp, shape[-3]), None, m(fsdp, shape[-1]))
            return lead(m(fsdp, shape[-3]), m(tp, shape[-2]), None)
        if path.endswith("router"):
            return lead(m(fsdp, shape[-2]), None)
        if path.endswith(("w_up", "w_gate", "in_proj", "in_x", "in_gate")):
            return lead(m(fsdp, shape[-2]), m(tp, shape[-1]))
        if path.endswith("out_proj") and "rec" in path:
            # sequence-parallel rec block: contraction dim replicated
            return lead(None, m(fsdp, shape[-1]))
        if path.endswith(("w_down", "out_proj")):
            return lead(m(tp, shape[-2]), m(fsdp, shape[-1]))
        if path.endswith(("w_a", "w_i")):
            # replicated: the rec block is sequence-parallel
            return lead(None, None)
        if path.endswith("conv_w"):
            return lead(None, m(tp, shape[-1]))
        return P(*([None] * nd))     # norms, biases, scalars: replicate

    return _map_with_path(lambda p, leaf: rule(path_str(p), _shape(leaf)), shapes_tree)


def opt_pspecs(pparams, opt_shapes, mctx: MeshCtx, moments_dtype: str):
    """Optimizer-state specs: fp32 moments mirror the param specs; int8
    blockwise moments keep the param's exact layout (q: param pspec,
    scale: param pspec with the last dim unsharded) so the Adam update
    never reshards."""
    if moments_dtype != "int8":
        return {"step": P(), "m": pparams, "v": pparams}

    def moment_spec(pspec, mshape):
        parts = list(pspec) + [None] * (len(_shape(mshape["q"])) - len(pspec))
        return {"q": P(*parts),
                "scale": P(*(parts[:-1] + [None]))}

    is_m = lambda x: isinstance(x, dict) and "q" in x
    m = T.map_tree(moment_spec, pparams, opt_shapes["m"], is_leaf=is_m)
    v = T.map_tree(moment_spec, pparams, opt_shapes["v"], is_leaf=is_m)
    return {"step": P(), "m": m, "v": v}


def batch_pspecs(batch_shapes, mctx: MeshCtx):
    mesh = mctx.mesh

    def spec(path, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:
            return P()
        dp = _maybe(mesh, mctx.dp, shape[0])
        return P(*([dp] + [None] * (nd - 1)))
    return _map_with_path(spec, batch_shapes)


def cache_pspecs(cache_shapes, cfg: ModelConfig, mctx: MeshCtx):
    """KV caches: batch on dp, *sequence* on the model axis (context-
    parallel cache — the only way a 512k-token cache fits)."""
    mesh = mctx.mesh

    def spec(path_tuple, leaf):
        key = path_str(path_tuple).rsplit(".", 1)[-1]   # exact last key
        shape = _shape(leaf)
        nd = len(shape)
        m = lambda ax, d: _maybe(mesh, ax, d)
        if key == "len":
            return P()
        if key in ("k", "v"):                        # (L,B,S,KV,hd)
            L, B, S, KV, hd = shape
            return P(None, m(mctx.dp, B), m(mctx.sp, S), None, None)
        if key in ("g_k", "g_v"):                    # (G,A,B,S,KV,hd)
            G, A, B, S, KV, hd = shape
            return P(None, None, m(mctx.dp, B), m(mctx.sp, S), None, None)
        if key == "state":                           # ssm (L,B,H,P,N)
            return P(None, m(mctx.dp, shape[1]), m(mctx.tp, shape[2]), None, None)
        if key == "conv":                            # ssm conv (L,B,k,C)
            return P(None, m(mctx.dp, shape[1]), None, m(mctx.tp, shape[3]))
        if key == "g_state":
            return P(None, None, m(mctx.dp, shape[2]), m(mctx.tp, shape[3]))
        if key == "g_conv":
            return P(None, None, m(mctx.dp, shape[2]), None, m(mctx.tp, shape[4]))
        if key == "t_state":
            return P(None, m(mctx.dp, shape[1]), m(mctx.tp, shape[2]))
        if key == "t_conv":
            return P(None, m(mctx.dp, shape[1]), None, m(mctx.tp, shape[3]))
        return P(*([None] * nd))
    return _map_with_path(spec, cache_shapes)


def to_named(tree_of_pspecs, mesh: Mesh):
    return T.map_tree(lambda s: NamedSharding(mesh, s), tree_of_pspecs)
