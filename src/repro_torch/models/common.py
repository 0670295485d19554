"""Model/config substrate shared by all assigned architectures: the
config dataclasses, the benchmark shapes, the mesh context, the
truncated-normal initializer (and its stand-in generator on ``meta``)
and a size helper."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.mesh import NamedSharding, P, check_spec


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    aux_coef: float = 0.01
    # "ragged": dropless sort + grouped products over contiguous expert
    #   groups.
    # "capacity": GShard-style fixed capacity C = T*top_k*capacity_factor/E
    #   per expert; routed slots past C are dropped.
    impl: str = "capacity"
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    pattern: tuple[str, ...] = ("rec", "rec", "attn")   # griffin 1 attn : 2 rec
    n_groups: int = 12
    tail: tuple[str, ...] = ("rec", "rec")              # 12*3 + 2 = 38 layers
    window: int = 2048
    lru_width: int | None = None
    conv_k: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"                # silu | sq_relu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embeds_input: bool = False       # audio/vlm stub frontend supplies embeddings
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    hybrid: HybridCfg | None = None
    attn_chunk: int = 512            # flash q-chunk (scores live memory)
    sub_quadratic: bool = False      # eligible for long_500k

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k":    ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeCfg("long_500k", "decode", 524288, 1),
}

# reduced shapes for CPU smoke tests
SMOKE_SHAPES = {
    "train": ShapeCfg("smoke_train", "train", 64, 2),
    "decode": ShapeCfg("smoke_decode", "decode", 64, 2),
}


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Mesh + logical axis roles.  mesh=None => single-device.

    ``mesh`` is a ``repro_torch.mesh.Mesh`` (a device may repeat): the
    models' shard branches (``moe.moe_ffn``, ``rglru._seq_scan``) run
    each shard in turn on its device, the parameters stay whole on the
    mesh's first device."""
    mesh: Any = None
    dp: tuple[str, ...] = ("data",)      # batch/token axes (+ 'pod' multi-pod)
    fsdp: str | None = "data"            # weight-shard axis (ZeRO-3 style)
    tp: str | None = "model"             # tensor-parallel axis
    sp: str | None = "model"             # sequence axis for long KV caches

    def named(self, *spec) -> NamedSharding | None:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, P(*spec))

    def constrain(self, x, *spec):
        """``x`` itself: a sharding constraint places a value and never
        changes it, and the port keeps every activation whole.  Raises
        where ``spec`` names an axis the mesh does not have."""
        if self.mesh is not None:
            check_spec(self.mesh, spec)
        return x


class MetaGenerator(torch.Generator):
    """Stands in for a generator on the ``meta`` device: the parameters
    get their shapes and dtypes, and nothing is drawn or allocated (the
    reference's ``jax.eval_shape(model.init, key)``)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def truncated_normal_init(generator: torch.Generator, shape, dtype,
                          scale: float) -> torch.Tensor:
    """``scale * N(0, 1)`` truncated to [-2, 2], drawn in float32 on the
    generator's device from ``generator``, then cast to ``dtype``."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (scale * t).to(dtype)


def pytree_size_bytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts, lists and tuples (or of
    a module's state)."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return sum(pytree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_size_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
