"""Model/config substrate shared by all assigned architectures: the
config dataclasses, the benchmark shapes, the (single-device) mesh
context, the truncated-normal initializer and a size helper."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


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
    """The mesh the models run on.  Only the single-device context
    (``mesh=None``) exists so far: ``constrain`` is the identity.  The
    reference's axis roles (``dp``, ``fsdp``, ``tp``, ``sp``) and its
    multi-device branches (the MoE and RG-LRU shard maps, parameter
    sharding) wait for the two-card work."""
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "MeshCtx(mesh=...): the models run on one device; their "
                "multi-device paths are not ported yet")

    def constrain(self, x, *spec):
        return x


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
