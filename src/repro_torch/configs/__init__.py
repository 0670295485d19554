"""Architecture config registry: ``get_config(arch_id)`` and the
reduced smoke variants used by CPU tests (the reference's
``src/repro/configs/__init__.py:22-45``)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig, MoECfg, SSMCfg, HybridCfg

ARCHS = [
    "musicgen-large", "nemotron-4-340b", "smollm-135m", "qwen3-32b",
    "minicpm-2b", "recurrentgemma-9b", "chameleon-34b", "mamba2-370m",
    "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_") for a in ARCHS}
_MODULES["sce-ntt"] = "repro_torch.configs.sce_ntt"


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: small depth/width/experts, tiny vocab."""
    cfg = get_config(arch)
    kw: dict = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16, d_ff=128, vocab=256, param_dtype="float32",
        compute_dtype="float32", attn_chunk=32,
    )
    if cfg.moe is not None:
        kw["moe"] = MoECfg(n_experts=4, top_k=2, d_expert=32)
    if cfg.ssm is not None:
        kw["ssm"] = SSMCfg(d_state=16, headdim=8, expand=2, d_conv=4, chunk=16)
        kw["n_heads"] = 0
        kw["n_kv_heads"] = 0
        kw["d_ff"] = 0
    if cfg.hybrid is not None:
        kw["hybrid"] = HybridCfg(pattern=("rec", "rec", "attn"), n_groups=2,
                                 tail=("rec",), window=32, lru_width=64)
        kw["n_layers"] = 7
    return dataclasses.replace(cfg, **kw)
