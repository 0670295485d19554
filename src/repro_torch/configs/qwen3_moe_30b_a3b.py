"""Qwen3-30B-A3B MoE: 128 experts top-8, d_expert=768, GQA kv=4,
qk-norm [hf:Qwen/Qwen3-30B-A3B; hf].
Values copied word for word from the reference's
`src/repro/configs/qwen3_moe_30b_a3b.py:5-10`."""
from repro_torch.models.common import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, act="silu", qk_norm=True,
    moe=MoECfg(n_experts=128, top_k=8, d_expert=768),
)
