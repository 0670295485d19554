"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 (paper-table)
[arXiv:2501.kimi2; unverified]. bf16 params (+8-bit Adam in its train
config) so that 1T params fit 512 x 16 GB HBM; see DESIGN.md.
Values copied word for word from the reference's
`src/repro/configs/kimi_k2_1t_a32b.py:6-11`."""
from repro_torch.models.common import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab=163840, act="silu", param_dtype="bfloat16",
    moe=MoECfg(n_experts=384, top_k=8, d_expert=2048),
)
