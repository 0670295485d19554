"""Qwen3-32B dense decoder: qk-norm, GQA kv=8, decoupled head_dim=128
[hf:Qwen/Qwen3-8B family; hf].
Values copied word for word from the reference's
`src/repro/configs/qwen3_32b.py:5-9`."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936, act="silu", qk_norm=True, rope_theta=1e6,
)
