"""MiniCPM-2B (llama-like arch; WSD schedule wired in its train config)
[arXiv:2404.06395; hf]. 36 heads / kv=36 (MHA).
Values copied word for word from the reference's
`src/repro/configs/minicpm_2b.py:5-9`."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab=122753, act="silu", attn_chunk=128,
)
