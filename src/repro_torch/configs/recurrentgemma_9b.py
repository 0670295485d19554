"""RecurrentGemma-9B (Griffin): RG-LRU + local attention 1:2 pattern,
MQA kv=1, window 2048 [arXiv:2402.19427; unverified].
38 layers = 12 x (rec, rec, attn) + 2 rec. Sub-quadratic -> runs long_500k.
Values copied word for word from the reference's
`src/repro/configs/recurrentgemma_9b.py:6-12`."""
from repro_torch.models.common import ModelConfig, HybridCfg

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000, act="gelu", sub_quadratic=True,
    hybrid=HybridCfg(pattern=("rec", "rec", "attn"), n_groups=12,
                     tail=("rec", "rec"), window=2048, lru_width=4096),
)
