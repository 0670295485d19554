"""Chameleon-34B early-fusion VLM backbone [arXiv:2405.09818; unverified].
VQ image-token frontend is a stub: input_specs supply fused token/patch
embeddings; unified 65536 vocab head kept. qk-norm per the paper.
Values copied word for word from the reference's
`src/repro/configs/chameleon_34b.py:6-10`."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536, act="silu", qk_norm=True, embeds_input=True,
)
