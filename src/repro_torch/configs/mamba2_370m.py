"""Mamba2-370M SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]. Sub-quadratic -> runs long_500k.
Values copied word for word from the reference's
`src/repro/configs/mamba2_370m.py:5-10`."""
from repro_torch.models.common import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280, sub_quadratic=True,
    ssm=SSMCfg(d_state=128, headdim=64, expand=2, d_conv=4, chunk=256),
)
