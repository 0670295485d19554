"""Nemotron-4-340B dense decoder: GQA kv=8, squared-ReLU MLP (no gate)
[arXiv:2402.16819; unverified].
Values copied word for word from the reference's
`src/repro/configs/nemotron_4_340b.py:5-9`."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab=256000, act="sq_relu",
)
