"""MusicGen-Large decoder backbone over EnCodec tokens [arXiv:2306.05284; hf].
Frontend (EnCodec + codebook interleaving) is a stub: input_specs supply
precomputed frame embeddings (B, S, d_model); the 2048-entry codebook head
remains.
Values copied word for word from the reference's
`src/repro/configs/musicgen_large.py:7-11`."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="dense",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, act="gelu", embeds_input=True,
)
