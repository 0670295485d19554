"""SmolLM-135M llama-arch small model [hf:HuggingFaceTB/SmolLM-135M; hf].
Tied embeddings (as the released model). Also the e2e training example.
Values copied word for word from the reference's
`src/repro/configs/smollm_135m.py:5-9`."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab=49152, act="silu", tie_embeddings=True, attn_chunk=256,
)
