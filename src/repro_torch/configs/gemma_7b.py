"""gemma-7b [dense] — GeGLU, head_dim=256 (arXiv:2403.08295).

28L d_model=3072 16H (MHA kv=16) d_ff=24576 vocab=256000, tied embeddings,
sqrt(d) embedding scaling.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("attn",),
    mlp="geglu",
    tie_embeddings=True,
    emb_scale=True,
)
