"""granite-moe-3b-a800m [moe] — 40 experts top-8
(hf:ibm-granite/granite-3.0 family).

32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155, SwiGLU experts.
40 % 16 != 0 -> experts replicated over the model axis (each shard computes
all 40 tiny experts on its sequence slice); see DESIGN.md §Arch-applicability.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    block_pattern=("attn",),
    n_experts=40,
    n_experts_active=8,
    moe_mode="replicated",
    tie_embeddings=True,
)
