"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent
(arXiv:2402.19427 Griffin / RecurrentGemma).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, local window 2048,
GeGLU, head_dim 256, gemma-style embedding scaling.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                      # 12 × (rglru, rglru, attn) + 2 tail
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    mlp="geglu",
    lru_width=4096,
    emb_scale=True,
    tie_embeddings=True,
)
