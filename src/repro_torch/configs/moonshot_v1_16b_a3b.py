"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6
(hf:moonshotai/Moonlight-16B-A3B).

48L d_model=2048 16H (kv=16, MHA) expert d_ff=1408 vocab=163840.
64 % 16 == 0 -> expert parallelism via all_to_all (4 experts / model shard).
Moonlight's shared-expert and dense-first-layer details are simplified to a
uniform top-6 MoE stack (noted in DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    head_dim=128,
    block_pattern=("attn",),
    n_experts=64,
    n_experts_active=6,
    moe_mode="ep",
)
