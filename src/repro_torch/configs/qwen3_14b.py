"""qwen3-14b [dense] — qk_norm, GQA (hf:Qwen/Qwen3 family).

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, head_dim 128,
SwiGLU, RoPE theta 1e6, q/k RMS-norm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    block_pattern=("attn",),
    qk_norm=True,
    rope_theta=1_000_000.0,
)
