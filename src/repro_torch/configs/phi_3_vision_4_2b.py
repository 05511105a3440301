"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend stub
(hf:microsoft/Phi-3-vision-128k-instruct).

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064, SwiGLU.
The CLIP vision tower is a STUB per the brief: ``input_specs()`` provides
precomputed patch embeddings (B, 64, d_model) prepended to the token
sequence; their label positions are loss-masked.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    block_pattern=("attn",),
    frontend="vision",
    vision_tokens=64,
)
