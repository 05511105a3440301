"""seamless-m4t-medium [audio] — encoder-decoder transformer backbone
(arXiv:2308.11596).

12L encoder + 12L decoder, d_model=1024 16H (MHA) d_ff=4096 vocab=256206.
The speech frontend (wav2vec-BERT conformer stack) is a STUB per the brief:
``input_specs()`` feeds precomputed frame embeddings of length seq_len//4
straight into the encoder.  Positioning uses RoPE (adaptation noted in
DESIGN.md).  Decode shapes exercise the decoder with cross-attention.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    block_pattern=("attn",),
    encoder_layers=12,
    encoder_ratio=4,
    frontend="audio",
)
