"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention
(arXiv:2401.16818).

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
Sub-quadratic (windowed) attention -> runs the long_500k cell.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    head_dim=80,
    block_pattern=("swa",),
    window=4096,
)
