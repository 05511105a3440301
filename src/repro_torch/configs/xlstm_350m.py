"""xlstm-350m [ssm] — sLSTM + mLSTM blocks, 1:1 (arXiv:2405.04517).

24L d_model=1024 4H vocab=50304. d_ff=0 in the brief: the xLSTM block's
feed-forward lives inside the blocks (mLSTM projection factor 2, sLSTM
post-MLP factor 4/3) — there is no separate transformer FFN.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    block_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
)
