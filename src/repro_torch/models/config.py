"""Model configuration — one dataclass covers all ten assigned architectures
(the port's own copy of ``repro/models/config.py``, line for line).

``block_pattern`` composes heterogeneous stacks: the pattern repeats down the
depth (``("rglru", "rglru", "attn")`` for RecurrentGemma's 1:2 ratio,
``("mlstm", "slstm")`` for xLSTM, ``("attn",)`` for dense).  Layers are
grouped by full pattern repeats (the reference scans over the groups, the
port loops over them); any remainder layers form the "tail".
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default d_model // n_heads
    block_pattern: tuple[str, ...] = ("attn",)   # attn|swa|local_attn|rglru|mlstm|slstm

    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None            # SWA width for "swa"/"local_attn" blocks
    rope_theta: float = 10_000.0

    # mlp flavour
    mlp: str = "swiglu"                     # swiglu | geglu
    # MoE (0 experts -> dense mlp)
    n_experts: int = 0
    n_experts_active: int = 0
    capacity_factor: float = 1.25
    moe_mode: str = "ep"                    # ep (all_to_all) | replicated

    # recurrent substrate
    lru_width: Optional[int] = None         # RG-LRU state width (default d_model)
    conv_width: int = 4

    # windowed ring-buffer KV cache for swa/local_attn decode (§Perf r4)
    ring_cache: bool = False

    # encoder-decoder (0 -> decoder-only)
    encoder_layers: int = 0
    encoder_ratio: int = 4                  # enc length = seq_len // ratio (audio stub)

    # modality frontend stubs
    frontend: Optional[str] = None          # None | audio | vision
    vision_tokens: int = 64                 # patch embeddings prepended (vlm)

    # embeddings / misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    emb_scale: bool = False                 # gemma-style sqrt(d) embed scaling
    dtype: str = "bfloat16"

    # ----------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.pattern_period

    @property
    def n_tail_layers(self) -> int:
        return self.n_layers % self.pattern_period

    @property
    def tail_pattern(self) -> tuple[str, ...]:
        return self.block_pattern[: self.n_tail_layers]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder (seamless is enc-dec)

    @property
    def subquadratic(self) -> bool:
        """True if every block is O(S·w) or better — long_500k eligibility."""
        quad = {"attn"}
        return not any(b in quad for b in self.block_pattern)

    # ----------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        period = self.pattern_period
        small = dict(
            n_layers=max(2, 2 * period) if period > 1 else 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab_size=512,
            head_dim=16,
            window=min(self.window, 16) if self.window else None,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_experts_active=min(self.n_experts_active, 2)
            if self.n_experts_active else 0,
            # capacity covers the worst case -> no token drops, so decode
            # and full-sequence forward agree exactly in the tests
            capacity_factor=(min(self.n_experts, 8)
                             / max(min(self.n_experts_active, 2), 1))
            if self.n_experts else self.capacity_factor,
            lru_width=64 if self.lru_width_ else None,
            encoder_layers=2 if self.encoder_layers else 0,
            vision_tokens=8 if self.frontend == "vision" else self.vision_tokens,
            dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    # ----------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (drives 6·N·D roofline MODEL_FLOPS)."""
        from . import blocks  # lazy, avoids cycle
        return blocks.count_params(self)

    def active_param_count(self) -> int:
        from . import blocks
        return blocks.count_params(self, active_only=True)
