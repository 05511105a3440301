"""Attention: the prefill kernel ``flash_attention`` and the
executor-callable block accumulation ``attn_step``."""

from .ops import attn_step, flash_attention
from . import ref

__all__ = ["attn_step", "flash_attention", "ref"]
