"""Chunked (flash-style) prefill attention — ``repro/models/attention_xla.py``
with the reference's signature and chunk-size contract.

The reference writes the online-softmax algorithm out as nested
``lax.scan`` loops so it lowers on any backend with O(S·c) live memory.
The port's flash-attention entry point is that algorithm already (the
hand-written kernel on the card, its plain version on the CPU), so this
function checks the chunking as the reference does and hands the call to
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`, padded
in tiles of ``cq`` / ``ckv``: the port keeps one attention algorithm, not
two.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention


def chunked_attention(
    q: torch.Tensor,   # (B, H, Sq, D)
    k: torch.Tensor,   # (B, KV, Skv, D)
    v: torch.Tensor,   # (B, KV, Skv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    cq: int = 512,
    ckv: int = 1024,
) -> torch.Tensor:
    sq, skv = q.shape[2], k.shape[2]
    cq = min(cq, sq)
    ckv = min(ckv, skv)
    if sq % cq or skv % ckv:
        raise ValueError(f"chunked attention needs Sq % cq == 0 and "
                         f"Skv % ckv == 0, got {(sq, skv)} and {(cq, ckv)}")
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale, bq=cq, bkv=ckv)
