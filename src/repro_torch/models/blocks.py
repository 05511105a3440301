"""Block composition — ``repro/models/blocks.py`` in PyTorch, for the block
kinds the port serves and trains: ``attn`` (full causal GQA), ``swa``
(sliding-window), ``local_attn`` (hybrid-local window, MQA in
RecurrentGemma) and ``rglru``.  Each block is a pre-norm sublayer with a
residual, then the MLP with its own pre-norm and residual.

A block is a :class:`Block` module whose parameters carry the reference's
dict keys (``ln1``, ``attn.wq``, ``rec.lam``, ``ln2``, ``mlp.w_up``, ...).
The xLSTM kinds (``mlstm``, ``slstm``), cross-attention (encoder-decoder)
and mixture-of-experts MLPs come with the rest of the LM stack
(:func:`check_ported` raises for them).  :func:`count_params` counts every
kind, as the reference's does, so ``ModelConfig.param_count()`` answers
for all ten configurations.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.constraints import shard_act

from . import layers, recurrent
from .layers import Params, init_rmsnorm, rmsnorm

ATTN_KINDS = ("attn", "swa", "local_attn", "cross")
HAS_MLP = ("attn", "swa", "local_attn", "rglru")
PORTED_KINDS = ("attn", "swa", "local_attn", "rglru")
_LATER = ("the rest of the LM stack (ROADMAP Queue 1, Slice 6: xLSTM "
          "blocks, mixture of experts, encoder-decoder and vision front "
          "ends)")


def check_ported(cfg, kinds=None) -> None:
    """Raise :class:`ValueError`, naming the slice that brings it, for a
    part of ``cfg`` the port does not run yet (``kinds``: the block kinds
    to check, ``cfg.block_pattern`` by default)."""
    for kind in cfg.block_pattern if kinds is None else kinds:
        if kind in ("mlstm", "slstm"):
            raise ValueError(f"{cfg.name}: block kind {kind!r} (xLSTM) is "
                             f"not ported yet; it comes with {_LATER}")
        if kind == "cross":
            raise ValueError(f"{cfg.name}: cross-attention is not ported "
                             f"yet; it comes with {_LATER}")
        if kind not in PORTED_KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    if cfg.is_moe:
        raise ValueError(f"{cfg.name}: mixture-of-experts MLPs are not "
                         f"ported yet; they come with {_LATER}")
    if cfg.encoder_layers:
        raise ValueError(f"{cfg.name}: the encoder-decoder stack is not "
                         f"ported yet; it comes with {_LATER}")
    if cfg.frontend is not None:
        raise ValueError(f"{cfg.name}: the {cfg.frontend} front end is not "
                         f"ported yet; it comes with {_LATER}")


def _window_of(kind: str, cfg) -> Optional[int]:
    if kind in ("swa", "local_attn"):
        return cfg.window
    return None


def _ring(kind: str, cfg) -> bool:
    return bool(cfg.ring_cache and kind in ("swa", "local_attn")
                and cfg.window)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Block(Params):
    """One block's parameters: ``ln1``, the sublayer (``attn`` or
    ``rec``), and ``ln2`` with ``mlp``; ``kind`` is its block kind."""

    def __init__(self, kind: str, cfg, dtype, device):
        check_ported(cfg, (kind,))

        def norms(generator, dev):
            p = {"ln1": init_rmsnorm(cfg.d_model, dtype, dev)}
            if kind in HAS_MLP:
                p["ln2"] = init_rmsnorm(cfg.d_model, dtype, dev)
            return p

        super().__init__(norms, device)
        self.kind = kind
        if kind in ATTN_KINDS:
            self.attn = Params(lambda g, dev: layers.init_attention(
                g, cfg, dtype, dev), device)
        else:
            self.rec = Params(lambda g, dev: recurrent.init_recurrent(
                g, cfg, dtype, dev), device)
        if kind in HAS_MLP:
            self.mlp = Params(lambda g, dev: layers.init_mlp(
                g, cfg, dtype, dev), device)


def init_block(generator, kind: str, cfg, dtype, device) -> Block:
    """A :class:`Block` of ``kind`` drawn from ``generator``."""
    return Block(kind, cfg, dtype, device).reset(generator)


# ---------------------------------------------------------------------------
# apply (full sequence: prefill)
# ---------------------------------------------------------------------------

def apply_block(
    p,
    x: torch.Tensor,
    kind: str,
    cfg,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    return_state: bool = False,
    s_max: Optional[int] = None,            # cache capacity when prefilling
    chunked: bool = False,
):
    """Returns ``x_out``, or ``(x_out, state)`` with ``return_state`` (the
    reference also returns the MoE auxiliary loss, always 0 here)."""
    check_ported(cfg, (kind,))
    state = None
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        win = _window_of(kind, cfg)
        if return_state:
            out, (k, v) = layers.attention(
                p["attn"], h, cfg, causal=causal, window=win,
                positions=positions, return_kv=True, chunked=chunked)
            s_have = k.shape[2]
            if _ring(kind, cfg):
                # arrange the last W positions into ring slots (p % W)
                W = min(cfg.window, s_max or s_have)
                if s_have >= W:
                    base = s_have - W
                    p_for = base + torch.remainder(
                        torch.arange(W, device=k.device) - base, W)
                    state = {"k": k[:, :, p_for], "v": v[:, :, p_for]}
                else:
                    pad = (0, 0, 0, W - s_have)
                    state = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
            else:
                pad = (0, 0, 0, (s_max or s_have) - s_have)
                state = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
        else:
            out = layers.attention(
                p["attn"], h, cfg, causal=causal, window=win,
                positions=positions, chunked=chunked)
    else:
        r = recurrent.recurrent_block(p["rec"], h, cfg,
                                      return_state=return_state)
        out, state = r if return_state else (r, None)
    x = x + out.to(x.dtype)
    x = shard_act(x, "residual")

    if kind in HAS_MLP:
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        out = layers.mlp(p["mlp"], h, cfg.mlp)
        x = x + out.to(x.dtype)
        x = shard_act(x, "residual")
    if return_state:
        return x, state
    return x


# ---------------------------------------------------------------------------
# apply (single-token decode with state)
# ---------------------------------------------------------------------------

def apply_block_decode(
    p,
    x: torch.Tensor,
    state: Any,
    kind: str,
    pos: int,
    cfg,
) -> tuple[torch.Tensor, Any]:
    check_ported(cfg, (kind,))
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        out, state = layers.attention_decode(
            p["attn"], h, state, pos, cfg, window=_window_of(kind, cfg),
            ring=_ring(kind, cfg))
    else:
        out, state = recurrent.recurrent_block_decode(p["rec"], h, state, cfg)
    x = x + out.to(x.dtype)

    if kind in HAS_MLP:
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        out = layers.mlp(p["mlp"], h, cfg.mlp)
        x = x + out.to(x.dtype)
    return x, state


def init_block_state(kind: str, cfg, batch: int, s_max: int, dtype,
                     device) -> Any:
    """Decode-time carried state for one block: a KV cache (full length,
    or the last ``window`` slots with ``cfg.ring_cache``) or the RG-LRU's
    conv window and hidden state."""
    check_ported(cfg, (kind,))
    if kind in ATTN_KINDS:
        cap = min(cfg.window, s_max) if _ring(kind, cfg) else s_max
        return layers.init_attention_cache(cfg, batch, cap, dtype, device)
    return recurrent.init_recurrent_state(cfg, batch, dtype, device)


# ---------------------------------------------------------------------------
# analytic parameter counts (every kind, as the reference counts them)
# ---------------------------------------------------------------------------

def _block_params(kind: str, cfg, active_only: bool) -> int:
    d, hd = cfg.d_model, cfg.head_dim_
    n = 0
    if kind in ATTN_KINDS:
        n += d * (cfg.n_heads * hd) * 2              # wq, wo
        n += d * (cfg.n_kv_heads * hd) * 2           # wk, wv
    elif kind == "rglru":
        w = cfg.lru_width_
        n += d * w * 2 + w * w * 2 + w * d + cfg.conv_width * w
    elif kind == "mlstm":
        h = 2 * d
        n += d * 2 * h + 3 * h * h + h * 2 * cfg.n_heads + h * d \
            + cfg.conv_width * h
    elif kind == "slstm":
        dh = d // cfg.n_heads
        d_ff = int(round(4 * d / 3 / 64) * 64) or 64
        n += d * 4 * d + 4 * cfg.n_heads * dh * dh + 2 * d * d_ff
    if kind in HAS_MLP:
        if cfg.is_moe:
            e = cfg.n_experts_active if active_only else cfg.n_experts
            n += d * cfg.n_experts                    # router
            n += e * 3 * d * cfg.d_ff
        else:
            n += 3 * d * cfg.d_ff if cfg.mlp in ("swiglu", "geglu") \
                else 2 * d * cfg.d_ff
    return n


def count_params(cfg, active_only: bool = False) -> int:
    """The reference's analytic count: the weight matrices, embedding and
    head (not the norm scales, biases or RG-LRU ``lam`` / ``conv_b``)."""
    pattern = cfg.block_pattern
    total = cfg.vocab_size * cfg.d_model              # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model         # lm head
    for li in range(cfg.n_layers):
        total += _block_params(pattern[li % len(pattern)], cfg, active_only)
    if cfg.encoder_layers:
        hd = cfg.head_dim_
        for li in range(cfg.encoder_layers):
            total += _block_params(pattern[li % len(pattern)], cfg, active_only)
        # decoder cross-attention (wq, wo over heads; wk, wv over kv heads)
        total += cfg.n_layers * (
            cfg.d_model * cfg.n_heads * hd * 2
            + cfg.d_model * cfg.n_kv_heads * hd * 2)
    return total
