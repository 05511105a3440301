"""Block composition — ``repro/models/blocks.py`` in PyTorch: every
architecture is a ``block_pattern`` over these kinds.

Kinds: ``attn`` (full causal GQA), ``swa`` (sliding-window),
``local_attn`` (hybrid-local window, MQA in RecurrentGemma), ``rglru``,
``mlstm`` and ``slstm``.  Each block is a pre-norm sublayer with a
residual; attention-family blocks and ``rglru`` are followed by a dense
or mixture-of-experts MLP with its own pre-norm and residual, while the
xLSTM blocks carry their feed-forward inside; a decoder block of an
encoder-decoder model also has cross-attention (``ln_cross``, ``cross``)
between the two.

A block is a :class:`Block` module whose parameters carry the reference's
dict keys (``ln1``, ``attn.wq``, ``rec.lam``, ``mlstm.wq``, ``ln_cross``,
``cross.wk``, ``ln2``, ``mlp.w_up``, ``moe.router``,
``moe.experts.w_gate``, ...).  :func:`count_params` counts every kind, as
the reference's does.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.constraints import shard_act

from . import layers, moe as moe_mod, recurrent, xlstm
from .layers import Params, init_rmsnorm, rmsnorm

ATTN_KINDS = ("attn", "swa", "local_attn", "cross")
HAS_MLP = ("attn", "swa", "local_attn", "rglru")
# the sublayer each kind holds, and the functions that draw it
_SUBLAYER = {"rglru": ("rec", recurrent.init_recurrent),
             "mlstm": ("mlstm", xlstm.init_mlstm),
             "slstm": ("slstm", xlstm.init_slstm),
             **{kind: ("attn", layers.init_attention) for kind in ATTN_KINDS}}


def _window_of(kind: str, cfg) -> Optional[int]:
    if kind in ("swa", "local_attn"):
        return cfg.window
    return None


def _ring(kind: str, cfg) -> bool:
    return bool(cfg.ring_cache and kind in ("swa", "local_attn")
                and cfg.window)


def _known(kind: str) -> None:
    if kind not in _SUBLAYER:
        raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Block(Params):
    """One block's parameters: ``ln1`` and the sublayer (``attn``,
    ``rec``, ``mlstm`` or ``slstm``); with ``cross``, ``ln_cross`` and the
    cross-attention ``cross``; for the kinds with an MLP, ``ln2`` and
    ``mlp`` (or ``moe``, whose ``router`` stays float32, and its
    ``experts``).  ``kind`` is its block kind."""

    def __init__(self, kind: str, cfg, dtype, device, *, cross: bool = False):
        _known(kind)

        def norms(generator, dev):
            p = {"ln1": init_rmsnorm(cfg.d_model, dtype, dev)}
            if cross:
                p["ln_cross"] = init_rmsnorm(cfg.d_model, dtype, dev)
            if kind in HAS_MLP:
                p["ln2"] = init_rmsnorm(cfg.d_model, dtype, dev)
            return p

        super().__init__(norms, device)
        self.kind = kind
        name, init = _SUBLAYER[kind]
        self.add_module(name, Params(lambda g, dev: init(g, cfg, dtype, dev),
                                     device))
        if cross:
            self.cross = Params(lambda g, dev: layers.init_attention(
                g, cfg, dtype, dev), device)
        if kind in HAS_MLP and cfg.is_moe:
            self.moe = Params(lambda g, dev: moe_mod.init_router(g, cfg, dev),
                              device)
            self.moe.experts = Params(lambda g, dev: moe_mod.init_experts(
                g, cfg, dtype, dev), device)
        elif kind in HAS_MLP:
            self.mlp = Params(lambda g, dev: layers.init_mlp(
                g, cfg, dtype, dev), device)


def init_block(generator, kind: str, cfg, dtype, device, *,
               cross: bool = False) -> Block:
    """A :class:`Block` of ``kind`` drawn from ``generator``."""
    return Block(kind, cfg, dtype, device, cross=cross).reset(generator)


def _has(p, name: str) -> bool:
    return name in p if isinstance(p, dict) else hasattr(p, name)


# ---------------------------------------------------------------------------
# apply (full sequence: train / prefill)
# ---------------------------------------------------------------------------

def apply_block(
    p,
    x: torch.Tensor,
    kind: str,
    cfg,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    memory_h: Optional[torch.Tensor] = None,   # encoder hiddens (cross-attn)
    return_state: bool = False,
    s_max: Optional[int] = None,            # cache capacity when prefilling
    chunked: bool = False,
    meter: bool = False,
):
    """Returns ``(x_out, moe_aux_loss)``, or ``(x_out, aux, state)`` with
    ``return_state``, as the reference's does; ``aux`` is a float32 zero
    for a block without a mixture of experts.  ``meter`` (the model's
    meter mode) runs attention and the RG-LRU scan as their plain
    versions.  A block with
    cross-attention attends ``memory_h``; its state is then ``{"self":
    ..., "cross": {"k", "v"}}``."""
    _known(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    state = None
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        win = _window_of(kind, cfg)
        if return_state:
            out, (k, v) = layers.attention(
                p["attn"], h, cfg, causal=causal, window=win,
                positions=positions, return_kv=True, chunked=chunked,
                meter=meter)
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
                positions=positions, chunked=chunked, meter=meter)
    elif kind == "rglru":
        r = recurrent.recurrent_block(p["rec"], h, cfg,
                                      return_state=return_state, meter=meter)
        out, state = r if return_state else (r, None)
    elif kind == "mlstm":
        r = xlstm.mlstm_block(p["mlstm"], h, cfg, return_state=return_state,
                              chunked=chunked)
        out, state = r if return_state else (r, None)
    else:
        r = xlstm.slstm_block(p["slstm"], h, cfg, return_state=return_state)
        out, state = r if return_state else (r, None)
    x = x + out.to(x.dtype)
    x = shard_act(x, "residual")

    if _has(p, "cross") and memory_h is not None:
        h = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
        if return_state:
            out, (ck, cv) = layers.attention(
                p["cross"], h, cfg, memory_h=memory_h, return_kv=True,
                chunked=chunked, meter=meter)
            state = {"self": state, "cross": {"k": ck, "v": cv}}
        else:
            out = layers.attention(p["cross"], h, cfg, memory_h=memory_h,
                                   chunked=chunked, meter=meter)
        x = x + out.to(x.dtype)
    elif _has(p, "cross") and return_state:
        state = {"self": state, "cross": None}

    if kind in HAS_MLP:
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            out, aux = moe_mod.moe_layer(p["moe"], h, cfg)
        else:
            out = layers.mlp(p["mlp"], h, cfg.mlp)
        x = x + out.to(x.dtype)
        x = shard_act(x, "residual")
    if return_state:
        return x, aux, state
    return x, aux


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
    """One token through the block against its decode ``state`` (a
    ``{"self", "cross"}`` pair for a block with cross-attention, whose
    encoder cache is read and never written); a mixture of experts runs at
    capacity T, so no token drops."""
    _known(kind)
    has_cross = (isinstance(state, dict) and "cross" in state
                 and "self" in state)
    self_state = state["self"] if has_cross else state

    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        out, self_state = layers.attention_decode(
            p["attn"], h, self_state, pos, cfg, window=_window_of(kind, cfg),
            ring=_ring(kind, cfg))
    elif kind == "rglru":
        out, self_state = recurrent.recurrent_block_decode(
            p["rec"], h, self_state, cfg)
    elif kind == "mlstm":
        out, self_state = xlstm.mlstm_block_decode(
            p["mlstm"], h, self_state, cfg)
    else:
        out, self_state = xlstm.slstm_block_decode(
            p["slstm"], h, self_state, cfg)
    x = x + out.to(x.dtype)

    if has_cross and state["cross"] is not None:
        h = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
        out, _ = layers.attention_decode(
            p["cross"], h, state["cross"], pos, cfg, is_cross=True)
        x = x + out.to(x.dtype)

    if kind in HAS_MLP:
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            out, _ = moe_mod.moe_layer(p["moe"], h, cfg)
        else:
            out = layers.mlp(p["mlp"], h, cfg.mlp)
        x = x + out.to(x.dtype)
    if has_cross:
        return x, {"self": self_state, "cross": state["cross"]}
    return x, self_state


def init_block_state(kind: str, cfg, batch: int, s_max: int, dtype,
                     device, *, enc_len: int = 0) -> Any:
    """Decode-time carried state for one block: a KV cache (full length,
    or the last ``window`` slots with ``cfg.ring_cache``), the RG-LRU's
    conv window and hidden state, or an xLSTM block's recurrent state;
    with ``enc_len``, ``{"self": that, "cross": the encoder's K/V
    cache}``."""
    _known(kind)
    if kind in ATTN_KINDS:
        cap = min(cfg.window, s_max) if _ring(kind, cfg) else s_max
        state = layers.init_attention_cache(cfg, batch, cap, dtype, device)
    elif kind == "rglru":
        state = recurrent.init_recurrent_state(cfg, batch, dtype, device)
    elif kind == "mlstm":
        state = xlstm.init_mlstm_state(cfg, batch, dtype, device)
    else:
        state = xlstm.init_slstm_state(cfg, batch, dtype, device)
    if enc_len:
        cross = layers.init_attention_cache(cfg, batch, enc_len, dtype,
                                            device)
        return {"self": state, "cross": cross}
    return state


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
