"""Transformer substrate of the port: norms, RoPE, GQA attention (prefill
and decode), MLPs — ``repro/models/layers.py`` in PyTorch.

Parameters are passed as ``p``, a mapping from the reference's dict keys
to tensors: a :class:`Params` module (what
:class:`~repro_torch.models.model.LanguageModel` holds) or a plain dict.
Dtypes follow the reference's jax promotion: norms and RoPE compute in
float32 and cast back, products stay in the parameters' dtype.

Full-sequence attention (training, the materialised path and the chunked
prefill alike; self-attention and cross-attention over an encoder's
hidden states) goes through the port's flash-attention entry point
(:func:`repro_torch.kernels.flash_attention.ops.flash_attention`): the
hand-written kernel on the card, its plain version on the CPU.  The
reference computes the same function with its oracle
(``kernels.flash_attention.ref.attention``) or its chunked XLA loop
(``models/attention_xla.py``); the entry point is differentiable, its
backward the hand-written backward kernel on the card.  Decode attention (one query against the
cache) stays plain PyTorch, as the reference computes it outside any
kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.sharding.constraints import shard_act

from .attention_xla import chunked_attention

NEG_INF = -1e30
META = torch.device("meta")


class Params(nn.Module):
    """The parameters of one sublayer, named by the reference's dict keys
    and indexable as its dicts are (``p["wq"]``); child modules are
    reached the same way (``p["attn"]``).

    ``init(generator, device)`` draws a dict of tensors (one of the
    ``init_*`` functions below).  Construction calls it on the ``meta``
    device, which allocates nothing, for the names, shapes and dtypes, and
    gives each parameter uninitialised storage on ``device``;
    :meth:`reset` draws the values, one sublayer at a time, so no more
    than one sublayer's float32 draws is ever alive beside the weights.
    Parameters take no gradient until a trainer asks for one
    (:func:`repro_torch.train.step.make_train_step` calls
    ``requires_grad_(True)``), so serving builds no autograd graph.
    """

    def __init__(self, init, device):
        super().__init__()
        self._init = init
        for name, t in init(None, META).items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(t.shape, dtype=t.dtype, device=device),
                requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    @torch.no_grad()
    def reset(self, generator: torch.Generator) -> "Params":
        """Draw every parameter of this module and of the :class:`Params`
        below it from ``generator`` (which lies on their device), in the
        order the modules were registered."""
        for module in self.modules():
            if isinstance(module, Params) and module._parameters:
                own = module._parameters
                device = next(iter(own.values())).device
                for name, t in module._init(generator, device).items():
                    own[name].copy_(t)
        return self


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator, d_in: int, d_out: int, dtype, scale=None, *,
               device) -> torch.Tensor:
    """A (d_in, d_out) normal draw times ``scale`` (1/sqrt(d_in) by
    default), in float32, then cast to ``dtype``."""
    scale = scale if scale is not None else (1.0 / math.sqrt(d_in))
    w = torch.randn((d_in, d_out), generator=generator, device=device)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def init_rmsnorm(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, H, S, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if positions.dim() == 1:
        cos, sin = cos[None, None], sin[None, None]
    else:  # (B, S, half) -> (B, 1, S, half)
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(generator, cfg, dtype, device) -> dict:
    hd = cfg.head_dim_
    p = {
        "wq": dense_init(generator, cfg.d_model, cfg.n_heads * hd, dtype,
                         device=device),
        "wk": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                         device=device),
        "wv": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                         device=device),
        "wo": dense_init(generator, cfg.n_heads * hd, cfg.d_model, dtype,
                         scale=1.0 / math.sqrt(cfg.n_heads * hd),
                         device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype,
                              device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype,
                              device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device)
        p["k_norm"] = init_rmsnorm(hd, dtype, device)
    return p


def _project_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def project_kv(p, memory_h: torch.Tensor, cfg):
    """Cross-attention K/V from encoder hidden states (no RoPE)."""
    b, s, _ = memory_h.shape
    hd = cfg.head_dim_
    k = memory_h @ p["wk"]
    v = memory_h @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _project_q(p, x: torch.Tensor, cfg) -> torch.Tensor:
    b, s, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim_).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return q


def attention(
    p,
    x: torch.Tensor,                   # (B, S, d)
    cfg,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,
    memory_h: Optional[torch.Tensor] = None,  # cross-attn: encoder hiddens
    kv_override: Optional[tuple] = None,      # cross-attn: precomputed (k, v)
    return_kv: bool = False,
    chunked: bool = False,
    meter: bool = False,
):
    """Full-sequence (prefill and training) attention through the
    flash-attention entry point; ``chunked`` takes
    :func:`.attention_xla.chunked_attention` (the same entry point, with
    the reference's chunk-size check).  ``meter`` takes the materialised
    oracle (``kernels.flash_attention.ref.attention``) instead, as the
    reference's meter mode does: no kernel, every product an op a FLOP
    counter sees.  With ``memory_h`` or
    ``kv_override`` it is cross-attention over an encoder's hidden states
    (queries without RoPE, K/V from :func:`project_kv`), never causal.

    A non-causal call hands the entry point the whole key length as its
    key block, so no key is padded: the reference's models call its
    oracle, which pads nothing, and a zero-padded key would be attended
    (the entry point's padded-keys quirk, ROADMAP Queue 3)."""
    b, s, _ = x.shape
    if memory_h is not None or kv_override is not None:
        q = _project_q(p, x, cfg)
        k, v = kv_override if kv_override is not None else project_kv(
            p, memory_h, cfg)
        causal = False
    else:
        if positions is None:
            positions = torch.arange(s, device=x.device)
        q, k, v = _project_qkv(p, x, cfg, positions)
    k = shard_act(k, "kv_gathered")
    v = shard_act(v, "kv_gathered")
    scale = cfg.head_dim_ ** -0.5
    if meter:
        out = attn_ref.attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    elif chunked:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                scale=scale)
    else:
        whole = {} if causal else {"bkv": max(1, k.shape[2])}
        out = flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale, **whole)
    out = out.transpose(1, 2).reshape(b, s, -1)
    out = out @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(
    p,
    x: torch.Tensor,                    # (B, 1, d)
    cache: dict,                        # {"k","v"}: (B, KV, S_max|W, hd)
    pos: int,                           # current position
    cfg,
    *,
    window: Optional[int] = None,
    is_cross: bool = False,             # cache holds static encoder K/V
    ring: bool = False,                 # windowed ring buffer (SWA decode)
) -> tuple[torch.Tensor, dict]:
    """Single-token decode against a KV cache, in plain PyTorch.

    With ``is_cross`` the cache holds the encoder's keys and values
    (cross-attention): the query attends to all of them and nothing is
    written.

    The new key and value are written into the cache tensors in place
    (slot ``pos``, or ``pos % W`` with ``ring``); the reference returns
    updated copies, with the same values.  A slot past the cache raises
    (the reference's ``dynamic_update_slice`` would clamp it onto the
    last slot).  With ``ring=True`` (requires ``window``) the cache holds
    only the last ``W`` positions and every resident entry is in-window;
    RoPE is applied at write time, so slot order does not matter.
    """
    b = x.shape[0]
    hd = cfg.head_dim_
    pos = int(pos)
    k, v = cache["k"], cache["v"]
    s_max = k.shape[2]
    if is_cross:
        q = _project_q(p, x, cfg)
    else:
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q, k_new, v_new = _project_qkv(p, x, cfg, positions)
        slot = pos % s_max if ring else pos
        if not 0 <= slot < s_max:
            raise ValueError(f"decode position {pos} is past the cache's "
                             f"{s_max} slots")
        k[:, :, slot:slot + 1] = k_new
        v[:, :, slot:slot + 1] = v_new

    kvh = k.shape[1]
    group = cfg.n_heads // kvh
    # GQA without repeating the cache: the query heads of one kv head
    # side by side, (B, KV, group, hd) against (B, KV, S, hd)
    qg = q.float().reshape(b, kvh, group, hd)
    s_ = torch.einsum("bhgd,bhkd->bhgk", qg, k.float()) * (hd ** -0.5)
    if not is_cross:
        kpos = torch.arange(s_max, device=x.device)
        if ring:
            # slots <= pos are written; wrapped slots are all in-window
            mask = (kpos <= pos) | (pos >= s_max)
        else:
            mask = kpos <= pos
            if window is not None:
                mask = mask & (kpos > pos - window)
        s_ = torch.where(mask, s_, NEG_INF)
    o = torch.einsum("bhgk,bhkd->bhgd", torch.softmax(s_, dim=-1),
                     v.float()).to(x.dtype)
    o = o.reshape(b, 1, -1)
    return o @ p["wo"], {"k": k, "v": v}


def init_attention_cache(cfg, batch: int, s_max: int, dtype,
                         device) -> dict:
    shape = (batch, cfg.n_kv_heads, s_max, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(generator, cfg, dtype, device, d_ff: Optional[int] = None
             ) -> dict:
    d_ff = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(generator, cfg.d_model, d_ff, dtype,
                             device=device),
        "w_up": dense_init(generator, cfg.d_model, d_ff, dtype,
                           device=device),
        "w_down": dense_init(generator, d_ff, cfg.d_model, dtype,
                             scale=1.0 / math.sqrt(d_ff), device=device),
    }


def mlp(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    gate = x @ p["w_gate"]
    act = F.silu(gate) if kind == "swiglu" else F.gelu(gate,
                                                       approximate="tanh")
    h = act * (x @ p["w_up"])
    h = shard_act(h, "ffn_hidden")
    return h @ p["w_down"]
