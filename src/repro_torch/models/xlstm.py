"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM —
``repro/models/xlstm.py`` in PyTorch.

* **mLSTM** runs its parallel (quadratic, attention-like) form with
  exponential-gate stabilisation for a full sequence, or, ``chunked``, a
  Python loop over query blocks so the (S × S) decay matrix never
  materialises (the reference's ``lax.scan`` over them); its final
  recurrent state has a closed form, so decode continues a prefill
  exactly, one O(1) step a token with the per-head matrix state (C, n, m).
* **sLSTM** has true recurrent (h_{t-1}) connections through
  block-diagonal R matrices, so a full sequence is one Python step per
  token (the reference's ``lax.scan`` over time), float32 inside.

Neither calls a kernel of the port: the reference computes both with XLA
outside any Pallas kernel.  Dtypes follow jax's promotion: where the
reference mixes a float32 intermediate with a bfloat16 weight, the weight
is cast up, as jax promotes it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import dense_init, init_rmsnorm, rmsnorm
from .recurrent import _causal_conv


def _head_norm(x: torch.Tensor, scale: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Per-head RMS norm. x: (..., H, dh); scale: (H*dh,)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    out = xf.reshape(*x.shape[:-2], -1) * (1.0 + scale.float())
    return out.to(dt)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jax's promotion of mixed float dtypes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    h = 2 * d                       # projection factor 2
    H = cfg.n_heads
    conv_k = torch.randn((cfg.conv_width, h), generator=generator,
                         device=device)
    return {
        "w_up": dense_init(generator, d, 2 * h, dtype, device=device),
        "conv_k": conv_k.mul_(1.0 / math.sqrt(cfg.conv_width)).to(dtype),
        "conv_b": torch.zeros((h,), dtype=dtype, device=device),
        "wq": dense_init(generator, h, h, dtype, device=device),
        "wk": dense_init(generator, h, h, dtype, device=device),
        "wv": dense_init(generator, h, h, dtype, device=device),
        # input and forget gates
        "w_if": dense_init(generator, h, 2 * H, dtype, device=device),
        "skip": torch.ones((h,), dtype=dtype, device=device),
        "norm": init_rmsnorm(h, dtype, device),
        "w_down": dense_init(generator, h, d, dtype,
                             scale=1.0 / math.sqrt(h), device=device),
    }


def _mlstm_qkvif(p, xm: torch.Tensor, cfg):
    b, s, h = xm.shape
    H = cfg.n_heads
    dh = h // H
    c, _ = _causal_conv(xm, p["conv_k"], p["conv_b"])
    c = F.silu(c)
    q = (c @ p["wq"]).reshape(b, s, H, dh)
    k = (c @ p["wk"]).reshape(b, s, H, dh) / math.sqrt(dh)
    v = (xm @ p["wv"]).reshape(b, s, H, dh)
    gates = (c @ p["w_if"]).float()                   # (b, s, 2H)
    return q, k, v, gates[..., :H], gates[..., H:], c


def _mlstm_weights_chunk(q_c, F_c, k, v, F_, i_gate, s: int, q_pos0: int,
                         cq: int) -> torch.Tensor:
    """Stabilised mLSTM mixing for one q-chunk against all keys."""
    # D[i, j] = F_i - F_j + i_j for j <= i
    D = F_c[:, :, None, :] - F_[:, None, :, :] + i_gate[:, None, :, :]
    q_pos = q_pos0 + torch.arange(cq, device=q_c.device)
    causal = q_pos[:, None] >= torch.arange(s, device=q_c.device)[None, :]
    D = torch.where(causal[None, :, :, None], D, -math.inf)
    m = D.amax(dim=2, keepdim=True)
    m = torch.clamp(m, min=-1e30)                     # guard all -inf rows
    decay = torch.exp(D - m)
    scores = torch.einsum("bihd,bjhd->bijh", q_c.float(), k.float())
    w = scores * decay
    denom = torch.maximum(w.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
    return torch.einsum("bijh,bjhd->bihd", w / denom, v.float())


def mlstm_block(p, x: torch.Tensor, cfg, *, return_state: bool = False,
                chunked: bool = False, cq: int = 512):
    """Parallel (quadratic) form; ``chunked`` loops over q-chunks of ``cq``
    (the reference's check: S % cq == 0) so the (S × S) decay matrix never
    materialises."""
    b, s, d = x.shape
    up = x @ p["w_up"]
    xm, z = up.chunk(2, dim=-1)                       # (b, s, h) each
    q, k, v, i_gate, f_gate, _ = _mlstm_qkvif(p, xm, cfg)

    log_f = F.logsigmoid(f_gate)                      # (b, s, H)
    F_ = torch.cumsum(log_f, dim=1)                   # prefix sums
    if chunked and s > cq:
        if s % cq:
            raise ValueError(f"chunked mLSTM needs S % cq == 0, got S {s}, "
                             f"cq {cq}")
        out = torch.cat([
            _mlstm_weights_chunk(q[:, i:i + cq], F_[:, i:i + cq], k, v, F_,
                                 i_gate, s, i, cq)
            for i in range(0, s, cq)], dim=1)
    else:
        out = _mlstm_weights_chunk(q, F_, k, v, F_, i_gate, s, 0, s)
    out = _head_norm(out, p["norm"], cfg.norm_eps)    # (b, s, h)
    out = out + xm * p["skip"]
    out = out * F.silu(z)
    out = _mm(out, p["w_down"])
    if not return_state:
        return out
    # Closed-form final recurrent state (continues decode exactly):
    #   m_S = max_j (F_S - F_j + i_j);  C_S = Σ_j e^{F_S-F_j+i_j-m_S} k_j v_jᵀ
    rel = F_[:, -1:, :] - F_ + i_gate                 # (b, s, H)
    m_S = rel.amax(dim=1)                             # (b, H)
    wts = torch.exp(rel - m_S[:, None, :])            # (b, s, H)
    kf, vf = k.float(), v.float()
    C = torch.einsum("bjhk,bjhl->bhkl", wts[..., None] * kf, vf)
    n = torch.einsum("bjh,bjhk->bhk", wts, kf)
    state = {"C": C, "n": n, "m": m_S,
             "conv": xm[:, -(cfg.conv_width - 1):, :].clone()}
    return out, state


def mlstm_block_decode(p, x: torch.Tensor, state: dict, cfg):
    """Recurrent step. state: C (B,H,dk,dv), n (B,H,dk), m (B,H), conv
    (B,K-1,h)."""
    b = x.shape[0]
    H = cfg.n_heads
    up = x @ p["w_up"]
    xm, z = up.chunk(2, dim=-1)
    h = xm.shape[-1]
    dh = h // H
    c, conv_state = _causal_conv(xm, p["conv_k"], p["conv_b"], state["conv"])
    c = F.silu(c)
    q = (c @ p["wq"]).reshape(b, H, dh)
    k = ((c @ p["wk"]) / math.sqrt(dh)).reshape(b, H, dh).float()
    v = (xm @ p["wv"]).reshape(b, H, dh).float()
    gates = (c @ p["w_if"]).float().reshape(b, 2 * H)
    log_i, log_f = gates[:, :H], F.logsigmoid(gates[:, H:])

    m_new = torch.maximum(log_f + state["m"], log_i)  # (b, H)
    f_sc = torch.exp(log_f + state["m"] - m_new)[..., None]
    i_sc = torch.exp(log_i - m_new)[..., None]
    C = f_sc[..., None] * state["C"] + i_sc[..., None] * (
        k[..., :, None] * v[..., None, :])            # (b,H,dk,dv)
    n = f_sc * state["n"] + i_sc * k
    qf = q.float()
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs()[..., None],
                        torch.exp(-m_new)[..., None])
    out = (num / den).reshape(b, 1, h)
    out = _head_norm(out.reshape(b, 1, H, dh), p["norm"], cfg.norm_eps)
    out = out + xm * p["skip"]
    out = out * F.silu(z)
    new_state = {"C": C, "n": n, "m": m_new, "conv": conv_state}
    return _mm(out, p["w_down"]), new_state


def init_mlstm_state(cfg, batch: int, dtype, device) -> dict:
    H = cfg.n_heads
    h = 2 * cfg.d_model
    dh = h // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, dh, dh), **f32),
        "n": torch.zeros((batch, H, dh), **f32),
        "m": torch.zeros((batch, H), **f32),
        "conv": torch.zeros((batch, cfg.conv_width - 1, h), dtype=dtype,
                            device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_d_ff(d: int) -> int:
    return int(round(4 * d / 3 / 64) * 64) or 64      # pf 4/3, aligned


def init_slstm(generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    d_ff = _slstm_d_ff(d)
    r = torch.randn((4, H, dh, dh), generator=generator, device=device)
    return {
        "w_gates": dense_init(generator, d, 4 * d, dtype, device=device),
        # block-diagonal R: i f z o
        "r_gates": r.mul_(1.0 / math.sqrt(dh)).to(dtype),
        "b_gates": torch.zeros((4 * d,), dtype=dtype, device=device),
        "norm": init_rmsnorm(d, dtype, device),
        "ffn_up": dense_init(generator, d, d_ff, dtype, device=device),
        "ffn_down": dense_init(generator, d_ff, d, dtype,
                               scale=1.0 / math.sqrt(d_ff), device=device),
    }


def _slstm_step(p, carry: tuple, wx: torch.Tensor, cfg) -> tuple:
    """One timestep. carry: (c, n, h, m) each (B, d) fp32; wx: (B, 4d)
    fp32.  ``p`` holds ``r_gates`` and ``b_gates``; :func:`slstm_block`
    hands it their float32 casts, made once for the whole sequence."""
    c, n, h, m = carry
    b, d = c.shape
    H = cfg.n_heads
    dh = d // H
    hh = h.reshape(b, H, dh)
    rec = torch.einsum("bhk,ghkl->gbhl", hh, p["r_gates"].float())
    rec = rec.reshape(4, b, d)
    pre = wx.reshape(b, 4, d).transpose(0, 1) + rec \
        + p["b_gates"].float().reshape(4, d)[:, None, :]
    i_t, f_t, z_t, o_t = pre.unbind(0)
    log_f = F.logsigmoid(f_t)
    m_new = torch.maximum(log_f + m, i_t)
    i_sc = torch.exp(i_t - m_new)
    f_sc = torch.exp(log_f + m - m_new)
    c_new = f_sc * c + i_sc * torch.tanh(z_t)
    n_new = f_sc * n + i_sc
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new)


def _slstm_out(p, h: torch.Tensor, cfg) -> torch.Tensor:
    h = rmsnorm(h, p["norm"], cfg.norm_eps)
    return F.gelu(h @ p["ffn_up"], approximate="tanh") @ p["ffn_down"]


def slstm_block(p, x: torch.Tensor, cfg, *, return_state: bool = False):
    """(B, S, d): the true recurrence, one Python step per token."""
    b, s, d = x.shape
    wx = (x @ p["w_gates"]).float()                   # (b, s, 4d)
    p32 = {"r_gates": p["r_gates"].float(), "b_gates": p["b_gates"].float()}
    zeros = wx.new_zeros((b, d))
    carry = (zeros, zeros, zeros, zeros)
    hs = []
    for t in range(s):
        carry = _slstm_step(p32, carry, wx[:, t], cfg)
        hs.append(carry[2])
    h = torch.stack(hs, dim=1).to(x.dtype)            # (b, s, d)
    y = _slstm_out(p, h, cfg)
    if return_state:
        c, n, hh, m = carry
        return y, {"c": c, "n": n, "h": hh, "m": m}
    return y


def slstm_block_decode(p, x: torch.Tensor, state: dict, cfg):
    """x: (B, 1, d); state: dict of c, n, h, m (B, d)."""
    wx = (x[:, 0] @ p["w_gates"]).float()
    carry = (state["c"], state["n"], state["h"], state["m"])
    c, n, h, m = _slstm_step(p, carry, wx, cfg)
    y = _slstm_out(p, h[:, None].to(x.dtype), cfg)
    return y, {"c": c, "n": n, "h": h, "m": m}


def init_slstm_state(cfg, batch: int, dtype, device) -> dict:
    d = cfg.d_model
    return {name: torch.zeros((batch, d), dtype=torch.float32, device=device)
            for name in ("c", "n", "h", "m")}
