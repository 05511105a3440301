"""RecurrentGemma's recurrent block: causal conv1d + RG-LRU (Griffin) —
``repro/models/recurrent.py`` in PyTorch.

The prefill form runs the RG-LRU recurrence through the port's
linear-scan entry point
(:func:`repro_torch.kernels.linear_scan.ops.linear_scan`: the
hand-written kernel on the card, its plain loop on the CPU), where the
reference calls its oracle ``kernels.linear_scan.ref.linear_scan``; both
take ``a`` and the gated input in float32.  The entry point is
differentiable: its backward is one more scan, over the reversed
sequence, on the same kernel.  Decode carries an O(1) state
and takes the single step ``a * h + x`` in plain PyTorch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.linear_scan.ref import linear_scan_chunked

from .layers import dense_init

_C_FACTOR = 8.0  # Griffin's fixed recurrence sharpness


def init_recurrent(generator, cfg, dtype, device) -> dict:
    d, w = cfg.d_model, cfg.lru_width_
    # Λ init so that a = sigmoid(Λ)^(8r) starts near 0.9..0.999 (Griffin A.2)
    u = torch.rand((w,), generator=generator, device=device) * 0.099 + 0.9
    root = u ** (1.0 / _C_FACTOR)
    lam = torch.log(root / (1 - root))
    conv_k = torch.randn((cfg.conv_width, w), generator=generator,
                         device=device)
    return {
        "w_x": dense_init(generator, d, w, dtype, device=device),
        "w_y": dense_init(generator, d, w, dtype, device=device),
        "conv_k": conv_k.mul_(1.0 / math.sqrt(cfg.conv_width)).to(dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "w_rg": dense_init(generator, w, w, dtype, device=device),
        "w_ig": dense_init(generator, w, w, dtype, device=device),
        "lam": lam.float(),
        "w_out": dense_init(generator, w, d, dtype, scale=1.0 / math.sqrt(w),
                            device=device),
    }


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv, width K. x: (B, S, w); state: (B, K-1, w)."""
    k = kernel.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S+K-1, w)
    out = sum(xp[:, i:i + x.shape[1], :] * kernel[i] for i in range(k))
    # a copy: a view would keep the whole (B, S+K-1, w) input alive
    new_state = xp[:, -(k - 1):, :].clone()
    return out + bias, new_state


def _rg_lru_gates(p, u: torch.Tensor):
    r = torch.sigmoid(u @ p["w_rg"])
    i = torch.sigmoid(u @ p["w_ig"])
    log_a = -_C_FACTOR * F.softplus(p["lam"]) * r.float()
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (i * u).float()
    return a, gated


def recurrent_block(p, x: torch.Tensor, cfg, *, return_state: bool = False,
                    meter: bool = False):
    """(B, S, d) -> (B, S, d), parallel (prefill) form.  ``meter`` runs
    the scan's plain chunked version (:func:`.linear_scan_chunked`, whose
    ops grow by the chunk, not by the step) instead of the kernel."""
    xb = x @ p["w_x"]
    yb = F.gelu(x @ p["w_y"], approximate="tanh")
    u, conv_state = _causal_conv(xb, p["conv_k"], p["conv_b"])
    a, gated = _rg_lru_gates(p, u)
    h = linear_scan_chunked(a, gated) if meter else linear_scan(a, gated)
    out = (h.to(x.dtype) * yb) @ p["w_out"]
    if return_state:
        return out, {"conv": conv_state, "h": h[:, -1, :].clone()}
    return out


def recurrent_block_decode(p, x: torch.Tensor, state: dict, cfg
                           ) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d); state: {"conv": (B, K-1, w), "h": (B, w)}."""
    xb = x @ p["w_x"]
    yb = F.gelu(x @ p["w_y"], approximate="tanh")
    u, conv_state = _causal_conv(xb, p["conv_k"], p["conv_b"], state["conv"])
    a, gated = _rg_lru_gates(p, u)
    h = a[:, 0] * state["h"] + gated[:, 0]          # single step
    out = (h[:, None, :].to(x.dtype) * yb) @ p["w_out"]
    return out, {"conv": conv_state, "h": h}


def init_recurrent_state(cfg, batch: int, dtype, device) -> dict:
    w = cfg.lru_width_
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }
