"""Plain PyTorch versions of the attention kernels.

:func:`attention` is the oracle of ``repro/kernels/flash_attention/ref.py``:
materialised float32 scores, ``-1e30`` masking, zeros for a row that sees
no key, the result in ``q.dtype``.  It loops over batches and query heads,
so at most one ``(Sq, Skv)`` score matrix lives at a time (268 MB at S =
8192).  Applied to the padded inputs the kernel takes, it is the kernel's
plain version: :func:`.ops.flash_attention` calls it so on CPU tensors, and
``chip_smoke.py`` holds the kernel against it so on the card.

:func:`attention_grad` is the gradient of :func:`attention` as autograd
through it forms it (softmax's backward ``p (dp - sum(p dp))``), in
float32 with the heads of a GQA group summed in float32: the backward
kernel's plain version (``csrc/flash_attention_bwd.cu``), which
:func:`.ops.flash_attention_bwd` calls on CPU tensors.

:func:`attention_lse` is :func:`attention` with each row's log-sum-exp of
its scaled, masked scores beside it (+inf for a row that sees no key), the
plain version of the forward's ``bf16_wgmma`` route when it hands the
backward its log-sum-exp; :func:`attention_grad_lse` is the gradient
formed from that log-sum-exp and the stored output as the backward's
``bf16_wgmma`` route forms it (``csrc/attn_bwd_wgmma.cuh``), its plain
version.  On the card the path calls neither: the tests and
``chip_smoke.py`` do.

:func:`attn_step` is one level of the chain body ``o + softmax(q kᵀ / √d)
v`` in the accumulator type (float32 for float32 and bfloat16, float64 for
float64), the carry rounded to its dtype: the plain version of one level
of ``chain_attn``.
"""

from __future__ import annotations

import torch

from ..gemm.ref import acc_dtype

NEG_INF = -1e30


def mask(sq: int, skv: int, *, causal: bool, window, device) -> torch.Tensor:
    """``(sq, skv)`` booleans: which keys each query row sees (positions
    from 0 for both, top-left aligned)."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    seen = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        seen &= q_pos >= k_pos
    if window is not None:
        seen &= (q_pos - k_pos) < window
    return seen


def _attention(q, k, v, *, causal, window, scale, with_lse: bool):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    seen = mask(sq, skv, causal=causal, window=window, device=q.device)
    any_seen = seen.any(dim=-1, keepdim=True)
    if q.device.type == "meta":
        # shapes only (a dry run): no score matrix to bound, so every
        # (batch, head) in one product: the same products, as many
        # operations as the loop below
        kk = k.float().repeat_interleave(group, dim=1)
        s = torch.matmul(q.float(), kk.transpose(-1, -2)) * scale
        s = torch.where(seen, s, NEG_INF)
        p = torch.where(any_seen, torch.softmax(s, dim=-1), 0.0)
        out = torch.matmul(p, v.float().repeat_interleave(group, dim=1))
        lse = (torch.where(any_seen[:, 0], torch.logsumexp(s, dim=-1),
                           float("inf")) if with_lse else None)
        return out.to(q.dtype), lse
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    for bi in range(b):
        for h in range(hq):
            kk = k[bi, h // group].float()
            s = (q[bi, h].float() @ kk.T) * scale
            s = torch.where(seen, s, NEG_INF)
            p = torch.where(any_seen, torch.softmax(s, dim=-1), 0.0)
            out[bi, h] = (p @ v[bi, h // group].float()).to(q.dtype)
            if with_lse:
                lse[bi, h] = torch.where(any_seen[:, 0],
                                         torch.logsumexp(s, dim=-1),
                                         float("inf"))
    return out, lse


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window=None,
              scale=None) -> torch.Tensor:
    """(B, Hq, Sq, D) × (B, Hkv, Skv, D)² → (B, Hq, Sq, D)."""
    return _attention(q, k, v, causal=causal, window=window, scale=scale,
                      with_lse=False)[0]


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window=None, scale=None) -> tuple:
    """``(out, lse)``: :func:`attention`'s output and each row's log-sum-exp
    of its scaled, masked scores, (B, Hq, Sq) float32, +inf for a row that
    sees no key."""
    return _attention(q, k, v, causal=causal, window=window, scale=scale,
                      with_lse=True)


def attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor, *, causal: bool = True, window=None,
                   scale=None) -> tuple:
    """(dq, dk, dv) of :func:`attention` at ``q``, ``k``, ``v`` for the
    output gradient ``dout``, each in its operand's dtype: per (batch,
    query head) p as the oracle forms it, dp = dout v^T, ds = p (dp -
    sum(p dp)), zero on masked keys and on rows that see no key; dq =
    (ds scale) k, and (ds scale)^T q and p^T dout summed into dk and dv
    over the group's heads, all in float32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    seen = mask(sq, skv, causal=causal, window=window, device=q.device)
    any_seen = seen.any(dim=-1, keepdim=True)
    f32 = torch.float32
    dq = torch.empty(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=q.device)
    dv = torch.zeros(v.shape, dtype=f32, device=q.device)
    for bi in range(b):
        for h in range(hq):
            qq, g = q[bi, h].float(), dout[bi, h].float()
            kk, vv = k[bi, h // group].float(), v[bi, h // group].float()
            s = torch.where(seen, (qq @ kk.T) * scale, NEG_INF)
            p = torch.where(any_seen, torch.softmax(s, dim=-1), 0.0)
            dp = g @ vv.T
            ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
            ds = torch.where(seen, ds, 0.0) * scale
            dq[bi, h] = ds @ kk
            dk[bi, h // group] += ds.T @ qq
            dv[bi, h // group] += p.T @ g
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_grad_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, dout: torch.Tensor,
                       lse: torch.Tensor, *, causal: bool = True,
                       window=None, scale=None) -> tuple:
    """(dq, dk, dv) from the forward's output ``out`` and log-sum-exp
    ``lse`` (:func:`attention_lse`), each in its operand's dtype: per
    (batch, query head) p = exp(s scale - lse), zero on masked keys (and
    so on rows that see no key, whose lse is +inf), delta = sum_c dout_c
    out_c, dp = dout v^T, ds = p (dp - delta); then the sums of
    :func:`attention_grad`, all in float32."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    seen = mask(sq, skv, causal=causal, window=window, device=q.device)
    f32 = torch.float32
    dq = torch.empty(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=q.device)
    dv = torch.zeros(v.shape, dtype=f32, device=q.device)
    for bi in range(b):
        for h in range(hq):
            qq, g = q[bi, h].float(), dout[bi, h].float()
            kk, vv = k[bi, h // group].float(), v[bi, h // group].float()
            p = torch.where(seen, torch.exp((qq @ kk.T) * scale
                                            - lse[bi, h, :, None]), 0.0)
            delta = (g * out[bi, h].float()).sum(dim=-1, keepdim=True)
            ds = p * (g @ vv.T - delta) * scale
            dq[bi, h] = ds @ kk
            dk[bi, h // group] += ds.T @ qq
            dv[bi, h // group] += p.T @ g
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attn_step(o: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``o + softmax(q kᵀ / √d) v`` in the accumulator type, cast to
    ``o.dtype``."""
    acc = acc_dtype(o.dtype)
    d = q.shape[-1]
    s = torch.softmax((q.to(acc) @ k.to(acc).T) * (1.0 / float(d) ** 0.5),
                      dim=-1)
    return (o.to(acc) + s @ v.to(acc)).to(o.dtype)
