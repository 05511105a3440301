"""Public entry points of attention: the hand-written kernel on CUDA, the
plain version on CPU.

``flash_attention(q, k, v)`` is prefill attention over (B, Hq, Sq, D) queries
and (B, Hkv, Skv, D) keys and values, GQA by ``h // (Hq / Hkv)``, causal and
sliding-window masks.  It pads Sq and Skv to multiples of ``bq`` / ``bkv``
exactly as the reference's wrapper does (``repro/kernels/flash_attention/
ops.py``), runs the kernel (:mod:`.kernel`) on CUDA tensors or the oracle on
the padded inputs (:func:`.ref.attention`) on CPU tensors, and only there,
and slices back to Sq; a strided view is copied into a row-major one
first.  On ``meta`` tensors (a dry run) the forward and the backward
launch nothing: they return empty ``meta`` outputs of the kernel's shapes
and dtypes and add the call's operations (:func:`attention_flops`) to
``flash_attention.meta_flops`` / ``flash_attention_bwd.meta_flops``.  The padding keeps a quirk of the reference: padded
keys are zeros that only the causal mask hides, so non-causal windowed
attention over a ragged Skv attends to them (ROADMAP Queue 3); non-causal
unwindowed attention refuses to pad.  ``backend="plain"`` asks for the
oracle on the unpadded inputs on any device (the reference's
``backend="xla"``).  It counts its launches in ``flash_attention.launches``
and each launch's route in ``flash_attention.routes`` (route name ->
launches): the route the built launcher reports for the very operands it
is handed, which must be the one :func:`route` gives them.

It is differentiable in q, k and v (:class:`_Attention`, around the padded
call): the backward is :func:`flash_attention_bwd`, the hand-written
backward kernel (``csrc/flash_attention_bwd.cu``, routes :data:`BWD_ROUTES`,
counted in ``flash_attention_bwd.launches`` / ``routes``) on the card and
its plain versions on the CPU.  A call that records a gradient asks the
forward for each row's log-sum-exp, which the tensor-core routes
(``bf16_wgmma``, ``f16_wgmma``, ``f32_3xtf32``; on the CPU
:func:`.ref.attention_lse`) hand back; the backward's tensor-core routes of
the same names
(:func:`bwd_route`) read it.  The reference has no backward kernel: it
differentiates its oracle with XLA.

:func:`route` says which loop a launch takes (``csrc/flash_attention.cu``
is the same rule in C, and :func:`.kernel.launcher_route` asks the built
library, as the wrapper does before every launch): float32 on the tensor
cores in 3xTF32 (``f32_3xtf32``) when the head dim is one of
:data:`TF32_HEAD_DIMS` (32, 64, 80, 96, 128: whole 32-column panels, or a
last panel of 16 real columns; 256 on blocks of its own) and q, k, v and
out are 16-byte aligned,
else on the CUDA cores (``f32_simt``); bfloat16 on the tensor cores (``bf16_wgmma``: ``wgmma``
fed by TMA) when the head dim is one of :data:`WGMMA_HEAD_DIMS` (64, 80,
96, 128, 192, 256: whole 64-column panels, or a last panel of 16 / 32
real columns over TMA's zero fill) and the operands are 16-byte aligned,
else on the CUDA cores (``bf16_simt``); float16 by the same rule on the
same tensor-core loop instantiated for it (``f16_wgmma``), else on the
CUDA cores (``f16_simt``).  Qwen3-14B (d 128), h2o-danube (d 80) and
Phi-3-vision (d 96) take ``f32_3xtf32``, ``bf16_wgmma`` and ``f16_wgmma``;
so do RecurrentGemma-9B and Gemma-7B (d 256).  No model runs float16 (its
configurations give bf16 or f32); every entry point takes it, as the
reference's do.

``attn_step(o, q, k, v)`` is the executor-callable block accumulation ``o ←
o + softmax(q kᵀ / √d) v``, tagged ``"dot"`` so a fused chain of it runs as
one chain kernel (:func:`repro_torch.kernels.chain.chain_attn`).  On
operands that kernel takes it runs it with one level (the kernel on the
card, its plain version on the CPU), so per-level replay and a whole chain
agree bit for bit (a 2-D tile of a chain kernel dtype that is not
contiguous is copied into a row-major one first); on any others (NumPy
tiles, batched shapes, float16) it computes the reference's expression as
jax does (:func:`step_body`, which counts its calls in
``step_body.calls``): NumPy operands give a CPU tensor, as the
reference's give a jax array.
``__bind_vmap__ = False``: a kernel cannot read a ``torch.func.vmap``-batched
tensor, so the fused backend runs it per op without stacking.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compat import jax_matmul, jax_operands
from repro_torch.core.trace import In, InOut

from .. import count_body, count_launch, count_meta, row_major
from . import kernel, ref

DTYPES = tuple(kernel.SUFFIX)
BACKENDS = ("cuda", "plain")
# the card launches the kernel, the host computes its plain version, meta
# tensors (a dry run) get their shapes and operations counted
DEVICES = ("cpu", "cuda", "meta")
# the routes, in the order of the Route enum of csrc/flash_attention.cu
ROUTES = ("f32_simt", "bf16_simt", "bf16_wgmma", "f32_3xtf32", "f16_simt",
          "f16_wgmma")
# the backward's routes, in the order of the Route enum of
# csrc/flash_attention_bwd.cu
BWD_ROUTES = ("f32_simt", "bf16_simt", "f16_simt", "bf16_wgmma",
              "f32_3xtf32", "f16_wgmma")
# the head dims of the bf16 and f16 tensor-core routes, forward and
# backward (wgmma_head_dim of csrc/attn_wgmma.cuh)
WGMMA_HEAD_DIMS = (64, 80, 96, 128, 192, 256)
# the head dims of both float32 tensor-core routes (tf32_head_dim of
# csrc/attn_tf32.cuh)
TF32_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
# the routes whose forward hands back a log-sum-exp and whose backward
# reads it
LSE_ROUTES = ("bf16_wgmma", "f32_3xtf32", "f16_wgmma")
# the 16-bit dtypes' tensor-core and CUDA-core routes
WGMMA_ROUTES = {torch.bfloat16: ("bf16_wgmma", "bf16_simt"),
                torch.float16: ("f16_wgmma", "f16_simt")}


def route(dtype: torch.dtype, d: int, addresses=()) -> str:
    """The route of a call with head dim ``d`` on operands of ``dtype``
    whose q, k, v and out start at ``addresses`` (device byte addresses):
    float32 goes to the tensor cores in 3xTF32 when d is one of
    :data:`TF32_HEAD_DIMS` and every address is 16-byte aligned, bfloat16
    and float16 when d is one of :data:`WGMMA_HEAD_DIMS` and TMA can read
    every operand (each address 16-byte aligned); every other call stays
    on the CUDA cores of its dtype."""
    aligned = all(int(x) % 16 == 0 for x in addresses)
    if dtype == torch.float32:
        tf32 = d in TF32_HEAD_DIMS and aligned
        return "f32_3xtf32" if tf32 else "f32_simt"
    if dtype not in WGMMA_ROUTES:
        raise TypeError(f"no attention route for dtype {dtype}")
    wgmma, simt = WGMMA_ROUTES[dtype]
    return wgmma if d in WGMMA_HEAD_DIMS and aligned else simt


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for t in (q, k, v):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in DTYPES:
            raise TypeError(f"dtype {t.dtype} is not supported; expected one "
                            f"of {DTYPES}")
        if t.dtype != q.dtype:
            raise TypeError(f"mixed dtypes {q.dtype} and {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
        if t.dim() != 4:
            raise ValueError(f"expected (B, H, S, D) tensors, got shape "
                             f"{tuple(t.shape)}")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit together")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"{hq} query heads over {k.shape[1]} kv heads")
    if d > kernel.MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {kernel.MAX_HEAD_DIM}")
    if q.device.type not in DEVICES:
        raise ValueError(f"unsupported device {q.device}")


def visible_pairs(sq: int, skv: int, *, causal: bool, window) -> int:
    """The (query row, key) pairs :func:`.ref.mask` lets through: the
    score products a call's kernel computes for each (batch, query
    head)."""
    r = np.arange(sq, dtype=np.int64)
    hi = np.minimum(r, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(r - window + 1, 0) if window is not None else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_flops(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                    window, backward: bool = False) -> int:
    """The operations of one call on ``q`` (B, Hq, Sq, D) over ``k``, as
    ``chip_smoke.py``'s bounds count them: ``4 B Hq D`` a visible pair for
    the forward (two products), ``10 B Hq D`` for the backward (five)."""
    b, hq, sq, d = q.shape
    per = 10 if backward else 4
    return per * b * hq * d * visible_pairs(sq, k.shape[2], causal=causal,
                                            window=window)


def pad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
        window, bq: int, bkv: int):
    """Zero-pad Sq to a multiple of ``min(bq, Sq)`` and Skv to one of
    ``min(bkv, Skv)``, as the reference's wrapper does."""
    sq, skv = q.shape[2], k.shape[2]
    pq = (-sq) % max(1, min(bq, sq))
    pkv = (-skv) % max(1, min(bkv, skv))
    if pq:
        q = F.pad(q, (0, 0, 0, pq))
    if pkv:
        if not causal and window is None:
            raise ValueError("non-causal attention requires Skv % bkv == 0")
        k = F.pad(k, (0, 0, 0, pkv))
        v = F.pad(v, (0, 0, 0, pkv))
    return q, k, v


def _route_taken(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor) -> str:
    """The route the built launcher takes for these operands, held against
    :func:`route` on the same addresses: a library and a mirror that
    disagree raise before anything is launched."""
    d = q.shape[3]
    addresses = [t.data_ptr() for t in (q, k, v, out)]
    taken = ROUTES[kernel.launcher_route(q.dtype, *addresses, d)]
    want = route(q.dtype, d, addresses)
    if taken != want:
        raise RuntimeError(f"flash attention: the launcher takes {taken} "
                           f"where ops.route says {want} (d {d}, "
                           f"addresses {addresses})")
    return taken


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, scale=None,
                    bq: int = 512, bkv: int = 512,
                    backend: str = "cuda") -> torch.Tensor:
    """(B, Hq, Sq, D) × (B, Hkv, Skv, D)² → (B, Hq, Sq, D), differentiable
    in q, k and v (:class:`_Attention`)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    q, k, v = row_major(DTYPES, q, k, v)
    _check(q, k, v)
    if backend == "plain":
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale)
    sq = q.shape[2]
    scale = q.shape[3] ** -0.5 if scale is None else scale
    q, k, v = pad(q, k, v, causal=causal, window=window, bq=bq, bkv=bkv)
    record = torch.is_grad_enabled() and any(t.requires_grad
                                             for t in (q, k, v))
    out = _Attention.apply(q, k, v, causal, window, scale, record)
    return out[:, :, :sq, :]


flash_attention.launches = 0
flash_attention.routes = {}
flash_attention.meta_flops = 0


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window, scale: float, lse: bool) -> tuple:
    """``(out, lse)``: attention of the padded, checked operands, the
    kernel on CUDA tensors (counted in ``flash_attention.launches`` /
    ``routes``), the oracle on CPU tensors; and, when ``lse`` asks for it
    and the route hands it back (:data:`LSE_ROUTES`;
    :func:`.ref.attention_lse` on the CPU), each row's log-sum-exp, (B, Hq,
    Sq) float32, else None."""
    if q.device.type == "cpu":
        if lse:
            return ref.attention_lse(q, k, v, causal=causal, window=window,
                                     scale=scale)
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale), None
    if q.device.type == "meta":
        # a dry run: the shapes the kernel's route would give, nothing
        # launched, its operations counted
        count_meta(flash_attention, attention_flops(
            q, k, causal=causal, window=window))
        rows = (torch.empty(q.shape[:3], dtype=torch.float32, device="meta")
                if lse and route(q.dtype, q.shape[3]) in LSE_ROUTES
                else None)
        return torch.empty_like(q), rows
    out = torch.empty_like(q)
    rows = None
    if out.numel():
        path = _route_taken(q, k, v, out)
        if lse and path in LSE_ROUTES:
            rows = torch.empty(q.shape[:3], dtype=torch.float32,
                               device=q.device)
        kernel.launch(q, k, v, out, causal=causal, window=window,
                      scale=scale, lse=rows)
        count_launch(flash_attention, path)
    return out, rows


class _Attention(torch.autograd.Function):
    """Attention of the padded operands with its gradient: the forward is
    :func:`_attend` (the kernel on the card), asked for each row's
    log-sum-exp when the call records a gradient (``record``); it saves q,
    k, v, the output and that log-sum-exp (None where the route gave
    none), and the backward is :func:`flash_attention_bwd` (the backward
    kernel on the card, its plain versions on the CPU).  The reference has
    no kernel here: it differentiates its oracle with XLA's autodiff
    (ROADMAP Queue 3)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, record):
        out, lse = _attend(q, k, v, causal=causal, window=window,
                           scale=scale, lse=record)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse=lse,
                                         causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None, None


def bwd_route(dtype: torch.dtype, d: int, addresses=()) -> str:
    """The route of the backward kernel at head dim ``d`` on operands of
    ``dtype`` whose q, k, v, out, dout and saved log-sum-exp start at
    ``addresses`` (device byte addresses; the log-sum-exp's 0 or None
    where the forward saved none; empty: all aligned, a log-sum-exp
    saved): bfloat16 and float16 go to the tensor cores (``bf16_wgmma``,
    ``f16_wgmma``) when d is one of :data:`WGMMA_HEAD_DIMS`, float32
    (``f32_3xtf32``) when d is one of :data:`TF32_HEAD_DIMS`, each when
    every address is 16-byte aligned and the forward saved its
    log-sum-exp; every other call takes the CUDA cores of its dtype
    (``csrc/flash_attention_bwd.cu`` ``route_of`` is the same rule in
    C)."""
    if dtype not in DTYPES:
        raise TypeError(f"no attention backward route for dtype {dtype}")
    if not 0 < d <= kernel.MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside 1..{kernel.MAX_HEAD_DIM}")
    addresses = tuple(addresses)
    saved = not addresses or (len(addresses) == 6 and bool(addresses[5]))
    aligned = all(int(x or 0) % 16 == 0 for x in addresses)
    if saved and aligned:
        if dtype in WGMMA_ROUTES and d in WGMMA_HEAD_DIMS:
            return WGMMA_ROUTES[dtype][0]
        if dtype == torch.float32 and d in TF32_HEAD_DIMS:
            return "f32_3xtf32"
    return BWD_ROUTES[kernel.DTYPE_CODES[dtype]]


def _bwd_addresses(q, k, v, out, dout, lse) -> tuple:
    return tuple(t.data_ptr() for t in (q, k, v, out, dout)) + (
        0 if lse is None else lse.data_ptr(),)


def _bwd_route_taken(dtype: torch.dtype, d: int, addresses) -> str:
    """The route the built backward library takes for operands at
    ``addresses`` (:func:`bwd_route`'s), held against :func:`bwd_route`: a
    library and a mirror that disagree raise before anything is
    launched."""
    index = kernel.bwd_launcher_route(dtype, d, addresses)
    taken = BWD_ROUTES[index] if 0 <= index < len(BWD_ROUTES) else None
    want = bwd_route(dtype, d, addresses)
    if taken != want:
        raise RuntimeError(f"attention backward: the launcher takes {taken} "
                           f"where ops.bwd_route says {want} (d {d}, "
                           f"addresses {addresses})")
    return taken


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        lse: torch.Tensor | None = None,
                        causal: bool = True, window=None,
                        scale=None) -> tuple:
    """(dq, dk, dv) of attention of ``q`` (B, Hq, Sq, D) over ``k``, ``v``
    (B, Hkv, Skv, D), given its output ``out``, the output's gradient
    ``dout`` and, where the forward saved it, each row's log-sum-exp
    ``lse`` ((B, Hq, Sq) float32), each gradient in its operand's dtype.
    The operands are the padded ones the forward ran on (:func:`pad`):
    this is the gradient of the padded function, whose padding rows the
    caller's slice cuts.

    On CUDA tensors the backward kernel of :func:`bwd_route` (counted as
    one call in ``flash_attention_bwd.launches`` and by route in
    ``flash_attention_bwd.routes``: the built library's route, held
    against :func:`bwd_route`): ``bf16_wgmma``, ``f16_wgmma`` and
    ``f32_3xtf32`` read ``lse``, the CUDA-core routes sweep the keys for
    it.  On CPU tensors
    the plain version of the route the same call takes on the card, and
    only there: :func:`.ref.attention_grad_lse` for :data:`LSE_ROUTES`,
    :func:`.ref.attention_grad` for the others.
    """
    q, k, v, out, dout = row_major(DTYPES, q, k, v, out, dout)
    _check(q, k, v)
    for t in (out, dout):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"out and dout must be {q.dtype} tensors of "
                             f"q's shape {tuple(q.shape)} on {q.device}, "
                             f"got {t.dtype}{tuple(t.shape)} on {t.device}")
    if lse is not None and (lse.shape != q.shape[:3]
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 tensor of shape "
                         f"{tuple(q.shape[:3])} on {q.device}, got "
                         f"{lse.dtype}{tuple(lse.shape)} on {lse.device}")
    scale = q.shape[3] ** -0.5 if scale is None else scale
    addresses = _bwd_addresses(q, k, v, out, dout, lse)
    if q.device.type == "cpu":
        if lse is not None and bwd_route(q.dtype, q.shape[3],
                                         addresses) in LSE_ROUTES:
            return ref.attention_grad_lse(q, k, v, out, dout, lse,
                                          causal=causal, window=window,
                                          scale=scale)
        return ref.attention_grad(q, k, v, dout, causal=causal,
                                  window=window, scale=scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.device.type == "meta":
        count_meta(flash_attention_bwd, attention_flops(
            q, k, causal=causal, window=window, backward=True))
        return dq, dk, dv
    if q.numel() and k.numel():
        taken = _bwd_route_taken(q.dtype, q.shape[3], addresses)
        kernel.launch_bwd(q, k, v, out, dout, dq, dk, dv, causal=causal,
                          window=window, scale=scale,
                          lse=lse if taken in LSE_ROUTES else None)
        count_launch(flash_attention_bwd, taken)
    else:
        for t in (dq, dk, dv):
            t.zero_()
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = {}
flash_attention_bwd.meta_flops = 0


_ONE_LEVEL = ("single",) * 4


def attn_step(o, q, k, v):
    """One block-accumulation level: ``o ← o + softmax(q kᵀ / √d) v``.

    Operands the chain kernel takes (its own rule,
    :func:`repro_torch.kernels.chain.ops.attn_problem`, once 2-D tiles of
    its dtypes are row-major) run it with one level; any others get the
    reference's own expression, decided before any launch:
    :func:`step_body`.
    """
    # imported here: the chain package imports this module's plain version
    # (.ref) while it loads
    from ..chain.ops import DTYPES as CHAIN_DTYPES
    from ..chain.ops import attn_problem, chain_attn

    o, q, k, v = row_major(CHAIN_DTYPES, o, q, k, v)
    if attn_problem(_ONE_LEVEL, 0, 1, (o, q, k, v)) is None:
        return chain_attn(_ONE_LEVEL, 0, 1, o, q, k, v)
    return step_body(o, q, k, v)


def step_body(o, q, k, v):
    """The reference's body (``repro/kernels/flash_attention/ops.py:71``)
    as jax computes it: the logits ``(q @ k.T) / √d`` (in NumPy when q and
    k are NumPy), then ``jax.nn.softmax``, which hands back a jax array,
    32-bit for a 64-bit NumPy input; ``o + p @ v`` follows jax's promotion.
    A ``jax.Array`` is a ``torch.Tensor`` here
    (:func:`repro_torch.compat.jax_operands`): on NumPy payloads the result
    is a CPU tensor, float32 for float64 ones.  Counts its calls in
    ``calls``."""
    count_body(step_body)
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    if isinstance(q, np.ndarray) and isinstance(k, np.ndarray):
        logits = (q @ k.T) * scale
        logits, o, v = jax_operands(logits, o, v)
    else:
        o, q, k, v = jax_operands(o, q, k, v)
        logits = jax_matmul(q, k.permute(*range(k.dim() - 1, -1, -1))) * scale
    return o + jax_matmul(torch.softmax(logits, dim=-1), v)


step_body.calls = 0
attn_step.__bind_intents__ = (InOut, In, In, In)
attn_step.__bind_kernel__ = "dot"
attn_step.__bind_vmap__ = False
