"""Build and bind the flash-attention kernel (``csrc/flash_attention.cu``)
and its backward (``csrc/flash_attention_bwd.cu``, a library of its own so
that the forward's build and bits stay as they were, with its tensor-core
routes in ``csrc/attn_bwd_wgmma.cuh`` (bf16 and f16) and
``csrc/attn_bwd_tf32.cuh`` (float32 in 3xTF32), and the masks they share in
``csrc/attn_mask.cuh``).

Built at first use through the shared :mod:`repro_torch.kernels._build`
helper, with the CUDA-core tile loop it shares with the chain kernel
(``csrc/attn_tile.cuh``), the tensor-core loops of the ``bf16_wgmma`` and
``f16_wgmma`` routes (``csrc/attn_wgmma.cuh``, one loop templated on the
element type) and of the ``f32_3xtf32`` route (``csrc/attn_tf32.cuh``), and
the GEMM headers they draw on (conversions, the TMA and ``wgmma`` helpers,
the TF32 rounding).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaLibrary

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "flash_attention.cu",)
HEADERS = (_HERE / "csrc" / "attn_tile.cuh",
           _HERE / "csrc" / "attn_wgmma.cuh",
           _HERE / "csrc" / "attn_tf32.cuh",
           _HERE / "csrc" / "attn_tf32_wide.cuh",
           _HERE.parent / "gemm" / "csrc" / "gemm_tile.cuh",
           _HERE.parent / "gemm" / "csrc" / "gemm_wgmma.cuh",
           _HERE.parent / "gemm" / "csrc" / "tf32.cuh")

SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float16: "f16"}
# torch dtype -> the element-type code of bind_flash_attention_route
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256          # bind_attn::MAX_HEAD_DIM of attn_tile.cuh

_P, _I, _I64, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_double)
_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _D, _I, _I,
         _I64, _P)

# which route (an index of ops.ROUTES) a call takes:
# (element-type code, q, k, v, out, d)
ROUTE_SYMBOL = "bind_flash_attention_route"
_ROUTE_ARGS = (_I, _P, _P, _P, _P, _I64)

# the bf16, f16 and f32 forwards that also store each row's log-sum-exp:
# (q, k, v, out, lse, batch, ...) as _ARGS
LSE_SYMBOL = "bind_flash_attention_bf16_lse"
F16_LSE_SYMBOL = "bind_flash_attention_f16_lse"
F32_LSE_SYMBOL = "bind_flash_attention_f32_lse"
LSE_SYMBOLS = {torch.bfloat16: LSE_SYMBOL, torch.float16: F16_LSE_SYMBOL,
               torch.float32: F32_LSE_SYMBOL}
_LSE_ARGS = _ARGS[:4] + (_P,) + _ARGS[4:]

LIBRARY = CudaLibrary("bind_flash_attention", SOURCES, HEADERS,
                      {**{f"bind_flash_attention_{s}": _ARGS
                          for s in SUFFIX.values()},
                       **{sym: _LSE_ARGS for sym in LSE_SYMBOLS.values()},
                       ROUTE_SYMBOL: _ROUTE_ARGS})


# the backward's CUDA-core routes: (q, k, v, out, dout, dq, dk, dv, lse,
# delta, batch, hq, hkv, sq, skv, d, scale, causal, windowed, window,
# stream), lse and delta scratch
BWD_SOURCES = (_HERE / "csrc" / "flash_attention_bwd.cu",)
BWD_HEADERS = (_HERE / "csrc" / "attn_bwd_wgmma.cuh",
               _HERE / "csrc" / "attn_mask.cuh",
               _HERE / "csrc" / "attn_bwd_tf32.cuh",
               _HERE / "csrc" / "attn_bwd_tf32_wide.cuh",
               _HERE / "csrc" / "attn_tf32.cuh",
               _HERE / "csrc" / "attn_tf32_wide.cuh",
               _HERE / "csrc" / "attn_wgmma.cuh",
               _HERE / "csrc" / "attn_tile.cuh",
               _HERE.parent / "gemm" / "csrc" / "gemm_tile.cuh",
               _HERE.parent / "gemm" / "csrc" / "gemm_wgmma.cuh",
               _HERE.parent / "gemm" / "csrc" / "tf32.cuh")
_BWD_ARGS = (_P,) * 10 + (_I64,) * 6 + (_D, _I, _I, _I64, _P)
# its tensor-core routes: (q, k, v, out, dout, dq, dk, dv, lse, delta,
# part, batch, hq, hkv, sq, skv, d, scale, causal, windowed, window, groups,
# stream), lse the forward's, delta and part scratch; bf16 and f16 (the
# same kernels of another element type)
BWD_LSE_SYMBOL = "bind_flash_attention_bwd_bf16_lse"
BWD_F16_LSE_SYMBOL = "bind_flash_attention_bwd_f16_lse"
_BWD_LSE_ARGS = (_P,) * 11 + (_I64,) * 6 + (_D, _I, _I, _I64, _I64, _P)
# the float32 tensor-core route (3xTF32): _BWD_LSE_ARGS, lse the forward's,
# part and groups the head groups of d 256 (one, and no scratch, below)
BWD_F32_LSE_SYMBOL = "bind_flash_attention_bwd_f32_lse"
BWD_LSE_SYMBOLS = {torch.bfloat16: BWD_LSE_SYMBOL,
                   torch.float16: BWD_F16_LSE_SYMBOL,
                   torch.float32: BWD_F32_LSE_SYMBOL}
# which route (an index of ops.BWD_ROUTES) a backward takes: (element-type
# code, d, q, k, v, out, dout, lse)
BWD_ROUTE_SYMBOL = "bind_flash_attention_bwd_route"
_BWD_ROUTE_ARGS = (_I, _I64) + (_P,) * 6
BWD_LIBRARY = CudaLibrary("bind_flash_attention_bwd", BWD_SOURCES,
                          BWD_HEADERS,
                          {**{f"bind_flash_attention_bwd_{s}": _BWD_ARGS
                              for s in SUFFIX.values()},
                           **{sym: _BWD_LSE_ARGS
                              for sym in BWD_LSE_SYMBOLS.values()},
                           BWD_ROUTE_SYMBOL: _BWD_ROUTE_ARGS})
# keys of a block of the tensor-core routes' dk/dv kernels
# (attn_bwd_wgmma.cuh BIG; attn_bwd_tf32_wide.cuh OWN, d 256)
BWD_KEY_BLOCK = 128
BWD_TF32_KEY_BLOCK = 64


def _mask_args(causal: bool, window) -> tuple:
    return (int(causal), int(window is not None),
            0 if window is None else int(window))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, window, scale: float,
           lse: torch.Tensor | None = None) -> None:
    """Enqueue attention of ``q`` (B, Hq, Sq, D) over ``k``, ``v`` (B, Hkv,
    Skv, D) into ``out`` on the current stream; given ``lse``, a (B, Hq,
    Sq) float32 buffer, also each row's log-sum-exp there (the tensor-core
    routes only, ``bf16_wgmma``, ``f16_wgmma`` and ``f32_3xtf32``: the
    library refuses it on any other).

    The caller (:mod:`.ops`) has checked every operand.  Does not
    synchronise; raises when the launch is refused.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if lse is None:
        symbol = f"bind_flash_attention_{SUFFIX[q.dtype]}"
    else:
        symbol, ptrs = LSE_SYMBOLS[q.dtype], ptrs + (lse.data_ptr(),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LIBRARY.call(symbol, *ptrs, b, hq, hkv, sq, skv, d, float(scale),
                     *_mask_args(causal, window), stream)


def launcher_route(dtype: torch.dtype, q_ptr: int, k_ptr: int, v_ptr: int,
                   out_ptr: int, d: int) -> int:
    """The route index the built library's launcher takes for these
    operands (:func:`.ops.flash_attention` counts it and holds it against
    :func:`.ops.route`)."""
    fn = getattr(LIBRARY.load(), ROUTE_SYMBOL)
    return fn(DTYPE_CODES[dtype], q_ptr, k_ptr, v_ptr, out_ptr, d)


def dkv_groups(hq: int, hkv: int, batch: int, skv: int, sms: int,
               key_block: int = BWD_KEY_BLOCK) -> int:
    """How many head groups a tensor-core route's dk/dv kernel splits a kv
    head's ``hq // hkv`` query heads into: the largest divisor of ``hq //
    hkv`` that keeps its blocks (``batch * hkv`` x key blocks of
    ``key_block`` x groups, one resident on an SM) within the card's
    ``sms`` SMs, and 1 where one group already fills them."""
    group = hq // hkv
    blocks = batch * hkv * -(-skv // key_block)
    return max(g for g in range(1, group + 1)
               if group % g == 0 and (g == 1 or blocks * g <= sms))


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, dout: torch.Tensor, dq: torch.Tensor,
               dk: torch.Tensor, dv: torch.Tensor, *, causal: bool, window,
               scale: float, lse: torch.Tensor | None = None) -> None:
    """Enqueue the backward of attention (``q`` (B, Hq, Sq, D), ``k``, ``v``
    (B, Hkv, Skv, D), its output ``out`` and the output's gradient
    ``dout``) into ``dq``, ``dk``, ``dv`` on the current stream.

    Without ``lse``, the CUDA-core route of the dtype: two kernel launches,
    with the (B, Hq, Sq) float32 log-sum-exp and delta scratch allocated
    here.  With ``lse``, the forward's (B, Hq, Sq) log-sum-exp, the
    tensor-core route of the dtype: bf16 and f16 three launches (four with
    head groups, :func:`dkv_groups`), float32 (3xTF32) four (delta, dq, dv, dk;
    five with head groups, at d 256 only), each with the delta scratch and
    the head groups' float32 partials allocated here.

    The caller (:mod:`.ops`) has checked every operand and the route.  Does
    not synchronise; raises when a launch is refused.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    mask = _mask_args(causal, window)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if lse is None:
            scratch = torch.empty_like(delta)
            BWD_LIBRARY.call(f"bind_flash_attention_bwd_{SUFFIX[q.dtype]}",
                             *(t.data_ptr() for t in (q, k, v, out, dout, dq,
                                                      dk, dv, scratch,
                                                      delta)),
                             b, hq, hkv, sq, skv, d, float(scale), *mask,
                             stream)
            return
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        if q.dtype == torch.float32:
            # head groups at d 256 only (its blocks of 64 keys); below, one
            groups = (dkv_groups(hq, hkv, b, skv, sms, BWD_TF32_KEY_BLOCK)
                      if d > 128 else 1)
        else:
            groups = dkv_groups(hq, hkv, b, skv, sms)
        part = (torch.empty((2, b, groups, hkv, skv, d), dtype=torch.float32,
                            device=q.device) if groups > 1 else None)
        BWD_LIBRARY.call(BWD_LSE_SYMBOLS[q.dtype],
                         *(t.data_ptr() for t in (q, k, v, out, dout, dq, dk,
                                                  dv, lse, delta)),
                         None if part is None else part.data_ptr(),
                         b, hq, hkv, sq, skv, d, float(scale), *mask, groups,
                         stream)


def bwd_launcher_route(dtype: torch.dtype, d: int, addresses) -> int:
    """The route index the built backward library takes for ``dtype`` at
    head dim ``d`` on operands at ``addresses`` (q, k, v, out, dout and the
    forward's log-sum-exp, 0 or None where there is none); -1 where it
    takes none."""
    fn = getattr(BWD_LIBRARY.load(), BWD_ROUTE_SYMBOL)
    return fn(DTYPE_CODES[dtype], d, *(a or None for a in addresses))
