"""Build and bind the flash-attention kernel (``csrc/flash_attention.cu``)
and its backward (``csrc/flash_attention_bwd.cu``, a library of its own so
that the forward's build and bits stay as they were).

Built at first use through the shared :mod:`repro_torch.kernels._build`
helper, with the CUDA-core tile loop it shares with the chain kernel
(``csrc/attn_tile.cuh``), the tensor-core loops of the ``bf16_wgmma`` route
(``csrc/attn_wgmma.cuh``) and of the ``f32_3xtf32`` route
(``csrc/attn_tf32.cuh``), and the GEMM headers they draw on (conversions,
the TMA and ``wgmma`` helpers).  Nothing here runs at import time.
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
           _HERE.parent / "gemm" / "csrc" / "gemm_tile.cuh",
           _HERE.parent / "gemm" / "csrc" / "gemm_wgmma.cuh")

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

LIBRARY = CudaLibrary("bind_flash_attention", SOURCES, HEADERS,
                      {**{f"bind_flash_attention_{s}": _ARGS
                          for s in SUFFIX.values()},
                       ROUTE_SYMBOL: _ROUTE_ARGS})


# the backward: (q, k, v, out, dout, dq, dk, dv, lse, delta, batch, hq, hkv,
# sq, skv, d, scale, causal, windowed, window, stream)
BWD_SOURCES = (_HERE / "csrc" / "flash_attention_bwd.cu",)
_BWD_ARGS = (_P,) * 10 + (_I64,) * 6 + (_D, _I, _I, _I64, _P)
# which route (an index of ops.BWD_ROUTES) a backward takes: (element-type
# code, d)
BWD_ROUTE_SYMBOL = "bind_flash_attention_bwd_route"
BWD_LIBRARY = CudaLibrary("bind_flash_attention_bwd", BWD_SOURCES, (),
                          {**{f"bind_flash_attention_bwd_{s}": _BWD_ARGS
                              for s in SUFFIX.values()},
                           BWD_ROUTE_SYMBOL: (_I, _I64)})


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, window, scale: float) -> None:
    """Enqueue attention of ``q`` (B, Hq, Sq, D) over ``k``, ``v`` (B, Hkv,
    Skv, D) into ``out`` on the current stream.

    The caller (:mod:`.ops`) has checked every operand.  Does not
    synchronise; raises when the launch is refused.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        LIBRARY.call(f"bind_flash_attention_{SUFFIX[q.dtype]}", q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
                     sq, skv, d, float(scale), int(causal),
                     int(window is not None),
                     0 if window is None else int(window), stream)


def launcher_route(dtype: torch.dtype, q_ptr: int, k_ptr: int, v_ptr: int,
                   out_ptr: int, d: int) -> int:
    """The route index the built library's launcher takes for these
    operands (:func:`.ops.flash_attention` counts it and holds it against
    :func:`.ops.route`)."""
    fn = getattr(LIBRARY.load(), ROUTE_SYMBOL)
    return fn(DTYPE_CODES[dtype], q_ptr, k_ptr, v_ptr, out_ptr, d)


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, dout: torch.Tensor, dq: torch.Tensor,
               dk: torch.Tensor, dv: torch.Tensor, *, causal: bool, window,
               scale: float) -> None:
    """Enqueue the backward of attention (``q`` (B, Hq, Sq, D), ``k``, ``v``
    (B, Hkv, Skv, D), its output ``out`` and the output's gradient
    ``dout``) into ``dq``, ``dk``, ``dv`` on the current stream: two kernel
    launches, with the (B, Hq, Sq) float32 log-sum-exp and delta scratch
    allocated here.

    The caller (:mod:`.ops`) has checked every operand.  Does not
    synchronise; raises when a launch is refused.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        BWD_LIBRARY.call(f"bind_flash_attention_bwd_{SUFFIX[q.dtype]}",
                         *(t.data_ptr() for t in (q, k, v, out, dout, dq, dk,
                                                  dv, lse, delta)),
                         b, hq, hkv, sq, skv, d, float(scale), int(causal),
                         int(window is not None),
                         0 if window is None else int(window), stream)


def bwd_launcher_route(dtype: torch.dtype, d: int) -> int:
    """The route index the built backward library takes for ``dtype`` at
    head dim ``d`` (-1 where it takes none)."""
    fn = getattr(BWD_LIBRARY.load(), BWD_ROUTE_SYMBOL)
    return fn(DTYPE_CODES[dtype], d)
