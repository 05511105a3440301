"""Build and bind the chain kernels (``csrc/chain.cu``).

Built at first use through the shared :mod:`repro_torch.kernels._build`
helper, together with the tile loops it includes: the GEMM's routes
(``gemm/csrc/gemm_routes.cuh`` and the tile loop of each) and flash
attention's (``flash_attention/csrc/attn_tile.cuh``).  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaLibrary
from ..gemm.kernel import HEADERS as GEMM_HEADERS
from ..gemm.kernel import on_device

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "chain.cu",)
HEADERS = GEMM_HEADERS + (
    _HERE.parent / "flash_attention" / "csrc" / "attn_tile.cuh",)

SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float64: "f64"}
# operand kinds of chain_ewise (the numbering of csrc/chain.cu)
KINDS = {"carry": 0, "single": 1, "xs": 2, "const": 3, "xs_const": 4}

_P, _I, _I64, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_double)
_EWISE_ARGS = (_P, _P, _I, _D, _P, _I, _D, _P, _I, _D, _I, _I64, _I64, _P)
_DOT_ARGS = (_P, _P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64, _P)
_ATTN_ARGS = (_P, _P, _I64, _P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64,
              _I64, _D, _P)

LIBRARY = CudaLibrary(
    "bind_chain", SOURCES, HEADERS,
    {**{f"bind_chain_ewise_{s}": _EWISE_ARGS for s in SUFFIX.values()},
     **{f"bind_chain_dot_{s}": _DOT_ARGS for s in SUFFIX.values()},
     **{f"bind_chain_attn_{s}": _ATTN_ARGS for s in SUFFIX.values()}})


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_ewise(out: torch.Tensor, layout: tuple, carry_pos: int,
                 n_levels: int, args) -> None:
    """Enqueue the ``scan_step`` chain; ``out`` has the carry's shape.

    The caller (:mod:`.ops`) has checked every operand.  Does not
    synchronise; raises when the launch is refused.
    """
    flat = []
    for pos, (lay, v) in enumerate(zip(layout, args)):
        if pos == carry_pos:
            flat += [v.data_ptr(), KINDS["carry"], 0.0]
        elif lay == "const":
            flat += [None, KINDS["const"], float(v)]
        else:
            flat += [v.data_ptr(), KINDS[lay], 0.0]
    with on_device(out.device):
        LIBRARY.call(f"bind_chain_ewise_{SUFFIX[out.dtype]}",
                     out.data_ptr(), *flat, carry_pos, out.numel(), n_levels,
                     _stream(out))


def launch_dot(out: torch.Tensor, c: torch.Tensor, a: torch.Tensor,
               a_stride: int, b: torch.Tensor, b_stride: int, k: int,
               n_levels: int) -> None:
    """Enqueue ``out = c + Σ_l a_l @ b_l`` (``*_stride`` elements between
    levels, 0 for an operand every level shares)."""
    m, n = c.shape
    with on_device(out.device):
        LIBRARY.call(f"bind_chain_dot_{SUFFIX[out.dtype]}", c.data_ptr(),
                     a.data_ptr(), a_stride, b.data_ptr(), b_stride,
                     out.data_ptr(), m, n, k, n_levels, _stream(out))


def launch_attn(out: torch.Tensor, o: torch.Tensor, q: torch.Tensor,
                q_stride: int, k: torch.Tensor, k_stride: int,
                v: torch.Tensor, v_stride: int, n_levels: int) -> None:
    """Enqueue ``n_levels`` of ``o ← o + softmax(q kᵀ / √d) v`` into
    ``out`` (``*_stride`` elements between levels, 0 for an operand every
    level shares)."""
    m, dv = o.shape
    n, d = k.shape[-2:]
    with on_device(out.device):
        LIBRARY.call(f"bind_chain_attn_{SUFFIX[out.dtype]}", o.data_ptr(),
                     q.data_ptr(), q_stride, k.data_ptr(), k_stride,
                     v.data_ptr(), v_stride, out.data_ptr(), m, n, d, dv,
                     n_levels, 1.0 / float(d) ** 0.5, _stream(out))
