"""Build and bind the hand-written Hopper GEMM (``csrc/gemm.cu``).

The source and the headers it shares with the chain kernel (the route
rule and launch, ``csrc/gemm_routes.cuh``, and one tile loop per route:
``gemm_tile.cuh``, ``gemm_wgmma.cuh``, ``gemm_dmma.cuh``,
``gemm_tf32.cuh`` with the TF32 rounding it shares with flash attention,
``tf32.cuh``) are compiled at first use through the shared
:mod:`repro_torch.kernels._build` helper: ``nvcc`` for ``sm_90a`` into a
hash-named shared library with a plain C interface, loaded with
:mod:`ctypes`.  A missing ``nvcc`` or a failed build raises: there is no
fallback.

Nothing here runs at import time — the CPU tests import this module on
hosts without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path

import torch

from .._build import BUILD_DIR, NVCC_FLAGS, CudaLibrary, nvcc

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "gemm.cu",)
HEADERS = tuple(_HERE / "csrc" / name for name in (
    "gemm_routes.cuh", "gemm_tile.cuh", "gemm_wgmma.cuh", "gemm_dmma.cuh",
    "gemm_tf32.cuh", "tf32.cuh"))

# torch dtype -> C entry point of csrc/gemm.cu
SYMBOLS = {
    torch.float32: "bind_gemm_f32",
    torch.bfloat16: "bind_gemm_bf16",
    torch.float64: "bind_gemm_f64",
    torch.float16: "bind_gemm_f16",
}
# torch dtype -> the element-type code of bind_gemm_route, and of the
# entry points' output type
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2,
               torch.float16: 3}
# (a, b, c, out, M, N, K, out's type code, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)

# which route (an index of ops.ROUTES) the launcher takes for a problem:
# (element-type code, a, a_stride, b, b_stride, M, N, K)
ROUTE_SYMBOL = "bind_gemm_route"
_ROUTE_ARGTYPES = (ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64)

LIBRARY = CudaLibrary("bind_gemm", SOURCES, HEADERS,
                      {**{sym: _ARGTYPES for sym in SYMBOLS.values()},
                       ROUTE_SYMBOL: _ROUTE_ARGTYPES})

__all__ = ["BUILD_DIR", "DTYPE_CODES", "HEADERS", "LIBRARY", "NVCC_FLAGS", "ROUTE_SYMBOL",
           "SYMBOLS", "launch", "launcher_route", "library_path", "nvcc",
           "on_device"]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    return LIBRARY.path()


_CURRENT = contextlib.nullcontext()


def on_device(device: torch.device):
    """A context that makes ``device`` the current card for a launch (the C
    launchers launch on the current one); free when it already is."""
    if device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(device)


def launch(a: torch.Tensor, b: torch.Tensor, c, out: torch.Tensor) -> None:
    """Enqueue ``out = a @ b (+ c)`` on the current stream of ``a``'s device.

    The caller (:mod:`.ops`) has checked devices, dtypes, shapes and
    contiguity and allocated ``out``, whose dtype (any of
    :data:`DTYPE_CODES`'; ``c``'s too) is the type the kernel writes: the
    accumulator of ``a``'s dtype rounded once to it.  Does not
    synchronise; raises when the launch is refused (the C function returns
    ``cudaGetLastError()``).
    """
    m, k = a.shape
    n = b.shape[1]
    with on_device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        LIBRARY.call(SYMBOLS[a.dtype], a.data_ptr(), b.data_ptr(),
                     c.data_ptr() if c is not None else None,
                     out.data_ptr(), m, n, k, DTYPE_CODES[out.dtype],
                     stream)


def launcher_route(dtype: torch.dtype, a_ptr: int, a_stride: int, b_ptr: int,
                   b_stride: int, m: int, n: int, k: int) -> int:
    """The route index the built library's launcher takes for these
    operands (``chip_smoke.py`` holds it against :func:`.ops.route`)."""
    fn = getattr(LIBRARY.load(), ROUTE_SYMBOL)
    return fn(DTYPE_CODES[dtype], a_ptr, a_stride, b_ptr, b_stride, m, n, k)
