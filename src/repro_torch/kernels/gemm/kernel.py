"""Build and bind the hand-written Hopper GEMM (``csrc/gemm.cu``).

The source and the tile loop it shares with the chain kernel
(``csrc/gemm_tile.cuh``) are compiled at first use through the shared
:mod:`repro_torch.kernels._build` helper: ``nvcc`` for ``sm_90a`` into a
hash-named shared library with a plain C interface, loaded with
:mod:`ctypes`.  A missing ``nvcc`` or a failed build raises: there is no
fallback.

Nothing here runs at import time — the CPU tests import this module on
hosts without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import BUILD_DIR, NVCC_FLAGS, CudaLibrary, nvcc

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "gemm.cu",)
HEADERS = (_HERE / "csrc" / "gemm_tile.cuh",)

# torch dtype -> C entry point of csrc/gemm.cu
SYMBOLS = {
    torch.float32: "bind_gemm_f32",
    torch.bfloat16: "bind_gemm_bf16",
    torch.float64: "bind_gemm_f64",
}
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_void_p)

LIBRARY = CudaLibrary("bind_gemm", SOURCES, HEADERS,
                      {sym: _ARGTYPES for sym in SYMBOLS.values()})

__all__ = ["BUILD_DIR", "LIBRARY", "NVCC_FLAGS", "SYMBOLS", "launch",
           "library_path", "nvcc"]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    return LIBRARY.path()


def launch(a: torch.Tensor, b: torch.Tensor, c, out: torch.Tensor) -> None:
    """Enqueue ``out = a @ b (+ c)`` on the current stream of ``a``'s device.

    The caller (:mod:`.ops`) has checked devices, dtypes, shapes and
    contiguity and allocated ``out``.  Does not synchronise; raises when the
    launch is refused (the C function returns ``cudaGetLastError()``).
    """
    m, k = a.shape
    n = b.shape[1]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        LIBRARY.call(SYMBOLS[a.dtype], a.data_ptr(), b.data_ptr(),
                     c.data_ptr() if c is not None else None,
                     out.data_ptr(), m, n, k, stream)
