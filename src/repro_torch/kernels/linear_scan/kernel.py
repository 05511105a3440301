"""Build and bind the chunked linear scan (``csrc/linear_scan.cu``).

Built at first use through the shared :mod:`repro_torch.kernels._build`
helper.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaLibrary

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "linear_scan.cu",)

SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float16: "f16"}
CHUNK = 128         # steps per chunk: the kernel's unit of parallel work

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P)

LIBRARY = CudaLibrary("bind_linear_scan", SOURCES, (),
                      {f"bind_linear_scan_{s}": _ARGS
                       for s in SUFFIX.values()})


def launch(a: torch.Tensor, x: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue the scan of ``a`` and ``x`` (``(B, S, D)``) into ``out``:
    three launches on the current stream (see the source), with a
    ``(2, B, ceil(S / CHUNK), D)`` float32 scratch allocated here.

    The caller (:mod:`.ops`) has checked every operand.  Does not
    synchronise; raises when a launch is refused.
    """
    b, s, d = a.shape
    n_chunks = -(-s // CHUNK)
    scratch = torch.empty((2, b, n_chunks, d), dtype=torch.float32,
                          device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        LIBRARY.call(f"bind_linear_scan_{SUFFIX[a.dtype]}", a.data_ptr(),
                     x.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, s,
                     d, CHUNK, stream)
