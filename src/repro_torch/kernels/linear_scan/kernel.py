"""Build and bind the one-launch linear scan (``csrc/linear_scan.cu``).

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
# bind_linear_scan_route's element-type codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CHUNK = 128         # steps per chunk: the CHUNK the kernel is built for

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P)

# which route (an index of ops.ROUTES) a call takes: (element-type code, a,
# x, d)
ROUTE_SYMBOL = "bind_linear_scan_route"
_ROUTE_ARGS = (_I, _P, _P, _I64)

LIBRARY = CudaLibrary("bind_linear_scan", SOURCES, (),
                      {**{f"bind_linear_scan_{s}": _ARGS
                          for s in SUFFIX.values()},
                       ROUTE_SYMBOL: _ROUTE_ARGS})


def scratch_words(b: int, s: int, d: int) -> int:
    """4-byte words of scratch a call on (b, s, d) needs: a chunk's
    aggregate (two words) and carry out per (batch, chunk, column), and the
    ticket counter."""
    return 3 * b * -(-s // CHUNK) * d + 1


def launch(a: torch.Tensor, x: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue the scan of ``a`` and ``x`` (``(B, S, D)``) into ``out``:
    one memset of the scratch and one kernel launch on the current stream,
    with the scratch allocated here.

    The caller (:mod:`.ops`) has checked every operand.  Does not
    synchronise; raises when a launch is refused.
    """
    b, s, d = a.shape
    scratch = torch.empty(scratch_words(b, s, d), dtype=torch.float32,
                          device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        LIBRARY.call(f"bind_linear_scan_{SUFFIX[a.dtype]}", a.data_ptr(),
                     x.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, s,
                     d, CHUNK, stream)


def launcher_route(dtype: torch.dtype, a_ptr: int, x_ptr: int,
                   d: int) -> int:
    """The route index the built library's launcher takes for these
    operands (:func:`.ops.linear_scan` counts it and holds it against
    :func:`.ops.route`)."""
    fn = getattr(LIBRARY.load(), ROUTE_SYMBOL)
    return fn(DTYPE_CODES[dtype], a_ptr, x_ptr, d)
