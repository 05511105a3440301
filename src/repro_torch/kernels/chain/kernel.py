"""Build and bind the chain kernels (``csrc/chain.cu``).

Built at first use through the shared :mod:`repro_torch.kernels._build`
helper, together with the tile loops it includes: the GEMM's routes
(``gemm/csrc/gemm_routes.cuh`` and the tile loop of each) and flash
attention's (``flash_attention/csrc/attn_tile.cuh``).  Nothing here runs
at import time.

``chain_attn`` runs its levels in parallel and sums them into the carry in
level order (``csrc/chain.cu``).  Its launcher hands the kernel a
workspace for every level's result, allocated per call with
``torch.empty``, and a counter per row tile, which the kernel leaves at
zero: one buffer per device and stream, zeroed once when it is made or
grown, so a chain is one launch and no fill kernel.  The workspace is
``n_levels x M x dv`` in the accumulator type and would grow with the
chain, so it is bounded: a chain whose workspace would pass
``WORKSPACE_BYTES`` runs as several launches of at most
:func:`level_runs`' levels each, the carry handed from one to the next
in the carry's own type.  That keeps every bit, since the kernel rounds
the carry to its type after every level anyway.
"""

from __future__ import annotations

import ctypes
import threading
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
          torch.float64: "f64", torch.float16: "f16"}
# operand kinds of chain_ewise (the numbering of csrc/chain.cu)
KINDS = {"carry": 0, "single": 1, "xs": 2, "const": 3, "xs_const": 4}

_P, _I, _I64, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_double)
_EWISE_ARGS = (_P, _P, _I, _D, _P, _I, _D, _P, _I, _D, _I, _I64, _I64, _P)
_DOT_ARGS = (_P, _P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64, _P)
_ATTN_ARGS = (_P, _P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _I64, _I64,
              _I64, _I64, _I64, _D, _P)
# rows of a chain_attn row tile in the smallest instantiation (float64's;
# 64 for float32, bfloat16 and float16): the counters cover m / ROW_TILE
# tiles
ROW_TILE = 32
# the most workspace one chain_attn launch takes; 4 MiB at chip_smoke.py's
# 512 x 128 float32 tile of 16 levels, which stays one launch up to 256
# levels
WORKSPACE_BYTES = 64 << 20
# the grid's y, the levels one launch runs side by side
MAX_LEVELS_PER_LAUNCH = 65535

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


_COUNTERS: dict = {}
_COUNTERS_LOCK = threading.Lock()


def row_tile_counters(device: torch.device, stream: int,
                      tiles: int) -> torch.Tensor:
    """At least ``tiles`` int32 counters for ``chain_attn`` launches on
    ``stream`` of ``device``, all zero between launches: made (or grown)
    with ``torch.zeros`` and kept, since every launch sets back to zero
    the counters it used.  Launches on one stream run one after another,
    so they never share a counter while it counts."""
    key = (device.index, stream)
    with _COUNTERS_LOCK:
        buf = _COUNTERS.get(key)
        if buf is None or buf.numel() < tiles:
            size = max(tiles, 1024, 2 * (0 if buf is None else buf.numel()))
            buf = torch.zeros(size, dtype=torch.int32, device=device)
            _COUNTERS[key] = buf
        return buf


def level_runs(m: int, dv: int, dtype: torch.dtype,
               n_levels: int) -> list[tuple[int, int]]:
    """The launches of a ``chain_attn`` of ``n_levels`` on an ``(m, dv)``
    carry of ``dtype``, as ``(first level, levels)``: as many levels each
    as fit ``WORKSPACE_BYTES`` of workspace (at least one)."""
    acc_bytes = 8 if dtype == torch.float64 else 4
    per_level = max(1, m * dv * acc_bytes)
    run = max(1, min(n_levels, WORKSPACE_BYTES // per_level,
                     MAX_LEVELS_PER_LAUNCH))
    return [(first, min(run, n_levels - first))
            for first in range(0, n_levels, run)]


def launch_attn(out: torch.Tensor, o: torch.Tensor, q: torch.Tensor,
                q_stride: int, k: torch.Tensor, k_stride: int,
                v: torch.Tensor, v_stride: int, n_levels: int) -> int:
    """Enqueue ``n_levels`` of ``o ← o + softmax(q kᵀ / √d) v`` into
    ``out`` (``*_stride`` elements between levels, 0 for an operand every
    level shares).  Returns the number of launches (:func:`level_runs`)."""
    m, dv = o.shape
    n, d = k.shape[-2:]
    acc = torch.float64 if o.dtype == torch.float64 else torch.float32
    runs = level_runs(m, dv, o.dtype, n_levels)
    size = o.element_size()
    with on_device(out.device):
        stream = _stream(out)
        # freed when this returns, while the kernels may still run: the
        # caching allocator hands the blocks only to later work on this
        # stream, which runs after them
        work = torch.empty((runs[0][1], m, dv), dtype=acc, device=out.device)
        done = row_tile_counters(out.device, stream, -(-m // ROW_TILE))
        # the carry between launches: each reads the last one's result and
        # writes the other buffer, the last launch writing out
        spare = torch.empty_like(out) if len(runs) > 1 else None
        carry = o
        for i, (first, levels) in enumerate(runs):
            dst = out if (len(runs) - 1 - i) % 2 == 0 else spare
            LIBRARY.call(f"bind_chain_attn_{SUFFIX[out.dtype]}",
                         carry.data_ptr(),
                         q.data_ptr() + first * q_stride * size, q_stride,
                         k.data_ptr() + first * k_stride * size, k_stride,
                         v.data_ptr() + first * v_stride * size, v_stride,
                         dst.data_ptr(), work.data_ptr(), done.data_ptr(),
                         m, n, d, dv, levels, 1.0 / float(d) ** 0.5, stream)
            carry = dst
    return len(runs)
