"""Build and bind the chain kernels (``csrc/chain.cu``).

Built at first use through the shared :mod:`repro_torch.kernels._build`
helper, together with the tile loops it includes: the GEMM's routes
(``gemm/csrc/gemm_routes.cuh`` and the tile loop of each) and flash
attention's (``flash_attention/csrc/attn_tile.cuh``, and for
``chain_attn``'s tensor-core routes ``attn_wgmma.cuh`` / ``attn_tf32.cuh``
through ``csrc/chain_attn_tc.cuh``).  Nothing here runs at import time.

``chain_attn`` runs its levels in parallel and sums them into the carry in
level order (``csrc/chain.cu``).  Its launcher hands the kernel a
workspace for every level's result, allocated per call with
``torch.empty``, and counters, which the kernel leaves at zero: one
buffer per device and stream, zeroed once when it is made or grown, so a
chain is one launch and no fill kernel.  On the CUDA-core routes the
workspace is ``n_levels x M x dv`` in the accumulator type and there is a
counter per row tile; on the tensor-core routes (:data:`TC_ROUTES`) each
level's keys are split into :func:`attn_chunks` chunks, the workspace is
``n_levels x chunks x M x (dv + 2)`` floats (each chunk's unnormalised O,
its m and l), there is a counter per row tile and level
(:func:`attn_counters`), and a launch of several levels is the chain
kernel and, after it on the stream, the kernel that folds the levels into
the carry.  The workspace would grow with the chain,
so it is bounded: a chain whose workspace would pass ``WORKSPACE_BYTES``
runs as several launches of at most :func:`level_runs`' levels each, the
carry handed from one to the next in the carry's own type.  That keeps
every bit, since the kernel rounds the carry to its type after every level
anyway, and the chunks depend on the level's shape alone.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from .._build import CudaLibrary
from ..gemm.kernel import DTYPE_CODES
from ..gemm.kernel import HEADERS as GEMM_HEADERS
from ..gemm.kernel import on_device

_HERE = Path(__file__).resolve().parent
# chain.cu first (its extern "C" entry points); then chain_attn's
# tensor-core kernels, built beside it in parallel (kernels/_build.py)
SOURCES = tuple(_HERE / "csrc" / name for name in (
    "chain.cu", "chain_attn_tf32.cu", "chain_attn_wgmma.cu"))
HEADERS = GEMM_HEADERS + (_HERE / "csrc" / "chain_attn_tc.cuh",) + tuple(
    _HERE.parent / "flash_attention" / "csrc" / name
    for name in ("attn_tile.cuh", "attn_wgmma.cuh", "attn_tf32.cuh"))

SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float64: "f64", torch.float16: "f16"}
# operand kinds of chain_ewise (the numbering of csrc/chain.cu)
KINDS = {"carry": 0, "single": 1, "xs": 2, "const": 3, "xs_const": 4}

_P, _I, _I64, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_double)
_EWISE_ARGS = (_P, _P, _I, _D, _P, _I, _D, _P, _I, _D, _I, _I64, _I64, _P)
_DOT_ARGS = (_P, _P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64, _P)
_ATTN_ARGS = (_P, _P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _I64, _I64,
              _I64, _I64, _I64, _I64, _D, _P)
# chain_attn's route of a chain: (element-type code, q, q_stride, k,
# k_stride, v, v_stride, N, d, dv, n_levels) -> an index of ATTN_ROUTES
ATTN_ROUTE_SYMBOL = "bind_chain_route_attn"
_ATTN_ROUTE_ARGS = (_I, _P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I64, _I64)
# chain_attn's routes, in the order of csrc/chain.cu's AttnRoute
ATTN_ROUTES = ("f32_simt", "bf16_simt", "f16_simt", "f64_simt",
               "f32_3xtf32", "bf16_wgmma", "f16_wgmma")
# the tensor-core routes (csrc/chain_attn_tc.cuh): flash attention's
# blocks, each level's keys in chunks
TC_ROUTES = ("f32_3xtf32", "bf16_wgmma", "f16_wgmma")
# rows of a chain_attn row tile on the CUDA-core routes in the smallest
# instantiation (float64's; 64 for float32, bfloat16 and float16): their
# counters cover m / ROW_TILE tiles
ROW_TILE = 32
# rows of a tensor-core block (both routes' BQ)
TC_ROWS = 128
# chunks: as many as make a level at least CHUNK_BLOCKS blocks (row tiles x
# chunks), at most the level's key tiles and MAX_CHUNKS (csrc/chain_attn_
# tc.cuh: the served 512-row level runs as 16 blocks)
CHUNK_BLOCKS = 16
MAX_CHUNKS = 16
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
     **{f"bind_chain_attn_{s}": _ATTN_ARGS for s in SUFFIX.values()},
     ATTN_ROUTE_SYMBOL: _ATTN_ROUTE_ARGS})


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


def key_tile(route: str, d: int) -> int:
    """Keys a tile of tensor-core route ``route``'s block takes at head dim
    ``d`` (``attn_tf32.cuh`` / ``attn_wgmma.cuh`` ``Cfg::BKV``)."""
    if route == "f32_3xtf32":
        return 64 if d <= 64 else 32
    return 128 if d <= 128 else 64


def attn_chunks(route: str, m: int, n: int, d: int) -> int:
    """How many chunks a level of ``m`` query rows over ``n`` keys at head
    dim ``d`` splits its keys into on ``route``: 1 on the CUDA-core
    routes; on the tensor-core routes as many as make ``ceil(m / 128)``
    row tiles times the chunks at least ``CHUNK_BLOCKS`` blocks, at most the
    level's key tiles and ``MAX_CHUNKS``, every chunk the same whole number
    of tiles but the last.  A function of the level alone, never of the
    chain's length: a level's bits are then those of its per-level
    replay."""
    if route not in TC_ROUTES:
        return 1
    tiles = -(-n // key_tile(route, d))
    rows = -(-m // TC_ROWS)
    want = max(1, min(tiles, MAX_CHUNKS, -(-CHUNK_BLOCKS // rows)))
    per = -(-tiles // want)
    return -(-tiles // per)


def level_bytes(m: int, dv: int, dtype: torch.dtype,
                chunks: int | None = None) -> int:
    """Workspace bytes of one level: ``m x dv`` in the accumulator type on
    the CUDA-core routes (``chunks`` None), ``chunks x m x (dv + 2)``
    floats on the tensor-core routes."""
    if chunks is None:
        return m * dv * (8 if dtype == torch.float64 else 4)
    return chunks * m * (dv + 2) * 4


def level_runs(m: int, dv: int, dtype: torch.dtype, n_levels: int,
               chunks: int | None = None) -> list[tuple[int, int]]:
    """The launches of a ``chain_attn`` of ``n_levels`` on an ``(m, dv)``
    carry of ``dtype``, as ``(first level, levels)``: as many levels each
    as fit ``WORKSPACE_BYTES`` of workspace (:func:`level_bytes`; at least
    one) and the grid's y (levels times ``chunks``)."""
    per_level = max(1, level_bytes(m, dv, dtype, chunks))
    run = max(1, min(n_levels, WORKSPACE_BYTES // per_level,
                     MAX_LEVELS_PER_LAUNCH // (chunks or 1)))
    return [(first, min(run, n_levels - first))
            for first in range(0, n_levels, run)]


def levels_per_launch(route: str, m: int, n: int, d: int, dv: int,
                      dtype: torch.dtype) -> int:
    """The most levels one ``chain_attn`` launch on ``route`` runs for
    levels of this shape (a longer chain is several launches)."""
    chunks = attn_chunks(route, m, n, d) if route in TC_ROUTES else None
    return level_runs(m, dv, dtype, MAX_LEVELS_PER_LAUNCH + 1, chunks)[0][1]


def attn_counters(route: str, m: int, levels: int) -> int:
    """Counters a ``chain_attn`` launch of ``levels`` on ``route`` uses: one
    per row tile (the CUDA-core routes' ordered sum), or on the tensor-core
    routes one per row tile and level (its chunks' merge)."""
    if route in TC_ROUTES:
        return -(-m // TC_ROWS) * levels
    return -(-m // ROW_TILE)


def launcher_route(dtype: torch.dtype, q_ptr: int, q_stride: int,
                   k_ptr: int, k_stride: int, v_ptr: int, v_stride: int,
                   n: int, d: int, dv: int, n_levels: int) -> str:
    """The route (a name of :data:`ATTN_ROUTES`) the built library's
    launcher takes for a ``chain_attn`` of these operands (``*_stride``
    elements between levels, 0 for an operand every level shares)."""
    fn = getattr(LIBRARY.load(), ATTN_ROUTE_SYMBOL)
    return ATTN_ROUTES[fn(DTYPE_CODES[dtype], q_ptr, q_stride, k_ptr,
                          k_stride, v_ptr, v_stride, n, d, dv, n_levels)]


def launch_attn(out: torch.Tensor, o: torch.Tensor, q: torch.Tensor,
                q_stride: int, k: torch.Tensor, k_stride: int,
                v: torch.Tensor, v_stride: int, n_levels: int,
                route: str) -> int:
    """Enqueue ``n_levels`` of ``o ← o + softmax(q kᵀ / √d) v`` into
    ``out`` (``*_stride`` elements between levels, 0 for an operand every
    level shares) on ``route``, the one the launcher takes
    (:func:`launcher_route`).  Returns the number of launches
    (:func:`level_runs`)."""
    m, dv = o.shape
    n, d = k.shape[-2:]
    tc = route in TC_ROUTES
    chunks = attn_chunks(route, m, n, d) if tc else None
    acc = (torch.float32 if tc or o.dtype != torch.float64
           else torch.float64)
    runs = level_runs(m, dv, o.dtype, n_levels, chunks)
    size = o.element_size()
    with on_device(out.device):
        stream = _stream(out)
        # freed when this returns, while the kernels may still run: the
        # caching allocator hands the blocks only to later work on this
        # stream, which runs after them
        work = torch.empty(
            level_bytes(m, dv, o.dtype, chunks) * runs[0][1]
            // acc.itemsize, dtype=acc, device=out.device)
        done = row_tile_counters(out.device, stream,
                                 attn_counters(route, m, runs[0][1]))
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
                         m, n, d, dv, levels, chunks or 1,
                         1.0 / float(d) ** 0.5, stream)
            carry = dst
    return len(runs)
