"""Public chain-kernel wrappers: one launch per chain on CUDA (for
:func:`chain_attn`, one per run of levels whose workspace fits
``kernel.WORKSPACE_BYTES``: :func:`.kernel.level_runs`), the plain
per-level loop (:mod:`.ref`) on CPU.

Both wrappers take a chain in the layout vocabulary of the executable
cache's width-1 chain entries: ``args`` holds the op body's arguments in
its own positions, the carry at ``carry_pos`` (layout ``"single"``), each
other position ``"single"`` (the same tensor every level), ``"xs"`` (a
``(n_levels, ...)`` stack, one slice per level), ``"const"`` (one Python
scalar) or ``"xs_const"`` (a ``(n_levels,)`` tensor of per-level scalars).
They return the final carry, a new tensor.

* :func:`chain_ewise` — ``linear_scan.ops.scan_step`` (``y ← a·y + x``):
  every tensor has the carry's shape (``xs``: one more leading axis), the
  carry's dtype (float32, bfloat16, float16 or float64; every wrapper
  takes these four) and device; ``y`` and ``a`` are not both constants
  (their product would be a Python number).
* :func:`chain_dot` — ``gemm.ops.gemm_tile`` (``c ← c + a @ b``): the carry
  is ``c`` (position 0, ``(m, n)``); ``a`` is ``(m, k)`` and ``b`` ``(k, n)``,
  each ``"single"`` or ``"xs"``; one dtype and device.
* :func:`chain_attn` — ``flash_attention.ops.attn_step`` (``o ← o +
  softmax(q kᵀ / √d) v``): the carry is ``o`` (position 0, ``(m, dv)``);
  ``q`` is ``(m, d)``, ``k`` ``(n, d)`` and ``v`` ``(n, dv)``, each
  ``"single"`` or ``"xs"``, with ``1 <= d, dv <= 256``; one dtype and
  device.

:func:`problem` says, before any launch, why a chain's operands are not
ones its body's kernel takes (``None`` when they are); a caller that asks
first never sees a wrapper raise for its operands.  On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor, and only there, it
computes the plain version.  Each wrapper counts its launches in
``launches``; :func:`chain_dot` also counts the GEMM route it took
(:func:`dot_route`) in ``routes``, and :func:`chain_attn` its route
(:func:`attn_route`: float32 in 3xTF32, ``f32_3xtf32``, with d == dv one
of :data:`TF32_HEAD_DIMS`; bfloat16 and float16 on ``wgmma``,
``bf16_wgmma`` / ``f16_wgmma``, with d == dv one of
:data:`WGMMA_HEAD_DIMS`; each with at least one key and every level's q, k
and v 16-byte aligned; else the CUDA-core loop of its dtype,
``f32_simt``, ``bf16_simt``, ``f16_simt``, ``f64_simt``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch._C._functorch import is_batchedtensor

from .. import count_launch
from ..flash_attention.kernel import MAX_HEAD_DIM
from ..flash_attention.ops import WGMMA_HEAD_DIMS
from ..gemm.ops import route as gemm_route
from . import kernel, ref

DTYPES = tuple(kernel.SUFFIX)
ATTN_ROUTES = kernel.ATTN_ROUTES
# the head dims of chain_attn's f32_3xtf32 route (chain_tf32_head_dim of
# csrc/chain_attn_tc.cuh): attn_tf32.cuh's block, flash attention's
# TF32_HEAD_DIMS without d 256, whose block is another
TF32_HEAD_DIMS = (32, 64, 80, 96, 128)
_TC_ATTN = {torch.float32: ("f32_3xtf32", "f32_simt", TF32_HEAD_DIMS),
            torch.bfloat16: ("bf16_wgmma", "bf16_simt", WGMMA_HEAD_DIMS),
            torch.float16: ("f16_wgmma", "f16_simt", WGMMA_HEAD_DIMS)}
_MAX_EXACT_INT = 2 ** 53        # a Python int the kernel takes as a double


def _tensor_problem(t, carry: torch.Tensor, shape, what: str):
    if not isinstance(t, torch.Tensor):
        return f"{what} is a {type(t).__name__}, not a tensor"
    if is_batchedtensor(t):
        return f"{what} is batched by torch.func.vmap"
    if tuple(t.shape) != tuple(shape):
        return f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}"
    if t.dtype != carry.dtype:
        return f"{what} is {t.dtype}, the carry {carry.dtype}"
    if t.device != carry.device:
        return f"{what} lies on {t.device}, the carry on {carry.device}"
    if not t.is_contiguous():
        return f"{what} is not contiguous"
    return None


def _carry_problem(layout, carry_pos, n_levels, args, arity):
    if len(args) != arity or len(layout) != arity:
        return f"expected {arity} operands, got {len(args)}"
    if not 0 <= carry_pos < arity or layout[carry_pos] != "single":
        return f"carry position {carry_pos} with layout {layout}"
    if int(n_levels) < 1:
        return f"{n_levels} levels"
    carry = args[carry_pos]
    if not isinstance(carry, torch.Tensor):
        return f"the carry is a {type(carry).__name__}, not a tensor"
    if carry.dtype not in DTYPES:
        return f"no chain kernel for dtype {carry.dtype}"
    if carry.device.type not in ("cpu", "cuda"):
        return f"no chain kernel on {carry.device}"
    return _tensor_problem(carry, carry, carry.shape, "the carry")


def ewise_problem(layout: tuple, carry_pos: int, n_levels: int,
                  args) -> Optional[str]:
    """Why :func:`chain_ewise` cannot take these operands, or ``None``."""
    bad = _carry_problem(layout, carry_pos, n_levels, args, 3)
    if bad:
        return bad
    carry = args[carry_pos]
    for pos, (lay, v) in enumerate(zip(layout, args)):
        if pos == carry_pos:
            continue
        what = f"operand {pos} ({lay})"
        if lay == "const":
            if isinstance(v, torch.Tensor) or not isinstance(
                    v, (bool, int, float)):
                return f"{what} is a {type(v).__name__}, not a real scalar"
            if isinstance(v, int) and abs(v) > _MAX_EXACT_INT:
                return f"{what} {v} is not exact as a double"
            continue
        if lay == "single":
            shape = carry.shape
        elif lay == "xs":
            shape = (n_levels,) + tuple(carry.shape)
        elif lay == "xs_const":
            shape = (n_levels,)
        else:
            return f"{what}: no chain kernel for this layout"
        bad = _tensor_problem(v, carry, shape, what)
        if bad:
            return bad
    if layout[0] == "const" and layout[1] == "const":
        return "y and a are both constants"
    return None


def dot_problem(layout: tuple, carry_pos: int, n_levels: int,
                args) -> Optional[str]:
    """Why :func:`chain_dot` cannot take these operands, or ``None``."""
    bad = _carry_problem(layout, carry_pos, n_levels, args, 3)
    if bad:
        return bad
    c, a, b = args
    if carry_pos != 0:
        return f"the carry is operand {carry_pos}, not c"
    if c.dim() != 2:
        return f"c has shape {tuple(c.shape)}, not a matrix"
    lead = {}
    for name, lay, t in (("a", layout[1], a), ("b", layout[2], b)):
        if lay not in ("single", "xs"):
            return f"{name} has layout {lay}"
        if not isinstance(t, torch.Tensor):
            return f"{name} is a {type(t).__name__}, not a tensor"
        lead[name] = (n_levels,) if lay == "xs" else ()
        if t.dim() != len(lead[name]) + 2:
            return f"{name} has shape {tuple(t.shape)}"
    m, n = c.shape
    k = a.shape[-1]
    bad = (_tensor_problem(a, c, lead["a"] + (m, k), "a")
           or _tensor_problem(b, c, lead["b"] + (k, n), "b"))
    return bad


def attn_problem(layout: tuple, carry_pos: int, n_levels: int,
                 args) -> Optional[str]:
    """Why :func:`chain_attn` cannot take these operands, or ``None``."""
    bad = _carry_problem(layout, carry_pos, n_levels, args, 4)
    if bad:
        return bad
    if carry_pos != 0:
        return f"the carry is operand {carry_pos}, not o"
    o = args[0]
    if o.dim() != 2:
        return f"o has shape {tuple(o.shape)}, not a matrix"
    lead = {}
    for name, lay, t in zip("qkv", layout[1:], args[1:]):
        if lay not in ("single", "xs"):
            return f"{name} has layout {lay}"
        if not isinstance(t, torch.Tensor):
            return f"{name} is a {type(t).__name__}, not a tensor"
        lead[name] = (n_levels,) if lay == "xs" else ()
        if t.dim() != len(lead[name]) + 2:
            return f"{name} has shape {tuple(t.shape)}"
    q, k, v = args[1:]
    m, dv = o.shape
    n, d = k.shape[-2:]
    for name, size in (("d", d), ("dv", dv)):
        if not 1 <= size <= MAX_HEAD_DIM:
            return f"{name} = {size} is not in [1, {MAX_HEAD_DIM}]"
    return (_tensor_problem(q, o, lead["q"] + (m, d), "q")
            or _tensor_problem(k, o, lead["k"] + (n, d), "k")
            or _tensor_problem(v, o, lead["v"] + (n, dv), "v"))


def chain_ewise(layout: tuple, carry_pos: int, n_levels: int,
                *args) -> torch.Tensor:
    """``n_levels`` levels of ``scan_step`` (see the module doc)."""
    bad = ewise_problem(layout, carry_pos, n_levels, args)
    if bad:
        raise ValueError(f"chain_ewise: {bad}")
    carry = args[carry_pos]
    if carry.device.type == "cpu":
        return ref.chain_ewise(layout, carry_pos, n_levels, *args)
    out = torch.empty_like(carry)
    if out.numel():
        kernel.launch_ewise(out, layout, carry_pos, n_levels, args)
        count_launch(chain_ewise)
    return out


chain_ewise.launches = 0


def chain_dot(layout: tuple, carry_pos: int, n_levels: int,
              *args) -> torch.Tensor:
    """``n_levels`` levels of ``gemm_tile`` (see the module doc)."""
    bad = dot_problem(layout, carry_pos, n_levels, args)
    if bad:
        raise ValueError(f"chain_dot: {bad}")
    c, a, b = args
    if c.device.type == "cpu":
        return ref.chain_dot(layout, carry_pos, n_levels, c, a, b)
    out = torch.empty_like(c)
    if out.numel():
        m, k = a.shape[-2:]
        a_stride = m * k if layout[1] == "xs" else 0
        b_stride = k * c.shape[1] if layout[2] == "xs" else 0
        path = dot_route(layout, n_levels, c, a, b)
        kernel.launch_dot(out, c, a, a_stride, b, b_stride, k, n_levels)
        count_launch(chain_dot, path)
    return out


chain_dot.launches = 0
chain_dot.routes = {}


def level_addresses(layout: tuple, n_levels: int, a: torch.Tensor,
                    b: torch.Tensor) -> list[int]:
    """Where each level's ``a`` and ``b`` start (bytes): what per-level
    replay of ``gemm_tile`` hands the GEMM at every level."""
    out = []
    for lay, t in ((layout[1], a), (layout[2], b)):
        if lay == "xs":
            step = t[0].numel() * t.element_size()
            out += [t.data_ptr() + level * step for level in range(n_levels)]
        else:
            out.append(t.data_ptr())
    return out


def dot_route(layout: tuple, n_levels: int, c: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> str:
    """The GEMM route (:func:`..gemm.ops.route`) of a ``gemm_tile`` chain:
    the one every level's ``matmul_accumulate`` would take."""
    m, n = c.shape
    return gemm_route(c.dtype, m, n, a.shape[-1],
                      level_addresses(layout, n_levels, a, b))


def chain_attn(layout: tuple, carry_pos: int, n_levels: int,
               *args) -> torch.Tensor:
    """``n_levels`` levels of ``attn_step`` (see the module doc)."""
    bad = attn_problem(layout, carry_pos, n_levels, args)
    if bad:
        raise ValueError(f"chain_attn: {bad}")
    o, q, k, v = args
    if o.device.type == "cpu":
        return ref.chain_attn(layout, carry_pos, n_levels, o, q, k, v)
    out = torch.empty_like(o)
    if out.numel():
        strides = [t[0].numel() if lay == "xs" else 0
                   for lay, t in zip(layout[1:], (q, k, v))]
        path = _attn_route_taken(layout, n_levels, strides, o, q, k, v)
        launches = kernel.launch_attn(out, o, q, strides[0], k, strides[1],
                                      v, strides[2], n_levels, path)
        for _ in range(launches):
            count_launch(chain_attn, path)
    return out


chain_attn.launches = 0
chain_attn.routes = {}


def attn_level_addresses(layout: tuple, n_levels: int, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor) -> list[int]:
    """Where each level's ``q``, ``k`` and ``v`` start (bytes): what
    per-level replay of ``attn_step`` hands the kernel at every level."""
    out = []
    for lay, t in zip(layout[1:], (q, k, v)):
        if lay == "xs":
            step = t[0].numel() * t.element_size()
            out += [t.data_ptr() + level * step for level in range(n_levels)]
        else:
            out.append(t.data_ptr())
    return out


def attn_route(layout: tuple, n_levels: int, o: torch.Tensor,
               q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route of a ``chain_attn`` of these operands (``csrc/chain.cu``
    ``attn_route`` is the same rule in C): a tensor-core route when d ==
    dv is one of its head dims, there is a key and every level's q, k and
    v is 16-byte aligned (:func:`attn_level_addresses`), which is then the
    route of every level's replay too; else the CUDA-core loop of the
    dtype."""
    if o.dtype == torch.float64:
        return "f64_simt"
    tc, simt, dims = _TC_ATTN[o.dtype]
    n, d = k.shape[-2:]
    aligned = all(x % 16 == 0 for x in attn_level_addresses(
        layout, n_levels, q, k, v))
    return (tc if aligned and d == o.shape[1] and d in dims and n >= 1
            else simt)


def _attn_route_taken(layout, n_levels, strides, o, q, k, v) -> str:
    """The route the built library's launcher takes for these operands,
    which must be :func:`attn_route`'s."""
    n, d = k.shape[-2:]
    taken = kernel.launcher_route(o.dtype, q.data_ptr(), strides[0],
                                  k.data_ptr(), strides[1], v.data_ptr(),
                                  strides[2], n, d, o.shape[1], n_levels)
    want = attn_route(layout, n_levels, o, q, k, v)
    if taken != want:
        raise RuntimeError(f"chain_attn: the launcher takes {taken} where "
                           f"attn_route says {want}")
    return taken


@functools.lru_cache(maxsize=None)
def _kernels() -> dict:
    # the tagged bodies with a chain kernel -> (wrapper, operand check)
    from ..flash_attention.ops import attn_step
    from ..gemm.ops import gemm_tile
    from ..linear_scan.ops import scan_step
    return {scan_step: (chain_ewise, ewise_problem),
            gemm_tile: (chain_dot, dot_problem),
            attn_step: (chain_attn, attn_problem)}


def chain_for(fn) -> Optional[Callable]:
    """The chain kernel's wrapper for op body ``fn``, or ``None``."""
    entry = _kernels().get(fn)
    return entry[0] if entry else None


def problem(fn, layout: tuple, carry_pos: int, n_levels: int,
            args) -> Optional[str]:
    """Why a chain of ``fn`` with these operands cannot run as one chain
    kernel (no kernel for the body, or operands it does not take), or
    ``None`` when it can."""
    entry = _kernels().get(fn)
    if entry is None:
        return f"no chain kernel for {getattr(fn, '__name__', fn)!r}"
    return entry[1](tuple(layout), carry_pos, n_levels, args)
