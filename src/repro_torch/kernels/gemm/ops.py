"""Public GEMM wrappers: the hand-written kernel on CUDA, the plain version
on CPU.

``matmul(a, b)`` computes ``a @ b`` and ``matmul_accumulate(c, a, b)``
computes ``c + a @ b`` (the Bind tile transaction ``gemm(a, b, c: InOut)``)
in one launch.  Both take 2-D float32, bfloat16, float16 or float64
tensors of one dtype on one device and return a new tensor of that dtype;
``matmul``'s ``out_dtype`` asks for any other of the four as output (the
reference kernel's ``out_dtype``: the accumulator rounded once to it; it
does not change the route).  A strided view is copied into a row-major
one first.  The kernel masks ragged edges itself, so unlike the
reference's ``ops.py`` nothing is padded.

On a CUDA tensor a wrapper launches the kernel or raises; on a CPU tensor,
and only there, it computes the plain version (:mod:`.ref`); on a ``meta``
tensor (a dry run: shapes, no storage) it returns an empty ``meta`` result
of the kernel's shape and dtype, launches nothing, and adds the call's
``2 M N K`` operations to ``meta_flops``.  Each wrapper counts its kernel
launches in ``launches`` (a plain integer on the function), so a run can
show that its main path went through the kernel, and each launch's route
in ``routes`` (route name -> launches).

:func:`route` says which tile loop a launch takes (``csrc/gemm_routes.cuh``
is the same rule in C, and :func:`.kernel.launcher_route` asks the built
library): float32 on the TF32 tensor cores in 3xTF32 (``f32_3xtf32``:
three TF32 products of hi and lo halves, each K panel summed apart and
added with IEEE adds) when 16-byte loads can read both operands (every
address 16-byte aligned, ``k`` and ``n`` multiples of 4, ``k > 0``), and
on the CUDA cores (``f32_simt``, one IEEE FMA chain an element) otherwise,
so a ragged ``k`` or ``n`` or an odd offset takes ``f32_simt``; bfloat16
and float16 on the tensor cores (``bf16_wgmma`` / ``f16_wgmma``: one
``wgmma`` tile loop fed by TMA, its operand type the inputs') when TMA
can read both operands and on the CUDA cores with an fp32 accumulator
otherwise (``bf16_simt`` / ``f16_simt``), float64 on the f64 tensor
cores.  The chain kernel's
``chain_dot`` takes the same route for its chain as per-level replay takes
at every level.

A tensor batched by ``torch.func.vmap`` has no storage a kernel could read,
so both wrappers raise ``TypeError`` on one, on every device, before any
launch.  A launch that fails stays a ``RuntimeError`` and propagates.

``gemm_tile(c, a, b)`` is the executor-callable tile transaction ``c ← c +
a @ b``, tagged ``"dot"`` so a fused chain of it runs as one chain kernel
(:mod:`repro_torch.kernels.chain`), and marked ``__bind_vmap__ = False``
so the fused backend runs its buckets per op without stacking them first
(the reference's rule for bodies vmap cannot batch).  A 2-D tile of a
kernel dtype that is not contiguous is copied into a row-major one first.
It launches the kernel exactly when :func:`accumulate_problem` (the
wrapper's own checks) then passes, and otherwise computes the reference's
``c + a @ b`` (:func:`accumulate_body`, which counts its calls in
``accumulate_body.calls``): batched, integer or mixed-dtype tiles compute
as in the reference instead of raising.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch._C._functorch import is_batchedtensor

from ...compat import jax_matmul, jax_operands
from .. import count_body, count_launch, count_meta, row_major
from . import kernel, ref

DTYPES = tuple(kernel.SYMBOLS)
# the card launches the kernel, the host computes its plain version, meta
# tensors get their shapes (and the operations counted)
DEVICES = ("cpu", "cuda", "meta")
# the routes, in the order of bind_gemm::Route (csrc/gemm_routes.cuh)
ROUTES = ("f32_simt", "bf16_simt", "bf16_wgmma", "f64_dmma", "f16_simt",
          "f32_3xtf32", "f16_wgmma")


def route(dtype: torch.dtype, m: int, n: int, k: int,
          addresses=()) -> str:
    """The route of a GEMM problem: ``(m, k) @ (k, n)`` of ``dtype`` whose
    ``a`` and ``b`` operands start at ``addresses`` (device byte addresses;
    for a chain, every level's).  float32 goes to the tensor cores when
    16-byte loads can read its operands: every address 16-byte aligned,
    ``k > 0`` and row strides (``4k``, ``4n`` bytes) multiples of 16
    bytes; bfloat16 and float16 when TMA can: the same with ``2k``, ``2n``
    bytes."""
    aligned = all(int(x) % 16 == 0 for x in addresses)
    if dtype == torch.float32:
        tc = k > 0 and k % 4 == 0 and n % 4 == 0 and aligned
        return "f32_3xtf32" if tc else "f32_simt"
    if dtype == torch.float64:
        return "f64_dmma"
    if dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"no GEMM route for dtype {dtype}")
    tma = k > 0 and k % 8 == 0 and n % 8 == 0 and aligned
    kind = "bf16" if dtype == torch.bfloat16 else "f16"
    return f"{kind}_wgmma" if tma else f"{kind}_simt"


def _problem(*tensors) -> Optional[tuple[type, str]]:
    """Why the kernel cannot take these operands, as the exception type
    and message its wrappers raise, or ``None`` when it can."""
    first = tensors[0]
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            return TypeError, f"expected a torch.Tensor, got {type(t).__name__}"
        if is_batchedtensor(t):
            return TypeError, ("the GEMM kernel cannot take a tensor batched "
                               "by torch.func.vmap")
        if t.dim() != 2:
            return ValueError, f"expected a 2-D tensor, got shape {tuple(t.shape)}"
        if t.dtype not in DTYPES:
            return TypeError, (f"dtype {t.dtype} is not supported; expected "
                               f"one of {DTYPES}")
        if t.dtype != first.dtype:
            return TypeError, f"mixed dtypes {first.dtype} and {t.dtype}"
        if t.device != first.device:
            return ValueError, f"tensors on {first.device} and {t.device}"
    if first.device.type not in DEVICES:
        return ValueError, f"unsupported device {first.device}"
    return None


def _check(*tensors: torch.Tensor) -> None:
    bad = _problem(*tensors)
    if bad:
        raise bad[0](bad[1])


def _shapes(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    return a.shape[0], b.shape[1]


def _accumulate_problem(c, a, b) -> Optional[tuple[type, str]]:
    bad = _problem(c, a, b)
    if bad:
        return bad
    if a.shape[1] != b.shape[0]:
        return ValueError, (f"inner dimensions differ: {tuple(a.shape)} @ "
                            f"{tuple(b.shape)}")
    if tuple(c.shape) != (a.shape[0], b.shape[1]):
        return ValueError, (f"c has shape {tuple(c.shape)}, expected "
                            f"{(a.shape[0], b.shape[1])}")
    return None


def accumulate_problem(c, a, b) -> Optional[str]:
    """Why :func:`matmul_accumulate` cannot take ``c``, ``a``, ``b`` (its
    own checks, before any launch), or ``None`` when it can."""
    bad = _accumulate_problem(c, a, b)
    return bad[1] if bad else None


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a @ b`` with the accumulator of :func:`.ref.acc_dtype`, rounded
    once to ``out_dtype`` (default ``a``'s dtype; any of :data:`DTYPES`)."""
    a, b = row_major(DTYPES, a, b)
    _check(a, b)
    m, n = _shapes(a, b)
    out_dtype = a.dtype if out_dtype is None else out_dtype
    if out_dtype not in DTYPES:
        raise TypeError(f"out_dtype {out_dtype} is not supported; expected "
                        f"one of {DTYPES}")
    if a.device.type == "cpu":
        return ref.matmul(a, b, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if a.device.type == "meta":
        count_meta(matmul, 2 * m * n * a.shape[1])
        return out
    if out.numel():
        path = route(a.dtype, m, n, a.shape[1], (a.data_ptr(), b.data_ptr()))
        kernel.launch(a, b, None, out)
        count_launch(matmul, path)
    return out


matmul.launches = 0
matmul.routes = {}
matmul.meta_flops = 0


def matmul_accumulate(c: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """``c + a @ b``, the sum taken in the accumulator type, in one launch."""
    c, a, b = row_major(DTYPES, c, a, b)
    bad = _accumulate_problem(c, a, b)
    if bad:
        raise bad[0](bad[1])
    m, n = c.shape
    if a.device.type == "cpu":
        return ref.matmul_accumulate(c, a, b)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if a.device.type == "meta":
        count_meta(matmul_accumulate, 2 * m * n * a.shape[1])
        return out
    if out.numel():
        path = route(a.dtype, m, n, a.shape[1], (a.data_ptr(), b.data_ptr()))
        kernel.launch(a, b, c, out)
        count_launch(matmul_accumulate, path)
    return out


matmul_accumulate.launches = 0
matmul_accumulate.routes = {}
matmul_accumulate.meta_flops = 0


# --------------------------------------------------------------------------
# Executor-callable entry point (reference: repro/kernels/gemm/ops.py)
# --------------------------------------------------------------------------

from repro_torch.core.trace import In, InOut  # noqa: E402


def gemm_tile(c, a, b):
    """One accumulation level of the tile transaction: ``c ← c + a @ b``.

    Operands the GEMM kernel takes (:func:`accumulate_problem`, once 2-D
    tiles of its dtypes are row-major) go through
    :func:`matmul_accumulate` (the kernel on the card, the plain version on
    the CPU); any others get the reference's own expression, decided
    before any launch: :func:`accumulate_body`.
    """
    c, a, b = row_major(DTYPES, c, a, b)
    if accumulate_problem(c, a, b) is None:
        return matmul_accumulate(c, a, b)
    return accumulate_body(c, a, b)


def accumulate_body(c, a, b):
    """The reference's body ``c + a @ b`` on operands the kernel does not
    take: NumPy tiles stay NumPy; with a tensor among them, as jax computes
    it (:func:`repro_torch.compat.jax_operands`, ``jax_matmul``): batched
    shapes, integer and mixed dtypes.  Counts its calls in ``calls``."""
    count_body(accumulate_body)
    if all(isinstance(x, np.ndarray) for x in (c, a, b)):
        return c + a @ b
    c, a, b = jax_operands(c, a, b)
    return c + jax_matmul(a, b)


accumulate_body.calls = 0
gemm_tile.__bind_intents__ = (InOut, In, In)
gemm_tile.__bind_kernel__ = "dot"
gemm_tile.__bind_vmap__ = False
