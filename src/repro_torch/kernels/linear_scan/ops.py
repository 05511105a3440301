"""Public entry points of the recurrence ``y_t = a_t ⊙ y_{t-1} + x_t``.

``linear_scan(a, x)`` runs the whole recurrence over ``(B, S, D)``: the
hand-written chunked kernel (:mod:`.kernel`, one launch) on CUDA tensors,
the plain sequential loop (:mod:`.ref`) on CPU tensors, and only there.  A
strided view is copied into a row-major one first.  It pads S as the
reference's wrapper does (``repro/kernels/linear_scan/ops.py``), counts its
launches in ``linear_scan.launches`` and each launch's route in
``linear_scan.routes`` (route name -> launches): the route the built
launcher reports for the very operands it is handed, which must be the one
:func:`route` gives them.  ``backend="plain"`` asks for the oracle on any
device (the reference's ``backend="xla"``).  It is differentiable in ``a``
and ``x`` (:class:`_Scan`): the backward is one more scan, over the
reversed sequence (:func:`linear_scan_bwd`), on the same kernel on the
card, counted as the forward's launches are.  On ``meta`` tensors (a dry
run) both return empty ``meta`` outputs of the kernel's shapes and launch
nothing (the scan has no products for a FLOP count).

:func:`route` says how the kernel stages its tiles (``csrc/linear_scan.cu``
``route_of`` is the same rule in C): by TMA (``"tma"``) when ``a`` and
``x`` start 16-byte aligned and a row of D elements is a multiple of 16
bytes, else by coalesced loads (``"ldg"``); the two give the same bits.
RecurrentGemma-9B's RG-LRU width (4096) takes ``"tma"``.

``scan_step`` is the per-level form, shaped for the Bind tracer: the carry
``y`` is ``InOut``, and the ``"ewise"`` tag marks the body as a
shape-preserving element-wise function, so a fused chain of these levels
runs as one chain kernel (:mod:`repro_torch.kernels.chain`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.compat import jax_operands
from repro_torch.core.trace import In, InOut

from .. import count_launch, row_major
from . import kernel, ref

DTYPES = tuple(kernel.SUFFIX)
BACKENDS = ("cuda", "plain")
# the routes, in the order of the Route enum of csrc/linear_scan.cu
ROUTES = ("tma", "ldg")


def route(dtype: torch.dtype, d: int, addresses=()) -> str:
    """The route of a scan over rows of ``d`` elements of ``dtype`` whose
    ``a`` and ``x`` start at ``addresses`` (device byte addresses): TMA
    when every address is 16-byte aligned and a row is a multiple of 16
    bytes, else coalesced loads."""
    if dtype not in DTYPES:
        raise TypeError(f"no linear scan route for dtype {dtype}")
    row = d * dtype.itemsize
    aligned = all(int(p) % 16 == 0 for p in addresses)
    return "tma" if aligned and row % 16 == 0 else "ldg"


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    for t in (a, x):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in DTYPES:
            raise TypeError(f"dtype {t.dtype} is not supported; expected one "
                            f"of {DTYPES}")
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"expected a and x of one (B, S, D) shape, got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    if a.dtype != x.dtype:
        raise TypeError(f"mixed dtypes {a.dtype} and {x.dtype}")
    if a.device != x.device:
        raise ValueError(f"tensors on {a.device} and {x.device}")
    if a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {a.device}")


def linear_scan(a: torch.Tensor, x: torch.Tensor, *, bs: int = 256,
                backend: str = "cuda") -> torch.Tensor:
    """``y_t = a_t ⊙ y_{t-1} + x_t`` over (B, S, D); ``y_{-1} = 0``.

    Float32 inside, the result in ``x.dtype``.  ``bs`` sets only the
    padding of S (the kernel chunks S itself).  Differentiable in ``a``
    and ``x`` (:class:`_Scan`).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    a, x = row_major(DTYPES, a, x)
    _check(a, x)
    if backend == "plain":
        return ref.linear_scan(a, x)
    s = a.shape[1]
    pad = (-s) % max(1, min(bs, s))
    if pad:
        a = F.pad(a, (0, 0, 0, pad))
        x = F.pad(x, (0, 0, 0, pad))
    return _Scan.apply(a, x)[:, :s, :]


linear_scan.launches = 0
linear_scan.routes = {}


def _scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The scan of checked, padded operands: the kernel on CUDA tensors
    (:func:`_kernel_scan`), the plain loop on CPU tensors."""
    if a.device.type == "cpu":
        return ref.linear_scan(a, x)
    if a.device.type == "meta":     # a dry run: the shape, no launch
        return torch.empty_like(x)
    return _kernel_scan(a, x)


def _kernel_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One launch of the scan kernel on CUDA tensors, counted in
    ``linear_scan.launches`` and by route in ``linear_scan.routes``: the
    forward's launches and the backward's alike."""
    out = torch.empty_like(x)
    if out.numel():
        path = _route_taken(a, x)
        kernel.launch(a, x, out)
        count_launch(linear_scan, path)
    return out


class _Scan(torch.autograd.Function):
    """The scan of padded operands with its gradient.  The forward is
    :func:`_scan` (the kernel on the card, as before) and saves ``a`` and
    ``y``; the backward (:func:`linear_scan_bwd`) is one more scan over the
    reversed sequence, so on the card it is one more launch of the same
    kernel.  The padding of S is differentiated as the forward pads it:
    the caller's ``F.pad`` and slice are on the graph."""

    @staticmethod
    def forward(ctx, a, x):
        y = _scan(a, x)
        ctx.save_for_backward(a, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, y = ctx.saved_tensors
        return linear_scan_bwd(a, y, g)


def linear_scan_bwd(a: torch.Tensor, y: torch.Tensor,
                    g: torch.Tensor) -> tuple:
    """``(da, dx)`` of the scan ``y`` of ``a`` and ``x`` for the output
    gradient ``g`` (:func:`.ref.linear_scan_grad`): ``dx`` is the scan of
    ``g`` over the reversed sequence with ``a`` shifted one step ahead,
    and ``da = dx ⊙ y_{t-1}``.  The reversed scan is the scan kernel on CUDA
    tensors (one launch, counted as the forward's are) and the plain loop
    on CPU tensors."""
    a, y, g = row_major(DTYPES, a, y, g)
    _check(a, y)
    _check(a, g)
    if a.device.type == "cpu":
        return ref.linear_scan_grad(a, y, g)
    return ref.linear_scan_grad(a, y, g, scan=_scan)


def _route_taken(a: torch.Tensor, x: torch.Tensor) -> str:
    """The route the built launcher takes for these operands, held against
    :func:`route` on the same addresses: a library and a mirror that
    disagree raise before anything is launched."""
    d = a.shape[2]
    addresses = (a.data_ptr(), x.data_ptr())
    taken = ROUTES[kernel.launcher_route(a.dtype, *addresses, d)]
    want = route(a.dtype, d, addresses)
    if taken != want:
        raise RuntimeError(f"linear scan: the launcher takes {taken} where "
                           f"ops.route says {want} (d {d}, addresses "
                           f"{addresses})")
    return taken


def scan_step(y, a, x):
    """One linear-recurrence level: ``y ← a ⊙ y + x``.

    Tensors and NumPy arrays mixed in one call mix as jax mixes the
    reference's (:func:`repro_torch.compat.jax_operands`): the NumPy
    operands become tensors of jax's dtype first."""
    if any(isinstance(t, torch.Tensor) for t in (y, a, x)) and any(
            isinstance(t, np.ndarray) for t in (y, a, x)):
        y, a, x = jax_operands(y, a, x)
    return a * y + x


scan_step.__bind_intents__ = (InOut, In, In)
scan_step.__bind_kernel__ = "ewise"
