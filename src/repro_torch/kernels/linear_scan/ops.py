"""Public entry points of the recurrence ``y_t = a_t ⊙ y_{t-1} + x_t``.

``linear_scan(a, x)`` runs the whole recurrence over ``(B, S, D)``: the
hand-written chunked kernel (:mod:`.kernel`) on CUDA tensors, the plain
sequential loop (:mod:`.ref`) on CPU tensors, and only there.  It pads S as
the reference's wrapper does (``repro/kernels/linear_scan/ops.py``) and
counts its launches in ``linear_scan.launches``.  ``backend="plain"`` asks
for the oracle on any device (the reference's ``backend="xla"``).

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

from .. import count_launch
from . import kernel, ref

DTYPES = tuple(kernel.SUFFIX)
BACKENDS = ("cuda", "plain")


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    for t in (a, x):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in DTYPES:
            raise TypeError(f"dtype {t.dtype} is not supported; expected one "
                            f"of {DTYPES}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"expected a and x of one (B, S, D) shape, got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    if a.dtype != x.dtype:
        raise TypeError(f"mixed dtypes {a.dtype} and {x.dtype}")
    if a.device != x.device:
        raise ValueError(f"tensors on {a.device} and {x.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def linear_scan(a: torch.Tensor, x: torch.Tensor, *, bs: int = 256,
                backend: str = "cuda") -> torch.Tensor:
    """``y_t = a_t ⊙ y_{t-1} + x_t`` over (B, S, D); ``y_{-1} = 0``.

    Float32 inside, the result in ``x.dtype``.  ``bs`` sets only the
    padding of S (the kernel chunks S itself).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    _check(a, x)
    if backend == "plain":
        return ref.linear_scan(a, x)
    s = a.shape[1]
    pad = (-s) % max(1, min(bs, s))
    if pad:
        a = F.pad(a, (0, 0, 0, pad))
        x = F.pad(x, (0, 0, 0, pad))
    if a.device.type == "cpu":
        out = ref.linear_scan(a, x)
    else:
        out = torch.empty_like(x)
        if out.numel():
            kernel.launch(a, x, out)
            count_launch(linear_scan)
    return out[:, :s, :]


linear_scan.launches = 0


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
