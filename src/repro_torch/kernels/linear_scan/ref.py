"""Plain PyTorch versions of the linear scan.

:func:`linear_scan` is the oracle: ``y_t = a_t * y_{t-1} + x_t`` with
``y_{-1} = 0``, a sequential loop over the sequence in float32, cast to
``x.dtype`` (reference: ``repro/kernels/linear_scan/ref.py``).  The tests
use it, ``chip_smoke.py`` holds the kernel against it on the card, and
:mod:`.ops` uses it for CPU tensors only.

:func:`linear_scan_chunked` is the kernel's own algorithm written out in
PyTorch, bit for bit: each chunk's aggregate from zero, the carry forward
from chunk to chunk, and the recurrence again from each chunk's carry (see
``csrc/linear_scan.cu``).  Every product and sum is a PyTorch op of its
own, rounded on its own as the kernel's ``__fmul_rn`` / ``__fadd_rn`` are,
and the cast to bfloat16 or float16 rounds to nearest even as the kernel's
does, so on the same inputs it gives the kernel's exact bits.  Nothing on
the main path calls it: the tests hold it against the reference, and
``chip_smoke.py`` holds the kernel against it with ``torch.equal``.

:func:`linear_scan_grad` is the scan's backward: one more scan, over the
reversed sequence (:func:`grad_operands`), then one element-wise product.
With the plain loop as its scan it is the backward's plain version; the
entry point's backward hands it the kernel on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) diagonal linear recurrence, one step at a time."""
    a32, x32 = a.float(), x.float()
    y = torch.empty_like(x32)
    h = torch.zeros_like(x32[:, 0])
    for t in range(x.shape[1]):
        h = a32[:, t] * h + x32[:, t]
        y[:, t] = h
    return y.to(x.dtype)


def grad_operands(a: torch.Tensor, g: torch.Tensor) -> tuple:
    """The backward's scan operands: ``a`` shifted one step ahead along S
    (``a_{t+1}``, 0 in the last place) and the output gradient ``g``, both
    reversed along S.  The scan of them, reversed back, is ``h_t = g_t +
    a_{t+1} h_{t+1}`` with ``h_{S-1} = g_{S-1}``: the gradient of ``x``."""
    a_next = F.pad(a[:, 1:], (0, 0, 0, 1))
    return a_next.flip(1), g.flip(1)


def linear_scan_grad(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor, *,
                     scan=None) -> tuple:
    """``(da, dx)`` of ``y = linear_scan(a, x)`` for the output gradient
    ``g``: ``dx`` is ``scan`` (:func:`linear_scan` by default) of
    :func:`grad_operands`, reversed back (in ``g``'s dtype, float32
    inside), and ``da_t = dx_t y_{t-1}`` with ``y_{-1} = 0``, in float32,
    cast to ``a.dtype``."""
    scan = linear_scan if scan is None else scan
    dx = scan(*grad_operands(a, g)).flip(1)
    y_prev = F.pad(y[:, :-1], (0, 0, 1, 0))
    da = (dx.float() * y_prev.float()).to(a.dtype)
    return da, dx


def _step(a: torch.Tensor, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # the kernel's step: the product rounded, then the sum (never an FMA)
    return torch.add(torch.mul(a, h), x)


def linear_scan_chunked(a: torch.Tensor, x: torch.Tensor,
                        chunk: int = 128) -> torch.Tensor:
    """(B, S, D) recurrence in chunks of ``chunk`` steps, as the kernel
    computes it, vectorised over (batch, chunk, column).

    1. Each chunk's aggregate from zero, in step order: ``A = prod a_t``
       and ``X`` the chunk's recurrence from 0 (``y_end = A y_in + X``).
    2. Each chunk's carry: ``h <- A h + X`` forward over the chunks from
       0; the carry into chunk c is the value before chunk c's step.
    3. The recurrence again in every chunk from its carry; the result is
       cast to ``x.dtype``.

    The short last chunk is padded with ``a = 1``, ``x = -0.0``, a step
    that leaves every float32 value, and every sign of zero, as it was.
    """
    b, s, d = a.shape
    n = -(-s // chunk)
    pad = n * chunk - s
    a32, x32 = a.float(), x.float()
    if pad:
        a32 = F.pad(a32, (0, 0, 0, pad), value=1.0)
        x32 = F.pad(x32, (0, 0, 0, pad), value=-0.0)
    a32 = a32.view(b, n, chunk, d)
    x32 = x32.view(b, n, chunk, d)
    prod = torch.ones((b, n, d), dtype=torch.float32, device=a.device)
    agg = torch.zeros((b, n, d), dtype=torch.float32, device=a.device)
    for t in range(chunk):
        agg = _step(a32[:, :, t], agg, x32[:, :, t])
        prod = torch.mul(prod, a32[:, :, t])
    carry = torch.empty_like(agg)
    h = torch.zeros((b, d), dtype=torch.float32, device=a.device)
    for c in range(n):
        carry[:, c] = h
        h = _step(prod[:, c], h, agg[:, c])
    y = torch.empty_like(a32)
    h = carry
    for t in range(chunk):
        h = _step(a32[:, :, t], h, x32[:, :, t])
        y[:, :, t] = h
    return y.view(b, n * chunk, d)[:, :s].to(x.dtype)
