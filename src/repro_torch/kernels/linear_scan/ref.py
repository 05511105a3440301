"""Plain PyTorch version of the linear scan: the oracle.

``y_t = a_t * y_{t-1} + x_t`` with ``y_{-1} = 0``, a sequential loop over
the sequence in float32, cast to ``x.dtype`` (reference:
``repro/kernels/linear_scan/ref.py``).  The tests use it, ``chip_smoke.py``
holds the kernel against it on the card, and :mod:`.ops` uses it for CPU
tensors only.
"""

from __future__ import annotations

import torch


def linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) diagonal linear recurrence, one step at a time."""
    a32, x32 = a.float(), x.float()
    y = torch.empty_like(x32)
    h = torch.zeros_like(x32[:, 0])
    for t in range(x.shape[1]):
        h = a32[:, t] * h + x32[:, t]
        y[:, t] = h
    return y.to(x.dtype)
