"""Executor-callable entry point of the linear recurrence.

``scan_step`` is the per-level form of ``y_t = a_t ⊙ y_{t-1} + x_t``,
shaped for the Bind tracer (reference: ``repro/kernels/linear_scan/ops.py``):
the carry ``y`` is ``InOut``, and the ``"ewise"`` tag marks the body as a
shape-preserving element-wise function, so a fused chain of these levels
runs as one chain kernel (:mod:`repro_torch.kernels.chain`).
"""

from __future__ import annotations

from repro_torch.core.trace import In, InOut


def scan_step(y, a, x):
    """One linear-recurrence level: ``y ← a ⊙ y + x``."""
    return a * y + x


scan_step.__bind_intents__ = (InOut, In, In)
scan_step.__bind_kernel__ = "ewise"
