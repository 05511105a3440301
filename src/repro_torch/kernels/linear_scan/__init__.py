"""Linear recurrence ``y_t = a_t ⊙ y_{t-1} + x_t``: the chunked
``linear_scan`` over (B, S, D) and its executor-callable level
``scan_step``."""

from .ops import linear_scan, scan_step
from . import ref

__all__ = ["linear_scan", "ref", "scan_step"]
