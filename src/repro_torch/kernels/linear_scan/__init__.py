"""Linear recurrence ``y_t = a_t ⊙ y_{t-1} + x_t``.

Only the executor-callable level ``scan_step`` is ported so far; the
chunked ``linear_scan`` wrapper and its kernel are still to port (ROADMAP
Queue 2, item 3).
"""

from .ops import scan_step

__all__ = ["scan_step"]
