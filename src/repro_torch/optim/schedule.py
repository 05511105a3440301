"""Learning-rate schedules — ``repro/optim/schedule.py`` in PyTorch's
package, as plain functions of the step count.

The reference evaluates the schedule on a float32 jax array; here it runs
in NumPy float32 with the reference's order of operations (Python floats
folded first, as jax's weak typing folds them), so the values agree to
float32 rounding.  The result is a Python float holding that float32
value.
"""

from __future__ import annotations

import numpy as np


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    """``lr(count)``: linear warm-up from 0 to ``peak`` over ``warmup``
    steps, then a cosine decay to ``floor * peak`` at ``total``."""
    f32 = np.float32
    low = f32(floor * peak)
    span = f32((1 - floor) * peak * 0.5)

    def lr(count) -> float:
        c = f32(int(count))
        warm = f32(peak) * c / f32(max(warmup, 1))
        prog = np.clip((c - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
        cos = low + span * (f32(1.0) + np.cos(f32(np.pi) * prog))
        return float(warm if c < warmup else cos)

    return lr
