"""Pluggable execution backends for compiled-plan replay.

The :class:`~repro_torch.core.scheduler.LocalExecutor` frontend owns the
simulated-machine *semantics* — per-rank stores, version locations,
transfers, live-footprint accounting, stats.  A **backend** owns only the
*dispatch strategy* for a compiled
:class:`~repro_torch.core.plan.ExecutionPlan`.

The port has one so far: ``"serial"`` — :class:`SerialPlanBackend`,
wavefront-ordered one-op-at-a-time replay, the reference semantics.  The
reference package's other backends arrive with later slices of the port
(``ROADMAP.md``, Queue 1); asking for one of them names its slice.
"""

from __future__ import annotations

from .base import Backend
from .serial import SerialPlanBackend

BACKENDS: dict[str, type] = {
    SerialPlanBackend.name: SerialPlanBackend,
}

# reference backends not ported yet -> the ROADMAP slice that brings them
_LATER_SLICES = {
    "threads": "Slice 2",
    "fused": "Slice 2",
    "mesh": "Slice 3",
    "procs": "Slice 4",
}


def get_backend(spec) -> Backend:
    """Resolve a backend name (or pass through a ready instance)."""
    if isinstance(spec, Backend):
        return spec
    cls = BACKENDS.get(spec) if isinstance(spec, str) else None
    if cls is not None:
        return cls()
    if isinstance(spec, str) and spec in _LATER_SLICES:
        raise ValueError(
            f"execution backend {spec!r} is not ported yet: it arrives with "
            f"ROADMAP Queue 1 {_LATER_SLICES[spec]}; "
            f"available: {sorted(BACKENDS)}")
    raise ValueError(
        f"unknown execution backend {spec!r}; "
        f"available: {sorted(BACKENDS)}")


__all__ = ["Backend", "SerialPlanBackend", "BACKENDS", "get_backend"]
