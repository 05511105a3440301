"""Pluggable execution backends for compiled-plan replay.

The :class:`~repro_torch.core.scheduler.LocalExecutor` frontend owns the
simulated-machine *semantics* — per-rank stores, version locations,
transfers, live-footprint accounting, stats.  A **backend** owns only the
*dispatch strategy* for a compiled
:class:`~repro_torch.core.plan.ExecutionPlan`:

* ``"serial"``  — :class:`SerialPlanBackend`: wavefront-ordered one-op-at-a-
  time replay, the reference semantics;
* ``"threads"`` — :class:`ThreadPoolBackend`: each wavefront level's ops are
  dispatched concurrently over a worker pool (the plan guarantees they share
  no version dependencies);
* ``"fused"``   — :class:`FusedBatchBackend`: same-signature ops of one
  level run as one ``torch.func.vmap`` call over stacked operands, and whole
  *signature chains* (:class:`~repro_torch.core.plan.ChainSlice`) as one
  call each;
* ``"procs"``   — :class:`ProcessPoolBackend`: one long-lived worker
  *process* per simulated rank, rank-local stores in shared memory, ships
  as real cross-process memcpys — GIL-free parallelism for NumPy op bodies
  the ``threads`` backend cannot overlap, plus *real* worker-kill fault
  injection feeding the recovery machinery (a CUDA payload is staged
  through host memory);
* ``"mesh"``    — :class:`MeshBackend`: ``fused`` on a rank mesh (one
  torch device per rank, repeats allowed): ships run as ``ppermute``
  broadcast rounds that copy each payload onto every rank's device, and
  kernel-tagged chains as one hand-written chain-kernel launch each.

All backends replay the same plan against the same frontend state, so
payload values and the transfer event stream are identical across backends;
only wall-clock (and, for concurrent backends, the moment a level's
in-flight payloads peak) differs.
"""

from __future__ import annotations

from .base import Backend, BatchBucket, BatchSlice, spill_dead_buckets
from .serial import SerialPlanBackend
from .threadpool import ThreadPoolBackend
from .fused import FusedBatchBackend
from .procs import ProcessPoolBackend
from .mesh import MeshBackend

BACKENDS: dict[str, type] = {
    SerialPlanBackend.name: SerialPlanBackend,
    ThreadPoolBackend.name: ThreadPoolBackend,
    FusedBatchBackend.name: FusedBatchBackend,
    ProcessPoolBackend.name: ProcessPoolBackend,
    MeshBackend.name: MeshBackend,
}


def get_backend(spec) -> Backend:
    """Resolve a backend name (or pass through a ready instance)."""
    if isinstance(spec, Backend):
        return spec
    cls = BACKENDS.get(spec) if isinstance(spec, str) else None
    if cls is not None:
        return cls()
    raise ValueError(
        f"unknown execution backend {spec!r}; "
        f"available: {sorted(BACKENDS)}")


__all__ = ["Backend", "BatchBucket", "BatchSlice", "SerialPlanBackend",
           "ThreadPoolBackend", "FusedBatchBackend", "MeshBackend",
           "ProcessPoolBackend", "BACKENDS", "get_backend",
           "spill_dead_buckets"]
