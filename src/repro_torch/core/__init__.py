"""Bind — the paper's partitioned global workflow model, on PyTorch.

Public API (the ``bind::`` namespace of the paper)::

    from repro_torch import core as bind

    @bind.op
    def gemm(a: bind.In, b: bind.In, c: bind.InOut):
        return c + a @ b

    with bind.Workflow(n_nodes=4) as wf:
        a = wf.array(...)
        with bind.node(3):
            gemm(a, b, c)      # placed on node 3, transfers implicit
        wf.sync()

Mirrors :mod:`repro.core` for one device: recording, planning (with the
plan and program-trace caches), and replay through :class:`LocalExecutor`
on the ``serial``, ``threads``, ``fused``, ``procs`` and ``mesh`` backends
or the interpreter, with fault injection and lineage recovery.
"""

from .trace import BindArray, In, InOut, Out, OpNode, Workflow, current_workflow, op
from .placement import NodeSet, node, nodes, placement_rank, placement_ranks
from .versioning import Ref, Version, VersionStore
from .collectives import (
    InferredCollective,
    TreeSchedule,
    allreduce_tree,
    broadcast_tree,
    infer_broadcasts,
    infer_reductions,
    reduce_tree,
)
from .scheduler import ExecutionStats, LocalExecutor, TransferEvent
from .stats import LatencyStats
from .plan import (
    ChainSlice,
    ExecutionPlan,
    PLAN_CACHE_STATS,
    build_plan,
    clear_plan_cache,
    plan_for,
    segment_signature,
    wavefront_flops,
)
from .program import (
    PROGRAM_CACHE_STATS,
    ProgramPlan,
    Segment,
    clear_program_cache,
    probe_plan,
    resolve_plan,
)
from .executable_cache import EXEC_CACHE, ExecutableCache
from .backends import (
    BACKENDS,
    Backend,
    BatchBucket,
    BatchSlice,
    FusedBatchBackend,
    MeshBackend,
    ProcessPoolBackend,
    SerialPlanBackend,
    ThreadPoolBackend,
    get_backend,
)
from .backends.base import FaultInjector, RankFailure
from .recovery import (
    PlanCheckpoint,
    build_subset_plan,
    choose_replacement,
    plan_recovery,
)

__all__ = [
    "BindArray", "In", "InOut", "Out", "OpNode", "Workflow", "current_workflow",
    "op", "NodeSet", "node", "nodes", "placement_rank", "placement_ranks",
    "Ref", "Version", "VersionStore", "InferredCollective", "TreeSchedule",
    "allreduce_tree", "broadcast_tree", "infer_broadcasts", "infer_reductions",
    "reduce_tree", "ExecutionStats", "LatencyStats", "LocalExecutor",
    "TransferEvent", "ChainSlice", "ExecutionPlan", "PLAN_CACHE_STATS",
    "build_plan", "clear_plan_cache", "plan_for", "segment_signature",
    "wavefront_flops", "PROGRAM_CACHE_STATS", "ProgramPlan", "Segment",
    "clear_program_cache", "probe_plan", "resolve_plan",
    "EXEC_CACHE", "ExecutableCache",
    "BACKENDS", "Backend", "BatchBucket", "BatchSlice", "SerialPlanBackend",
    "ThreadPoolBackend", "FusedBatchBackend", "MeshBackend",
    "ProcessPoolBackend", "get_backend", "FaultInjector", "RankFailure",
    "PlanCheckpoint", "build_subset_plan", "choose_replacement",
    "plan_recovery",
]
