"""Execution accounting shared by the executor frontend and all backends.

:class:`ExecutionStats` is the observable behaviour of one workflow
execution — transfers (with round ids: transfers of one collective round fly
concurrently), live-set peaks, wavefront decomposition.  It is backend- and
mode-agnostic: every execution backend appends the same event stream.

With a topology cost model (:class:`repro_torch.launch.mesh.Topology` or anything
exposing ``transfer_time(src, dst, nbytes)``) the stats convert message
counts into *estimated simulated time*: :meth:`ExecutionStats.estimated_makespan`
charges each transfer round the maximum of its concurrent hops, which makes
``tree`` vs ``naive`` collectives and backend-vs-backend ablations comparable
in seconds, not just message counts.  Transfers carry the global wavefront
ordinal they precede, so the default *contention-aware* makespan overlaps
each level's communication with its compute (``max(comm, compute)`` per
level); ``overlap=False`` keeps the legacy summed model for A/B comparison.
"""

from __future__ import annotations

import dataclasses
from typing import Any


def _nbytes(x: Any) -> int:
    """Payload bytes: ``.nbytes`` of a NumPy array or a ``torch.Tensor``
    (``numel * element_size`` — the same count NumPy gives for the same
    shape and dtype); 0 for constants and other objects."""
    n = getattr(x, "nbytes", None)
    if n is not None:
        return int(n)
    return 0


@dataclasses.dataclass
class TransferEvent:
    """One point-to-point hop of an implicit transfer."""

    version_key: tuple[int, int]
    src: int
    dst: int
    nbytes: int
    round_id: int          # rounds of one collective may fly concurrently
    collective: str        # "p2p" | "broadcast" | "reduce"
    # global wavefront ordinal (index into ``ExecutionStats.wavefronts``)
    # of the level this transfer feeds — lets the makespan model overlap a
    # level's communication with its compute
    wavefront: int = 0


@dataclasses.dataclass
class ExecutionStats:
    """Observable behaviour of one workflow execution."""

    ops_executed: int = 0
    transfers: list[TransferEvent] = dataclasses.field(default_factory=list)
    copies_elided: int = 0          # InOut writes that classical by-value would copy
    peak_live_bytes: int = 0
    peak_live_payloads: int = 0
    # Wavefront decomposition: level -> number of ops runnable concurrently.
    # Accumulated across incremental ``run()`` segments (one entry per level
    # of every executed segment, in execution order).
    wavefronts: list[int] = dataclasses.field(default_factory=list)
    # Critical-path compute per level (max over ranks of the summed
    # ``OpNode.flops`` placed on that rank) — aligned with ``wavefronts``,
    # accumulated the same way; priced by ``Topology.flops_per_s``.
    wavefront_flops: list[int] = dataclasses.field(default_factory=list)
    # Observability: cache traffic attributable to this executor's flushes
    # (sampled as deltas of the process-wide counters around each flush) —
    # lets stitched-replay reuse be asserted in tests and shown in benches.
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    program_cache_hits: int = 0
    program_cache_misses: int = 0
    exec_cache_hits: int = 0
    exec_cache_misses: int = 0
    # Fault tolerance (core.recovery): ``recoveries`` counts handled
    # RankFailures; ``recomputed_ops`` the lineage-recovery ops re-executed
    # (a subset of ``ops_executed`` — recovery work is real work);
    # ``restored_versions`` the versions rehydrated from a checkpoint
    # barrier or re-placed from ``wf.initial`` instead of recomputed;
    # ``recovery_time_s`` wall-clock seconds spent planning + executing
    # recovery sub-plans (the "narrow recovery vs full replay" bench unit).
    recoveries: int = 0
    recomputed_ops: int = 0
    restored_versions: int = 0
    recovery_time_s: float = 0.0
    # Bytes a ``value()``/``fetch`` actually copied out of backend-owned
    # storage into a fresh buffer (shared-memory rehydration, fused-bucket
    # row slicing).  Zero-copy reads — rank-local store hits, read-only
    # ``ShmRef`` views — add nothing, so tests can assert the no-copy fetch
    # path by byte count instead of guessing from timings.
    fetch_bytes_copied: int = 0
    # Process-pool backend observability: frontend->worker control messages
    # (plan slices shipped, run/epoch triggers, seed payloads).  A
    # steady-state loop iteration on a worker-resident plan should cost one
    # "run plan N, epoch K" message per worker — per-op control traffic in
    # this counter is a dispatch-overhead regression.  Not part of the
    # cross-backend conformance contract (simulated backends leave it 0).
    control_messages: int = 0

    @property
    def recompute_ratio(self) -> float:
        """Fraction of executed ops that were lineage-recovery recomputation.

        0.0 on fault-free runs; strictly < 1.0 whenever recovery was
        narrower than re-running everything that executed.
        """
        return self.recomputed_ops / self.ops_executed if self.ops_executed \
            else 0.0

    @property
    def bytes_transferred(self) -> int:
        return sum(t.nbytes for t in self.transfers)

    @property
    def message_count(self) -> int:
        return len(self.transfers)

    def transfer_depth(self, version_key: tuple[int, int]) -> int:
        """Number of *rounds* (latency hops) used to move one version."""
        rounds = {t.round_id for t in self.transfers if t.version_key == version_key}
        return len(rounds)

    @property
    def critical_path(self) -> int:
        return len(self.wavefronts)

    @property
    def max_parallelism(self) -> int:
        return max(self.wavefronts) if self.wavefronts else 0

    def estimated_comm_time(self, topology) -> float:
        """Simulated seconds spent communicating under ``topology``.

        Transfers sharing a ``round_id`` fly concurrently (one round of a
        broadcast/reduce tree), so a round costs the *max* of its hops;
        rounds are serialised.  Naive collectives emit one round per message,
        so the same formula prices the tree-vs-naive ablation fairly.
        """
        rounds: dict[int, float] = {}
        for t in self.transfers:
            dt = topology.transfer_time(t.src, t.dst, t.nbytes)
            if dt > rounds.get(t.round_id, -1.0):
                rounds[t.round_id] = dt
        return sum(rounds.values())

    def estimated_compute_time(self, topology) -> float:
        """Simulated seconds spent computing under ``topology``.

        Levels serialise along the critical path; within a level, ops run
        concurrently across ranks but serialise on a rank, so each level is
        charged its busiest rank's summed ``OpNode.flops`` (accumulated in
        ``wavefront_flops``) at the topology's ``flops_per_s`` rate.  A
        topology without a positive ``flops_per_s`` (the default) prices
        compute at zero — communication-only makespans, the pre-flops
        behaviour.
        """
        rate = getattr(topology, "flops_per_s", 0.0) or 0.0
        if rate <= 0.0 or not self.wavefront_flops:
            return 0.0
        return sum(f / rate for f in self.wavefront_flops)

    def estimated_makespan(self, topology, op_time_s: float = 0.0,
                           overlap: bool = True) -> float:
        """Estimated simulated makespan of the execution under ``topology``.

        The default model is *contention-aware*: each wavefront level
        overlaps its communication (the rounds feeding that level, priced
        as serialised round-maxima) with its compute (critical-path flops
        at the topology's ``flops_per_s`` rate) and costs
        ``max(comm, compute)``; levels serialise.  This models Bind's
        eager asynchronous ships (a version travels the moment it exists,
        well before its consuming level starts), so it is an *optimistic*
        bound — perfect prefetch hides a level's input transfers behind
        earlier compute.  ``overlap=False`` keeps the legacy summed model
        (``comm_total + compute_total``), the *pessimistic* no-prefetch
        bound; real machines land between the two.  The models agree
        whenever no level has both terms (in particular whenever the
        topology prices compute at zero, so the default flip preserves
        all communication-only makespans).

        ``op_time_s`` additionally charges a uniform per-level cost
        (``critical_path * op_time_s``) in both models.
        """
        if not overlap:
            return (self.estimated_comm_time(topology)
                    + self.estimated_compute_time(topology)
                    + self.critical_path * op_time_s)
        rounds: dict[tuple[int, int], float] = {}
        for t in self.transfers:
            key = (t.wavefront, t.round_id)
            dt = topology.transfer_time(t.src, t.dst, t.nbytes)
            if dt > rounds.get(key, -1.0):
                rounds[key] = dt
        comm: dict[int, float] = {}
        for (w, _r), dt in rounds.items():
            comm[w] = comm.get(w, 0.0) + dt
        rate = getattr(topology, "flops_per_s", 0.0) or 0.0
        flops = self.wavefront_flops
        total = 0.0
        n_levels = max(len(flops), max(comm) + 1 if comm else 0)
        for w in range(n_levels):
            c = comm.get(w, 0.0)
            f = flops[w] / rate if rate > 0.0 and w < len(flops) else 0.0
            total += c if c >= f else f
        return total + self.critical_path * op_time_s


class LatencyStats:
    """Per-request latency accounting for the serving runtime.

    Records wall-clock samples (seconds) and answers the questions a
    service dashboard asks: p50/p99 quantiles and the mean.  Percentiles
    use the nearest-rank method over a sort of the recorded samples —
    sample counts are request counts (thousands, not billions), so exact
    quantiles are affordable and reproducible.
    """

    __slots__ = ("samples",)

    def __init__(self) -> None:
        self.samples: list[float] = []

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank quantile, ``q`` in [0, 100]; 0.0 when empty."""
        s = self.samples
        if not s:
            return 0.0
        ordered = sorted(s)
        rank = max(0, min(len(ordered) - 1,
                          int(round(q / 100.0 * (len(ordered) - 1)))))
        return ordered[rank]

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    def summary(self, scale: float = 1e3) -> dict:
        """Dashboard row (default unit: milliseconds)."""
        return {
            "count": len(self.samples),
            "mean": self.mean * scale,
            "p50": self.p50 * scale,
            "p99": self.p99 * scale,
        }

    def __repr__(self) -> str:
        return (f"LatencyStats(n={len(self.samples)}, "
                f"p50={self.p50 * 1e3:.3f}ms, p99={self.p99 * 1e3:.3f}ms)")
