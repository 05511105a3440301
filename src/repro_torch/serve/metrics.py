"""Serving-side observability: request counters + latency quantiles.

:class:`ServeMetrics` is the service twin of
:class:`~repro_torch.core.stats.ExecutionStats` — the executor accounts ops,
transfers and cache traffic; this accounts *requests*: admissions, sheds,
completions, failures, how often flushes actually coalesced work across
requests, and end-to-end/queue latency distributions
(:class:`~repro_torch.core.stats.LatencyStats`).  The batching effectiveness
counters are what the serving tests and bench assert: a runtime absorbing
N concurrent one-step clients should show ``coalesced_requests`` close to
N and ``batched_flushes >= 1``, while the one-at-a-time arm shows 0.
Overload is observable, not mysterious: ``requests_shed`` and
``queue_depth_hwm`` say how hard admission pushed back, ``bisections`` /
``requests_salvaged`` say how often a failed batch was narrowed to its
true culprit, and ``compactions`` / ``trace_ops_hwm`` bound the shared
trace's growth.
"""

from __future__ import annotations

import dataclasses

from ..core.stats import LatencyStats


@dataclasses.dataclass
class ServeMetrics:
    """Counters and latency distributions for one serving runtime."""

    requests_admitted: int = 0
    requests_completed: int = 0
    requests_failed: int = 0
    requests_cancelled: int = 0     # cancelled while still queued
    requests_rejected: int = 0      # refused at admission (poisoned session)
    requests_shed: int = 0          # refused at admission (overload)
    queue_depth_hwm: int = 0        # admission-queue high-water mark
    # flush coalescing: every executor flush issued by the serving loop;
    # "batched" ones carried >= 2 requests' segments in one program
    flushes: int = 0
    batched_flushes: int = 0
    coalesced_requests: int = 0     # requests that shared their flush
    max_batch: int = 0              # widest batch observed
    # flush-failure bisection: failed multi-request flushes narrowed by
    # re-driving per-request sub-ranges (probes = flush_slice calls)
    bisections: int = 0
    bisect_probes: int = 0
    requests_salvaged: int = 0      # completed despite a failed batch flush
    # trace compaction (bounded-memory serving)
    compactions: int = 0
    ops_compacted: int = 0
    trace_ops_hwm: int = 0          # widest shared trace observed
    # end-to-end (submit -> result ready; for CUDA payloads, ready means
    # the request's kernels are enqueued) and queue (submit -> admitted)
    latency: LatencyStats = dataclasses.field(default_factory=LatencyStats)
    queue_latency: LatencyStats = dataclasses.field(
        default_factory=LatencyStats)

    def summary(self) -> dict:
        """One dashboard/bench row (latencies in milliseconds)."""
        return {
            "requests_admitted": self.requests_admitted,
            "requests_completed": self.requests_completed,
            "requests_failed": self.requests_failed,
            "requests_cancelled": self.requests_cancelled,
            "requests_rejected": self.requests_rejected,
            "requests_shed": self.requests_shed,
            "queue_depth_hwm": self.queue_depth_hwm,
            "flushes": self.flushes,
            "batched_flushes": self.batched_flushes,
            "coalesced_requests": self.coalesced_requests,
            "max_batch": self.max_batch,
            "bisections": self.bisections,
            "bisect_probes": self.bisect_probes,
            "requests_salvaged": self.requests_salvaged,
            "compactions": self.compactions,
            "ops_compacted": self.ops_compacted,
            "trace_ops_hwm": self.trace_ops_hwm,
            "latency_ms": self.latency.summary(),
            "queue_ms": self.queue_latency.summary(),
        }
