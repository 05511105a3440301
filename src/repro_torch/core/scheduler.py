"""Execution engine for the transactional DAG (paper §II/III).

The engine is split into three layers:

* :class:`LocalExecutor` — the **frontend**, owning the simulated
  distributed machine's *semantics*: per-rank payload stores, the
  version→holder-ranks location index, implicit transfers along inferred
  broadcast trees, version GC, and :class:`ExecutionStats` accounting.  An
  op placed on rank ``r`` can only read payloads present on ``r``; versions
  are immutable (zero-copy: a new version *is* the op's return value);
  payloads are reclaimed once their last consumer ran.  Ranks are
  simulated: every rank's payloads live in this process, on whatever
  device the op bodies put them (the GPU for CUDA tensors).
* the **Program layer** (:mod:`repro_torch.core.program`) — ``run(start=…)``
  does not plan its segment in isolation: it appends the segment to a
  pending *program trace*, and execution happens at a materialization
  boundary (a ``fetch``/``value``, a ``stats`` read, or an explicit
  :meth:`LocalExecutor.flush`).  The whole pending range is then compiled
  as ONE stitched plan, so optimization does not stop at incremental
  ``sync()`` seams, and loop-shaped programs replay a cached plan skeleton
  via the relocatable program-trace cache with zero re-analysis.
  ``stitch=False`` restores eager per-segment execution.
* :mod:`repro_torch.core.backends` — the **dispatch strategy** replaying a
  compiled :class:`~repro_torch.core.plan.ExecutionPlan` against the
  frontend's state (``backend="serial"``, the reference; ``"threads"``,
  ``"fused"``, ``"mesh"``).

``mode="interpret"`` bypasses planning entirely: the original per-op
trace-order interpreter, kept as the semantics reference.  It participates
in program deferral too — a flush interprets the whole pending range with
program-wide reader/GC scopes, so its accounting stays comparable to the
stitched plan.

With a topology cost model (:func:`repro_torch.launch.mesh.make_topology`),
``stats.estimated_makespan(topo)`` converts the transfer stream into
simulated seconds.
"""

from __future__ import annotations

import threading
import time
import weakref
from itertools import islice
from typing import Any, Optional, Union

from .backends import get_backend
from .backends.base import (BatchSlice, RankFailure, drop_versions,
                            spill_dead_buckets)
from .collectives import broadcast_tree
from .executable_cache import EXEC_CACHE, ExecutableCache
from .placement import placement_ranks
from .plan import (PLAN_CACHE_STATS, map_ranks, wavefront_flops,
                   wavefront_levels)
from .program import PROGRAM_CACHE_STATS, Segment, probe_plan, resolve_plan
from .recovery import (apply_failure, build_subset_plan, choose_replacement,
                       plan_recovery, wipe_rank)
from .shm_store import ShmRef
from .stats import ExecutionStats, TransferEvent, _nbytes
from .trace import OpNode, Workflow

__all__ = ["ExecutionStats", "TransferEvent", "LocalExecutor"]


class LocalExecutor:
    """Deterministic simulated-distributed executor for a Workflow.

    ``collective_mode``:
      * ``"tree"``  — versions with multiple reader ranks ship along a binary
        broadcast tree (paper-faithful implicit collectives);
      * ``"naive"`` — producer sends one message per reader rank (what a
        non-collective-aware runtime would do; kept for the ablation).

    ``mode``:
      * ``"plan"``      — compiled-plan replay through an execution backend
        (default);
      * ``"interpret"`` — per-op trace-order interpreter (reference).

    ``backend`` selects the plan-replay dispatch strategy: a name from
    :data:`repro_torch.core.backends.BACKENDS` or a ready
    :class:`~repro_torch.core.backends.Backend` instance.  Ignored under
    ``mode="interpret"``.

    ``topology`` is an optional cost model
    (:class:`repro_torch.launch.mesh.Topology`); the thread-pool backend
    seeds its dispatch threshold from a calibrated one, and elastic
    recovery prices its choice of a replacement rank with it.

    ``fault_injector`` (:class:`~repro_torch.core.backends.base.FaultInjector`)
    is consulted at every wavefront boundary; a :class:`RankFailure` it
    raises (or a ``procs`` worker that really died) is recovered narrowly
    from lineage (:mod:`repro_torch.core.recovery`) and the plan resumes.

    ``stitch`` (default True) defers each ``run()`` segment into a pending
    program trace and executes the stitched whole at the next
    materialization boundary (``value``/``fetch``, a ``stats`` read, or
    :meth:`flush`); ``stitch=False`` executes every segment eagerly at
    ``run()``, the pre-program behaviour.

    ``prefix_cache`` (default False) lets a flush execute a cached *prefix*
    of the pending program (at recorded segment boundaries) instead of
    always compiling the union range: a streaming client whose program
    grows by structurally-identical steps pays planning cost once, even
    when several of its steps are pending in one flush.  Off by default
    because a split program reports its wavefront decomposition per
    sub-plan (values, transfers and GC are identical; the
    cross-backend conformance contract compares ``stats.wavefronts``
    shapes, which assume whole-range stitching).  The serving runtime
    turns it on.

    ``protect_inputs`` (default False) makes every flush *input-atomic*:
    the program's external reads (versions produced before the flushed
    range) are pinned for the duration of the flush instead of being
    GC'd at their last in-program read, then explicitly dropped once the
    program succeeds.  Happy-path cost is a short extension of those
    payloads' lifetime (peak residency may rise by one generation of
    inputs); in exchange a *failed* flush leaves every external input
    materialised, so sub-ranges of the rolled-back program can be
    re-driven via :meth:`flush_slice` — the serving runtime's
    flush-failure bisection relies on this.  Overridable per flush via
    ``flush(protect_inputs=...)``.

    **Thread safety** — ``run()``, ``flush()``, ``value()``, the ``stats``
    property and ``decommission_rank()`` are serialised on an internal
    re-entrant lock and safe to call from concurrent client threads.
    *Recording* (``Workflow.call``/``apply``/``array``) is not the
    executor's surface and is NOT thread-safe: keep each workflow's
    recording on one thread (the serving runtime's single-writer
    discipline), or externally serialise recorders against surfaces that
    flush.

    **Failure contract** — if a flush fails mid-program (an op-body
    exception, or a :class:`RankFailure` recovery could not mask), the
    original exception re-raises and the executor stays *usable*: the
    failed program's recorded segments are discarded (its writes dropped —
    fetching a version it produced raises ``KeyError``), accounting is
    rolled back to the pre-flush snapshot (peaks and recovery counters
    keep their physically-true values), and payloads that existed before
    the flush — every head pinned at the program's last sync, plus (under
    ``protect_inputs``) every external input the program read — remain
    fetchable.  Both continuing to record on the same workflow and
    switching to a fresh ``Workflow`` afterwards work; switching
    workflows resets the payload stores (a new workflow restarts the
    version-id streams, so stale keys would collide).
    """

    def __init__(self, n_nodes: int = 1, collective_mode: str = "tree",
                 mode: str = "plan",
                 executable_cache: Optional[ExecutableCache] = None,
                 backend: Union[str, Any, None] = None,
                 stitch: bool = True,
                 prefix_cache: bool = False,
                 protect_inputs: bool = False,
                 fault_injector: Optional[Any] = None,
                 topology: Optional[Any] = None):
        if collective_mode not in ("tree", "naive"):
            raise ValueError(f"unknown collective_mode {collective_mode!r}")
        if mode not in ("plan", "interpret"):
            raise ValueError(f"unknown mode {mode!r}")
        self.n_nodes = n_nodes
        self.collective_mode = collective_mode
        self.mode = mode
        self.stitch = bool(stitch)
        self.prefix_cache = bool(prefix_cache)
        self.protect_inputs = bool(protect_inputs)
        self.backend = get_backend(backend if backend is not None else "serial")
        # fault tolerance: a FaultInjector consulted at wavefront
        # boundaries; a topology cost model pricing elastic replacement
        # choices; the permanent-death record (dead rank -> immediate
        # replacement) and its path-compressed rank map threaded through
        # planning after an elastic rebind
        self.fault_injector = fault_injector
        self.topology = topology
        self._decommissioned: dict[int, int] = {}
        self._rank_map: Optional[dict[int, int]] = None
        # payload stores: rank -> version_key -> payload
        self._stores: dict[int, dict[tuple[int, int], Any]] = {
            r: {} for r in range(n_nodes)
        }
        # location index: version_key -> set of holder ranks (O(1) queries)
        self._where: dict[tuple[int, int], set[int]] = {}
        # incremental live footprint (matches the old full-store rescan:
        # bytes deduplicated across replicas, payloads counted per replica)
        self._key_bytes: dict[tuple[int, int], int] = {}
        self._live_bytes = 0
        self._live_entries = 0
        self._init_seen = 0            # wf.initial items already materialised
        # fused-batch residency registry: BatchBuckets with lazy rows still
        # resident in the stores (see backends.base.spill_dead_buckets)
        self._lazy_buckets: set = set()
        self._exec_cache = executable_cache if executable_cache is not None else EXEC_CACHE
        self._stats = ExecutionStats()
        self._round_counter = 0
        # pending program trace: deferred run() segments awaiting a flush
        self._pending: list[Segment] = []
        self._wf: Optional[Workflow] = None
        # the workflow whose version keys currently populate the stores
        # (weakly held: _wf is dropped at flush so finished workflows can
        # be reclaimed, but a *switch* to a different workflow must reset
        # the stores — Workflow() restarts the version-id streams)
        self._wf_token: Optional[weakref.ref] = None
        # serialises the public surfaces (run/flush/value/stats/
        # decommission_rank) against each other; re-entrant because a
        # stats read or value() flushes internally
        self._lock = threading.RLock()
        # global wavefront ordinal of the executing plan's first level —
        # backends stamp it onto TransferEvents for the makespan model
        self._wavefront_base = 0

    # -- observable state (materialization boundaries) -----------------------
    @property
    def stats(self) -> ExecutionStats:
        """Execution accounting; reading it materialises any pending program."""
        with self._lock:
            if self._pending:
                self._flush()
            return self._stats

    def flush(self, *, prefix_cache: Optional[bool] = None,
              protect_inputs: Optional[bool] = None) -> ExecutionStats:
        """Execute the pending program trace (no-op when nothing pends).

        ``prefix_cache`` overrides the constructor setting for this flush
        only (the serving runtime's planning policy: replay cached
        per-segment plans when the pending program is one client's step
        stream, plan the whole stitched program when segments from many
        clients could fuse into shared batches).  ``protect_inputs``
        likewise overrides the constructor setting for this flush only
        (input-atomic execution — see the class docstring).

        On a mid-program failure the original exception re-raises with the
        executor in the documented usable state (see the class docstring's
        failure contract).
        """
        with self._lock:
            if self._pending:
                prev = (self.prefix_cache, self.protect_inputs)
                if prefix_cache is not None:
                    self.prefix_cache = prefix_cache
                if protect_inputs is not None:
                    self.protect_inputs = protect_inputs
                try:
                    self._flush()
                finally:
                    self.prefix_cache, self.protect_inputs = prev
            return self._stats

    def flush_slice(self, wf: Workflow, start: int, end: int
                    ) -> ExecutionStats:
        """Execute ``wf.ops[start:end]`` as its own program.

        The flush-failure *bisection* entry point (serving runtime): when a
        multi-request flush fails, the executor rolls the whole range back
        and discards its segments — but the recorded trace still holds
        every request's ops.  The caller (which knows the per-request
        segment boundaries) re-drives sub-ranges through this, narrowing
        attribution to the truly-failing request; each call runs under the
        same exception-safe flush contract as a normal flush (a failing
        sub-range rolls back alone, the executor stays usable for the next
        probe).

        Soundness of re-driving a sub-range in recorded order: the failed
        flush must have run with ``protect_inputs`` — then its rollback
        left every external input of the program materialised, not just
        the last-sync pinned heads (an input superseded *within* the
        failed batch is no head, yet an innocent sub-range still needs
        it).  Probes themselves always run input-atomically too, so a
        failing *group* probe cannot GC an innocent member's inputs out
        from under the narrower re-probes that follow.  A sub-range whose
        inputs were produced by an earlier failed sub-range raises (those
        writes were dropped), which is exactly the attribution the
        bisection wants.  Anything still pending flushes first (sub-range
        replay must not interleave with a live program).
        """
        with self._lock:
            if self._pending:
                self._flush()
            token = self._wf_token
            if token is not None and token() is not wf:
                self._reset_stores()
            self._wf_token = weakref.ref(wf)
            self._wf = wf
            self._place_initial(wf, len(wf.initial))
            if start >= end:
                return self._stats
            self._pending.append(
                Segment(start, end, self._pinned(wf), len(wf.initial)))
            prev = self.protect_inputs
            self.protect_inputs = True
            try:
                return self._flush()
            finally:
                self.protect_inputs = prev

    def compact(self, wf: Workflow) -> int:
        """Truncate ``wf``'s executed trace prefix (bounded-memory serving).

        Flushes anything pending, then drops every executed op record,
        rebases the survivors, and prunes version histories / producer
        maps / placed initial payloads down to what is still live
        (:meth:`Workflow.compact_trace`).  Steady-state memory becomes
        O(live state) instead of O(steps ever served); the relocatable
        program-trace cache keys survive rebasing, so warm loops keep
        replaying cached plans afterwards.  The documented trade: lineage
        below the compaction horizon is gone, so fault recovery can no
        longer recompute it (checkpoint first if that matters).  Returns
        the number of op records removed.
        """
        with self._lock:
            if self._pending:
                self._flush()
            token = self._wf_token
            mine = token is not None and token() is wf
            removed, placed = wf.compact_trace(
                len(wf.ops), self._init_seen if mine else 0)
            if mine and removed:
                self._init_seen = placed
            return removed

    # -- payload access ------------------------------------------------------
    def value(self, version) -> Any:
        """Fetch a version's payload from whichever rank holds it (O(1)).

        A materialization boundary: any pending program segments execute
        first.  A CUDA payload is returned as it lies on the card (no
        synchronisation).  A lazy fused-batch row
        (:class:`~repro_torch.core.backends.base.BatchSlice`) is copied out
        of its stacked buffer here — a copy, not a view, so the buffer does
        not outlive its other rows — and written back, so repeated fetches
        copy once; ``stats.fetch_bytes_copied`` counts those bytes.
        Shared-memory payloads (``procs`` backend) come back as *zero-copy
        views* of the worker's segment for NumPy and CPU tensors, and as
        one host-to-device copy for a CUDA tensor (counted), also written
        back so repeated fetches attach once.
        """
        with self._lock:
            if self._pending:
                self._flush()
            ranks = self._where.get(version.key)
            if not ranks:
                raise KeyError(f"no payload for {version!r}")
            payload = self._stores[next(iter(ranks))][version.key]
            if type(payload) is BatchSlice:
                concrete = payload.concrete()
                payload.release()
                self._stats.fetch_bytes_copied += _nbytes(concrete)
                for r in ranks:
                    self._stores[r][version.key] = concrete
                payload = concrete
            elif type(payload) is ShmRef:
                concrete, copied = payload.view()
                self._stats.fetch_bytes_copied += copied
                for r in ranks:
                    self._stores[r][version.key] = concrete
                payload = concrete
            return payload

    def _holders(self, vkey) -> list[int]:
        return sorted(self._where.get(vkey, ()))

    # -- store bookkeeping (all mutations flow through these) ----------------
    def _place(self, rank: int, vkey, payload) -> None:
        ranks = self._where.get(vkey)
        if ranks is None:
            self._where[vkey] = ranks = set()
        if rank in ranks:
            return
        ranks.add(rank)
        self._stores[rank][vkey] = payload
        self._live_entries += 1
        if vkey not in self._key_bytes:
            nb = _nbytes(payload)
            self._key_bytes[vkey] = nb
            self._live_bytes += nb

    def _drop(self, vkey) -> None:
        ranks = self._where.pop(vkey, None)
        if ranks is None:
            return
        for r in ranks:
            del self._stores[r][vkey]
        self._live_entries -= len(ranks)
        self._live_bytes -= self._key_bytes.pop(vkey, 0)

    def _note_live(self) -> None:
        if self._live_bytes > self._stats.peak_live_bytes:
            self._stats.peak_live_bytes = self._live_bytes
        if self._live_entries > self._stats.peak_live_payloads:
            self._stats.peak_live_payloads = self._live_entries

    # -- transfers --------------------------------------------------------------
    def _transfer(self, vkey, payload, src: int, dst: int, kind: str,
                  round_id: int, wavefront: int = 0):
        self._place(dst, vkey, payload)
        self._stats.transfers.append(
            TransferEvent(vkey, src, dst, _nbytes(payload), round_id, kind,
                          wavefront)
        )

    def _ship(self, vkey, reader_ranks: set[int], wavefront: int = 0) -> None:
        """Make ``vkey`` available on every rank in ``reader_ranks``.

        Tree mode builds one binary broadcast tree over {holder} ∪ readers —
        the paper's dynamically-constructed partial collective.
        """
        holders = self._holders(vkey)
        assert holders, f"version {vkey} was never materialised"
        missing = sorted(set(reader_ranks) - set(holders))
        if not missing:
            return
        root = holders[0]
        payload = self._stores[root][vkey]
        if self.collective_mode == "naive" or len(missing) == 1:
            for dst in missing:
                self._round_counter += 1
                self._transfer(vkey, payload, root, dst, "p2p",
                               self._round_counter, wavefront)
            return
        tree = broadcast_tree(root, [root] + missing)
        for round_pairs in tree.rounds:
            self._round_counter += 1
            for src, dst in round_pairs:
                self._transfer(vkey, payload, src, dst, "broadcast",
                               self._round_counter, wavefront)

    # -- wavefront decomposition -------------------------------------------------
    @staticmethod
    def wavefronts(wf: Workflow, start: int = 0, end: Optional[int] = None) -> list[int]:
        """Ops per dependency level — the DAG parallelism profile.

        Delegates to :func:`repro_torch.core.plan.wavefront_levels`, the single
        source of the level recurrence for both execution modes.
        """
        end = len(wf.ops) if end is None else end
        return wavefront_levels(wf, start, end)[1]

    # -- execution ------------------------------------------------------------
    def run(self, wf: Workflow, start: int = 0) -> ExecutionStats:
        """Append ``wf.ops[start:]`` to the program trace (and, without
        stitching, execute it immediately).

        Under stitching the returned stats object is live: it reflects the
        segment once a materialization boundary flushes the program.

        Switching to a *different* ``Workflow`` object flushes anything the
        previous one left pending, then **resets the payload stores**:
        ``Workflow()`` restarts the version-id streams, so the old
        workflow's keys would collide with (and shadow) the new one's.
        Fetch a finished workflow's results before running the next one.
        """
        with self._lock:
            if self._wf is not None and self._wf is not wf and self._pending:
                self._flush()
            token = self._wf_token
            if token is not None and token() is not wf:
                self._reset_stores()
            self._wf_token = weakref.ref(wf)
            end = len(wf.ops)
            if start >= end:
                # nothing newly recorded: keep initial-array placement
                # current (a fetch of a fresh array must see its payload)
                # without opening an empty segment
                if self._pending:
                    self._wf = wf
                    seg = self._pending[-1]
                    seg.init_upto = len(wf.initial)
                    seg.pinned = self._pinned(wf)
                else:
                    # nothing pends, so hold no strong reference: the
                    # workflow refers to this executor, and the cycle would
                    # keep every payload alive (device memory included)
                    # until the cyclic garbage collector runs
                    self._place_initial(wf, len(wf.initial))
                return self._stats
            self._wf = wf
            if self._pending and self._pending[-1].end != start:
                # overlapping or rewound range: the pending trace is not a
                # contiguous program — materialise it first (the flush
                # clears _wf; restore it for the segment appended below)
                self._flush()
                self._wf = wf
            self._pending.append(
                Segment(start, end, self._pinned(wf), len(wf.initial)))
            if not self.stitch:
                return self._flush()
            return self._stats

    def _reset_stores(self) -> None:
        """Forget every payload: the stores' keys belong to a previous
        workflow whose version-id streams a fresh ``Workflow()`` restarts.

        Machine state survives (decommissioned ranks, the elastic rank
        map, stats, caches, the round counter); only payload residency and
        its live accounting reset.  The backend drops its own payload state
        too (process-pool worker arenas hold the same stale keys).
        """
        self.backend.reset(self)
        for store in self._stores.values():
            store.clear()
        self._where.clear()
        self._key_bytes.clear()
        self._live_bytes = 0
        self._live_entries = 0
        self._init_seen = 0
        self._lazy_buckets.clear()

    # -- program flush ---------------------------------------------------------
    def _pinned(self, wf: Workflow) -> set:
        # Every ref's *head* (latest version as of this sync) is pinned: the
        # user may fetch() it, and — under incremental sync — ops recorded
        # after this segment may still read it (the conformance fuzzer found
        # the original user-arrays-only policy reclaiming an apply-created
        # head that a later segment consumed).  Superseded versions can
        # never gain new readers (recording always reads the then-current
        # head), so they remain reclaimable after their last recorded
        # reader; under stitching only the *last* pending segment's snapshot
        # governs the program, so a head one sync pinned is dropped at its
        # true last read once a later segment supersedes it.
        return {ref.head.key for ref in wf.refs.values()}

    def _place_initial(self, wf: Workflow, upto: int) -> None:
        # Materialise initial payloads where the sequential program created
        # them (``wf.array(..., rank=r)``); transfers away from there are
        # implicit.  Only items recorded since the last placement are new.
        if self._init_seen < upto:
            rm = self._rank_map
            for vkey, (payload, rank) in islice(
                    wf.initial.items(), self._init_seen, upto):
                if vkey not in self._where:
                    if rm:
                        rank = rm.get(rank, rank)
                    self._place(rank, vkey, payload)
            self._init_seen = upto

    def _flush(self) -> ExecutionStats:
        pending, self._pending = self._pending, []
        wf = self._wf
        # the workflow reference only serves the pending trace — dropping
        # it lets a finished workflow (its op list, index maps and initial
        # payloads) be reclaimed while the executor lives on
        self._wf = None
        last = pending[-1]
        self._place_initial(wf, last.init_upto)
        start, end = pending[0].start, last.end
        if start >= end:
            return self._stats
        # observability: attribute process-wide cache traffic to this flush
        ph, pm = PLAN_CACHE_STATS["hits"], PLAN_CACHE_STATS["misses"]
        gh, gm = PROGRAM_CACHE_STATS["hits"], PROGRAM_CACHE_STATS["misses"]
        eh, em = self._exec_cache.hits, self._exec_cache.misses
        st = self._stats
        # pre-flush snapshot for the failure contract: if execution dies
        # mid-program, _abort_flush rolls accounting back to here and
        # discards the failed range's writes, leaving the executor usable
        snap = (st.ops_executed, st.copies_elided, len(st.transfers),
                len(st.wavefronts), len(st.wavefront_flops),
                self._round_counter)
        # input-atomic flush: external reads not already pinned ride the
        # pinned set for the whole program, so a mid-program failure
        # cannot have GC'd an input a re-driven sub-range would need
        protected: frozenset = frozenset()
        if self.protect_inputs:
            protected = frozenset(
                self._program_inputs(wf, start, end) - last.pinned)
        try:
            if self.mode == "interpret":
                self._run_interpret(wf, start, end,
                                    last.pinned | protected if protected
                                    else last.pinned)
            else:
                self._run_program(wf, pending, start, end, protected)
        except BaseException:
            self._abort_flush(wf, start, end, snap)
            raise
        finally:
            st.plan_cache_hits += PLAN_CACHE_STATS["hits"] - ph
            st.plan_cache_misses += PLAN_CACHE_STATS["misses"] - pm
            st.program_cache_hits += PROGRAM_CACHE_STATS["hits"] - gh
            st.program_cache_misses += PROGRAM_CACHE_STATS["misses"] - gm
            st.exec_cache_hits += self._exec_cache.hits - eh
            st.exec_cache_misses += self._exec_cache.misses - em
        if protected:
            # success: the protected inputs are superseded (they were not
            # heads at the last sync) with no readers left — drop them now
            # so input atomicity costs lifetime, not steady-state memory
            present = [k for k in protected if k in self._where]
            if present:
                self._live_bytes, self._live_entries = drop_versions(
                    present, self._stores, self._where, self._key_bytes,
                    self._live_bytes, self._live_entries)
                spill_dead_buckets(self)
        return st

    @staticmethod
    def _program_inputs(wf: Workflow, start: int, end: int) -> set:
        """Version keys ``wf.ops[start:end]`` reads but does not produce.

        Trace order makes one pass sufficient: any in-range read of an
        in-range write necessarily follows that write.
        """
        written: set = set()
        ext: set = set()
        for node in wf.ops[start:end]:
            for v in node.reads:
                if v.key not in written:
                    ext.add(v.key)
            for v in node.writes:
                written.add(v.key)
        return ext

    def _abort_flush(self, wf: Workflow, start: int, end: int,
                     snap: tuple) -> None:
        """Restore a usable executor after a failed program execution.

        The failed range's segments were already popped from ``_pending``
        (they are *discarded* — the contract, not a leak: re-running them
        against half-mutated stores could double-apply effects).  This
        rolls the accounting back to the pre-flush snapshot and drops
        every version the failed range wrote, so the stores hold exactly
        the pre-flush payloads: pinned heads from before the program stay
        fetchable, while fetching anything the failed program produced
        raises ``KeyError`` instead of returning a phantom.

        Peaks and recovery counters are deliberately *not* rolled back —
        they record physically-true high-water marks and recovery work
        that really ran.  Live-footprint counters are recomputed from the
        stores: the serial hot loop mirrors them into locals and writes
        them back only on success, so their incremental values are
        unreliable mid-flight (store/index/byte maps are mutated inline and
        stay mutually consistent).
        """
        st = self._stats
        ops, copies, n_tr, n_wf, n_wff, rnd = snap
        st.ops_executed = ops
        st.copies_elided = copies
        del st.transfers[n_tr:]
        del st.wavefronts[n_wf:]
        del st.wavefront_flops[n_wff:]
        # events past the snapshot are gone, so their round ids are free
        # to be re-issued — later plans never collide
        self._round_counter = rnd
        for node in wf.ops[start:end]:
            for v in node.writes:
                vkey = v.key
                ranks = self._where.pop(vkey, None)
                if ranks is None:
                    continue
                for r in ranks:
                    dead = self._stores[r].pop(vkey, None)
                    if type(dead) is BatchSlice:
                        dead.release()
                self._key_bytes.pop(vkey, None)
        spill_dead_buckets(self)
        self._live_entries = sum(len(s) for s in self._stores.values())
        self._live_bytes = sum(self._key_bytes.get(k, 0)
                               for k in self._where)

    def _run_program(self, wf: Workflow, pending: list, start: int,
                     end: int, protected: frozenset = frozenset()) -> None:
        """Execute the pending program, optionally as cached prefixes.

        Default (``prefix_cache=False``, or a single pending segment):
        resolve-and-run the union range — the stitched-whole behaviour.

        With ``prefix_cache`` on and several segments pending, recorded
        segment boundaries become candidate split points: the largest
        candidate range starting at the current position whose plan is
        *already cached* (exact or relocatable — :func:`probe_plan`, which
        never builds) executes first, and only a totally-cold remainder
        pays a plan build.  A streaming client whose per-step programs
        were planned individually therefore replays N pending steps as N
        cached plans instead of building an N-step super-plan it will
        never see again.  Normalization assigns ids in first-appearance
        order, so a prefix's relocatable signature is exactly the front
        of the full program's — prefix probes are cheap and sound.

        GC safety at a split boundary ``b``: a version produced before
        ``b`` and read at or after ``b`` is necessarily still its ref's
        head at ``b`` (recording always reads then-current heads), hence
        in segment ``b``'s pinned snapshot — a prefix plan can never drop
        a payload a later sub-range needs.
        """
        if not self.prefix_cache or len(pending) == 1:
            self._run_planned(wf, start, end,
                              pending[-1].pinned | protected if protected
                              else pending[-1].pinned)
            return
        # protected inputs join every sub-plan's pinned set: over-pinning a
        # sub-range is always GC-safe, and the relocatable cache key only
        # normalizes pinned keys the sub-range actually reads, so warm
        # prefix probes keep hitting
        pin_of = {seg.end: (seg.pinned | protected if protected
                            else seg.pinned)
                  for seg in pending}
        bounds = [seg.end for seg in pending]       # strictly increasing
        pos = start
        while pos < end:
            plan = None
            nxt = end
            for b in reversed(bounds):              # largest range first
                if b <= pos:
                    break
                p = probe_plan(wf, pos, b, self.n_nodes,
                               self.collective_mode, self._where,
                               pin_of[b], rank_map=self._rank_map)
                if p is not None:
                    plan, nxt = p, b
                    break
            if plan is not None:
                self._run_planned(wf, pos, nxt, pin_of[nxt], preplan=plan)
            else:
                # cold at pos: when some *later* pending segment's own plan
                # is already cached, build only up to the first seam and
                # compose — the cached segments then replay as probe hits
                # instead of being swallowed into a cold union rebuild
                # (incremental stitching).  Probing a future segment with
                # current holder state is speculative: a miss only costs
                # the union build we were about to pay anyway, and the
                # authoritative probe re-runs at the seam with true state.
                nxt = end
                later = [b for b in bounds if b > pos]
                if len(later) > 1:
                    for lo, hi in zip(later, later[1:]):
                        if probe_plan(wf, lo, hi, self.n_nodes,
                                      self.collective_mode, self._where,
                                      pin_of[hi],
                                      rank_map=self._rank_map) is not None:
                            nxt = later[0]
                            break
                self._run_planned(wf, pos, nxt, pin_of[nxt])
            pos = nxt

    # -- planned replay (default) ---------------------------------------------
    def _run_planned(self, wf: Workflow, start: int, end: int,
                     pinned: set, preplan=None) -> ExecutionStats:
        stats = self._stats
        current = preplan if preplan is not None else resolve_plan(
            wf, start, end, self.n_nodes, self.collective_mode, self._where,
            pinned, rank_map=self._rank_map)
        while current is not None:
            base_round = self._round_counter
            self._wavefront_base = len(stats.wavefronts)
            try:
                self.backend.execute(self, wf, current)
            except RankFailure as failure:
                # backends raise at a wavefront boundary: levels [0, level)
                # are fully committed, the failed level untouched.  Account
                # the completed prefix, then recover and resume from the
                # boundary — the loop re-enters with the replanned suffix.
                level = failure.level if failure.level is not None else 0
                lo = (current.levels[level][0]
                      if level < len(current.levels)
                      else len(current.schedule))
                stats.ops_executed += lo
                stats.copies_elided += sum(
                    p.n_writes for p in current.schedule[:lo])
                stats.wavefronts.extend(current.wavefront_counts[:level])
                stats.wavefront_flops.extend(current.level_flops[:level])
                # the prefix's transfers consumed relative rounds from this
                # plan's budget; skip the whole budget so recovery/suffix
                # round ids never collide with it
                self._round_counter = base_round + current.n_rounds
                current = self._recover_planned(wf, current, level, failure,
                                                pinned)
                continue
            stats.ops_executed += len(current.schedule)
            # zero-copy accounting: every InOut write in pass-by-value C++
            # semantics would deep-copy; versioning just re-points.
            stats.copies_elided += current.total_writes
            self._round_counter = base_round + current.n_rounds
            # wavefronts accumulate across program flushes
            stats.wavefronts.extend(current.wavefront_counts)
            stats.wavefront_flops.extend(current.level_flops)
            current = None
        # program-end residency pass: whatever backend ran, partially-dead
        # fused buckets must not outlive the flush (serial and threads
        # release rows they GC; the spill copies out the survivors so
        # device residency matches the live-set accounting)
        spill_dead_buckets(self)
        return stats

    # -- fault recovery --------------------------------------------------------
    def _note_death(self, dead: int, replacement: Optional[int] = None) -> int:
        """Record a permanent rank death; returns its replacement and
        refreshes the path-compressed elastic rank map."""
        alive = [r for r in range(self.n_nodes)
                 if r != dead and r not in self._decommissioned]
        if replacement is None:
            replacement = choose_replacement(dead, alive, self.topology)
        if replacement not in alive:
            raise ValueError(
                f"replacement rank {replacement} is not a surviving rank")
        self._decommissioned[dead] = replacement
        # path-compress: a replacement that later died itself forwards to
        # its own (transitively live) replacement — deaths are ordered, so
        # every chain terminates at a surviving rank
        rm = {}
        for d in self._decommissioned:
            r = d
            while r in self._decommissioned:
                r = self._decommissioned[r]
            rm[d] = r
        self._rank_map = rm
        return rm[dead]

    def _recover_planned(self, wf: Workflow, plan, level: int, failure,
                         pinned: set):
        """Narrow recovery at a failed wavefront boundary.

        Materialises the failure against the stores, walks plan lineage to
        the minimal ancestor closure of the lost still-needed versions
        (:func:`repro_torch.core.recovery.plan_recovery`), replays that
        closure as a recovery sub-plan with the injector suspended, and
        returns the failed plan's suffix *replanned* from the post-recovery
        holder state (the original plan's precomputed ships assumed
        pre-failure stores) — or None when the failure hit the final
        boundary.
        """
        stats = self._stats
        t0 = time.perf_counter()
        if failure.permanent:
            self._note_death(failure.rank)
        apply_failure(self, failure)
        suffix = (plan.schedule[plan.levels[level][0]:]
                  if level < len(plan.levels) else ())
        suffix_ids = [p.op_id for p in suffix]
        needed = set(pinned)
        for p in suffix:
            for k in p.arg_keys:
                if k is not None:
                    needed.add(k)
        rec_plan, restored, _replaced = plan_recovery(
            self, wf, needed, rank_map=self._rank_map,
            future=frozenset(suffix_ids))
        stats.recoveries += 1
        stats.restored_versions += restored
        if rec_plan is not None:
            self._execute_recovery_plan(wf, rec_plan)
        resumed = None
        if suffix_ids:
            resumed = build_subset_plan(wf, suffix_ids, self.n_nodes,
                                        self.collective_mode, self._where,
                                        pinned, self._rank_map)
        stats.recovery_time_s += time.perf_counter() - t0
        return resumed

    def _execute_recovery_plan(self, wf: Workflow, plan) -> None:
        """Replay a recovery sub-plan (injector suspended — recovery never
        re-faults itself) and account it as recomputed work."""
        stats = self._stats
        base_round = self._round_counter
        self._wavefront_base = len(stats.wavefronts)
        inj = self.fault_injector
        if inj is not None:
            inj.suspend()
        try:
            self.backend.execute(self, wf, plan)
        finally:
            if inj is not None:
                inj.resume()
        n = len(plan.schedule)
        stats.ops_executed += n
        stats.recomputed_ops += n
        stats.copies_elided += plan.total_writes
        self._round_counter = base_round + plan.n_rounds
        stats.wavefronts.extend(plan.wavefront_counts)
        stats.wavefront_flops.extend(plan.level_flops)

    def decommission_rank(self, wf: Workflow, rank: int,
                          replacement: Optional[int] = None) -> int:
        """Elastically retire ``rank``: re-bind its placements onto a
        surviving rank and narrowly recover whatever only it held.

        The explicit (caller-initiated) half of elastic degradation — the
        implicit half is a ``permanent=True`` kill policy firing mid-plan.
        Any pending program flushes first (it was planned for the old world
        size); subsequent plans re-bind cached skeletons to the shrunken
        placement via the program cache's skeleton index instead of paying
        re-analysis.  Returns the replacement rank.
        """
        if self.n_nodes <= 1:
            raise ValueError("cannot decommission the only rank")
        if rank in self._decommissioned:
            raise ValueError(f"rank {rank} already dead")
        with self._lock:
            if self._pending:
                self._flush()
            stats = self._stats
            t0 = time.perf_counter()
            replacement = self._note_death(rank, replacement)
            lost = wipe_rank(self, rank)
            if lost:
                # still-demanded versions: every ref head (fetchable /
                # readable by ops recorded later), plus reads of ops
                # recorded but not yet synced — those snapshot then-current
                # heads that later records may since have superseded
                recorded_upto = getattr(wf, "_synced_upto", len(wf.ops))
                needed = set(self._pinned(wf))
                for node in wf.ops[recorded_upto:]:
                    for v in node.reads:
                        needed.add(v.key)
                rec_plan, restored, _replaced = plan_recovery(
                    self, wf, needed, rank_map=self._rank_map,
                    future=frozenset(range(recorded_upto, len(wf.ops))))
                stats.recoveries += 1
                stats.restored_versions += restored
                if rec_plan is not None:
                    self._execute_recovery_plan(wf, rec_plan)
                stats.recovery_time_s += time.perf_counter() - t0
            return replacement

    # -- reference interpreter (trace order, per-op) --------------------------
    def _reader_ranks(self, ops, i: int = 0) -> dict:
        """Per version, the set of (mapped) ranks that will read it — the
        "queue of communications involving the same object" the paper builds
        its trees from.  Recomputed over the remaining ops after an elastic
        rebind (the precomputed sets would still name the dead rank)."""
        reader_ranks: dict[tuple[int, int], set[int]] = {}
        for op_node in ops[i:]:
            for v in op_node.reads:
                for r in map_ranks(placement_ranks(op_node.placement),
                                   self._rank_map):
                    reader_ranks.setdefault(v.key, set()).add(r)
        return reader_ranks

    def _run_interpret(self, wf: Workflow, start: int, end: int,
                       pinned: set) -> ExecutionStats:
        ops = wf.ops[start:end]

        # Program-wide wavefront levels: transfers are attributed to the
        # global level ordinal they feed (the makespan model's overlap key).
        level_of, counts = wavefront_levels(wf, start, end)
        base = len(self._stats.wavefronts)

        # Reader refcounts for version GC within this program.
        readers: dict[tuple[int, int], int] = {}
        for op_node in ops:
            for v in op_node.reads:
                readers[v.key] = readers.get(v.key, 0) + 1

        reader_ranks = self._reader_ranks(ops)

        # wavefronts accumulate across program flushes (extended up front so
        # a mid-program recovery sub-plan appends after this program's
        # levels; content is identical to the loop-end extend it replaces)
        self._stats.wavefronts.extend(counts)
        self._stats.wavefront_flops.extend(wavefront_flops(wf, start, end))

        inj = self.fault_injector
        # Ship each version to all its future readers the moment it exists —
        # started eagerly (async in real Bind), giving comm/compute overlap.
        i = 0
        n = len(ops)
        while i < n:
            op_node = ops[i]
            wavefront = base + level_of[op_node.op_id] - 1
            if inj is not None and inj.armed:
                try:
                    inj.check(self, wavefront, op_index=i)
                except RankFailure as failure:
                    self._recover_interpret(wf, ops, i, failure, pinned)
                    reader_ranks = self._reader_ranks(ops, i)
                    continue        # retry op i against the healed stores
            ranks = map_ranks(placement_ranks(op_node.placement),
                              self._rank_map)
            # 1. implicit transfers for inputs not local yet
            for v in op_node.reads:
                self._ship(v.key, set(ranks) | (reader_ranks.get(v.key) or set()),
                           wavefront)
            # 2. execute the transaction on its rank(s)
            payload_args = []
            for ref, v_or_const, intent in op_node.args:
                if ref is None:
                    payload_args.append(v_or_const)
                else:
                    payload_args.append(self.value(v_or_const))
            result = op_node.fn(*payload_args)
            if not isinstance(result, tuple):
                result = (result,)
            if len(result) != len(op_node.writes):
                raise ValueError(
                    f"{op_node.name} returned {len(result)} payloads for "
                    f"{len(op_node.writes)} written args")
            for rank in ranks:
                for v, payload in zip(op_node.writes, result):
                    self._place(rank, v.key, payload)
            # zero-copy accounting: every InOut write in pass-by-value C++
            # semantics would deep-copy; versioning just re-points.
            self._stats.copies_elided += len(op_node.writes)
            self._stats.ops_executed += 1
            self._note_live()
            # 3. version GC: drop payloads whose last reader has run
            for v in op_node.reads:
                readers[v.key] -= 1
                if readers[v.key] <= 0 and v.key not in pinned:
                    self._drop(v.key)
            i += 1
        return self._stats

    def _recover_interpret(self, wf: Workflow, ops, i: int, failure,
                           pinned: set) -> None:
        """Interpreter-side narrow recovery before retrying op ``i``.

        Same shape as :meth:`_recover_planned` minus the suffix replan: the
        interpreter re-ships on demand, so after the lineage closure replays
        (through the plan machinery — recovery is planned work even under
        ``mode="interpret"``) the per-op loop simply resumes.
        """
        stats = self._stats
        t0 = time.perf_counter()
        if failure.permanent:
            self._note_death(failure.rank)
        apply_failure(self, failure)
        remaining = ops[i:]
        needed = set(pinned)
        for op_node in remaining:
            for v in op_node.reads:
                needed.add(v.key)
        rec_plan, restored, _replaced = plan_recovery(
            self, wf, needed, rank_map=self._rank_map,
            future=frozenset(op_node.op_id for op_node in remaining))
        stats.recoveries += 1
        stats.restored_versions += restored
        if rec_plan is not None:
            self._execute_recovery_plan(wf, rec_plan)
        stats.recovery_time_s += time.perf_counter() - t0
