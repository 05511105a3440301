"""Compiled execution plans for the transactional DAG (interpreter → replay).

The paper's §III names run-time DAG handling the model's "critical
disadvantage": every recorded op used to pay interpreter-style bookkeeping —
an O(ranks) store scan per payload read, a full live-footprint rescan after
every op, and a fresh ``producers()`` rebuild per analysis.  This module
splits that cost out of the hot path:

* :class:`ExecutionPlan` — built **once** per recorded op segment: topological
  wavefront levels, per-version reader refcounts, segment-wide reader-rank
  sets, precomputed broadcast-tree ship schedules (relative round ids), and
  per-op GC drop lists.  Executing a plan is a pure replay: every step is a
  dict hit, no scans.
* a process-wide **plan cache** keyed on the structural signature of the
  segment (op functions, placements, version keys, initial holder state):
  iterative drivers that re-record the same DAG every step — tiled linalg,
  MapReduce rounds, training loops — pay analysis cost once and replay
  thereafter.  ``Workflow()`` resets the global id streams, so two identical
  builds of the same user code produce byte-identical signatures.

Plans are no longer restricted to one ``run()`` segment: the executor
frontend defers incremental-sync segments into a *program trace* and plans
the whole pending range at once (:mod:`repro_torch.core.program`), so
signature chains split by a sync boundary stitch back together.
:meth:`ExecutionPlan.rebind` supports the program-trace cache's
relocatable replay — a loop-shaped program whose version keys advance every
iteration re-points the cached plan skeleton at the fresh keys instead of
re-running analysis.

Plans are pure metadata (no payloads), so a cached plan is valid for any
payload values — only the *structure* (which the signature captures) matters.
Constants embedded in op args are read from the live op at replay time, never
baked into the plan.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterable

from .collectives import broadcast_tree
from .placement import placement_ranks


class PlanOp:
    """One op of a plan: everything replay needs, resolved to O(1) lookups.

    ``ships`` is a tuple of ``(version_key, root_rank, transfers)`` where
    ``transfers`` is ``((src, dst, kind, relative_round), ...)`` — the
    broadcast-tree schedule computed at plan time.  ``gc_keys`` are the
    versions whose last (execution-order) reader is this op.

    ``cached_types``/``cached_call`` memoise the executable-cache resolution:
    when the payload types match the previous replay the resolved callable
    is reused without rebuilding the abstract signature (sound because the
    port's cache always resolves to the Python body, valid for any shape).
    """

    __slots__ = ("op_id", "fn", "arg_keys", "write_keys", "exec_ranks",
                 "ships", "gc_keys", "level", "n_writes", "simple_write",
                 "binary_simple", "cached_types", "cached_call")

    def __init__(self, op_id, fn, arg_keys, write_keys, exec_ranks, ships,
                 gc_keys, level):
        self.op_id = op_id
        self.fn = fn
        self.arg_keys = arg_keys
        self.write_keys = write_keys
        self.exec_ranks = exec_ranks
        self.ships = ships
        self.gc_keys = gc_keys
        self.level = level
        self.n_writes = len(write_keys)
        # dominant case: one written version, one executing rank
        self.simple_write = len(write_keys) == 1 and len(exec_ranks) == 1
        # the replay fast path unrolls the ubiquitous binary-op shape
        self.binary_simple = self.simple_write and len(arg_keys) == 2
        self.cached_types = None
        self.cached_call = None


class ChainSlice:
    """A *signature chain*: ≥2 consecutive wavefront levels fusible into one
    dispatch.

    The static (plan-time) half of chain-fusion eligibility: every level of
    the run holds exactly ``width`` ops sharing one ``(fn, constant-position
    mask)`` signature with ``k ≥ 1`` payload arguments
    (``payload_positions``), and the level-to-level dataflow is
    *elementwise aligned* on one of them — the **carry** (``carry_pos``):
    op ``j`` of level ``i+1`` reads, at ``carry_pos``, exactly the version
    written by op ``j`` of level ``i`` and is its sole (final) reader, so
    every carried interior version lives and dies inside the chain.  The
    remaining payload positions are **chain-exterior**: they read versions
    produced *before* the chain (never a version written inside it), so a
    chain-aware backend can gather them up front — per-level varying
    exteriors are stacked and scanned as ``xs``.  Interior levels are
    guaranteed ship-free (an aligned producer/consumer pair always shares a
    rank, and exterior operands of interior ops are already resident).

    ``members`` holds the aligned schedule indices, one tuple per level:
    ``members[i+1][j]`` consumes ``members[i][j]``.  ``interior_keys`` are
    the carried version keys written by all but the last level — a
    chain-aware backend never materialises them, but must still replay
    their (virtual) commit/GC accounting so live-set stats stay
    byte-identical to serial replay.  The dynamic half (payload avals,
    constant equality/hoistability, scan traceability) is resolved at
    replay time, since plans are shape-oblivious and constants are read
    from the live ops.
    """

    __slots__ = ("members", "width", "first_level", "fn", "carry_pos",
                 "payload_positions", "interior_keys")

    def __init__(self, members, width, first_level, fn, carry_pos,
                 payload_positions, interior_keys):
        self.members = members
        self.width = width
        self.first_level = first_level   # ordinal into ExecutionPlan.levels
        self.fn = fn
        self.carry_pos = carry_pos
        self.payload_positions = payload_positions
        self.interior_keys = interior_keys

    @property
    def n_levels(self) -> int:
        return len(self.members)

    @property
    def lowerable(self):
        """Kernel-lowering tag of this chain's op body, or ``None``.

        Op functions published as executor-callable kernel entry points
        carry a ``__bind_kernel__`` annotation naming their lowering class
        (``"ewise"`` — shape-preserving elementwise bodies; ``"dot"`` —
        tile-contraction bodies).  A chain-aware backend may run a chain
        whose body carries the tag as one chain kernel; untagged bodies
        take a generic per-level loop.  Derived from ``fn`` so
        :meth:`ExecutionPlan.rebind` preserves it for free.
        """
        return getattr(self.fn, "__bind_kernel__", None)

    def __repr__(self) -> str:
        return (f"ChainSlice({getattr(self.fn, '__name__', self.fn)!r}, "
                f"{self.n_levels} levels x {self.width} ops "
                f"from level {self.first_level})")


class ExecutionPlan:
    """A compiled segment: wavefront-ordered :class:`PlanOp` schedule.

    ``levels`` are ``(lo, hi)`` index slices into ``schedule`` — the ops of
    one wavefront level, guaranteed free of mutual version dependencies, so
    a backend may dispatch them concurrently.  ``level_groups`` (one tuple
    per level) are the *signature groups*: schedule indices within the level
    sharing ``(fn, constant-position mask)`` with a single written version —
    the static half of the fused-batch eligibility test (the dynamic half,
    payload shapes/dtypes, is resolved at replay since plans are
    shape-oblivious).  Only groups of ≥2 ops are recorded;
    ``has_fusion_groups`` lets batch-aware backends skip group handling
    entirely on plans with no batching opportunity.

    ``chains`` are the :class:`ChainSlice` runs — maximal sequences of
    consecutive levels a chain-aware backend may dispatch as a single
    chain executable.  ``level_flops`` carries, per level, the
    critical-path compute (max over ranks of the summed ``OpNode.flops``
    placed on that rank) consumed by the topology cost model.

    ``level_kernels`` is the lowerable-signature annotation: per level, the
    ``__bind_kernel__`` tag when *every* op of the level shares one tagged
    op function (kernel entry points), else ``None`` — a chain-aware
    backend consults it (and the equivalent :attr:`ChainSlice.lowerable`)
    to decide which schedule slices may run as chain kernels.
    Structure-derived, so rebinding shares it with the template.

    ``inline_memo`` is the threads backend's memo of its whole-plan
    pre-sweep (:mod:`.backends.threadpool`): the plan's input keys and its
    last verdict.  Key-bearing, so a rebound plan starts without one.
    """

    __slots__ = ("schedule", "wavefront_counts", "n_rounds", "start", "end",
                 "n_nodes", "collective_mode", "total_writes", "levels",
                 "level_groups", "has_fusion_groups", "chains", "level_flops",
                 "level_kernels", "inline_memo")

    def __init__(self, schedule, wavefront_counts, n_rounds, start, end,
                 n_nodes, collective_mode, level_flops=()):
        self.schedule = schedule
        self.wavefront_counts = wavefront_counts
        self.n_rounds = n_rounds
        self.start = start
        self.end = end
        self.n_nodes = n_nodes
        self.collective_mode = collective_mode
        self.total_writes = sum(p.n_writes for p in schedule)
        self.levels = _level_slices(schedule)
        self.level_groups = tuple(
            _signature_groups(schedule, lo, hi) for lo, hi in self.levels)
        self.has_fusion_groups = any(self.level_groups)
        self.chains = _signature_chains(schedule, self.levels)
        self.level_flops = tuple(level_flops) if level_flops else \
            (0,) * len(self.levels)
        self.level_kernels = _level_kernels(schedule, self.levels)
        self.inline_memo = None     # the threads backend's last pre-sweep

    def __len__(self) -> int:
        return len(self.schedule)

    def rebind(self, schedule, start: int, end: int) -> "ExecutionPlan":
        """A structurally identical plan re-pointed at ``schedule``'s keys.

        The program-trace cache (:mod:`repro_torch.core.program`) replays a
        loop-shaped program's template plan against fresh version keys:
        every analysis product that is index- or structure-based (level
        slices, signature groups, chain member indices, wavefront counts,
        per-level flops, the relative round budget) is shared with the
        template — only the key-bearing schedule, and the chains' interior
        key sets (recomputed from it), are new.
        """
        plan = object.__new__(ExecutionPlan)
        plan.schedule = schedule
        plan.wavefront_counts = self.wavefront_counts
        plan.n_rounds = self.n_rounds
        plan.start = start
        plan.end = end
        plan.n_nodes = self.n_nodes
        plan.collective_mode = self.collective_mode
        plan.total_writes = self.total_writes
        plan.levels = self.levels
        plan.level_groups = self.level_groups
        plan.has_fusion_groups = self.has_fusion_groups
        plan.chains = tuple(
            ChainSlice(c.members, c.width, c.first_level, c.fn, c.carry_pos,
                       c.payload_positions,
                       frozenset(schedule[m].write_keys[0]
                                 for lvl in c.members[:-1] for m in lvl))
            for c in self.chains)
        plan.level_flops = self.level_flops
        plan.level_kernels = self.level_kernels
        plan.inline_memo = None     # keyed by this schedule's own inputs
        return plan


def _level_kernels(schedule, levels) -> tuple:
    """Per-level kernel-lowering tag (see :attr:`ExecutionPlan.level_kernels`).

    A level is annotated only when all its ops share one op function that
    carries ``__bind_kernel__`` — mixed or untagged levels get ``None``.
    """
    tags = []
    for lo, hi in levels:
        fn0 = schedule[lo].fn
        tag = getattr(fn0, "__bind_kernel__", None)
        if tag is not None and any(schedule[i].fn is not fn0
                                   for i in range(lo + 1, hi)):
            tag = None
        tags.append(tag)
    return tuple(tags)


def _level_slices(schedule) -> tuple[tuple[int, int], ...]:
    """Contiguous ``(lo, hi)`` runs of equal-level ops (schedule is level-major)."""
    slices = []
    lo = 0
    n = len(schedule)
    for i in range(1, n + 1):
        if i == n or schedule[i].level != schedule[lo].level:
            slices.append((lo, i))
            lo = i
    return tuple(slices)


def _signature_groups(schedule, lo: int, hi: int) -> tuple[tuple[int, ...], ...]:
    """Schedule indices in ``[lo, hi)`` grouped by static fusion signature."""
    groups: dict[tuple, list[int]] = {}
    for idx in range(lo, hi):
        p = schedule[idx]
        if not p.simple_write:      # fusion covers the 1-write/1-rank case
            continue
        mask = tuple(k is None for k in p.arg_keys)
        groups.setdefault((p.fn, mask), []).append(idx)
    return tuple(tuple(g) for g in groups.values() if len(g) >= 2)


def _chain_level_info(schedule, lo: int, hi: int):
    """``(fn, const-mask, payload positions)`` if the whole level shares
    one chain-eligible signature, else None.

    Chain-eligible: every op is ``simple_write`` with at least one payload
    argument (one of which may carry the chain) and the same ``(fn,
    constant-position mask)``.
    """
    p0 = schedule[lo]
    if not p0.simple_write:
        return None
    mask = tuple(k is None for k in p0.arg_keys)
    payload_positions = tuple(
        i for i, is_const in enumerate(mask) if not is_const)
    if not payload_positions:
        return None
    fn = p0.fn
    for idx in range(lo + 1, hi):
        p = schedule[idx]
        if (not p.simple_write or p.fn is not fn
                or tuple(k is None for k in p.arg_keys) != mask):
            return None
    return fn, mask, payload_positions


def _align_level(schedule, nlo, nhi, carry_pos, wk_pos, payload_positions,
                 chain_writes):
    """Aligned member tuple for ``[nlo, nhi)`` under ``carry_pos``, or None.

    An op aligns when its carry operand is the version written by exactly
    one previous-level member, it is that version's sole (final) reader,
    it needs no ships, and every *other* payload operand reads a version
    produced outside the chain (``chain_writes`` holds everything written
    inside it so far — an exterior reading an interior version would need
    that version materialised, which a fused chain never does).
    """
    aligned: list = [None] * (nhi - nlo)
    for idx in range(nlo, nhi):
        p = schedule[idx]
        k = p.arg_keys[carry_pos]
        pos = wk_pos.get(k)
        if (p.ships or pos is None or aligned[pos] is not None
                or k not in p.gc_keys):
            return None
        for e in payload_positions:
            if e != carry_pos and p.arg_keys[e] in chain_writes:
                return None
        aligned[pos] = idx
    return tuple(aligned)


def _signature_chains(schedule, levels) -> tuple:
    """Maximal :class:`ChainSlice` runs over consecutive levels.

    Greedy left-to-right scan: a chain starts at any level whose ops all
    share one chain-eligible signature, and extends while the next level
    (same signature, same width, no ships) is elementwise-aligned with it
    on some payload position — op ``j`` reads the version written by
    aligned op ``j`` of the previous level *and* carries it on its GC drop
    list (sole final reader), so every carried version is private to the
    chain.  The first transition that aligns locks the carry position for
    the rest of the run (a chain has ONE carry); the remaining payload
    positions must read chain-exterior versions at every level.
    """
    chains = []
    n = len(levels)
    li = 0
    while li < n - 1:
        info = _chain_level_info(schedule, *levels[li])
        if info is None:
            li += 1
            continue
        fn, mask, payload_positions = info
        lo, hi = levels[li]
        width = hi - lo
        members = [tuple(range(lo, hi))]
        chain_writes = {schedule[m].write_keys[0] for m in members[0]}
        carry_pos = None
        lj = li + 1
        while lj < n:
            nlo, nhi = levels[lj]
            if nhi - nlo != width:
                break
            nxt = _chain_level_info(schedule, nlo, nhi)
            if nxt is None or nxt[0] is not fn or nxt[1] != mask:
                break
            prev = members[-1]
            wk_pos = {schedule[m].write_keys[0]: j for j, m in enumerate(prev)}
            aligned = None
            for c in ((carry_pos,) if carry_pos is not None
                      else payload_positions):
                aligned = _align_level(schedule, nlo, nhi, c, wk_pos,
                                       payload_positions, chain_writes)
                if aligned is not None:
                    carry_pos = c
                    break
            if aligned is None:
                break
            members.append(aligned)
            chain_writes.update(schedule[m].write_keys[0] for m in aligned)
            lj += 1
        if len(members) >= 2:
            interior = frozenset(
                schedule[m].write_keys[0]
                for lvl in members[:-1] for m in lvl)
            chains.append(ChainSlice(tuple(members), width, li, fn,
                                     carry_pos, payload_positions, interior))
            li = lj
        else:
            li += 1
    return tuple(chains)


def _flops_per_level(ops, level_of: dict, n_levels: int) -> list[int]:
    """Critical-path compute per level: max over ranks of summed op flops.

    Ops of one level run concurrently across ranks but serialise on a rank,
    so a level's compute cost is the busiest rank's total.  Single source of
    truth for both execution modes (plan stores it; the interpreter calls
    :func:`wavefront_flops`) — the cost model must price them identically.
    """
    acc: dict[int, dict[int, int]] = {}
    for node in ops:
        if node.flops:
            per_rank = acc.setdefault(level_of[node.op_id], {})
            for r in placement_ranks(node.placement):
                per_rank[r] = per_rank.get(r, 0) + node.flops
    return [max(acc[lv].values()) if lv in acc else 0
            for lv in range(1, n_levels + 1)]


def wavefront_flops(wf, start: int, end: int) -> list[int]:
    """Per-level critical-path flops for a segment (see :func:`_flops_per_level`)."""
    level, counts = wavefront_levels(wf, start, end)
    return _flops_per_level(wf.ops[start:end], level, len(counts))


def segment_signature(wf, start: int, end: int) -> tuple:
    """Structural identity of ``wf.ops[start:end]`` (plan-cache key part).

    Captures op functions, names, placements and the version-key wiring;
    deliberately excludes embedded constants (read from the live op at
    replay) and payload shapes (plans are shape-oblivious).  The per-op
    signatures are hash-consed to small ints at record time
    (``Workflow._index_op``), so this is a slice of ints — cache keys hash
    and compare without revisiting the nested structure.
    """
    return tuple(wf._op_sigs[start:end])


def wavefront_levels(wf, start: int, end: int) -> tuple[dict[int, int], list[int]]:
    """Dependency level per op and ops-per-level counts for a segment.

    Level of an op = 1 + max level of the producers of the versions it
    reads *plus* the producer of the previous version of any ref it writes
    (write-after-write order on the same ref is preserved).  Single source
    of truth for both the planner and ``LocalExecutor.wavefronts`` — the
    two execution modes must report identical wavefront stats.
    """
    producers = wf.producers()
    level: dict[int, int] = {}
    counts: dict[int, int] = {}
    for node in wf.ops[start:end]:
        deps = []
        for v in node.reads:
            p = producers.get(v.key)
            if p is not None and p.op_id != node.op_id:
                deps.append(level.get(p.op_id, 0))
        for v in node.writes:
            if v.index > 0:
                prev = producers.get((v.ref_id, v.index - 1))
                if prev is not None and prev.op_id != node.op_id:
                    deps.append(level.get(prev.op_id, 0))
        lv = (max(deps) + 1) if deps else 1
        level[node.op_id] = lv
        counts[lv] = counts.get(lv, 0) + 1
    return level, [counts[k] for k in sorted(counts)]


def build_plan(wf, start: int, end: int, n_nodes: int, collective_mode: str,
               holders: dict, pinned: Iterable) -> ExecutionPlan:
    """Compile ``wf.ops[start:end]`` into an :class:`ExecutionPlan`.

    ``holders`` maps version_key -> set of ranks holding its payload at run
    start (copied, never mutated); ``pinned`` are version keys exempt from
    GC.  The simulation walks ops in execution
    order (wavefront level major, trace order minor — identical to trace
    order whenever the trace is already level-sorted, which keeps stats
    byte-compatible with the interpreter on such workflows).
    """
    ops = wf.ops[start:end]
    pinned = set(pinned)

    level, wavefront_counts = wavefront_levels(wf, start, end)
    order = sorted(range(len(ops)), key=lambda i: (level[ops[i].op_id], i))

    # -- segment-wide reader refcounts and reader-rank sets ------------------
    readers: dict[tuple[int, int], int] = {}
    reader_ranks: dict[tuple[int, int], set[int]] = {}
    for node in ops:
        rr = placement_ranks(node.placement)
        for v in node.reads:
            k = v.key
            readers[k] = readers.get(k, 0) + 1
            s = reader_ranks.get(k)
            if s is None:
                reader_ranks[k] = s = set()
            s.update(rr)

    # -- execution-order simulation: ships, writes, GC -----------------------
    sim: dict[tuple[int, int], set[int]] = {k: set(v) for k, v in holders.items()}
    naive = collective_mode == "naive"
    rel_round = 0
    schedule = []
    for i in order:
        node = ops[i]
        exec_ranks = placement_ranks(node.placement)
        ships = []
        for v in node.reads:
            k = v.key
            hold = sim.get(k)
            assert hold, f"version {k} was never materialised"
            missing = sorted((set(exec_ranks) | reader_ranks[k]) - hold)
            if not missing:
                continue
            root = min(hold)
            transfers = []
            if naive or len(missing) == 1:
                for dst in missing:
                    rel_round += 1
                    transfers.append((root, dst, "p2p", rel_round))
            else:
                tree = broadcast_tree(root, [root] + missing)
                for round_pairs in tree.rounds:
                    rel_round += 1
                    for src, dst in round_pairs:
                        transfers.append((src, dst, "broadcast", rel_round))
            hold.update(missing)
            ships.append((k, root, tuple(transfers)))
        write_keys = tuple(v.key for v in node.writes)
        for k in write_keys:
            sim[k] = set(exec_ranks)
        gc_keys = []
        for v in node.reads:
            k = v.key
            left = readers[k] - 1
            readers[k] = left
            if left <= 0 and k not in pinned and k in sim:
                gc_keys.append(k)
                del sim[k]
        schedule.append(PlanOp(
            op_id=node.op_id,
            fn=node.fn,
            arg_keys=tuple((v.key if ref is not None else None)
                           for ref, v, _ in node.args),
            write_keys=write_keys,
            exec_ranks=exec_ranks,
            ships=tuple(ships),
            gc_keys=tuple(gc_keys),
            level=level[node.op_id],
        ))
    return ExecutionPlan(tuple(schedule), wavefront_counts, rel_round,
                         start, end, n_nodes, collective_mode,
                         _flops_per_level(ops, level, len(wavefront_counts)))


# ---------------------------------------------------------------------------
# Process-wide plan cache
# ---------------------------------------------------------------------------

PLAN_CACHE_SIZE = 64
_PLAN_CACHE: "OrderedDict[tuple, ExecutionPlan]" = OrderedDict()
_PLAN_CACHE_LOCK = threading.Lock()
PLAN_CACHE_STATS = {"hits": 0, "misses": 0}


def clear_plan_cache() -> None:
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE.clear()
        PLAN_CACHE_STATS["hits"] = PLAN_CACHE_STATS["misses"] = 0


def absolute_plan_key(wf, start: int, end: int, n_nodes: int,
                      collective_mode: str, holders: dict,
                      pinned: Iterable) -> tuple:
    """Exact-identity cache key for a planned range.

    Ties the structural segment signature to everything else the simulation
    consumed: world size, collective mode, the run-start holder state of the
    versions the range *reads* (ship schedules and GC depend on nothing else
    in the stores — unrelated live payloads must not cause misses) and the
    pinned set — a hit guarantees the cached ship/GC schedules are valid
    for this run.
    """
    read_holders: dict[tuple[int, int], tuple[int, ...]] = {}
    for node in wf.ops[start:end]:
        for v in node.reads:
            k = v.key
            if k not in read_holders:
                rs = holders.get(k)
                if rs is not None:
                    read_holders[k] = tuple(sorted(rs))
    return (
        n_nodes, collective_mode, start,
        segment_signature(wf, start, end),
        tuple(sorted(read_holders.items())),
        tuple(sorted(pinned)),
    )


def _plan_cache_get(key: tuple):
    with _PLAN_CACHE_LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            _PLAN_CACHE.move_to_end(key)
            PLAN_CACHE_STATS["hits"] += 1
        else:
            PLAN_CACHE_STATS["misses"] += 1
    return plan


def _plan_cache_probe(key: tuple):
    """Like :func:`_plan_cache_get` but *silent on miss*.

    Speculative lookups (the prefix-flush probe tries several candidate
    ranges per flush) must not inflate the miss counter — a miss here is
    not a plan build, just one rejected candidate.
    """
    with _PLAN_CACHE_LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            _PLAN_CACHE.move_to_end(key)
            PLAN_CACHE_STATS["hits"] += 1
    return plan


def _plan_cache_put(key: tuple, plan: ExecutionPlan) -> None:
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > PLAN_CACHE_SIZE:
            _PLAN_CACHE.popitem(last=False)


def plan_for(wf, start: int, end: int, n_nodes: int, collective_mode: str,
             holders: dict, pinned: Iterable) -> ExecutionPlan:
    """Fetch-or-build the plan for a segment (LRU-cached process-wide).

    See :func:`absolute_plan_key` for what a hit guarantees.  The executor
    frontend goes through :func:`repro_torch.core.program.resolve_plan`, which
    backs this exact-key cache with the relocatable program-trace cache.
    """
    key = absolute_plan_key(wf, start, end, n_nodes, collective_mode,
                            holders, pinned)
    plan = _plan_cache_get(key)
    if plan is None:
        plan = build_plan(wf, start, end, n_nodes, collective_mode, holders,
                          pinned)
        _plan_cache_put(key, plan)
    return plan
