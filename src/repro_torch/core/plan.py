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

    def rebind_ranks(self, rank_map: dict, holders: dict, pinned,
                     wf=None) -> "ExecutionPlan":
        """Re-bind this plan's skeleton to a remapped rank placement.

        The elastic-degradation half of the fault-tolerance story: when a
        rank is declared permanently dead, the structural analysis (level
        slices, signature groups, chain alignment, wavefront counts) stays
        valid — only the *placement-derived* products change.  This
        re-simulates exec ranks, ship schedules and GC drop lists over the
        existing schedule with every rank sent through ``rank_map``
        (typically ``{dead: replacement}``), starting from the live
        ``holders`` state, and recomputes ``level_flops`` against the
        merged placement when ``wf`` is given (rank merging changes the
        busiest-rank sum).  Chains whose interior levels acquire ships
        under the new holder state are dropped (a fused chain must stay
        interior-ship-free); everything else is shared with the template —
        the same reuse contract as :meth:`rebind`.
        """
        pinned = set(pinned)
        mapped_exec = []
        readers: dict = {}
        reader_ranks: dict = {}
        for p in self.schedule:
            er = tuple(dict.fromkeys(rank_map.get(r, r)
                                     for r in p.exec_ranks))
            mapped_exec.append(er)
            for k in p.arg_keys:
                if k is None:
                    continue
                readers[k] = readers.get(k, 0) + 1
                s = reader_ranks.get(k)
                if s is None:
                    reader_ranks[k] = s = set()
                s.update(er)
        sim: dict = {}
        naive = self.collective_mode == "naive"
        rel_round = 0
        schedule = []
        for p, er in zip(self.schedule, mapped_exec):
            ships = []
            for k in p.arg_keys:
                if k is None:
                    continue
                hold = sim.get(k)
                if hold is None:
                    rs = holders.get(k)
                    assert rs, f"version {k} was never materialised"
                    sim[k] = hold = set(rs)
                missing = sorted((set(er) | reader_ranks[k]) - hold)
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
                            transfers.append((src, dst, "broadcast",
                                              rel_round))
                hold.update(missing)
                ships.append((k, root, tuple(transfers)))
            for k in p.write_keys:
                sim[k] = set(er)
            gc_keys = []
            for k in p.arg_keys:
                if k is None:
                    continue
                left = readers[k] - 1
                readers[k] = left
                if left <= 0 and k not in pinned and k in sim:
                    gc_keys.append(k)
                    del sim[k]
            schedule.append(PlanOp(p.op_id, p.fn, p.arg_keys, p.write_keys,
                                   er, tuple(ships), tuple(gc_keys),
                                   p.level))
        plan = object.__new__(ExecutionPlan)
        plan.schedule = tuple(schedule)
        plan.wavefront_counts = self.wavefront_counts
        plan.n_rounds = rel_round
        plan.start = self.start
        plan.end = self.end
        plan.n_nodes = self.n_nodes
        plan.collective_mode = self.collective_mode
        plan.total_writes = self.total_writes
        plan.levels = self.levels
        plan.level_groups = self.level_groups
        plan.has_fusion_groups = self.has_fusion_groups
        plan.chains = tuple(
            ChainSlice(c.members, c.width, c.first_level, c.fn, c.carry_pos,
                       c.payload_positions,
                       frozenset(plan.schedule[m].write_keys[0]
                                 for lvl in c.members[:-1] for m in lvl))
            for c in self.chains
            if not any(plan.schedule[m].ships
                       for lvl in c.members[1:] for m in lvl))
        plan.level_kernels = self.level_kernels
        plan.inline_memo = None     # keyed by this schedule's own inputs
        if wf is not None:
            acc: dict[int, dict[int, int]] = {}
            for p in plan.schedule:
                fl = wf.ops[p.op_id].flops
                if fl:
                    per_rank = acc.setdefault(p.level, {})
                    for r in p.exec_ranks:
                        per_rank[r] = per_rank.get(r, 0) + fl
            plan.level_flops = tuple(
                max(acc[lv].values()) if lv in acc else 0
                for lv in range(1, len(plan.levels) + 1))
        else:
            plan.level_flops = self.level_flops
        return plan

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


def _flops_per_level(ops, level_of: dict, n_levels: int,
                     rank_map: dict = None) -> list[int]:
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
            for r in map_ranks(placement_ranks(node.placement), rank_map):
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


def map_ranks(ranks, rank_map) -> tuple[int, ...]:
    """Send a rank tuple through an (elastic-rebind) rank map, deduplicated
    in order — two ranks merged by the map must not double-place."""
    if not rank_map:
        return tuple(ranks)
    return tuple(dict.fromkeys(rank_map.get(r, r) for r in ranks))


def build_plan(wf, start: int, end: int, n_nodes: int, collective_mode: str,
               holders: dict, pinned: Iterable,
               rank_map: dict = None) -> ExecutionPlan:
    """Compile ``wf.ops[start:end]`` into an :class:`ExecutionPlan`.

    ``holders`` maps version_key -> set of ranks holding its payload at run
    start (copied, never mutated); ``pinned`` are version keys exempt from
    GC.  ``rank_map`` (elastic degradation, :mod:`repro_torch.core.recovery`)
    re-points recorded placements at surviving ranks — every
    placement-derived product (exec ranks, ships, flops attribution) is
    computed in the mapped space.  The simulation walks ops in execution
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
        rr = map_ranks(placement_ranks(node.placement), rank_map)
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
        exec_ranks = map_ranks(placement_ranks(node.placement), rank_map)
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
                         _flops_per_level(ops, level, len(wavefront_counts),
                                          rank_map))


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
                      pinned: Iterable, rank_map: dict = None) -> tuple:
    """Exact-identity cache key for a planned range.

    Ties the structural segment signature to everything else the simulation
    consumed: world size, collective mode, the run-start holder state of the
    versions the range *reads* (ship schedules and GC depend on nothing else
    in the stores — unrelated live payloads must not cause misses), the
    pinned set, and the elastic rank map (a remapped plan must never
    satisfy an unmapped lookup or vice versa) — a hit guarantees the cached
    ship/GC schedules are valid for this run.
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
        tuple(sorted(rank_map.items())) if rank_map else (),
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


# ---------------------------------------------------------------------------
# Rank-local plan slicing (process-pool backend)
# ---------------------------------------------------------------------------

class RankSlices:
    """A plan resolved into per-rank, per-level picklable work lists.

    The process-pool backend ships each worker only its own slice:
    ``worker_levels[rank][li]`` is ``(pulls, ops, drops)`` where ``pulls``
    are ``(version_key, src_rank)`` memcpys realising this rank's share of
    the level's ship schedule, ``ops`` are ``(fn_index, argspec,
    write_keys, report)`` descriptors (``argspec`` entries are ``(0, key)``
    payload reads from the rank's own arena or ``(1, const_index)`` into
    the shared ``consts`` vector; ``report`` marks the one exec rank that
    reports result nbytes back), and ``drops`` are the version keys whose
    last reader sits in this level — the per-op GC drop lists re-bucketed
    by holder rank so workers free eagerly.

    ``fns`` is the registered fn table (pickled by reference — workers
    resolve the module-level callables on their side); constants are
    *not* baked into descriptors because plans are reused across runs with
    different embedded constants.  ``read_holders`` records the holder
    ranks of every key the plan reads before writing, so a later run may
    validate that a cached slice's ship/drop distribution is still valid.
    """

    __slots__ = ("fns", "consts", "worker_levels", "read_holders",
                 "n_levels")

    def __init__(self, fns, consts, worker_levels, read_holders, n_levels):
        self.fns = fns
        self.consts = consts
        self.worker_levels = worker_levels
        self.read_holders = read_holders
        self.n_levels = n_levels


def slice_for_ranks(plan: ExecutionPlan, wf, holders: dict,
                    n_ranks: int) -> RankSlices:
    """Slice ``plan`` into per-rank wavefront work lists (see
    :class:`RankSlices`).

    Re-simulates holder evolution exactly as :func:`build_plan` did (ships
    add replicas, writes place on exec ranks, GC removes every replica) so
    each drop lands on precisely the ranks physically holding a segment.
    Broadcast-tree ships are realised as direct pulls from the tree root:
    the *accounting* keeps the tree shape (the frontend replays
    ``p.ships`` virtually), but the physical memcpy always reads the root
    rank's segment — the root committed it before the level started, so
    every pull inside one level is race-free without intra-level rounds.
    """
    n_levels = len(plan.levels)
    fns: list = []
    fn_idx: dict = {}
    consts: list = []
    per_rank = [[([], [], []) for _ in range(n_levels)]
                for _ in range(n_ranks)]
    sim: dict = {}
    read_holders: dict = {}

    def ensure(k):
        hold = sim.get(k)
        if hold is None:
            rs = holders.get(k)
            sim[k] = hold = set(rs) if rs else set()
            read_holders[k] = tuple(sorted(hold))
        return hold

    for p in plan.schedule:
        node = wf.ops[p.op_id]
        li = p.level - 1
        for k, root, transfers in p.ships:
            hold = ensure(k)
            for _src, dst, _kind, _rel in transfers:
                if dst not in hold:
                    per_rank[dst][li][0].append((k, root))
                    hold.add(dst)
        for k in p.arg_keys:
            if k is not None:
                ensure(k)
        fi = fn_idx.get(p.fn)
        if fi is None:
            fn_idx[p.fn] = fi = len(fns)
            fns.append(p.fn)
        argspec = []
        for k, a in zip(p.arg_keys, node.args):
            if k is not None:
                argspec.append((0, k))
            else:
                argspec.append((1, len(consts)))
                consts.append(a[1])
        desc = (fi, tuple(argspec), p.write_keys)
        for j, r in enumerate(p.exec_ranks):
            per_rank[r][li][1].append(desc + (j == 0,))
        for k in p.write_keys:
            sim[k] = set(p.exec_ranks)
        for k in p.gc_keys:
            hold = sim.pop(k, None)
            if hold:
                for r in hold:
                    per_rank[r][li][2].append(k)
    worker_levels = tuple(
        tuple((tuple(pl), tuple(ops), tuple(dr)) for pl, ops, dr in lvls)
        for lvls in per_rank)
    return RankSlices(tuple(fns), tuple(consts), worker_levels,
                      read_holders, n_levels)


def key_map(template: ExecutionPlan, plan: ExecutionPlan):
    """Per-ref translation ``{template ref: (plan ref, index shift)}``
    mapping ``template``'s keys onto ``plan``'s, or None if the two
    schedules are not equivalent under one.

    :func:`key_delta`'s check (exhaustive over every key-bearing field:
    args, writes, GC, ship roots and schedules) with one generalisation: a
    ref may map onto *another* ref, one to one.  A loop iteration that
    creates fresh arrays (``wf.apply`` temporaries, new output tiles) binds
    the same plan skeleton to new refs each time; the ``procs`` backend
    then still sends only the translation table, where the reference's
    ``key_delta`` (refs fixed) finds no delta and re-ships the plan.
    """
    if len(template.schedule) != len(plan.schedule):
        return None
    trans: dict[int, tuple[int, int]] = {}
    taken: dict[int, int] = {}

    def match(ok, nk):
        if ok is None or nk is None:
            return ok is None and nk is None
        t = (nk[0], nk[1] - ok[1])
        if trans.setdefault(ok[0], t) != t:
            return False
        return taken.setdefault(nk[0], ok[0]) == ok[0]

    for op_, np_ in zip(template.schedule, plan.schedule):
        if (op_.fn is not np_.fn or op_.exec_ranks != np_.exec_ranks
                or op_.level != np_.level
                or len(op_.arg_keys) != len(np_.arg_keys)
                or len(op_.write_keys) != len(np_.write_keys)
                or len(op_.gc_keys) != len(np_.gc_keys)
                or len(op_.ships) != len(np_.ships)):
            return None
        for ok, nk in zip(op_.arg_keys, np_.arg_keys):
            if not match(ok, nk):
                return None
        for ok, nk in zip(op_.write_keys, np_.write_keys):
            if not match(ok, nk):
                return None
        for ok, nk in zip(op_.gc_keys, np_.gc_keys):
            if not match(ok, nk):
                return None
        for (okk, oroot, otr), (nkk, nroot, ntr) in zip(op_.ships,
                                                        np_.ships):
            if oroot != nroot or otr != ntr or not match(okk, nkk):
                return None
    return trans


def translate(trans: dict, key: tuple[int, int]) -> tuple[int, int]:
    """``key`` through a :func:`key_map` translation."""
    t = trans.get(key[0])
    return key if t is None else (t[0], key[1] + t[1])


def key_delta(template: ExecutionPlan, plan: ExecutionPlan):
    """Per-ref version-index shift mapping ``template``'s keys onto
    ``plan``'s, or None if the two schedules are not shift-equivalent.

    The program-trace cache replays a loop body against fresh version keys
    every iteration (:meth:`ExecutionPlan.rebind`): same structure, every
    key of ref ``r`` advanced by a per-ref constant.  The check is
    exhaustive over every key-bearing field (args, writes, GC, ship
    roots/schedules), so a successful delta *proves* a worker-resident
    plan slice replays correctly under translation.  The reference's
    function: :func:`key_map` with every ref mapped onto itself.
    """
    trans = key_map(template, plan)
    if trans is None or any(new != old for old, (new, _d) in trans.items()):
        return None
    return {old: d for old, (_new, d) in trans.items()}


def plan_consts(plan: ExecutionPlan, wf) -> tuple:
    """The plan's embedded-constant vector, in :func:`slice_for_ranks`
    order (schedule-major, argument-position minor).  Read from the live
    ops — constants are never baked into plans or shipped slices."""
    out = []
    for p in plan.schedule:
        node = wf.ops[p.op_id]
        for k, a in zip(p.arg_keys, node.args):
            if k is None:
                out.append(a[1])
    return tuple(out)
