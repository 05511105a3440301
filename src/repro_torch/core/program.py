"""Program-level execution: cross-segment stitching + the program-trace cache.

Bind's unit of optimization is the *global workflow*, but the executor used
to compile and replay one ``run()`` segment at a time, so every incremental
``sync()`` was an optimization barrier: a signature chain split by a sync
dispatched as two chains, plans were rebuilt per segment, and loop-shaped
programs (iterative solvers, training steps) re-paid full analysis every
iteration because their version keys advance.

This module is the **Program layer** between the
:class:`~repro_torch.core.scheduler.LocalExecutor` frontend and
:class:`~repro_torch.core.plan.ExecutionPlan`:

* a :class:`Segment` records one deferred ``run(start=…)`` call — its op
  range, the head-pinned set snapshotted at its sync, and how much of
  ``wf.initial`` existed then.  The executor appends segments to a pending
  *program trace* and only executes at a materialization boundary
  (``fetch``/``value``, a ``stats`` read, or an explicit ``flush()``).
* :func:`resolve_plan` compiles the pending range ``[first.start,
  last.end)`` as ONE stitched plan — chain detection, ship schedules and GC
  refcounts all run across the seams, so a chain split by a sync is
  detected whole and a head one segment pinned is dropped
  at its true last read once a later segment supersedes it.
* the **program-trace cache**: plans are also keyed on a *relocatable*
  signature — version keys normalized to ``(ref-ordinal,
  index-delta-from-first-appearance)`` — so the Nth iteration of a loop,
  structurally identical to the first but with every version key advanced,
  re-binds the cached plan skeleton (:meth:`ExecutionPlan.rebind`) instead
  of re-running wavefront/ship/GC/chain analysis.  Segment boundaries are
  deliberately *not* part of the key: a program split ``[0,10)+[10,20)``
  and one recorded as ``[0,20)`` stitch to the same plan.

Lookup order: the exact-identity plan cache first (cheapest key — interned
int slices; hits when an identical workflow is re-built from scratch), then
the relocatable cache (hits when keys advanced), then a full build that
populates both.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterable

from .plan import (ExecutionPlan, PlanOp, _plan_cache_get, _plan_cache_probe,
                   _plan_cache_put, absolute_plan_key, build_plan)

__all__ = ["Segment", "ProgramPlan", "PROGRAM_CACHE_STATS",
           "clear_program_cache", "probe_plan", "resolve_plan"]


class Segment:
    """One deferred ``run()`` segment of a pending program trace.

    ``pinned`` is the head-pinned set snapshotted when the segment's sync
    was issued (heads advance as later segments record, and only the *last*
    pending segment's snapshot governs the stitched program's GC);
    ``init_upto`` is ``len(wf.initial)`` at that moment, so initial-array
    placement at flush time covers exactly what an eager run would have.
    """

    __slots__ = ("start", "end", "pinned", "init_upto")

    def __init__(self, start: int, end: int, pinned: set, init_upto: int):
        self.start = start
        self.end = end
        self.pinned = pinned
        self.init_upto = init_upto

    def __repr__(self) -> str:
        return f"Segment([{self.start}, {self.end}))"


class ProgramPlan:
    """A relocatable compiled program: plan skeleton + its binding slots.

    ``keys`` holds the template program's concrete version keys in
    first-appearance order — the normalization pass assigns slots in that
    same order for any structurally-equal program, so re-binding is a
    positional ``zip`` of the two key sequences.
    """

    __slots__ = ("plan", "keys", "start")

    def __init__(self, plan: ExecutionPlan, keys: tuple, start: int):
        self.plan = plan
        self.keys = keys
        self.start = start


def _normalize(wf, start: int, end: int, holders: dict, pinned) -> tuple:
    """Relocatable identity of ``wf.ops[start:end]`` + its binding sequence.

    Every version key is renamed ``(ref-ordinal, index - first-seen-index
    of that ref)`` — the shape the key wiring keeps across loop iterations
    whose absolute version indices advance.  Returns ``(ops_sig, ext_sig,
    pinned_sig, keys)``: the normalized per-op structure, the normalized
    run-start holder state of externally-produced read keys, the normalized
    effective pinned set (pinned ∩ reads — the only pins GC consults), and
    the concrete keys in first-appearance order (the binding sequence).
    """
    ref_slot: dict[int, int] = {}
    ref_base: dict[int, int] = {}
    norm_of: dict[tuple[int, int], tuple[int, int]] = {}
    keys: list = []

    def norm(k):
        nk = norm_of.get(k)
        if nk is None:
            rid, idx = k
            base = ref_base.get(rid)
            if base is None:
                ref_slot[rid] = len(ref_slot)
                ref_base[rid] = base = idx
            norm_of[k] = nk = (ref_slot[rid], idx - base)
            keys.append(k)
        return nk

    ops_sig = []
    read_keys = set()
    for node in wf.ops[start:end]:
        arg_sig = tuple(norm(v.key) if ref is not None else None
                        for ref, v, _ in node.args)
        write_sig = tuple(norm(v.key) for v in node.writes)
        read_sig = tuple(norm(v.key) for v in node.reads)
        read_keys.update(v.key for v in node.reads)
        ops_sig.append((node.fn, node.name, node.placement, node.flops,
                        arg_sig, write_sig, read_sig))
    ext = []
    pin = []
    for k in keys:
        if k in read_keys:
            hold = holders.get(k)
            if hold:
                ext.append((norm_of[k], tuple(sorted(hold))))
            if k in pinned:
                pin.append(norm_of[k])
    return tuple(ops_sig), tuple(ext), tuple(pin), tuple(keys)


def _bind(tmpl: ProgramPlan, keys: tuple, start: int, end: int) -> ExecutionPlan:
    """Re-point the template plan at a structurally-equal program's keys."""
    tr = dict(zip(tmpl.keys, keys))
    delta = start - tmpl.start
    schedule = []
    for p in tmpl.plan.schedule:
        schedule.append(PlanOp(
            op_id=p.op_id + delta,
            fn=p.fn,
            arg_keys=tuple(tr[k] if k is not None else None
                           for k in p.arg_keys),
            write_keys=tuple(tr[k] for k in p.write_keys),
            exec_ranks=p.exec_ranks,
            ships=tuple((tr[k], root, transfers)
                        for k, root, transfers in p.ships),
            gc_keys=tuple(tr[k] for k in p.gc_keys),
            level=p.level,
        ))
    return tmpl.plan.rebind(tuple(schedule), start, end)


# ---------------------------------------------------------------------------
# Process-wide program-trace cache (relocatable keys)
# ---------------------------------------------------------------------------

PROGRAM_CACHE_SIZE = 32
_PROGRAM_CACHE: "OrderedDict[tuple, ProgramPlan]" = OrderedDict()
# structural skeleton index for elastic rebind: the latest *unmapped*
# template per (n_nodes, collective_mode, ops_sig), regardless of holder /
# pinned state — after a permanent rank death the pre-failure holder
# signatures can never recur, but the structural analysis is still valid
# and ExecutionPlan.rebind_ranks re-simulates everything placement-derived.
_SKELETON_INDEX: "OrderedDict[tuple, ProgramPlan]" = OrderedDict()
_PROGRAM_CACHE_LOCK = threading.Lock()
PROGRAM_CACHE_STATS = {"hits": 0, "misses": 0}


def clear_program_cache() -> None:
    with _PROGRAM_CACHE_LOCK:
        _PROGRAM_CACHE.clear()
        _SKELETON_INDEX.clear()
        PROGRAM_CACHE_STATS["hits"] = PROGRAM_CACHE_STATS["misses"] = 0


def probe_plan(wf, start: int, end: int, n_nodes: int, collective_mode: str,
               holders: dict, pinned: Iterable, rank_map: dict = None):
    """Cache-only lookup of the stitched plan for ``[start, end)``.

    Same lookup order as :func:`resolve_plan` (exact-identity plan cache,
    then the relocatable program-trace cache) but it **never builds**: a
    total miss returns ``None`` and counts nothing — probes are
    speculative (the prefix flush tries several candidate ranges), so only
    hits may touch the cache counters.  A relocatable hit binds the
    template and promotes it into the exact cache, exactly as
    :func:`resolve_plan` would.

    The prefix-keyed property this enables: :func:`_normalize` assigns
    norm ids in first-appearance order, so the normalized signature of a
    program *prefix* equals the prefix of the full program's signature —
    a streaming client that previously ran ``[0, k)`` as its own flush
    hits here when ``[0, k)`` reappears as the front of a longer pending
    program, paying planning cost once.
    """
    pinned = set(pinned)
    akey = absolute_plan_key(wf, start, end, n_nodes, collective_mode,
                             holders, pinned, rank_map)
    plan = _plan_cache_probe(akey)
    if plan is not None:
        return plan
    ops_sig, ext, pin, keys = _normalize(wf, start, end, holders, pinned)
    rmap_sig = tuple(sorted(rank_map.items())) if rank_map else ()
    pkey = (n_nodes, collective_mode, ops_sig, ext, pin, rmap_sig)
    with _PROGRAM_CACHE_LOCK:
        tmpl = _PROGRAM_CACHE.get(pkey)
        if tmpl is not None:
            _PROGRAM_CACHE.move_to_end(pkey)
            PROGRAM_CACHE_STATS["hits"] += 1
    if tmpl is None:
        return None
    plan = _bind(tmpl, keys, start, end)
    _plan_cache_put(akey, plan)
    return plan


def resolve_plan(wf, start: int, end: int, n_nodes: int, collective_mode: str,
                 holders: dict, pinned: Iterable,
                 rank_map: dict = None) -> ExecutionPlan:
    """Fetch-bind-or-build the stitched plan for a pending program range.

    Tries the exact-identity plan cache, then the relocatable program-trace
    cache (binding the skeleton to this program's keys), then builds —
    storing the result under both keys either way, so an identical replay
    of the same program is always an exact-cache hit.

    Under an elastic ``rank_map`` (a permanently dead rank re-bound to a
    survivor) both caches key on the map; on a miss, a structurally-equal
    *unmapped* template recorded before the failure is re-bound to the
    (n−1)-rank placement via :meth:`ExecutionPlan.rebind_ranks` instead of
    paying a fresh structural analysis.
    """
    pinned = set(pinned)
    akey = absolute_plan_key(wf, start, end, n_nodes, collective_mode,
                             holders, pinned, rank_map)
    plan = _plan_cache_get(akey)
    if plan is not None:
        return plan
    ops_sig, ext, pin, keys = _normalize(wf, start, end, holders, pinned)
    rmap_sig = tuple(sorted(rank_map.items())) if rank_map else ()
    pkey = (n_nodes, collective_mode, ops_sig, ext, pin, rmap_sig)
    skel = None
    with _PROGRAM_CACHE_LOCK:
        tmpl = _PROGRAM_CACHE.get(pkey)
        if tmpl is not None:
            _PROGRAM_CACHE.move_to_end(pkey)
            PROGRAM_CACHE_STATS["hits"] += 1
        else:
            if rank_map:
                skel = _SKELETON_INDEX.get((n_nodes, collective_mode,
                                            ops_sig))
            if skel is not None:
                PROGRAM_CACHE_STATS["hits"] += 1
            else:
                PROGRAM_CACHE_STATS["misses"] += 1
    if tmpl is not None:
        plan = _bind(tmpl, keys, start, end)
        _plan_cache_put(akey, plan)
        return plan
    if skel is not None:
        # elastic path: re-point the pre-failure skeleton at this program's
        # keys, then re-bind its placement products to the surviving ranks
        plan = _bind(skel, keys, start, end).rebind_ranks(
            rank_map, holders, pinned, wf)
    else:
        plan = build_plan(wf, start, end, n_nodes, collective_mode, holders,
                          pinned, rank_map)
    _plan_cache_put(akey, plan)
    with _PROGRAM_CACHE_LOCK:
        _PROGRAM_CACHE[pkey] = ProgramPlan(plan, keys, start)
        while len(_PROGRAM_CACHE) > PROGRAM_CACHE_SIZE:
            _PROGRAM_CACHE.popitem(last=False)
        if not rank_map:
            _SKELETON_INDEX[(n_nodes, collective_mode, ops_sig)] = \
                ProgramPlan(plan, keys, start)
            while len(_SKELETON_INDEX) > PROGRAM_CACHE_SIZE:
                _SKELETON_INDEX.popitem(last=False)
    return plan
