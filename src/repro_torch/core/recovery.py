"""Lineage-based fault recovery for the plan executor — ``repro/core/recovery.py``.

The executor's state model already *is* a lineage graph: every live payload
is an immutable version with a recorded producing op (``wf.producers()``),
every plan carries per-op drop lists, and GC means interior versions are
gone but reconstructible.  This module turns that into Spark-style narrow
recovery — the shape "Challenges of Translating HPC codes to Workflows"
argues is where workflow models beat static SPMD on dynamic machines:

* :func:`wipe_rank` / :func:`apply_failure` — materialise a
  :class:`~repro_torch.core.backends.base.RankFailure` against the executor's
  stores (a killed rank loses every payload it held; a dropped ship loses
  one replica), returning the version keys left with **no** holder.
* :func:`plan_recovery` — the lineage walk: from the versions still
  *needed* (read by the not-yet-executed suffix, or pinned) but no longer
  held anywhere, walk producer edges backwards to the **minimal ancestor
  closure** that must re-execute.  The walk terminates early at initial
  arrays (re-placed from ``wf.initial``) and at saved checkpoint barriers
  (:class:`PlanCheckpoint` — rehydrated from disk), so recompute is bounded
  by the lost versions' ancestry, never a full replay.
* :func:`build_subset_plan` — compiles an arbitrary op-id set into a normal
  :class:`~repro_torch.core.plan.ExecutionPlan` (subset-local wavefront levels,
  ship schedules, GC drop lists), so recovery work replays through the very
  same backends as primary work and recomputed temporaries free eagerly.
  The executor also uses it to resume the failed plan: the surviving
  *suffix* is replanned from post-recovery holder state (the original
  plan's precomputed ships assumed the pre-failure stores).
* :func:`choose_replacement` — elastic degradation: when a rank is
  permanently dead, pick the surviving rank the topology model
  (:mod:`repro_torch.launch.mesh`) prices cheapest to reach from the dead one;
  the executor then threads ``{dead: replacement}`` through planning
  (:func:`repro_torch.core.plan.build_plan` /
  :meth:`~repro_torch.core.plan.ExecutionPlan.rebind_ranks`).
"""

from __future__ import annotations

from typing import Iterable, Optional

from .backends.base import BatchSlice
from .placement import placement_ranks
from .plan import ExecutionPlan, PlanOp, _flops_per_level, map_ranks
from .collectives import broadcast_tree

__all__ = ["wipe_rank", "apply_failure", "plan_recovery",
           "build_subset_plan", "choose_replacement", "PlanCheckpoint"]


# ---------------------------------------------------------------------------
# Failure materialisation
# ---------------------------------------------------------------------------

def wipe_rank(ex, rank: int, keys: Optional[Iterable] = None) -> set:
    """Remove ``rank``'s payloads (all, or just ``keys``) from the stores.

    Mirrors the accounting of :func:`~repro_torch.core.backends.base.drop_versions`
    per replica — lazy :class:`BatchSlice` rows are released from their
    bucket, live counters are debited — but keeps replicas on *other* ranks
    alive.  Returns the version keys that lost their **last** holder (the
    recovery planner's starting point).
    """
    store = ex._stores[rank]
    victims = (list(store.keys()) if keys is None
               else [k for k in keys if k in store])
    lost = set()
    for vkey in victims:
        dead = store.pop(vkey)
        if type(dead) is BatchSlice:
            dead.release()
        ranks = ex._where[vkey]
        ranks.discard(rank)
        ex._live_entries -= 1
        if not ranks:
            del ex._where[vkey]
            ex._live_bytes -= ex._key_bytes.pop(vkey, 0)
            lost.add(vkey)
    return lost


def apply_failure(ex, failure) -> set:
    """Apply a :class:`RankFailure` to the stores; returns fully-lost keys."""
    if failure.kind == "ship":
        return wipe_rank(ex, failure.rank, failure.lost_keys)
    return wipe_rank(ex, failure.rank)


def _drop_version(ex, vkey) -> None:
    """Drop every replica of one version (BatchSlice-aware, full accounting)."""
    ranks = ex._where.pop(vkey, None)
    if ranks is None:
        return
    for r in ranks:
        dead = ex._stores[r].pop(vkey)
        if type(dead) is BatchSlice:
            dead.release()
    ex._live_entries -= len(ranks)
    ex._live_bytes -= ex._key_bytes.pop(vkey, 0)


# ---------------------------------------------------------------------------
# Elastic replacement choice
# ---------------------------------------------------------------------------

def choose_replacement(dead: int, alive: Iterable[int], topology=None,
                       nbytes: int = 1 << 20) -> int:
    """Surviving rank that inherits a permanently dead rank's placements.

    With a topology cost model the survivor cheapest to reach from the dead
    rank wins (its neighbours already hold most of what the dead rank's ops
    consume under locality-aware placements), ties broken by lowest rank;
    without one, the lowest surviving rank.
    """
    alive = sorted(alive)
    if not alive:
        raise ValueError("no surviving rank to rebind onto")
    if topology is None:
        return alive[0]
    return min(alive, key=lambda c: (topology.transfer_time(dead, c, nbytes),
                                     c))


# ---------------------------------------------------------------------------
# Checkpoint barriers (lineage-walk terminators)
# ---------------------------------------------------------------------------

class PlanCheckpoint:
    """A plannable checkpoint barrier: an op that atomically saves its
    inputs' payloads through a :class:`repro_torch.ckpt.CheckpointManager`.

    Recorded like any op (:meth:`repro_torch.core.trace.Workflow.checkpoint`),
    so it rides plans, backends and the program cache unchanged; it reads
    its arrays (all-``In``) and writes nothing.  Once :attr:`saved`, the
    recovery planner's lineage walk *terminates* at the checkpointed
    versions — they rehydrate from disk (:meth:`restore_leaf`) instead of
    recomputing their ancestry, bounding post-barrier recompute to
    post-barrier lineage.

    Each payload's container is recorded beside it, in the checkpoint's
    ``extra`` (``"numpy"`` or ``"tensor:<device>"``), so a restored leaf
    comes back as the same kind of payload, on the same device, it had when
    saved — recovery must be bitwise invisible to downstream consumers.
    The containers live on disk rather than on this object because under
    the ``procs`` backend the body runs on a pickled copy in a worker
    process; that backend marks the frontend's barrier :attr:`saved` when
    it replays the barrier's level.
    """

    __bind_nojit__ = True

    def __init__(self, manager, step: int):
        self.manager = manager
        self.step = int(step)
        self.saved = False
        self.__name__ = f"ckpt_barrier@{self.step}"

    def __call__(self, *payloads):
        import torch

        from .backends.base import materialize

        arrs = [materialize(p) for p in payloads]
        containers = [f"tensor:{a.device}" if isinstance(a, torch.Tensor)
                      else "numpy" for a in arrs]
        self.manager.save(self.step, arrs, extra={"containers": containers},
                          block=True)
        self.saved = True
        return ()

    def restore_leaf(self, i: int):
        """Load one saved payload back, in its original container kind."""
        return self.manager.load_leaf(self.step, i)


# ---------------------------------------------------------------------------
# Subset planning (recovery sub-plans + suffix replans)
# ---------------------------------------------------------------------------

def build_subset_plan(wf, op_ids: Iterable[int], n_nodes: int,
                      collective_mode: str, holders: dict, pinned: Iterable,
                      rank_map: dict = None) -> ExecutionPlan:
    """Compile an arbitrary set of recorded ops into an execution plan.

    The recovery analogue of :func:`repro_torch.core.plan.build_plan`: the op set
    is a *subset* of the trace (an ancestor closure, or a failed plan's
    level suffix), so it is not a contiguous op-id range — levels,
    refcounts, ships and GC are all computed subset-locally.  Dependencies
    on ops outside the subset resolve through ``holders`` (their outputs
    must already be live); ``pinned`` keys survive the subset's GC (the
    caller pins everything a later suffix still reads), so recomputed
    temporaries free eagerly — recovery's live footprint matches a primary
    run of the same ops.
    """
    subset = set(op_ids)
    ops = [wf.ops[i] for i in sorted(subset)]
    if not ops:
        raise ValueError("empty subset plan")
    pinned = set(pinned)
    producers = wf.producers()

    # subset-local wavefront levels: a dep counts only if its producer is
    # being re-executed too (everything else is already materialised)
    level: dict[int, int] = {}
    counts: dict[int, int] = {}
    for node in ops:
        deps = []
        for v in node.reads:
            p = producers.get(v.key)
            if p is not None and p.op_id in subset and p.op_id != node.op_id:
                deps.append(level[p.op_id])
        for v in node.writes:
            if v.index > 0:
                prev = producers.get((v.ref_id, v.index - 1))
                if (prev is not None and prev.op_id in subset
                        and prev.op_id != node.op_id):
                    deps.append(level[prev.op_id])
        lv = (max(deps) + 1) if deps else 1
        level[node.op_id] = lv
        counts[lv] = counts.get(lv, 0) + 1
    wavefront_counts = [counts[k] for k in sorted(counts)]
    order = sorted(range(len(ops)), key=lambda i: (level[ops[i].op_id], i))

    readers: dict = {}
    reader_ranks: dict = {}
    for node in ops:
        rr = map_ranks(placement_ranks(node.placement), rank_map)
        for v in node.reads:
            k = v.key
            readers[k] = readers.get(k, 0) + 1
            s = reader_ranks.get(k)
            if s is None:
                reader_ranks[k] = s = set()
            s.update(rr)

    sim: dict = {}
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
            if hold is None:
                rs = holders.get(k)
                if not rs:
                    raise RuntimeError(f"version {k} was never materialised")
                sim[k] = hold = set(rs)
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
    start = min(subset)
    end = max(subset) + 1
    return ExecutionPlan(tuple(schedule), wavefront_counts, rel_round,
                         start, end, n_nodes, collective_mode,
                         _flops_per_level(ops, level, len(wavefront_counts),
                                          rank_map))


# ---------------------------------------------------------------------------
# The lineage walk
# ---------------------------------------------------------------------------

def plan_recovery(ex, wf, needed: Iterable, *, rank_map: dict = None,
                  future: frozenset = frozenset()):
    """Plan the minimal recomputation for lost-but-needed versions.

    ``needed`` is everything execution still demands: versions read by the
    not-yet-executed ops plus the pinned heads.  ``future`` holds the op
    ids that have *not run yet* — a needed version whose producer is in
    ``future`` will be produced normally and must not be "recovered".

    Walks producer edges backwards from each lost needed version.  A
    version with a live replica terminates the walk (survivor); an initial
    array re-places eagerly from ``wf.initial``; a version saved by a
    :class:`PlanCheckpoint` barrier rehydrates eagerly from disk; anything
    else adds its producing op to the recompute closure and recurses on
    that op's own lost inputs.  Surviving sibling writes of recompute ops
    are pre-dropped (re-execution re-places and re-counts them).

    Returns ``(recovery_plan | None, restored, replaced)`` — the subset
    plan over the closure (None when nothing needs recomputing), the count
    of checkpoint-rehydrated versions, and the count of re-placed initials.
    """
    producers = wf.producers()
    where = ex._where
    lost = [k for k in needed
            if not where.get(k)
            and ((producers.get(k) is None)
                 or producers[k].op_id not in future)]
    if not lost:
        return None, 0, 0
    ckpt_sources = getattr(wf, "_ckpt_sources", None) or {}
    op_ids: set[int] = set()
    visited = set(lost)
    stack = list(lost)
    restored = replaced = 0
    while stack:
        k = stack.pop()
        src = ckpt_sources.get(k)
        if src is not None and src[0].saved:
            ckpt, leaf = src
            payload = ckpt.restore_leaf(leaf)
            prod = producers.get(k)
            if prod is not None:
                rank = map_ranks(placement_ranks(prod.placement),
                                 rank_map)[0]
            else:
                rank = wf.initial[k][1]
                if rank_map:
                    rank = rank_map.get(rank, rank)
            ex._place(rank, k, payload)
            restored += 1
            continue
        prod = producers.get(k)
        if prod is None:
            payload, rank = wf.initial[k]
            if rank_map:
                rank = rank_map.get(rank, rank)
            ex._place(rank, k, payload)
            replaced += 1
            continue
        if prod.op_id in op_ids:
            continue
        op_ids.add(prod.op_id)
        for v in prod.reads:
            kk = v.key
            if kk in visited:
                continue
            visited.add(kk)
            if not where.get(kk):
                stack.append(kk)
    ex._note_live()
    if not op_ids:
        return None, restored, replaced
    # pre-drop surviving sibling writes of the closure: re-execution
    # re-places them, and commit accounting assumes the key is not live
    for oid in op_ids:
        for v in wf.ops[oid].writes:
            if where.get(v.key):
                _drop_version(ex, v.key)
    plan = build_subset_plan(wf, op_ids, ex.n_nodes, ex.collective_mode,
                             where, set(needed), rank_map)
    return plan, restored, replaced
