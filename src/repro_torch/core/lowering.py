"""Bind's implicit collectives as ``ppermute`` rounds on a rank mesh.

The paper's runtime turns the consumer queue of a version into a *binary
tree* of MPI point-to-point messages; the reference lowers that onto a
named mesh axis as log-depth ``jax.lax.ppermute`` rounds inside
``shard_map``.  The port keeps every schedule's round structure and pair
lists line for line, on :mod:`repro_torch.core.spmd`: each function takes
a :class:`~repro_torch.core.spmd.Sharded` value and runs inside
``shard_map`` (or ``spmd.in_mesh``), and ``ppermute`` copies each pair's
shard into a new allocation on the destination rank's device.

* :func:`tree_reduce`, :func:`tree_broadcast`, :func:`tree_allreduce` —
  the paper's binary trees;
* :func:`ring_allreduce` — the bandwidth-optimal schedule.  The
  reference's is ``lax.psum``, which XLA lowers as a reduce-scatter and
  an all-gather; the port builds it from exactly those, as ``n - 1``
  neighbour rounds each (:func:`reduce_scatter`, :func:`all_gather`), so
  the sum's order is the ring's (within float rounding of XLA's);
* :func:`hierarchical_allreduce` — pod-aware: reduce-scatter inside the
  pod, all-reduce the 1/n-sized shards across pods, all-gather inside;
* rooted broadcasts (:func:`tree_broadcast_from`, :func:`ring_broadcast`,
  :func:`hierarchical_broadcast`) — the mesh backend's ship lowering.
"""

from __future__ import annotations

import math

import torch

from .spmd import Sharded, axis_index, axis_size, ppermute, where


# ---------------------------------------------------------------------------
# Paper-faithful binary-tree collectives (log-depth ppermute schedules)
# ---------------------------------------------------------------------------

def tree_reduce(x: Sharded, axis_name) -> Sharded:
    """Binary-tree reduction onto rank 0 of ``axis_name`` (paper's log reduction).

    Round ``s``: ranks ``i`` with ``i % 2s == s`` send their partial to
    ``i - s`` which accumulates.  After ⌈log₂ n⌉ rounds rank 0 holds the sum;
    other ranks hold partials (callers follow with a broadcast or
    discard).  Mirrors Listing 1's ``for (s = 1; s < nt; s *= 2)`` loop.
    """
    n = axis_size(axis_name)
    idx = axis_index(axis_name)
    s = 1
    while s < n:
        pairs = [(i + s, i) for i in range(0, n - s, 2 * s)]
        y = ppermute(x, axis_name, pairs)
        is_receiver = (idx % (2 * s) == 0) & (idx + s < n)
        x = where(is_receiver, x + y, x)
        s *= 2
    return x


def tree_broadcast(x: Sharded, axis_name) -> Sharded:
    """Binary-tree broadcast from rank 0 of ``axis_name`` (log₂ n rounds)."""
    n = axis_size(axis_name)
    idx = axis_index(axis_name)
    if n == 1:
        return x
    s = 1 << (int(math.ceil(math.log2(n))) - 1)
    while s >= 1:
        pairs = [(i, i + s) for i in range(0, n - s, 2 * s)]
        y = ppermute(x, axis_name, pairs)
        is_receiver = idx % (2 * s) == s  # exactly the ranks first informed now
        x = where(is_receiver, y, x)
        s //= 2
    return x


def tree_allreduce(x: Sharded, axis_name) -> Sharded:
    """Paper-faithful all-reduce: binary-tree reduce to 0, then tree broadcast.

    Depth 2·log₂ n.  This is the *baseline* gradient-sync schedule (the
    paper's implicit collective); :func:`ring_allreduce` is the
    bandwidth-optimal one.
    """
    return tree_broadcast(tree_reduce(x, axis_name), axis_name)


# ---------------------------------------------------------------------------
# Ring schedules (the reference's psum / psum_scatter / all_gather)
# ---------------------------------------------------------------------------

def _ring(n: int) -> list:
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_reduce_scatter(parts: Sharded, axis_name) -> Sharded:
    """``parts`` holds each rank's list of ``n`` chunks; after ``n - 1``
    neighbour rounds rank ``i`` holds the sum over the ranks of chunk
    ``i``.  Round ``t`` sends the partial of chunk ``i - t - 1`` onward."""
    n = axis_size(axis_name)
    idx = axis_index(axis_name)
    acc = parts.map(lambda p, i: p[(i - 1) % n], idx)
    for t in range(1, n):
        y = ppermute(acc, axis_name, _ring(n))
        acc = parts.map(lambda p, i, yi, t=t: yi + p[(i - t - 1) % n], idx, y)
    return acc


def _ring_all_gather(x: Sharded, axis_name) -> Sharded:
    """Each rank's list of every rank's shard, in axis-index order, after
    ``n - 1`` neighbour rounds."""
    n = axis_size(axis_name)
    idx = axis_index(axis_name)
    held = x.map(lambda t, i: {i: t}, idx)
    cur = x
    for t in range(1, n):
        cur = ppermute(cur, axis_name, _ring(n))
        # rank i now holds rank i - t's shard
        for h, c, i in zip(held.shards, cur.shards, idx.shards):
            h[(i - t) % n] = c
    return held.map(lambda h: [h[j] for j in range(n)])


def ring_allreduce(x: Sharded, axis_name) -> Sharded:
    """Bandwidth-optimal all-reduce: a ring reduce-scatter of the flattened
    shard in ``n`` chunks, then a ring all-gather (2·B·(n−1)/n bytes a
    rank; the reference's ``lax.psum``)."""
    n = axis_size(axis_name)
    if n == 1:
        return x
    shape = x.shape
    parts = x.map(lambda t: list(torch.tensor_split(t.reshape(-1), n)))
    gathered = _ring_all_gather(_ring_reduce_scatter(parts, axis_name),
                                axis_name)
    return gathered.map(lambda ch: torch.cat(ch).reshape(shape))


def reduce_scatter(x: Sharded, axis_name, *,
                   scatter_dimension: int = 0) -> Sharded:
    """The sum over ``axis_name``, rank ``i`` keeping block ``i`` of
    ``scatter_dimension`` (``lax.psum_scatter(..., tiled=True)``)."""
    n = axis_size(axis_name)
    if x.shape[scatter_dimension] % n:
        raise ValueError(f"reduce_scatter: dimension {scatter_dimension} of "
                         f"{x.shape} does not split {n} ways")
    parts = x.map(lambda t: list(torch.tensor_split(t, n, scatter_dimension)))
    return _ring_reduce_scatter(parts, axis_name)


def all_gather(x: Sharded, axis_name, *, axis: int = 0) -> Sharded:
    """Every rank's shard concatenated along ``axis`` in axis-index order
    (``lax.all_gather(..., tiled=True)``)."""
    return _ring_all_gather(x, axis_name).map(
        lambda ch: torch.cat(ch, axis))


def hierarchical_allreduce(
    x: Sharded, inner_axis, outer_axis, *, scatter_dimension: int = 0
) -> Sharded:
    """Two-level (pod-aware) all-reduce.

    reduce-scatter over ``inner_axis`` (fast intra-pod links), all-reduce
    the 1/inner-sized shard over ``outer_axis`` (scarce inter-pod links),
    then all-gather over ``inner_axis``.  Cross-pod bytes shrink by the pod
    size.
    """
    shard = reduce_scatter(x, inner_axis, scatter_dimension=scatter_dimension)
    shard = ring_allreduce(shard, outer_axis)
    return all_gather(shard, inner_axis, axis=scatter_dimension)


GRAD_SYNC_SCHEDULES = ("tree", "ring", "hierarchical")


def allreduce_by_schedule(
    x: Sharded,
    schedule: str,
    *,
    data_axes: tuple,
    scatter_dimension: int | None = None,
) -> Sharded:
    """Dispatch an all-reduce over (possibly several) data axes by schedule name.

    ``data_axes`` is ordered outermost-first, e.g. ``("pod", "data")``.  For
    the hierarchical schedule the scatter dimension is auto-picked as the
    first dim divisible by the inner axis size (falling back to the ring
    over all the axes when no dim divides — e.g. tiny bias vectors, where
    the cross-pod saving is negligible anyway).
    """
    if schedule == "tree":
        for ax in data_axes:
            x = tree_allreduce(x, ax)
        return x
    if schedule == "ring":
        return ring_allreduce(x, tuple(data_axes))
    if schedule == "hierarchical":
        if len(data_axes) == 1:
            return ring_allreduce(x, data_axes[0])
        outer, inner = data_axes[0], data_axes[-1]
        scat = scatter_dimension
        if scat is None:
            inner_n = axis_size(inner)
            scat = next(
                (d for d in range(x.ndim) if x.shape[d] % inner_n == 0), None
            )
        if scat is None:
            return ring_allreduce(x, tuple(data_axes))
        return hierarchical_allreduce(x, inner, outer, scatter_dimension=scat)
    raise ValueError(f"unknown schedule {schedule!r}; one of {GRAD_SYNC_SCHEDULES}")


# ---------------------------------------------------------------------------
# Rooted broadcasts (the mesh backend's ship lowering)
# ---------------------------------------------------------------------------
# A plan ship moves one version from its *root* holder to the destination
# ranks; the plan's TreeSchedule already fixes the accounting (the transfer
# stream replayed by every backend).  These are the corresponding *physical*
# schedules over a named mesh axis: every rank ends holding the root's
# shard.  ``tree`` is the log-depth lowering of the plan's broadcast tree;
# ``ring``/``hierarchical`` are the topology-model-selected alternatives
# (neighbour fabrics / switch trees), value-identical by construction —
# ppermute moves bytes, it never rounds.
#
# All three work from an arbitrary root by operating on *virtual* ranks
# ``v = (idx - root) mod n`` (the root plays virtual rank 0), so the pair
# lists are plain rotations of the root-0 schedules.

def tree_broadcast_from(x: Sharded, axis_name, root: int = 0) -> Sharded:
    """Binary-tree broadcast from ``root`` (log₂ n ppermute rounds)."""
    n = axis_size(axis_name)
    if n == 1:
        return x
    idx = axis_index(axis_name)
    v = (idx - root) % n
    s = 1 << (int(math.ceil(math.log2(n))) - 1)
    while s >= 1:
        pairs = [((i + root) % n, (i + s + root) % n)
                 for i in range(0, n - s, 2 * s)]
        y = ppermute(x, axis_name, pairs)
        is_receiver = v % (2 * s) == s
        x = where(is_receiver, y, x)
        s //= 2
    return x


def ring_broadcast(x: Sharded, axis_name, root: int = 0) -> Sharded:
    """Neighbour-only broadcast: n−1 single-hop rounds around the ring.

    Linear depth but every round is a nearest-neighbour ppermute — the
    right schedule when the topology model says distant hops are expensive
    (a 1-D torus), and the baseline the tree must beat elsewhere.
    """
    n = axis_size(axis_name)
    if n == 1:
        return x
    idx = axis_index(axis_name)
    v = (idx - root) % n
    for s in range(1, n):
        y = ppermute(x, axis_name,
                     [((root + s - 1) % n, (root + s) % n)])
        x = where(v == s, y, x)
    return x


def hierarchical_broadcast(x: Sharded, axis_name, root: int = 0,
                           *, arity: int = 4) -> Sharded:
    """Two-phase broadcast for switch-tree fabrics: leaders, then groups.

    Virtual ranks split into groups of ``arity``; phase 1 tree-broadcasts
    the root's shard across the group *leaders* (the cross-switch hops),
    phase 2 tree-broadcasts inside every group concurrently (the cheap
    intra-switch hops).  Cross-switch rounds drop to ⌈log₂⌈n/arity⌉⌉.
    """
    n = axis_size(axis_name)
    if n == 1:
        return x
    idx = axis_index(axis_name)
    v = (idx - root) % n
    leaders = list(range(0, n, arity))
    m = len(leaders)
    if m > 1:                       # phase 1: binary tree over leaders
        s = 1 << (int(math.ceil(math.log2(m))) - 1)
        while s >= 1:
            pairs = [((leaders[i] + root) % n,
                      (leaders[i + s] + root) % n)
                     for i in range(0, m - s, 2 * s)]
            y = ppermute(x, axis_name, pairs)
            is_receiver = (v % arity == 0) & ((v // arity) % (2 * s) == s)
            x = where(is_receiver, y, x)
            s //= 2
    g = min(arity, n)               # phase 2: trees inside each group
    s = 1 << max(0, int(math.ceil(math.log2(g))) - 1)
    while s >= 1:
        pairs = []
        for lead in leaders:
            size = min(arity, n - lead)
            for i in range(0, size - s, 2 * s):
                pairs.append(((lead + i + root) % n,
                              (lead + i + s + root) % n))
        if pairs:
            y = ppermute(x, axis_name, pairs)
            x = where((v % arity) % (2 * s) == s, y, x)
        s //= 2
    return x


SHIP_SCHEDULES = ("tree", "ring", "hierarchical")


def broadcast_by_schedule(x: Sharded, schedule: str, axis_name,
                          root: int = 0, *, arity: int = 4) -> Sharded:
    """Dispatch a rooted broadcast by schedule name (value-identical)."""
    if schedule == "tree":
        return tree_broadcast_from(x, axis_name, root)
    if schedule == "ring":
        return ring_broadcast(x, axis_name, root)
    if schedule == "hierarchical":
        return hierarchical_broadcast(x, axis_name, root, arity=arity)
    raise ValueError(f"unknown schedule {schedule!r}; one of {SHIP_SCHEDULES}")


def schedule_for_topology(topology) -> str:
    """Ship schedule the :class:`~repro_torch.launch.mesh.Topology` model prefers.

    Neighbour fabrics (``ring``) price distant hops by arc length — the
    single-hop pipeline wins; switch trees (``fat-tree``) price cross-switch
    hops double — the leader/group split wins; flat crossbars (and no
    topology at all) take the paper's log-depth tree.
    """
    kind = getattr(topology, "kind", None)
    if kind == "ring":
        return "ring"
    if kind == "fat-tree":
        return "hierarchical"
    return "tree"


# ---------------------------------------------------------------------------
# Whole-tree wrappers (a dict or list of gradients inside shard_map)
# ---------------------------------------------------------------------------

def sync_gradients(
    grads,
    schedule: str,
    data_axes: tuple,
    *,
    mean: bool = True,
):
    """All-reduce every :class:`Sharded` leaf of a dict / list / tuple of
    gradients with the chosen schedule (divided by the ranks' count when
    ``mean``)."""
    n = 1
    for ax in data_axes:
        n *= axis_size(ax)

    def _one(g):
        out = allreduce_by_schedule(g, schedule, data_axes=data_axes)
        return out / n if mean else out

    def _walk(tree):
        if isinstance(tree, dict):      # in sorted key order, as jax's
            return {k: _walk(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_walk(v) for v in tree)
        return _one(tree)

    return _walk(grads)
