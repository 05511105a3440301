"""Declarative partitioning — the paper's ``bind::node`` scope guards (§II-C).

Bind deliberately leaves placement to the user ("optimal scheduling of the
DAG across many nodes is a hard optimisation problem") and derives all data
movement implicitly.  We keep that contract:

    with node(3):
        gemm(a, b, c)          # executes on node 3; transfers are implicit

``node(k)`` pins ops to integer ranks for the LocalExecutor; ``nodes(ks)``
pins them to a set of ranks (replicated execution — partial collectives
operate on exactly such subsets).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from .trace import current_workflow


@dataclasses.dataclass(frozen=True)
class NodeSet:
    """A placement over an explicit subset of ranks (partial-collective target)."""

    ranks: tuple[int, ...]

    def __contains__(self, r: int) -> bool:
        return r in self.ranks


class _PlacementScope:
    def __init__(self, placement: Any):
        self.placement = placement

    def __enter__(self):
        wf = current_workflow()
        if wf is not None:
            wf.push_placement(self.placement)
        self._active = wf is not None
        return self

    def __exit__(self, *exc):
        if self._active:
            wf = current_workflow()
            if wf is not None:
                wf.pop_placement()
        return False


def node(rank: int) -> _PlacementScope:
    """Pin subsequent ops to ``rank`` (paper's ``bind::node p(rank)``)."""
    return _PlacementScope(int(rank))


def nodes(ranks: Sequence[int]) -> _PlacementScope:
    """Pin subsequent ops to a *set* of ranks (replicated execution)."""
    return _PlacementScope(NodeSet(tuple(int(r) for r in ranks)))


def placement_rank(placement: Any, default: int = 0) -> int:
    """Primary executing rank for a placement."""
    if placement is None:
        return default
    if isinstance(placement, NodeSet):
        return placement.ranks[0]
    return int(placement)


def placement_ranks(placement: Any, default: int = 0) -> tuple[int, ...]:
    if placement is None:
        return (default,)
    if isinstance(placement, NodeSet):
        return placement.ranks
    return (int(placement),)
