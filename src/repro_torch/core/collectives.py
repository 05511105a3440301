"""Implicit-collective inference (paper §III "Implicit collectives").

Bind infers collective communication from the globally-known DAG: when one
version is consumed on many nodes it becomes a *broadcast*; when many
versions produced on different nodes accumulate into one object (a chain of
``+=`` transactions) it becomes a *reduction*.  Both are scheduled as binary
trees built "dynamically from the queue of the communications involving the
same object across multiple nodes" — and because the consumer set can be any
subset of ranks, the same machinery yields **partial collectives** for free.

This module is pure schedule construction (no tensors): it returns lists of
point-to-point rounds, each round a list of (src, dst) pairs that may fly
concurrently.  The LocalExecutor replays them to count transfer bytes/depth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class TreeSchedule:
    """Log-depth schedule: rounds of concurrent (src, dst) transfers."""

    kind: str                     # "broadcast" | "reduce"
    root: int
    ranks: tuple[int, ...]        # participating ranks (partial collective ⊂ world)
    rounds: tuple[tuple[tuple[int, int], ...], ...]

    @property
    def depth(self) -> int:
        return len(self.rounds)

    @property
    def total_messages(self) -> int:
        return sum(len(r) for r in self.rounds)

    def estimated_time(self, topology, nbytes: int) -> float:
        """Simulated seconds to run this schedule under a topology cost model.

        Transfers of one round fly concurrently (a round costs the max of
        its hops); rounds serialise.  ``topology`` is anything exposing
        ``transfer_time(src, dst, nbytes)`` — normally
        :class:`repro_torch.launch.mesh.Topology`.  This is the per-collective
        counterpart of ``ExecutionStats.estimated_makespan``: it prices a
        log-depth tree against the ``depth == len(ranks) - 1`` schedule a
        naive runtime would use, in time instead of message counts.
        """
        return sum(
            max(topology.transfer_time(src, dst, nbytes) for src, dst in round_)
            for round_ in self.rounds if round_
        )


def broadcast_tree(root: int, ranks: Sequence[int]) -> TreeSchedule:
    """Binary broadcast tree from ``root`` over ``ranks`` (root included).

    Round ``t`` doubles the informed set: classic recursive-doubling over the
    *positions* of the rank list, so arbitrary (partial) rank subsets work.
    """
    ranks = tuple(dict.fromkeys(ranks))  # stable-unique
    assert root in ranks, (root, ranks)
    order = [root] + [r for r in ranks if r != root]
    n = len(order)
    rounds = []
    informed = 1
    while informed < n:
        step = []
        for i in range(min(informed, n - informed)):
            step.append((order[i], order[informed + i]))
        rounds.append(tuple(step))
        informed += len(step)
    return TreeSchedule("broadcast", root, ranks, tuple(rounds))


def reduce_tree(root: int, ranks: Sequence[int]) -> TreeSchedule:
    """Binary reduction tree onto ``root`` (mirror of the broadcast tree).

    This is the paper's "logarithmic reduction": any output block accumulates
    its updates by a binary tree, cf. Listing 1's ``for (s = 1; s < nt; s *= 2)``
    loop.
    """
    b = broadcast_tree(root, ranks)
    rounds = tuple(
        tuple((dst, src) for (src, dst) in round_) for round_ in reversed(b.rounds)
    )
    return TreeSchedule("reduce", root, b.ranks, rounds)


def allreduce_tree(ranks: Sequence[int], root: Optional[int] = None) -> tuple[TreeSchedule, TreeSchedule]:
    """Reduce-to-root + broadcast-from-root (the paper-faithful all-reduce)."""
    ranks = tuple(dict.fromkeys(ranks))
    r = ranks[0] if root is None else root
    return reduce_tree(r, ranks), broadcast_tree(r, ranks)


# ---------------------------------------------------------------------------
# DAG-level inference
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InferredCollective:
    """A collective inferred from the transactional DAG."""

    version_key: tuple[int, int]
    schedule: TreeSchedule


def infer_broadcasts(workflow, default_rank: int = 0) -> list[InferredCollective]:
    """Find versions consumed on >1 rank → broadcast trees (possibly partial).

    The producer's rank is the root.  A consumer set that is a strict subset
    of the world yields a *partial* collective — only those ranks participate
    (paper cites Hoefler & Träff's sparse collectives [5]).
    """
    from .placement import placement_rank

    producers = workflow.producers()
    out: list[InferredCollective] = []
    for vkey, consumers in sorted(workflow.consumers().items()):
        prod_op = producers.get(vkey)
        root = placement_rank(prod_op.placement, default_rank) if prod_op else default_rank
        ranks = sorted({placement_rank(op.placement, default_rank) for op in consumers} | {root})
        if len(ranks) > 1:
            out.append(InferredCollective(vkey, broadcast_tree(root, ranks)))
    return out


def infer_reductions(workflow, default_rank: int = 0) -> list[InferredCollective]:
    """Find accumulation chains (v0 ← v0+x_i across ranks) → reduction trees.

    A chain is a maximal run of ops over one ref where each op both reads and
    writes the ref (``InOut``) with a commutative name (``iadd``).  If the
    contributing ops sit on >1 rank, the chain is replaced by a binary
    reduction tree rooted at the final consumer's rank.
    """
    from .placement import placement_rank

    chains: dict[int, list] = {}
    for op_node in workflow.ops:
        for v in op_node.writes:
            if op_node.name in ("iadd", "acc", "add_inplace", "_add_inplace"):
                chains.setdefault(v.ref_id, []).append(op_node)
    out: list[InferredCollective] = []
    for ref_id, ops_ in sorted(chains.items()):
        ranks = sorted({placement_rank(o.placement, default_rank) for o in ops_})
        if len(ranks) > 1:
            root = placement_rank(ops_[-1].placement, default_rank)
            out.append(
                InferredCollective((ref_id, ops_[-1].writes[0].index), reduce_tree(root, ranks))
            )
    return out
