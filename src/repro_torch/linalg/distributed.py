"""Distributed classical GEMM with logarithmic reduction (paper Listing 1, Fig. 3/4).

Two implementations of the same algorithm:

* :func:`distributed_gemm_listing1` — the paper-faithful 18-line version
  over the Bind model: per-``j`` partial products placed on node
  ``(i % NP) * NQ + j % NQ``, accumulated by the explicit binary tree
  ``for (s = 1; s < nt; s *= 2)`` with the listing's slot rotation,
  executed by the LocalExecutor (validates semantics + collective
  accounting).  On one GPU every rank's tiles live on that card, and every
  partial product launches the hand-written GEMM kernel.

* :func:`distributed_gemm_shardmap` — the mesh lowering: the same
  partial-sum + log-reduction structure expressed as a ``shard_map`` over a
  (p, q) rank mesh (:mod:`repro_torch.core.spmd`), with the reduction
  schedule selectable (the paper's binary tree vs the ring) — the unit of
  the collective ablation.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch import core as bind
from repro_torch.compat import shard_map, to_torch
from repro_torch.core import lowering
from repro_torch.core.spmd import P
from repro_torch.kernels.gemm import ops as gemm_ops
from .tiles import Tiled, _t_iadd


def _p_gemm(a, b):
    if isinstance(a, torch.Tensor):
        return gemm_ops.matmul(a, b)
    return a @ b


def owner_rank(i: int, j: int, NP: int, NQ: int) -> int:
    """Paper's placement: ``bind::node p((i % NP) * NQ + j % NQ)``."""
    return (i % NP) * NQ + j % NQ


def distributed_gemm_listing1(
    wf: bind.Workflow, a: Tiled, b: Tiled, c: Tiled, NP: int, NQ: int
) -> None:
    """``c += a @ b`` exactly as the paper's Listing 1 (block loops elided to
    the per-tile level; the ``ii/kk`` blocking is a locality optimisation that
    does not change the DAG)."""
    nt = a.nt
    for i in range(c.mt):
        for k in range(c.nt):
            # slot w holds the partial of j = (w + k) % nt  (listing's rotation)
            r: list = [None] * nt
            for j in range(nt):
                with bind.node(owner_rank(i, j, NP, NQ)):
                    r[(nt - k + j) % nt] = wf.apply(
                        _p_gemm, (a.tile(i, j), b.tile(j, k)), name="pgemm"
                    )
            # logarithmic reduction: for (s = 1; s < nt; s *= 2)
            s = 1
            while s < nt:
                w = s
                while w < nt:
                    with bind.node((i % NP) * NQ + ((k + w - s) % nt) % NQ):
                        wf.call(_t_iadd, (r[w - s], r[w]), name="iadd")
                    w += s * 2
                s *= 2
            with bind.node(owner_rank(i, k, NP, NQ)):
                wf.call(_t_iadd, (c.tile(i, k), r[0]), name="iadd")


def make_distributed_inputs(wf: bind.Workflow, A, B, ib: int, NP: int,
                            NQ: int):
    """Tile + distribute operands the way the algorithm's placement expects.

    ``A`` and ``B`` are NumPy arrays (NumPy tiles) or tensors (tensor tiles
    on their device); ``C`` starts as zeros of ``A``'s kind, dtype and
    device.
    """
    a = Tiled.from_array(wf, A, ib, "A", rank_of=lambda i, j: owner_rank(i, j, NP, NQ))
    b = Tiled.from_array(wf, B, ib, "B", rank_of=lambda j, k: owner_rank(k, j, NP, NQ))
    mt, nt = A.shape[0] // ib, B.shape[1] // ib
    c = Tiled.zeros(wf, mt, nt, ib, A.dtype, "C",
                    rank_of=lambda i, k: owner_rank(i, k, NP, NQ),
                    device=A.device if isinstance(A, torch.Tensor) else None)
    return a, b, c


def run_distributed_gemm(
    A, B, *, ib: int, NP: int, NQ: int, device="cuda",
    collective_mode: str = "tree", backend: str = "serial",
    topology=None,
) -> tuple[torch.Tensor, "bind.ExecutionStats", float]:
    """Record + execute Listing 1 end-to-end on ``device``.

    ``A`` and ``B`` (NumPy arrays or tensors) move to ``device`` with their
    dtype; pass ``device="cpu"`` to run on the host.  Returns ``(C, stats,
    est_makespan)``: ``C`` is a tensor on ``device`` (enqueued work; read it
    or synchronise to wait for the card), ``est_makespan`` the simulated
    makespan under ``topology`` (``0.0`` when no topology is given).
    """
    A = to_torch(A, device)
    B = to_torch(B, device)
    ex = bind.LocalExecutor(NP * NQ, collective_mode=collective_mode,
                            backend=backend)
    with bind.Workflow(n_nodes=NP * NQ, executor=ex) as wf:
        a, b, c = make_distributed_inputs(wf, A, B, ib=ib, NP=NP, NQ=NQ)
        distributed_gemm_listing1(wf, a, b, c, NP, NQ)
        out = c.to_array()
    est = ex.stats.estimated_makespan(topology) if topology is not None else 0.0
    return out, ex.stats, est


# ---------------------------------------------------------------------------
# Mesh lowering
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tf32_off():
    """Switch TF32 off for float32 products on the card inside the block,
    and restore the process's setting after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def distributed_gemm_shardmap(
    mesh, *, schedule: str = "tree", p_axis: str = "p", q_axis: str = "q"
):
    """Build an ``(A, B) -> A @ B`` over a (p, q) rank mesh.

    A is block-distributed ``(i→p, j→q)`` and B ``(j→q)`` — the exact data
    placement of Listing 1; each rank computes its local partial GEMM and
    the ``q`` axis reduces it with the chosen schedule (``"tree"`` is the
    paper's logarithmic reduction, ``"ring"`` the bandwidth-optimal ring).
    The local product is a plain ``torch.matmul``, as the reference's is
    XLA's dot (callers that want IEEE float32 products on the card call it
    under :func:`tf32_off`); the result lies on the mesh's first device.
    """

    def local(a_blk, b_blk):
        part = a_blk @ b_blk  # (M/p, N) partial over the q axis
        if schedule == "tree":
            part = lowering.tree_allreduce(part, q_axis)
        elif schedule == "ring":
            part = lowering.ring_allreduce(part, q_axis)
        else:
            raise ValueError(schedule)
        return part

    return shard_map(
        local,
        mesh=mesh,
        in_specs=(P(p_axis, q_axis), P(q_axis, None)),
        out_specs=P(p_axis, None),
        check_vma=False,
    )
