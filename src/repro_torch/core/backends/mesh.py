"""Rank-mesh dispatch: plan ships become ``ppermute`` collectives and
kernel-tagged chains become one chain-kernel launch.

Every other backend *simulates* the distributed machine the plan was
compiled for — per-rank stores are dict entries, a ship is a dict insert.
This backend executes the same plan against a **rank mesh**
(:mod:`repro_torch.core.spmd`): one torch device per rank, repeats
allowed, so 4 ranks can share one card as the reference's 8 fake CPU
devices share one host (``MeshBackend(devices=("cuda:0",) * 4)``; the
default is the cards present, one rank each).

* **Ships** — plan ranks map 1:1 onto a mesh axis ``"r"``.  Each op's
  precomputed ship schedule is lowered to the ``ppermute`` broadcast
  rounds of :mod:`repro_torch.core.lowering` (``tree`` / ``ring`` /
  ``hierarchical``, selected by the executor's
  :class:`~repro_torch.launch.mesh.Topology` model).  The root's shard
  carries the payload and every other rank's starts as zeros, so a broken
  schedule shows up as zeros, not as silently correct replicas; each
  destination's store then holds *its own* shard, a copy that travelled
  the rounds onto its rank's device.
* **Chains** — a width-1 chain of a tagged body that has a hand-written
  chain kernel (``linear_scan.ops.scan_step``, ``gemm.ops.gemm_tile``,
  ``flash_attention.ops.attn_step``; :mod:`repro_torch.kernels.chain`)
  dispatches through
  :meth:`~repro_torch.core.executable_cache.ExecutableCache.lookup_chain_pallas`:
  the whole chain is one launch whose kernel runs the levels with the
  carry in registers.  Whether a chain goes there is decided *before* the
  call, from the body's identity, the layouts, the shapes and the dtypes
  (:func:`repro_torch.kernels.chain.problem`).  An untagged body, a width
  above 1, or operands the kernel does not take go to the generic chain
  path of :class:`~.fused.FusedBatchBackend`, as in the reference.

The frontend contract is unchanged: commit/GC/transfer accounting is
replayed virtually in plan order, so values, stats and the transfer-event
stream stay identical to serial.  ``ppermute`` moves bits without
arithmetic, so parity is exact.

When ships stay simulated, as in the reference: fewer than 2 rank devices
or a plan with more ranks than devices (the whole plan), and a NumPy or
empty payload (that ship; counted in ``ships_simulated``).  Every other
tensor payload is lowered.  Unlike the reference, which simulates a ship
whose collective failed, a failure of the collective, or of a chain kernel
after the decision, raises: no fallback hides the device.  So does a
tensor payload that lies off the rank mesh's device.

Armed, a plan's ranks must share one device.  The engine does not place a
rank's payloads on that rank's device, so on distinct devices a
destination's shard would meet operands on another device; a plan armed
over distinct devices (a default ``MeshBackend()`` on a host with two or
more cards) raises ``NotImplementedError`` until a cell with four cards
verifies that arm.
"""

from __future__ import annotations

import torch

from ..lowering import broadcast_by_schedule, schedule_for_topology
from ..spmd import Mesh, Sharded, as_device, in_mesh
from .base import apply_ships
from .fused import CONST, SINGLE, XS, XS_CONST, FusedBatchBackend

# layouts a width-1 chain kernel takes (FLAT/STACKED are width>1 shapes;
# they keep the generic chain path)
_KERNEL_LAYOUTS = frozenset((SINGLE, CONST, XS, XS_CONST))


class MeshBackend(FusedBatchBackend):
    """Execute a compiled plan on a rank mesh (see module doc).

    ``devices`` are the ranks' devices (repeats allowed); the default is
    one rank per CUDA card present, none on a host without one.  An armed
    plan's ranks must share one device (see module doc).

    ``schedule`` pins the ship-lowering collective (``"tree"`` | ``"ring"``
    | ``"hierarchical"``); default derives it from the executor's topology
    model via :func:`~repro_torch.core.lowering.schedule_for_topology`.

    ``pallas`` gates the chain kernels (the name is the reference's):
    ``"auto"`` (default) enables them exactly when ship lowering is armed
    (two or more rank devices), ``True`` forces them on any host (the
    tests and ``chip_smoke.py`` use this), ``False`` disables them.
    ``interpret`` is accepted for the reference's signature; the operands'
    device decides the route.
    """

    name = "mesh"

    def __init__(self, min_batch: int = 2, min_chain_levels: int = 2, *,
                 schedule: str | None = None, pallas="auto",
                 interpret: bool = True, devices=None):
        super().__init__(min_batch, min_chain_levels)
        self.schedule = schedule
        self.pallas = pallas
        self.interpret = interpret
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self._devices = tuple(as_device(d) for d in devices)
        self._active = False            # ship lowering armed for this plan?
        self._schedule_eff = "tree"     # resolved per execute()
        self._arity = 4
        self._n_ranks = 0
        self._meshes: dict[int, Mesh] = {}
        # observability: counter-asserted by tests and chip_smoke.py
        self.ships_lowered = 0          # ship schedules run as collectives
        self.ships_simulated = 0        # armed plans' ships replayed simulated
        self.pallas_chains_dispatched = 0
        self.ops_pallas = 0

    # -- per-plan arming ------------------------------------------------------
    def _pallas_enabled(self) -> bool:
        if self.pallas == "auto":
            return len(self._devices) >= 2
        return bool(self.pallas)

    def execute(self, ex, wf, plan) -> None:
        self._active = (len(self._devices) >= 2
                        and 2 <= ex.n_nodes <= len(self._devices))
        if self._active:
            ranks = set(self._devices[:ex.n_nodes])
            if len(ranks) > 1:
                raise NotImplementedError(
                    f"mesh backend: a {ex.n_nodes}-rank plan on distinct "
                    f"devices {sorted(map(str, ranks))} is not supported "
                    f"until a four-card cell verifies it; give the ranks "
                    f"one device, MeshBackend(devices=(dev,) * n)")
            self._n_ranks = ex.n_nodes
            topo = getattr(ex, "topology", None)
            self._schedule_eff = (self.schedule
                                  or schedule_for_topology(topo))
            self._arity = max(2, int(getattr(topo, "arity", 4) or 4))
        super().execute(ex, wf, plan)

    def _delegate_wholesale(self, ex, wf, plan) -> bool:
        # while lowering is armed, multi-rank plans stay on the level loop
        # so their ships actually reach the collective path (serial replays
        # ships inline, simulated)
        if self._active and ex.n_nodes >= 2:
            return False
        return super()._delegate_wholesale(ex, wf, plan)

    # -- ship lowering --------------------------------------------------------
    def mesh(self, n: int) -> Mesh:
        """The ``n``-rank mesh (axis ``"r"``) ships lower onto; it counts
        the copies its rounds make (``copies``, ``bytes_copied``)."""
        mesh = self._meshes.get(n)
        if mesh is None:
            mesh = self._meshes[n] = Mesh(self._devices[:n], ("r",))
        return mesh

    def _broadcast_shards(self, payload, root: int):
        """Run one rooted broadcast of a ship's payload on the rank mesh;
        every rank's shard of the result holds the payload's bits on that
        rank's device (``None`` for a NumPy or empty payload: simulated)."""
        if not (isinstance(payload, torch.Tensor) and payload.numel()):
            self.ships_simulated += 1
            return None
        mesh = self.mesh(self._n_ranks)
        device = mesh.rank_devices[root]
        if payload.device != device:
            raise ValueError(
                f"mesh backend: a ship's payload lies on {payload.device}, "
                f"off the rank mesh's device {device}; make the workflow's "
                f"tensors there")
        shards = [payload if r == root else torch.zeros_like(payload)
                  for r in range(self._n_ranks)]
        with in_mesh(mesh):
            out = broadcast_by_schedule(Sharded(mesh, shards),
                                        self._schedule_eff, "r", root=root,
                                        arity=self._arity)
        self.ships_lowered += 1
        return out.shards

    def _apply_ships(self, ex, p) -> None:
        if not self._active:
            super()._apply_ships(ex, p)
            return
        self._materialize_shipped(ex, p)
        # the plan's transfer schedule is replayed verbatim (identical
        # stream); only what a destination rank holds differs: its own shard
        apply_ships(ex, p, self._broadcast_shards)

    # -- chain lowering -------------------------------------------------------
    def _dispatch_chain(self, ex, chain, layout, width, n_levels, carry_pos,
                        call_args, sig_args):
        if (width == 1 and chain.lowerable is not None
                and self._pallas_enabled()
                and set(layout) <= _KERNEL_LAYOUTS):
            from repro_torch.kernels import chain as chain_kernels

            if chain_kernels.problem(chain.fn, layout, carry_pos, n_levels,
                                     call_args) is None:
                call = ex._exec_cache.lookup_chain_pallas(
                    chain.fn, layout, n_levels, carry_pos, sig_args,
                    interpret=self.interpret)
                out = call(*call_args)
                self.pallas_chains_dispatched += 1
                self.ops_pallas += n_levels
                return out
        return super()._dispatch_chain(ex, chain, layout, width, n_levels,
                                       carry_pos, call_args, sig_args)
