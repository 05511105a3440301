"""Device-mesh dispatch: kernel-tagged chains run as ONE chain-kernel launch.

The reference's mesh backend executes a plan on a real device mesh: ship
schedules lower to ``shard_map``/``ppermute`` collectives, and a
:class:`~repro_torch.core.plan.ChainSlice` whose op body carries a
``__bind_kernel__`` tag compiles into one ``pallas_call``.  The port has
the chain half so far:

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
  Anything that fails after the decision raises: a failed build or launch
  is never hidden behind the generic path.
* **Ships** — lowering onto ``torch.distributed`` is ROADMAP Queue 1
  Slice 3.  On one GPU (or a one-rank plan) ships replay simulated, as on
  the reference's one-device arm; a plan that would arm lowering (two or
  more GPUs and two or more ranks) raises ``NotImplementedError``.

Commit/GC/transfer accounting is the fused backend's, so values, stats and
the transfer-event stream stay identical to serial.
"""

from __future__ import annotations

import torch

from .fused import CONST, SINGLE, XS, XS_CONST, FusedBatchBackend

# layouts a width-1 chain kernel takes (FLAT/STACKED are width>1 shapes;
# they keep the generic chain path)
_KERNEL_LAYOUTS = frozenset((SINGLE, CONST, XS, XS_CONST))


class MeshBackend(FusedBatchBackend):
    """Execute a compiled plan with kernel-tagged chains as one launch each
    (see module doc).

    ``schedule`` pins the ship-lowering collective (``"tree"`` | ``"ring"``
    | ``"hierarchical"``) for when ships lower (Slice 3).

    ``pallas`` gates the chain kernels (the name is the reference's):
    ``"auto"`` (default) enables them exactly when ship lowering would be
    armed (two or more GPUs — so on one card it is off, as on the
    reference's one-device arm), ``True`` forces them on any host (the
    tests and ``chip_smoke.py`` use this), ``False`` disables them.
    ``interpret`` is accepted for the reference's signature; the operands'
    device decides the route.
    """

    name = "mesh"

    def __init__(self, min_batch: int = 2, min_chain_levels: int = 2, *,
                 schedule: str | None = None, pallas="auto",
                 interpret: bool = True):
        super().__init__(min_batch, min_chain_levels)
        self.schedule = schedule
        self.pallas = pallas
        self.interpret = interpret
        self._n_devices = torch.cuda.device_count()
        # observability: counter-asserted by tests and chip_smoke.py; the
        # ship counters stay 0 until ships lower (Slice 3)
        self.ships_lowered = 0          # ship schedules run as collectives
        self.ships_simulated = 0        # armed plans' ships replayed simulated
        self.pallas_chains_dispatched = 0
        self.ops_pallas = 0

    def _pallas_enabled(self) -> bool:
        if self.pallas == "auto":
            return self._n_devices >= 2
        return bool(self.pallas)

    def execute(self, ex, wf, plan) -> None:
        if self._n_devices >= 2 and 2 <= ex.n_nodes <= self._n_devices:
            raise NotImplementedError(
                f"mesh backend: lowering ships of a {ex.n_nodes}-rank plan "
                f"onto {self._n_devices} GPUs (torch.distributed) is not "
                f"ported yet: it arrives with ROADMAP Queue 1 Slice 3")
        super().execute(ex, wf, plan)

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
