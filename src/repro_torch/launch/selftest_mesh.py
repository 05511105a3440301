"""Multi-rank self-test for the mesh backend on a rank mesh.

``python -m repro_torch.launch.selftest_mesh`` validates the rank-mesh
execution path end to end on 8 ranks that share the card (``--device
cpu``: 8 ranks that share the host):

* the rooted broadcast schedules in ``repro_torch.core.lowering``
  (``tree`` / ``ring`` / ``hierarchical``) deliver the root's bits to every
  rank, for every root, under ``shard_map``;
* ``MeshBackend`` replays a ship-heavy workflow with values AND the
  transfer-event stream identical to serial while actually running the
  ships as ``ppermute`` rounds (``ships_lowered`` counter), each
  destination holding a shard of its own, under all three schedules;
* a kernel-tagged chain dispatches exactly ONE chain-kernel launch
  (``pallas_chains_dispatched`` / ``ExecutableCache.compiles``) with
  bitwise value parity against serial.

Prints ``OK`` on success; any assertion failure exits nonzero.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch import core as bind
from repro_torch.compat import shard_map
from repro_torch.core import lowering
from repro_torch.core.backends.mesh import MeshBackend
from repro_torch.core.spmd import P, make_mesh
from repro_torch.kernels.linear_scan.ops import scan_step
from repro_torch.launch.mesh import make_topology
from repro_torch.launch.selftest_collectives import N, rank_devices


def _consume(x, out):
    return out + x


_consume.__bind_intents__ = (bind.In, bind.InOut)


def _scale(a, s):
    return a * s


_scale.__bind_intents__ = (bind.InOut, bind.In)


def check_rooted_broadcasts(devices) -> None:
    """Every schedule × every root: rank r ends with root's row, bitwise."""
    mesh = make_mesh((N,), ("i",), devices)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(N, 16)).astype(np.float32)).to(
        devices[0])
    for schedule in lowering.SHIP_SCHEDULES:
        for root in range(N):
            f = shard_map(
                lambda v, s=schedule, r=root: lowering.broadcast_by_schedule(
                    v, s, "i", root=r, arity=4),
                mesh=mesh, in_specs=P("i"), out_specs=P("i"),
                check_vma=False)
            assert torch.equal(f(x), x[root].expand(N, 16)), (schedule, root)


def ship_workflow(backend, device, topo=None):
    """One producer rank, seven consumer ranks — every read is a broadcast
    ship of a tensor payload.  Returns the values, the transfer stream and
    the executor."""
    ex = bind.LocalExecutor(N, collective_mode="tree", mode="plan",
                            backend=backend, topology=topo)
    with bind.Workflow(n_nodes=N, executor=ex) as wf:
        x = wf.array(torch.arange(64, dtype=torch.float32, device=device),
                     "x")
        outs = [wf.array(torch.full((64,), float(r), device=device))
                for r in range(N - 1)]
        with bind.node(0):
            wf.call(_scale, (x, 2.0), name="scale")
        for r in range(N - 1):
            with bind.node(r + 1):
                wf.call(_consume, (x, outs[r]), name="consume")
        vals = [wf.fetch(o) for o in outs]
    tr = [(e.version_key, e.src, e.dst, e.nbytes, e.round_id, e.collective,
           e.wavefront) for e in ex.stats.transfers]
    return vals, tr, ex


def check_ship_lowering(devices) -> None:
    ref_vals, ref_tr, _ = ship_workflow("serial", devices[0])
    assert ref_tr, "reference workflow shipped nothing"
    topos = {"tree": None, "ring": make_topology("ring", N),
             "hierarchical": make_topology("fat-tree", N)}
    for schedule, topo in topos.items():
        mb = MeshBackend(devices=devices)
        vals, tr, ex = ship_workflow(mb, devices[0], topo)
        assert mb._schedule_eff == schedule, (schedule, mb._schedule_eff)
        assert mb.ships_lowered > 0, f"{schedule}: nothing lowered"
        assert mb.ships_simulated == 0, f"{schedule}: simulated"
        assert tr == ref_tr, f"{schedule}: transfer stream diverged"
        for a, b in zip(vals, ref_vals):
            assert torch.equal(a, b), schedule
        # every rank that received x holds a shard of its own
        key = ref_tr[0][0]
        held = [ex._stores[r][key] for r in range(N) if key in ex._stores[r]]
        ptrs = {t.untyped_storage().data_ptr() for t in held}
        assert len(held) > 1 and len(ptrs) == len(held), schedule


def check_pallas_chain(devices) -> None:
    depth = 8
    device = devices[0]

    def run(backend, cache=None):
        ex = bind.LocalExecutor(1, mode="plan", backend=backend,
                                executable_cache=cache)
        with bind.Workflow(n_nodes=1, executor=ex) as wf:
            y = wf.array(torch.linspace(0., 1., 16, device=device), "y")
            for i in range(depth):
                x = wf.array(torch.full((16,), float(2 ** (i % 3)),
                                        device=device))
                wf.call(scan_step, (y, 0.5, x), name="scan_step")
            return wf.fetch(y)

    cache = bind.ExecutableCache()
    mb = MeshBackend(devices=devices)   # pallas="auto": armed, 8 ranks
    out = run(mb, cache)
    ref = run("serial")
    assert torch.equal(out, ref)
    assert mb.pallas_chains_dispatched == 1, mb.pallas_chains_dispatched
    assert mb.ops_pallas == depth
    assert cache.compiles == 1, cache.compiles   # ONE executable per chain


def main(argv=None) -> int:
    devices = rank_devices(argv, __doc__)
    check_rooted_broadcasts(devices)
    check_ship_lowering(devices)
    check_pallas_chain(devices)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
