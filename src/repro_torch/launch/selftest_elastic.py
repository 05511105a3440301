"""Elastic checkpoint self-test: save sharded on an 8-rank mesh, restore
re-sharded onto a 4-rank mesh and back to 8 — values bit for bit.

    python -m repro_torch.launch.selftest_elastic [--device cpu]

The ranks share the card (``--device cpu``: the host).  A float32 and a
bfloat16 leaf are placed ``P("data", None)`` on 8 ranks, saved (the
manager writes each global array), restored by ``NamedSharding`` onto 4
of those ranks, saved again and restored onto 8.  Prints ``OK``.
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core.spmd import NamedSharding, P, assemble, make_mesh
from repro_torch.launch.selftest_collectives import rank_devices


def main(argv=None) -> int:
    devices = rank_devices(argv, __doc__)
    rng = np.random.default_rng(0)
    tree = {
        "w": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)),
        "e": torch.from_numpy(rng.normal(size=(8, 4)).astype(
            np.float32)).to(torch.bfloat16),
    }
    tree = {k: v.to(devices[0]) for k, v in tree.items()}
    mesh8 = make_mesh((8,), ("data",), devices)
    sh8 = {k: NamedSharding(mesh8, P("data", None)) for k in tree}
    placed = {k: sh8[k].place(v) for k, v in tree.items()}

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=False)
        mgr.save(0, placed, extra={"mesh": [8]})

        mesh4 = make_mesh((4,), ("data",), devices[:4])
        sh4 = {k: NamedSharding(mesh4, P("data", None)) for k in tree}
        out, _ = mgr.restore(tree, shardings=sh4)
        for k in tree:
            assert torch.equal(assemble(out[k]), tree[k]), k
            assert out[k].sharding.mesh.shape["data"] == 4
            assert out[k].shards[0].shape[0] == tree[k].shape[0] // 4

        # and back up to 8 (scale-up after scale-down)
        mgr.save(1, out, extra={"mesh": [4]})
        out8, _ = mgr.restore(tree, shardings=sh8)
        for k in tree:
            assert torch.equal(assemble(out8[k]), tree[k]), k
            assert out8[k].sharding.mesh.shape["data"] == 8
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
