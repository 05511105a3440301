"""Multi-rank self-test for core.lowering on a rank mesh.

``python -m repro_torch.launch.selftest_collectives`` validates every
collective schedule in ``repro_torch.core.lowering`` against the
psum/broadcast oracle under ``shard_map``, on 8 ranks that share the card
(``--device cpu``: 8 ranks that share the host).  Prints ``OK`` on
success; any assertion failure exits nonzero.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.compat import shard_map
from repro_torch.core import lowering
from repro_torch.core.spmd import P, make_mesh

N = 8


def rank_devices(argv, doc: str) -> tuple:
    """The ``--device`` (default ``cuda``) of a self-test's command line,
    once for each of its ``N`` ranks; without a card ``cuda`` is refused."""
    parser = argparse.ArgumentParser(description=doc.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="the device every rank shares (cuda, cpu)")
    device = torch.device(parser.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no GPU (torch.cuda.is_available() is false); pass "
                     "--device cpu to run on the host")
    return (device,) * N


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def main(argv=None) -> int:
    devices = rank_devices(argv, __doc__)
    dev = devices[0]
    rng = np.random.default_rng(0)
    mesh1 = make_mesh((N,), ("i",), devices)

    def _run_1d(fn, x):
        f = shard_map(fn, mesh=mesh1, in_specs=P("i"), out_specs=P("i"),
                      check_vma=False)
        return _host(f(torch.from_numpy(x).to(dev)))

    for n in (N,):
        for shape in ((8, 4), (8, 16, 3)):
            x = rng.normal(size=shape).astype(np.float32)
            per = x.reshape(n, -1)
            total = per.sum(axis=0)

            # tree_allreduce == sum on every rank
            out = _run_1d(lambda v: lowering.tree_allreduce(v, "i"), x)
            np.testing.assert_allclose(
                out.reshape(n, -1), np.tile(total, (n, 1)), rtol=1e-5
            )

            # tree_reduce: rank 0 row holds the sum
            out = _run_1d(lambda v: lowering.tree_reduce(v, "i"), x)
            np.testing.assert_allclose(out.reshape(n, -1)[0], total, rtol=1e-5)

            # tree_broadcast: everyone ends with rank 0's row
            out = _run_1d(lambda v: lowering.tree_broadcast(v, "i"), x)
            np.testing.assert_allclose(
                out.reshape(n, -1), np.tile(per[0], (n, 1)), rtol=1e-6
            )

            # ring == psum oracle
            out = _run_1d(lambda v: lowering.ring_allreduce(v, "i"), x)
            np.testing.assert_allclose(
                out.reshape(n, -1), np.tile(total, (n, 1)), rtol=1e-5
            )

    # hierarchical on a (2,4) mesh == psum over both axes
    mesh = make_mesh((2, 4), ("pod", "data"), devices)
    x = rng.normal(size=(8, 4)).astype(np.float32)  # 8 = 2*4 shards of (1,4)
    xt = torch.from_numpy(x).to(dev)

    def hier(v):
        return lowering.hierarchical_allreduce(v, "data", "pod",
                                               scatter_dimension=1)

    f = shard_map(
        hier, mesh=mesh, in_specs=P(("pod", "data")),
        out_specs=P(("pod", "data")), check_vma=False,
    )
    out = _host(f(xt))
    total = x.reshape(8, 1, 4).sum(axis=0)
    np.testing.assert_allclose(out.reshape(8, 1, 4),
                               np.tile(total, (8, 1, 1)), rtol=1e-5)

    # allreduce_by_schedule dispatch: all three agree on a (2,4) mesh
    for schedule in lowering.GRAD_SYNC_SCHEDULES:
        def sync(v, s=schedule):
            return lowering.allreduce_by_schedule(
                v, s, data_axes=("pod", "data")
            )

        f = shard_map(
            sync, mesh=mesh, in_specs=P(("pod", "data")),
            out_specs=P(("pod", "data")), check_vma=False,
        )
        out = _host(f(xt))
        np.testing.assert_allclose(
            out.reshape(8, 1, 4), np.tile(total, (8, 1, 1)), rtol=1e-5,
            err_msg=f"schedule={schedule}",
        )

    # sync_gradients over a dict of gradients, mean semantics
    grads = {
        "w": rng.normal(size=(8, 4)).astype(np.float32),
        "b": rng.normal(size=(8,)).astype(np.float32),
    }

    def sync_tree(g):
        return lowering.sync_gradients(g, "hierarchical", ("pod", "data"))

    f = shard_map(
        sync_tree, mesh=mesh,
        in_specs=({"w": P(("pod", "data")), "b": P(("pod", "data"))},),
        out_specs={"w": P(("pod", "data")), "b": P(("pod", "data"))},
        check_vma=False,
    )
    out = f({k: torch.from_numpy(v).to(dev) for k, v in grads.items()})
    np.testing.assert_allclose(
        _host(out["w"]).reshape(8, 1, 4),
        np.tile(grads["w"].reshape(8, 1, 4).mean(axis=0), (8, 1, 1)),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        _host(out["b"]).reshape(8, 1),
        np.tile(grads["b"].reshape(8, 1).mean(axis=0), (8, 1)),
        rtol=1e-5,
    )

    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
