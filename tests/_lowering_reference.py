"""The reference's collectives on 8 fake CPU devices, written to an .npz.

Run as a subprocess (it sets ``XLA_FLAGS`` before importing jax, so the
test process, which imports this module for :data:`CASES`, keeps its one
device)::

    python tests/_lowering_reference.py OUT.npz

For every case of :data:`CASES` (built by ``cases()`` from one seed, the
same inputs ``tests/test_torch_lowering.py`` rebuilds) it runs the
reference function under ``shard_map`` and stores the global output as
``<case>`` and the ``(axis, src, dst)`` pairs of every ``lax.ppermute``
round it traced as ``<case>.pairs`` (a JSON string).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

N = 8
SEED = 24
GEMM_SHAPES = ((8, 8, 8), (16, 32, 8), (64, 16, 24))   # selftest_distgemm's


def inputs() -> dict:
    """The cases' global inputs, from :data:`SEED`."""
    rng = np.random.default_rng(SEED)
    f32 = np.float32
    out = {"x84": rng.normal(size=(8, 4)).astype(f32),
           "x8163": rng.normal(size=(8, 16, 3)).astype(f32),
           "x816": rng.normal(size=(8, 16)).astype(f32),
           "w": rng.normal(size=(8, 4)).astype(f32),
           "b": rng.normal(size=(8,)).astype(f32)}
    for m, k, n in GEMM_SHAPES:
        out[f"A{m}_{k}_{n}"] = rng.normal(size=(m, k)).astype(f32)
        out[f"B{m}_{k}_{n}"] = rng.normal(size=(k, n)).astype(f32)
    return out


# case -> (mesh, input, spec, function name, keyword arguments); mesh "1d"
# is (8,) over "i", "2d" (2, 4) over ("pod", "data"); spec "i" splits the
# leading dimension over the mesh's axes together
ONE_D = [(f"{fn}-{x}", "1d", x, fn, {})
         for fn in ("tree_reduce", "tree_broadcast", "tree_allreduce",
                    "ring_allreduce")
         for x in ("x84", "x8163")]
ONE_D += [("reduce_scatter-x816", "1d", "x816", "reduce_scatter",
           {"scatter_dimension": 1}),
          ("all_gather-x84", "1d", "x84", "all_gather", {"axis": 0}),
          ("all_gather-x8163", "1d", "x8163", "all_gather", {"axis": 1})]
BROADCASTS = [(f"broadcast-{s}-a{a}-root{r}", "1d", "x816",
               "broadcast_by_schedule", {"schedule": s, "root": r,
                                         "arity": a})
              for s, a in (("tree", 4), ("ring", 4), ("hierarchical", 4),
                           ("hierarchical", 2), ("hierarchical", 3))
              for r in range(N)]
TWO_D = [("hierarchical_allreduce-x84", "2d", "x84",
          "hierarchical_allreduce", {"scatter_dimension": 1}),
         ("tree_reduce-data-x84", "2d", "x84", "tree_reduce_data", {}),
         ("ring_allreduce-data-x84", "2d", "x84", "ring_allreduce_data", {})]
TWO_D += [(f"allreduce_by_schedule-{s}-{x}", "2d", x,
           "allreduce_by_schedule", {"schedule": s})
          for s in ("tree", "ring", "hierarchical") for x in ("x84", "b")]
TWO_D += [(f"sync_gradients-{s}-mean{int(m)}", "2d", "grads",
           "sync_gradients", {"schedule": s, "mean": m})
          for s in ("tree", "ring", "hierarchical") for m in (True, False)]
GEMMS = [(f"distributed_gemm_shardmap-{s}-{m}_{k}_{n}", "pq",
          f"{m}_{k}_{n}", "distributed_gemm_shardmap", {"schedule": s})
         for m, k, n in GEMM_SHAPES for s in ("tree", "ring")]
CASES = ONE_D + BROADCASTS + TWO_D + GEMMS


def main(path: str) -> None:
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import lowering
    from repro.linalg.distributed import distributed_gemm_shardmap

    assert len(jax.devices()) == N, jax.devices()
    recorded: list = []
    ppermute = lax.ppermute

    def recording(x, axis_name, perm):
        recorded.append([axis_name, [list(p) for p in perm]])
        return ppermute(x, axis_name, perm)

    lax.ppermute = recording        # lowering calls lax.ppermute at trace
    meshes = {"1d": jax.make_mesh((N,), ("i",)),
              "2d": jax.make_mesh((2, 4), ("pod", "data")),
              "pq": jax.make_mesh((2, 4), ("p", "q"))}
    data = inputs()
    out = {}
    for case, mesh_name, x, fn, kw in CASES:
        recorded.clear()
        mesh = meshes[mesh_name]
        if fn == "distributed_gemm_shardmap":
            call = distributed_gemm_shardmap(mesh, **kw)
            res = call(data[f"A{x}"], data[f"B{x}"])
        else:
            axis = "i" if mesh_name == "1d" else ("pod", "data")
            spec = P(axis)
            if fn == "tree_reduce_data":
                body = lambda v: lowering.tree_reduce(v, "data")  # noqa: E731
            elif fn == "ring_allreduce_data":
                body = lambda v: lowering.ring_allreduce(v, "data")  # noqa
            elif fn == "hierarchical_allreduce":
                body = lambda v: lowering.hierarchical_allreduce(  # noqa
                    v, "data", "pod", **kw)
            elif fn == "allreduce_by_schedule":
                body = lambda v: lowering.allreduce_by_schedule(  # noqa
                    v, kw["schedule"], data_axes=("pod", "data"))
            elif fn == "sync_gradients":
                body = lambda g: lowering.sync_gradients(  # noqa
                    g, kw["schedule"], ("pod", "data"), mean=kw["mean"])
            elif fn == "broadcast_by_schedule":
                body = lambda v: lowering.broadcast_by_schedule(  # noqa
                    v, kw["schedule"], "i", root=kw["root"],
                    arity=kw["arity"])
            else:
                body = lambda v, f=getattr(lowering, fn): f(  # noqa
                    v, "i", **kw)
            if fn == "sync_gradients":
                arg = {"w": data["w"], "b": data["b"]}
                spec = {"w": spec, "b": spec}
                specs = (spec,)
            else:
                arg = data[x]
                specs = spec
            f = shard_map(body, mesh=mesh, in_specs=specs, out_specs=spec,
                          check_vma=False)
            res = jax.jit(f)(arg)
        if isinstance(res, dict):
            for k, v in res.items():
                out[f"{case}.{k}"] = np.asarray(v)
        else:
            out[case] = np.asarray(res)
        out[f"{case}.pairs"] = np.array(json.dumps(recorded))
    np.savez(path, **out)


if __name__ == "__main__":
    # before jax is imported (main imports it), and only here: the test
    # process that imports this module for CASES keeps its one device
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1])
