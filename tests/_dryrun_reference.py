"""The reference half of ``tests/test_torch_dryrun.py``, run in a
subprocess: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 fake CPU
devices when it is imported, so it cannot share the test's process.

    python tests/_dryrun_reference.py OUT.json < request.json

``request.json`` names what to compute; ``OUT.json`` gets, under the same
keys:

* ``parse``: ``parse_collective_bytes`` of each HLO text;
* ``shapes``: ``SHAPES``, and ``cells_for`` / ``long500k_eligible`` of
  every configuration;
* ``shards``: for each ``[arch, mesh kind]``, one device's bytes of the
  parameters and of the AdamW state (a float32 master and two moments a
  leaf) under ``make_policy(make_production_mesh(...))``, summed from
  ``NamedSharding.shard_shape`` over ``jax.eval_shape(model.init)`` at
  full size (nothing compiled);
* ``meter``: for each ``[arch, kind, seq_len, batch]``, the reduced
  configuration's ``meter=True`` step lowered on a one-device
  ``("data", "model")`` mesh and compiled, ``cost_analysis()["flops"]``.

The meshes get the ``Auto`` axis types of jax 0.4.37, without which the
reference's policy path fails under jax 0.9 (``_multidevice_reference``).
"""

from __future__ import annotations

import json
import math
import sys


def _auto_axes() -> None:
    import jax
    from jax.sharding import AxisType

    make = jax.make_mesh

    def make_mesh(shape, names, *args, **kwargs):
        kwargs.setdefault("axis_types", (AxisType.Auto,) * len(names))
        return make(shape, names, *args, **kwargs)

    jax.make_mesh = make_mesh


def _shards(arch: str, mesh_kind: str) -> dict:
    import jax
    from jax.sharding import NamedSharding

    from repro import configs
    from repro.launch.mesh import make_production_mesh
    from repro.models import LanguageModel
    from repro.sharding import make_policy

    cfg = configs.get(arch)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    policy = make_policy(mesh)
    shapes = jax.eval_shape(LanguageModel(cfg).init, jax.random.PRNGKey(0))
    shardings = policy.tree_param_shardings(shapes)
    params = state = 0
    for leaf, sh in zip(jax.tree_util.tree_leaves(shapes),
                        jax.tree_util.tree_leaves(
                            shardings,
                            is_leaf=lambda x: isinstance(x, NamedSharding))):
        n = math.prod(sh.shard_shape(leaf.shape))
        params += n * leaf.dtype.itemsize
        state += n * 12
    return {"params": params, "state": state}


def _meter(arch: str, kind: str, seq_len: int, batch: int) -> float:
    import jax

    from repro import configs
    from repro.launch import dryrun
    from repro.models import LanguageModel
    from repro.sharding import make_policy

    cfg = configs.get(arch).reduced()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         devices=jax.devices()[:1])
    policy = make_policy(mesh, batch_sharded=batch > 1,
                         seq_sharded=kind != "decode")
    lowered = dryrun._lower_for(LanguageModel(cfg, meter=True), cfg, policy,
                                kind, seq_len, batch, remat=False)
    return dryrun._compile_stats(lowered)["flops"]


def main(out_path: str) -> None:
    from repro.launch import dryrun  # sets XLA_FLAGS before jax starts

    _auto_axes()
    from repro import configs

    request = json.load(sys.stdin)
    out = {}
    if "parse" in request:
        out["parse"] = [dryrun.parse_collective_bytes(t)
                        for t in request["parse"]]
    if request.get("shapes"):
        out["shapes"] = {
            "SHAPES": {k: list(v) for k, v in dryrun.SHAPES.items()},
            "cells": {n: dryrun.cells_for(configs.get(n))
                      for n in configs.all_names()},
            "long500k": {n: dryrun.long500k_eligible(configs.get(n))
                         for n in configs.all_names()},
        }
    if "shards" in request:
        out["shards"] = [_shards(*cell) for cell in request["shards"]]
    if "meter" in request:
        out["meter"] = [_meter(*cell) for cell in request["meter"]]
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
