"""The port's collective schedules against the reference's, on rank meshes.

One subprocess (``tests/_lowering_reference.py``) runs every case of its
``CASES`` through the reference's ``repro.core.lowering`` under
``shard_map`` on 8 fake CPU devices and records the ``(src, dst)`` pairs of
every ``lax.ppermute`` round; this module runs the same cases through
``repro_torch.core.lowering`` on 8 CPU rank devices
(:mod:`repro_torch.core.spmd`) — a 1-D mesh ``("i",)``, the (pod 2, data
4) mesh of ``selftest_collectives.py`` and the (p 2, q 4) mesh of
``selftest_distgemm.py`` — from the same inputs, and holds them to it:

* every rooted broadcast (each root × each schedule, hierarchical at
  arity 4, 2 and 3), ``tree_reduce``, ``tree_broadcast``,
  ``tree_allreduce``, the tree schedule of ``allreduce_by_schedule`` and
  ``all_gather`` bit for bit: they add in the reference's order or only
  copy;
* ``ring_allreduce``, ``reduce_scatter``, ``hierarchical_allreduce``, the
  ring and hierarchical schedules and ``sync_gradients`` within 1e-6 of
  the sum of the summands' magnitudes (the same collective run on
  ``|x|``), element by element: XLA's ``psum`` adds in its own order, the
  port's ring in the ring's, and any order of 8 float32 terms lies within
  7 · 2^-24 of that sum of magnitudes of the exact one;
* the recorded pairs of every round of every ``ppermute``-built schedule
  equal the reference's, round by round;
* ``distributed_gemm_shardmap`` at ``selftest_distgemm.py``'s shapes, both
  schedules, within 1e-5 (the local products sum in another order);
* ``schedule_for_topology`` and the schedule name tuples.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _lowering_reference import CASES, N, inputs

from repro.core import lowering as ref_lowering
from repro.launch.mesh import make_topology as ref_make_topology
from repro_torch.compat import shard_map
from repro_torch.core import lowering, spmd
from repro_torch.core.spmd import P, Sharded, make_mesh
from repro_torch.launch.mesh import make_topology
from repro_torch.linalg.distributed import distributed_gemm_shardmap

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CPU = (torch.device("cpu"),) * N
MESHES = {"1d": ((N,), ("i",)), "2d": ((2, 4), ("pod", "data")),
          "pq": ((2, 4), ("p", "q"))}
BY_NAME = {case[0]: case for case in CASES}

# copies, or adds in the reference's own order: bit for bit
BITWISE = sorted(name for name in BY_NAME
                 if name.startswith(("tree_", "broadcast-", "all_gather-",
                                     "allreduce_by_schedule-tree-")))
# psum in the reference, the ring in the port
SUMMED = sorted(name for name in BY_NAME
                if name.startswith(("ring_allreduce", "reduce_scatter",
                                    "hierarchical_allreduce",
                                    "allreduce_by_schedule-ring",
                                    "allreduce_by_schedule-hierarchical",
                                    "sync_gradients")))
GEMMS = sorted(name for name in BY_NAME
               if name.startswith("distributed_gemm_shardmap"))
# built from ppermute rounds on both sides: the same pairs
PAIRED = sorted(name for name in BY_NAME
                if name.startswith(("tree_", "broadcast-"))
                or "-tree-" in name or name.startswith("sync_gradients-tree"))
SUMMED_TOL = 1e-6
GEMM_TOL = 1e-5


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference output and recorded pairs (one subprocess
    with 8 fake CPU devices)."""
    path = tmp_path_factory.mktemp("lowering") / "reference.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "_lowering_reference.py"),
         str(path)], capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def run_port(name, monkeypatch=None, magnitude=False):
    """Case ``name`` through the port on 8 CPU rank devices: the global
    output (a dict for ``sync_gradients``) as NumPy and the recorded
    ``[axis, pairs]`` of every ``ppermute`` (run on ``|x|`` when
    ``magnitude``)."""
    _, mesh_name, x, fn, kw = BY_NAME[name]
    data = {k: torch.from_numpy(np.abs(v) if magnitude else v)
            for k, v in inputs().items()}
    recorded = []
    if monkeypatch is not None:
        def recording(v, axis_name, perm):
            recorded.append([axis_name, [list(p) for p in perm]])
            return spmd.ppermute(v, axis_name, perm)

        monkeypatch.setattr(lowering, "ppermute", recording)
    mesh = make_mesh(*MESHES[mesh_name], CPU)
    if fn == "distributed_gemm_shardmap":
        res = distributed_gemm_shardmap(mesh, **kw)(data[f"A{x}"],
                                                    data[f"B{x}"])
    else:
        axis = "i" if mesh_name == "1d" else ("pod", "data")
        spec = P(axis)
        bodies = {
            "tree_reduce_data": lambda v: lowering.tree_reduce(v, "data"),
            "ring_allreduce_data":
                lambda v: lowering.ring_allreduce(v, "data"),
            "hierarchical_allreduce":
                lambda v: lowering.hierarchical_allreduce(v, "data", "pod",
                                                          **kw),
            "allreduce_by_schedule":
                lambda v: lowering.allreduce_by_schedule(
                    v, kw["schedule"], data_axes=("pod", "data")),
            "sync_gradients":
                lambda g: lowering.sync_gradients(
                    g, kw["schedule"], ("pod", "data"), mean=kw["mean"]),
            "broadcast_by_schedule":
                lambda v: lowering.broadcast_by_schedule(
                    v, kw["schedule"], "i", root=kw["root"],
                    arity=kw["arity"]),
        }
        body = bodies.get(fn) or (lambda v: getattr(lowering, fn)(v, "i",
                                                                  **kw))
        if fn == "sync_gradients":
            arg = {"w": data["w"], "b": data["b"]}
            spec = {"w": spec, "b": spec}
            specs = (spec,)
        else:
            arg, specs = data[x], spec
        res = shard_map(body, mesh=mesh, in_specs=specs, out_specs=spec)(arg)
    if isinstance(res, dict):
        res = {k: v.numpy() for k, v in res.items()}
    else:
        res = res.numpy()
    return res, recorded


def _outputs(reference, name, got):
    """Pairs of (label, reference array, port array) of case ``name``."""
    if isinstance(got, dict):
        return [(f"{name}.{k}", reference[f"{name}.{k}"], v)
                for k, v in sorted(got.items())]
    return [(name, reference[name], got)]


@pytest.mark.parametrize("name", BITWISE)
def test_schedule_matches_the_reference_bit_for_bit(name, reference):
    got, _ = run_port(name)
    for label, ref, port in _outputs(reference, name, got):
        assert port.dtype == ref.dtype and port.shape == ref.shape, label
        np.testing.assert_array_equal(port, ref, err_msg=label)


@pytest.mark.parametrize("name", SUMMED)
def test_summing_schedule_matches_the_reference(name, reference):
    got, _ = run_port(name)
    scale, _ = run_port(name, magnitude=True)
    scale = scale if isinstance(scale, dict) else {None: scale}
    for label, ref, port in _outputs(reference, name, got):
        mag = scale[label.rsplit(".", 1)[1] if label != name else None]
        assert port.dtype == ref.dtype and port.shape == ref.shape, label
        err = np.abs(port.astype(np.float64) - ref)
        assert (err <= SUMMED_TOL * mag).all(), (
            f"{label}: {(err / mag).max()} of the summands' magnitude")


@pytest.mark.parametrize("name", PAIRED)
def test_rounds_send_the_reference_pairs(name, reference, monkeypatch):
    _, recorded = run_port(name, monkeypatch)
    want = json.loads(str(reference[f"{name}.pairs"]))
    assert want, name
    assert recorded == want


@pytest.mark.parametrize("name", sorted(set(BY_NAME) - set(PAIRED)))
def test_the_reference_sums_with_psum_and_the_port_on_a_ring(
        name, reference, monkeypatch):
    """Where the reference records no round (``psum`` /
    ``psum_scatter`` / ``all_gather``), the port's rounds are neighbour
    rounds ``i -> i + 1`` around every group."""
    assert json.loads(str(reference[f"{name}.pairs"])) == []
    _, recorded = run_port(name, monkeypatch)
    assert recorded
    mesh = make_mesh(*MESHES[BY_NAME[name][1]], CPU)
    for axis, pairs in recorded:
        n = mesh.axis_size(axis)
        assert pairs == [[i, (i + 1) % n] for i in range(n)], (axis, pairs)


@pytest.mark.parametrize("name", GEMMS)
def test_distributed_gemm_shardmap_matches_the_reference(name, reference):
    got, _ = run_port(name)
    ref = reference[name]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=GEMM_TOL,
                               atol=GEMM_TOL * np.abs(ref).max())


@pytest.mark.parametrize("kind", [None, "flat", "ring", "fat-tree"])
def test_schedule_for_topology_matches_the_reference(kind):
    port = None if kind is None else make_topology(kind, 4)
    ref = None if kind is None else ref_make_topology(kind, 4)
    assert (lowering.schedule_for_topology(port)
            == ref_lowering.schedule_for_topology(ref))
    assert lowering.SHIP_SCHEDULES == ref_lowering.SHIP_SCHEDULES
    assert lowering.GRAD_SYNC_SCHEDULES == ref_lowering.GRAD_SYNC_SCHEDULES


def test_unknown_schedules_raise():
    mesh = make_mesh((N,), ("i",), CPU)
    x = Sharded(mesh, [torch.zeros(2)] * N)
    with spmd.in_mesh(mesh):
        with pytest.raises(ValueError, match="unknown schedule"):
            lowering.broadcast_by_schedule(x, "star", "i")
        with pytest.raises(ValueError, match="unknown schedule"):
            lowering.allreduce_by_schedule(x, "star", data_axes=("i",))


# ---------------------------------------------------------------------------
# The rank mesh itself
# ---------------------------------------------------------------------------

def test_ppermute_copies_into_a_new_allocation_on_a_shared_device():
    """Ranks that share a device still get storage of their own: a copy,
    never the source tensor (``t.to(same device)`` would return it)."""
    mesh = make_mesh((4,), ("r",), CPU[:4])
    x = Sharded(mesh, [torch.full((3,), float(r)) for r in range(4)])
    y = spmd.ppermute(x, "r", [(0, 1), (1, 2)])
    assert y.shards[0] is None and y.shards[3] is None
    assert torch.equal(y.shards[1], x.shards[0])
    assert torch.equal(y.shards[2], x.shards[1])
    assert (y.shards[1].untyped_storage().data_ptr()
            != x.shards[0].untyped_storage().data_ptr())
    assert mesh.copies == 2 and mesh.bytes_copied == 2 * 3 * 4


def test_collectives_act_on_every_group_along_the_axis():
    """On a (2, 4) mesh a round over ``data`` runs in both pods."""
    mesh = make_mesh((2, 4), ("pod", "data"), CPU)
    x = Sharded(mesh, [torch.tensor([float(r)]) for r in range(N)])
    y = spmd.ppermute(x, "data", [(0, 3)])
    assert [None if s is None else s.item() for s in y.shards] == [
        None, None, None, 0.0, None, None, None, 4.0]
    with spmd.in_mesh(mesh):
        assert spmd.axis_index("pod").shards == [0] * 4 + [1] * 4
        assert spmd.axis_index(("pod", "data")).shards == list(range(N))
        assert spmd.axis_size(("pod", "data")) == N
        got = lowering.tree_allreduce(x, "data")
    assert [s.item() for s in got.shards] == [6.0] * 4 + [22.0] * 4


def test_a_round_that_misses_a_receiver_raises():
    mesh = make_mesh((4,), ("r",), CPU[:4])
    x = Sharded(mesh, [torch.zeros(1)] * 4)
    y = spmd.ppermute(x, "r", [(0, 1)])
    with pytest.raises(RuntimeError, match="no round delivered"):
        spmd.where(Sharded(mesh, [False, False, True, False]), y, x)
    with pytest.raises(ValueError, match="not a permutation"):
        spmd.ppermute(x, "r", [(0, 1), (2, 1)])
    with pytest.raises(RuntimeError, match="no value to send"):
        spmd.ppermute(y, "r", [(2, 3)])


def test_shard_map_splits_and_assembles_by_spec():
    mesh = make_mesh((2, 4), ("p", "q"), CPU)
    a = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    seen = []

    def body(blk):
        seen.append(blk.shape)
        return blk + blk

    out = shard_map(body, mesh=mesh, in_specs=P("p", "q"),
                    out_specs=P("p", "q"))(a)
    assert seen == [(4, 3)] and torch.equal(out, a * 2)
    # a replicated operand: every rank gets the whole tensor; an output
    # axis the spec does not name takes index 0's shard
    out = shard_map(lambda b: b + spmd.axis_index("q"), mesh=mesh,
                    in_specs=P(), out_specs=P("p"))(torch.zeros(2, 3))
    assert torch.equal(out, torch.zeros(4, 3))
    with pytest.raises(ValueError, match="does not split"):
        shard_map(body, mesh=mesh, in_specs=P("q"),
                  out_specs=P("q"))(torch.zeros(6))
    with pytest.raises(RuntimeError, match="no mesh"):
        spmd.axis_size("q")
