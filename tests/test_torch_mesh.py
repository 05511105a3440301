"""The port's mesh backend with ship lowering armed, on CPU rank devices.

``MeshBackend(devices=("cpu",) * 8)`` is the port's counterpart of the
reference's mesh backend under ``--xla_force_host_platform_device_count=8``
(``src/repro/launch/selftest_mesh.py``): a plan of 2 to 8 ranks lowers
every tensor ship to ``ppermute`` rounds (:mod:`repro_torch.core.lowering`)
whose shards land on the ranks' devices.  The reference's ``serial``
backend runs the same workflows here, in this process, and the port must
give its values bit for bit, its stats and its transfer stream, under each
ship schedule, with ``ships_lowered`` counting the collectives.  Also:

* NumPy and empty payloads stay simulated (``ships_simulated``), as in the
  reference; so does a plan with more ranks than devices (unarmed);
* every destination rank holds a shard of its own (distinct storage);
* a failing collective **raises** — the deliberate divergence from the
  reference, which simulates the ship (``mesh.py:178``);
* a default ``MeshBackend()`` on a host without a card is unarmed;
* a plan armed over distinct devices (a default ``MeshBackend()`` on a
  host with two cards) raises ``NotImplementedError``, and a tensor
  payload off the rank mesh's device raises: neither is simulated;
* ``pallas="auto"`` on an armed mesh dispatches the chain kernel;
* Listing 1 on 4 CPU ranks: C bit for bit ``serial``'s, every ship
  lowered, three copies a ship under the tree;
* the port's three self-tests print ``OK`` in this process with
  ``--device cpu``, and refuse their default ``cuda`` without a card.
"""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_bind
from repro.kernels.linear_scan.ops import scan_step as ref_scan_step
from repro.launch.mesh import make_topology as ref_make_topology
from repro_torch import core as port_bind
from repro_torch.compat import to_numpy
from repro_torch.core import lowering
from repro_torch.kernels.linear_scan.ops import scan_step as port_scan_step
from repro_torch.launch.mesh import make_topology
from repro_torch.linalg.distributed import run_distributed_gemm

N = 8
CPU8 = ("cpu",) * N


def _pool(bind, scan_step, arr, make_topology):
    def consume(x, out):
        return out + x

    def scale(a, s):
        return a * s

    consume.__bind_intents__ = (bind.In, bind.InOut)
    scale.__bind_intents__ = (bind.InOut, bind.In)
    return types.SimpleNamespace(bind=bind, consume=consume, scale=scale,
                                 scan_step=scan_step, arr=arr,
                                 make_topology=make_topology)


REF = _pool(ref_bind, ref_scan_step, jnp.asarray, ref_make_topology)
PORT = _pool(port_bind, port_scan_step,
             lambda x: torch.from_numpy(np.array(x)), make_topology)
NUMPY = types.SimpleNamespace(**{**vars(PORT), "arr": np.array})


def _host(payload):
    return to_numpy(payload) if isinstance(payload, torch.Tensor) \
        else np.asarray(payload)


def ship_workflow(pkg, backend, kind=None, n=N, length=64):
    """``selftest_mesh.py``'s workflow: one producer rank, ``n - 1``
    consumer ranks — every read is a broadcast ship.  Returns the host
    values, the transfer stream and the executor."""
    topo = None if kind is None else pkg.make_topology(kind, n)
    ex = pkg.bind.LocalExecutor(n, collective_mode="tree", mode="plan",
                                backend=backend, topology=topo)
    with pkg.bind.Workflow(n_nodes=n, executor=ex) as wf:
        x = wf.array(pkg.arr(np.arange(length, dtype=np.float32)), "x")
        outs = [wf.array(pkg.arr(np.full(length, float(r), np.float32)))
                for r in range(n - 1)]
        with pkg.bind.node(0):
            wf.call(pkg.scale, (x, 2.0), name="scale")
        for r in range(n - 1):
            with pkg.bind.node(r + 1):
                wf.call(pkg.consume, (x, outs[r]), name="consume")
        vals = [_host(wf.fetch(o)) for o in outs]
    tr = [(e.version_key, e.src, e.dst, e.nbytes, e.round_id, e.collective,
           e.wavefront) for e in ex.stats.transfers]
    return vals, tr, ex


def _stats(ex):
    s = ex.stats
    return (s.message_count, s.bytes_transferred, s.ops_executed,
            s.wavefronts, s.peak_live_bytes, s.copies_elided)


def _n_ships(ex):
    """The ship schedules behind the transfer stream: one per version and
    wavefront."""
    return len({(t.version_key, t.wavefront) for t in ex.stats.transfers})


@pytest.mark.parametrize("kind, schedule", [(None, "tree"),
                                            ("ring", "ring"),
                                            ("fat-tree", "hierarchical")])
def test_ship_lowering_matches_the_reference_serial(kind, schedule):
    ref_vals, ref_tr, ref_ex = ship_workflow(REF, "serial", kind)
    assert ref_tr
    mb = port_bind.MeshBackend(devices=CPU8)
    vals, tr, ex = ship_workflow(PORT, mb, kind)
    assert mb._schedule_eff == schedule
    assert mb.ships_lowered == _n_ships(ex) > 0
    assert mb.ships_simulated == 0
    assert tr == ref_tr
    assert _stats(ex) == _stats(ref_ex)
    # the live-payload peak is the level loop's, as the reference's fused
    # backend (whose loop the mesh backend runs) counts it on this plan
    _, _, fused_ex = ship_workflow(REF, "fused", kind)
    assert (ex.stats.peak_live_payloads == fused_ex.stats.peak_live_payloads
            >= ref_ex.stats.peak_live_payloads)
    for got, want in zip(vals, ref_vals):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # each tree/ring/hierarchical broadcast over 8 ranks makes 7 copies
    assert mb.mesh(N).copies == 7 * mb.ships_lowered


@pytest.mark.parametrize("schedule", lowering.SHIP_SCHEDULES)
def test_every_destination_holds_a_shard_of_its_own(schedule):
    mb = port_bind.MeshBackend(devices=CPU8, schedule=schedule)
    _, tr, ex = ship_workflow(PORT, mb)
    replicated = 0
    for key in {t[0] for t in tr}:      # the live ones: x's last version
        held = [ex._stores[r][key] for r in range(N)
                if key in ex._stores[r]]
        storages = {t.untyped_storage().data_ptr() for t in held}
        assert len(storages) == len(held), key
        for t in held[1:]:
            assert torch.equal(t, held[0])
        replicated += len(held) > 1
    assert replicated


def test_numpy_and_empty_ships_stay_simulated():
    ref_vals, ref_tr, _ = ship_workflow(REF, "serial")
    mb = port_bind.MeshBackend(devices=CPU8)
    vals, tr, ex = ship_workflow(NUMPY, mb)
    assert mb.ships_lowered == 0 and mb.ships_simulated == _n_ships(ex) > 0
    assert tr == ref_tr
    for got, want in zip(vals, ref_vals):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
    mb = port_bind.MeshBackend(devices=CPU8)
    _, tr, ex = ship_workflow(PORT, mb, length=0)
    assert mb.ships_lowered == 0 and mb.ships_simulated == _n_ships(ex) > 0
    assert mb.mesh(N).copies == 0


def test_a_plan_with_more_ranks_than_devices_is_not_armed():
    ref_vals, ref_tr, _ = ship_workflow(REF, "serial")
    mb = port_bind.MeshBackend(devices=CPU8[:4])
    vals, tr, _ = ship_workflow(PORT, mb)
    assert not mb._active
    assert mb.ships_lowered == 0 and mb.ships_simulated == 0
    assert tr == ref_tr
    for got, want in zip(vals, ref_vals):
        np.testing.assert_array_equal(got, want)


def test_a_failing_collective_raises(monkeypatch):
    """Pinned divergence: the reference catches a failed collective and
    simulates the ship; the port raises, so no fallback hides the device."""
    def broken(x, axis_name, perm):
        raise RuntimeError("ppermute failed")

    monkeypatch.setattr(lowering, "ppermute", broken)
    mb = port_bind.MeshBackend(devices=CPU8)
    with pytest.raises(RuntimeError, match="ppermute failed"):
        ship_workflow(PORT, mb)
    assert mb.ships_simulated == 0


def test_a_default_mesh_backend_without_a_card_is_not_armed(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    mb = port_bind.MeshBackend()
    assert mb._devices == () and not mb._pallas_enabled()
    ref_vals, ref_tr, _ = ship_workflow(REF, "serial")
    vals, tr, _ = ship_workflow(PORT, mb)
    assert not mb._active and mb.ships_lowered == mb.ships_simulated == 0
    assert tr == ref_tr
    for got, want in zip(vals, ref_vals):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("devices", [("cpu", "meta"), None])
def test_a_plan_armed_over_distinct_devices_raises(devices, monkeypatch):
    """The engine leaves a rank's payloads where they were made, so shards
    on distinct devices would meet operands on another one: until a cell
    with four cards verifies that arm, it is refused, also for the default
    ``MeshBackend()`` on a host with two cards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mb = port_bind.MeshBackend(devices=devices)
    assert len(set(mb._devices)) == 2
    with pytest.raises(NotImplementedError, match="distinct devices"):
        ship_workflow(PORT, mb, n=2)
    assert mb.ships_lowered == mb.ships_simulated == 0


def test_a_tensor_payload_off_the_mesh_device_raises():
    """Every non-empty tensor ship is lowered: one whose payload lies off
    the rank mesh's device raises rather than being simulated."""
    mb = port_bind.MeshBackend(devices=("meta",) * N)
    with pytest.raises(ValueError, match="off the rank mesh's device"):
        ship_workflow(PORT, mb)
    assert mb.ships_lowered == mb.ships_simulated == 0


def _scan_chain(pkg, backend, depth=8):
    ex = pkg.bind.LocalExecutor(1, mode="plan", backend=backend)
    with pkg.bind.Workflow(n_nodes=1, executor=ex) as wf:
        y = wf.array(pkg.arr(np.linspace(0., 1., 16, dtype=np.float32)), "y")
        for i in range(depth):
            x = wf.array(pkg.arr(np.full(16, float(2 ** (i % 3)),
                                         np.float32)))
            wf.call(pkg.scan_step, (y, 0.5, x), name="scan_step")
        return _host(wf.fetch(y))


def test_pallas_auto_on_an_armed_mesh_dispatches_the_chain_kernel():
    mb = port_bind.MeshBackend(devices=CPU8)     # pallas="auto"
    assert mb._pallas_enabled()
    out = _scan_chain(PORT, mb)
    np.testing.assert_array_equal(out, _scan_chain(REF, "serial"))
    assert mb.pallas_chains_dispatched == 1 and mb.ops_pallas == 8


@pytest.mark.parametrize("schedule", lowering.SHIP_SCHEDULES)
def test_listing1_on_four_rank_devices(schedule):
    """Listing 1 (n 64, ib 16, 2 x 2 ranks) on an armed 4-rank mesh: C bit
    for bit ``serial``'s with the same stats and transfer stream, every
    tensor ship lowered (3 copies each: any of the schedules over 4
    ranks), none simulated."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(64, 64)).astype(np.float32)
    B = rng.normal(size=(64, 64)).astype(np.float32)
    C, s_stats, _ = run_distributed_gemm(A, B, ib=16, NP=2, NQ=2,
                                         device="cpu")
    mb = port_bind.MeshBackend(devices=("cpu",) * 4, schedule=schedule)
    got, stats, _ = run_distributed_gemm(A, B, ib=16, NP=2, NQ=2,
                                         device="cpu", backend=mb)
    assert torch.equal(got, C)
    assert list(stats.transfers) == list(s_stats.transfers)
    assert stats.ops_executed == s_stats.ops_executed
    assert mb.ships_simulated == 0 and mb.ships_lowered > 0
    assert mb.mesh(4).copies == 3 * mb.ships_lowered
    np.testing.assert_allclose(got.numpy(), A @ B, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["collectives", "mesh", "distgemm"])
def test_selftest_prints_ok(name, capsys):
    module = importlib.import_module(f"repro_torch.launch.selftest_{name}")
    assert module.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "OK"


@pytest.mark.parametrize("name", ["collectives", "mesh", "distgemm"])
def test_selftest_without_a_card_refuses_its_default(name, monkeypatch,
                                                      capsys):
    """A self-test runs on the card unless asked for the host: with no
    card its default stops with an error instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"repro_torch.launch.selftest_{name}")
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
