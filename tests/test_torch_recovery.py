"""Fault tolerance in the port against the reference: lineage recovery,
checkpoint barriers, elastic rebind, and the planning it rests on.

* **Planning** — plans built under an elastic ``rank_map`` equal the
  reference's (levels, ships, drop lists, chains, flops), as do
  ``ExecutionPlan.rebind_ranks``, ``slice_for_ranks``, ``key_delta`` and
  ``plan_consts`` on the same workflows.
* **Recovery** — every case of ``tests/test_recovery.py`` runs through both
  packages on the same NumPy inputs: values bit for bit, and the same
  recovery accounting (``recoveries``, ``recomputed_ops``,
  ``restored_versions``, ``ops_executed``, ``wavefronts``) and transfer
  stream wherever both packages replay the same way.
* **Fault-mode conformance** (``tests/test_conformance.py``'s
  ``check_fault_conformance``) for every port backend on the pinned seeds:
  kill a rank at a wavefront, values identical to the reference's
  fault-free run, fewer ops recomputed than a full replay — ``procs`` with
  a real worker ``SIGKILL``.
"""

import sys
import time

import numpy as np
import pytest
from test_conformance import N_WORKFLOWS, make_spec
from test_torch_conformance import (PORT, REF, _assert_values, _events,
                                    _reference_run, run_spec)
from test_torch_plan import (PKGS, _fresh_state, _holders,  # noqa: F401
                             _pinned, _record_linalg, _record_spec,
                             plan_summary)

from _torch_conformance_ops import chains as port_chains
from repro import core as ref_bind
from repro.ckpt.manager import CheckpointManager as RefCheckpointManager
from repro_torch import core as port_bind
from repro_torch.ckpt import CheckpointManager as PortCheckpointManager
from repro_torch.core import plan as port_plan
from repro_torch.core.recovery import choose_replacement


@ref_bind.op
def _ref_step(c: ref_bind.InOut, s: ref_bind.In):
    return c * 1.01 + s


@ref_bind.op
def _ref_mix(c: ref_bind.InOut, o: ref_bind.In):
    return c + 0.5 * o


def _ref_chains(wf, arrs, depth, mix_at=()):
    n = len(arrs)
    for lv in range(depth):
        for r, a in enumerate(arrs):
            with ref_bind.node(r):
                _ref_step(a, float(lv))
        if lv in mix_at:
            for r, a in enumerate(arrs):
                with ref_bind.node(r):
                    _ref_mix(a, arrs[(r + 1) % n])


SIDES = {"ref": (ref_bind, _ref_chains, RefCheckpointManager),
         "port": (port_bind, port_chains, PortCheckpointManager)}


def _run(pkg, program, n_nodes, injector=None, backend="serial",
         mode="plan", decomm=None):
    """``program(chains, wf, arrs, ckpt_manager_class)`` recorded through
    package ``pkg`` and run; returns ``(values, stats, executor)``."""
    bind, chains, manager = SIDES[pkg]
    ex = bind.LocalExecutor(n_nodes, mode=mode, backend=backend,
                            fault_injector=injector)
    with bind.Workflow(n_nodes=n_nodes, executor=ex) as wf:
        arrs = [wf.array(np.arange(8.0) + r, rank=r) for r in range(n_nodes)]
        program(chains, wf, arrs, manager)
        wf.sync()
        if decomm is not None:
            ex.decommission_rank(wf, decomm)
        vals = [np.asarray(wf.fetch(a)) for a in arrs]
    return vals, ex.stats, ex


def _both(program, n_nodes, policy=None, **kw):
    """The program through both packages, each under a fresh injector made
    by ``policy(bind)``; values bit for bit, recovery accounting equal."""
    out = {}
    for pkg in ("ref", "port"):
        inj = policy(SIDES[pkg][0]) if policy is not None else None
        out[pkg] = _run(pkg, program, n_nodes, inj, **kw) + (inj,)
    (rv, rs, _, _), (pv, ps, _, _) = out["ref"], out["port"]
    for a, b in zip(rv, pv):
        np.testing.assert_array_equal(b, a)
    for name in ("recoveries", "recomputed_ops", "restored_versions",
                 "ops_executed", "wavefronts", "copies_elided"):
        assert getattr(ps, name) == getattr(rs, name), name
    return out


def _chains_program(depth, mix_at=()):
    return lambda chains, wf, arrs, _m: chains(wf, arrs, depth, mix_at)


# ---------------------------------------------------------------------------
# planning under an elastic rank map
# ---------------------------------------------------------------------------

def _mapped(pkg, wf, n_nodes, rank_map):
    plan_mod = PKGS[pkg][1]
    end = len(wf.ops)
    holders = {k: {rank_map.get(r, r) for r in rs}
               for k, rs in _holders(wf).items()}
    return plan_mod.build_plan(wf, 0, end, n_nodes, "tree", holders,
                               _pinned(wf), rank_map), holders


@pytest.mark.parametrize("seed", range(0, N_WORKFLOWS, 5))
def test_rank_mapped_plans_match_the_reference(seed):
    spec = make_spec(seed)
    n = spec["n_nodes"]
    if n < 2:
        spec = {**spec, "n_nodes": 2}
        n = 2
    rank_map = {n - 1: 0}
    got = {}
    for pkg, pool in (("ref", REF), ("port", PORT)):
        PKGS[pkg][3].reset_ids()
        wf = _record_spec(pool, spec)
        plan, holders = _mapped(pkg, wf, n, rank_map)
        unmapped = PKGS[pkg][1].build_plan(wf, 0, len(wf.ops), n, "tree",
                                           _holders(wf), _pinned(wf))
        rebound = unmapped.rebind_ranks(rank_map, holders, _pinned(wf), wf)
        slices = PKGS[pkg][1].slice_for_ranks(plan, wf, holders, n)
        got[pkg] = (plan_summary(plan), plan_summary(rebound),
                    slices.worker_levels, slices.read_holders,
                    [getattr(f, "__name__", "") for f in slices.fns],
                    len(slices.consts),
                    PKGS[pkg][1].plan_consts(plan, wf) == slices.consts)
    assert got["port"] == got["ref"]
    assert all(n - 1 not in p[4] for p in got["port"][0]["schedule"])


@pytest.mark.parametrize("kind", ["listing1", "strassen"])
def test_linalg_slices_and_rank_maps_match_the_reference(kind):
    got = {}
    for pkg in PKGS:
        PKGS[pkg][3].reset_ids()
        wf, n_nodes = _record_linalg(pkg, kind)
        rank_map = {n_nodes - 1: 0} if n_nodes > 1 else {}
        plan, holders = _mapped(pkg, wf, n_nodes, rank_map)
        slices = PKGS[pkg][1].slice_for_ranks(plan, wf, holders, n_nodes)
        got[pkg] = (plan_summary(plan), slices.worker_levels,
                    slices.read_holders, slices.n_levels)
    assert got["port"] == got["ref"]


def _loop_plans(pkg, steps=3):
    """The plans a loop-shaped program replays, one per flush."""
    bind = PKGS[pkg][0]
    plans = []

    class Spy(bind.SerialPlanBackend):
        def execute(self, ex, wf, plan):
            plans.append(plan)
            super().execute(ex, wf, plan)

    def scale(a, s):
        return a * s

    scale.__bind_intents__ = (bind.InOut, bind.In)
    ex = bind.LocalExecutor(2, backend=Spy())
    wf = bind.Workflow(n_nodes=2, executor=ex)
    with wf.recording():
        x = wf.array(np.ones(4), "x", rank=0)
    for i in range(steps):
        with wf.recording():
            with bind.node(1):
                wf.call(scale, (x, 2.0 + i))
            wf.call(scale, (x, 0.5))
        wf.sync()
        ex.flush()
    return plans, wf


def test_key_delta_and_plan_consts_match_the_reference():
    got = {}
    for pkg in PKGS:
        PKGS[pkg][3].reset_ids()
        plans, wf = _loop_plans(pkg)
        plan_mod = PKGS[pkg][1]
        got[pkg] = ([plan_mod.key_delta(plans[0], p) for p in plans],
                    [plan_mod.plan_consts(p, wf) for p in plans])
    assert got["port"] == got["ref"]
    deltas, consts = got["port"]
    assert set(deltas[0].values()) == {0}
    assert all(d and all(d.values()) for d in deltas[1:])
    assert consts == [(2.0, 0.5), (3.0, 0.5), (4.0, 0.5)]
    assert port_plan.map_ranks((0, 2, 1), {2: 0}) == (0, 1)


# ---------------------------------------------------------------------------
# the cases of tests/test_recovery.py, through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,backend", [("plan", "serial"),
                                          ("plan", "fused"),
                                          ("interpret", "serial")])
def test_kill_sweep_every_rank_every_wavefront(mode, backend):
    n, depth = 3, 5
    program = _chains_program(depth, (2,))
    _, ref_st, _ = _run("ref", program, n)
    for rank in range(n):
        for w in range(len(ref_st.wavefronts)):
            out = _both(program, n,
                        lambda b: b.FaultInjector.kill_rank(rank, w),
                        backend=backend, mode=mode)
            st = out["port"][1]
            assert st.recoveries == 1, (rank, w)
            assert st.recomputed_ops < ref_st.ops_executed, (rank, w)
            assert sum(st.wavefronts) == st.ops_executed, (rank, w)
            if mode == "plan":
                assert _events(st) == _events(out["ref"][1]), (rank, w)


def test_recompute_bounded_by_lost_lineage():
    n, depth = 4, 16
    program = _chains_program(depth)
    out = _both(program, n, lambda b: b.FaultInjector.kill_rank(2, 12))
    st = out["port"][1]
    assert st.recoveries == 1
    assert st.recomputed_ops <= 12, st.recomputed_ops
    assert 0.0 < st.recompute_ratio < 1.0
    assert st.recovery_time_s > 0.0


@pytest.mark.parametrize("backend", ["serial", "procs"])
def test_checkpoint_barrier_truncates_recovery(tmp_path, backend):
    """The barrier saves through each package's own manager; under
    ``procs`` its body runs in a worker, and the frontend marks it saved
    when the barrier's level commits."""
    n, depth, barrier = 2, 12, 8
    dirs = iter(range(100))

    def with_barrier(chains, wf, arrs, manager):
        chains(wf, arrs, barrier)
        wf.checkpoint(arrs, manager(str(tmp_path / f"ck{next(dirs)}")))
        chains(wf, arrs, depth - barrier)

    plain = _chains_program(depth)
    _, nb_st, _ = _run("ref", plain, n)
    _, b_st, _ = _run("ref", with_barrier, n)
    out_nb = _both(plain, n, lambda b: b.FaultInjector.kill_rank(
        1, len(nb_st.wavefronts) - 1))
    out = {}
    for pkg in ("ref", "port"):
        inj = SIDES[pkg][0].FaultInjector.kill_rank(
            1, len(b_st.wavefronts) - 1)
        out[pkg] = _run(pkg, with_barrier, n, inj,
                        backend=backend if pkg == "port" else "serial")
    for a, b in zip(out["ref"][0], out["port"][0]):
        np.testing.assert_array_equal(b, a)
    st, st_nb = out["port"][1], out_nb["port"][1]
    for name in ("recoveries", "recomputed_ops", "restored_versions"):
        assert getattr(st, name) == getattr(out["ref"][1], name), name
    assert st.restored_versions >= 1
    assert st_nb.recoveries == 1 and st.recoveries == 1
    assert st.recomputed_ops <= depth - barrier
    assert st.recomputed_ops < st_nb.recomputed_ops
    if backend == "procs":
        assert out["port"][2].backend.fallbacks == 0


def test_ship_drop_reships_without_recompute():
    n = 3
    out = _both(_chains_program(6, (1, 3)), n,
                lambda b: b.FaultInjector.drop_ship(2, seed=5))
    st, inj = out["port"][1], out["port"][3]
    assert st.recoveries == 1
    assert st.recomputed_ops == 0
    assert inj.fired and inj.fired[0]["kind"] == "ship"
    assert inj.fired == out["ref"][3].fired


def test_ship_drop_under_procs_falls_back_to_the_checked_serial_path():
    """A ship drop needs mid-plan replica state the workers do not report:
    ``procs`` runs that plan on the serial checked path (counted)."""
    n = 3
    program = _chains_program(6, (1, 3))
    ref, _, _ = _run("ref", program, n,
                     ref_bind.FaultInjector.drop_ship(2, seed=5))
    vals, st, ex = _run("port", program, n,
                        port_bind.FaultInjector.drop_ship(2, seed=5),
                        backend="procs")
    for a, b in zip(ref, vals):
        np.testing.assert_array_equal(b, a)
    assert st.recoveries == 1 and st.recomputed_ops == 0
    assert ex.backend.fallbacks >= 1


def test_delay_policy_is_not_a_failure():
    out = _both(_chains_program(4), 2,
                lambda b: b.FaultInjector.delay_rank(1, 2, seconds=0.125))
    st, inj = out["port"][1], out["port"][3]
    assert st.recoveries == 0 and st.recomputed_ops == 0
    assert inj.delays == 1 and inj.delay_s == pytest.approx(0.125)


@pytest.mark.parametrize("backend", ["serial", "threads", "fused", "mesh",
                                     "procs"])
def test_permanent_kill_rebinds_to_survivors(backend):
    n = 4
    program = _chains_program(8, (2, 5))
    ref, ref_st, ref_ex = _run("ref", program, n,
                               ref_bind.FaultInjector.kill_rank(
                                   2, 4, permanent=True))
    vals, st, ex = _run("port", program, n,
                        port_bind.FaultInjector.kill_rank(2, 4,
                                                          permanent=True),
                        backend=(port_bind.MeshBackend(pallas=True)
                                 if backend == "mesh" else backend))
    for a, b in zip(ref, vals):
        np.testing.assert_array_equal(b, a)
    assert st.recoveries == 1
    assert st.recomputed_ops == ref_st.recomputed_ops
    assert not ex._stores[2], "dead rank must hold nothing"
    assert ex._rank_map == ref_ex._rank_map == {2: ex._decommissioned[2]}
    assert all(2 not in ranks for ranks in ex._where.values())


def test_decommission_rank_migrates_state():
    out = _both(_chains_program(6, (3,)), 4, decomm=1)
    ex = out["port"][2]
    assert not ex._stores[1]
    assert 1 in ex._decommissioned
    assert ex._decommissioned == out["ref"][2]._decommissioned
    assert all(1 not in ranks for ranks in ex._where.values())


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_decommission_then_continue_recording(pkg):
    bind, chains, _m = SIDES[pkg]
    n = 3
    ex = bind.LocalExecutor(n)
    with bind.Workflow(n_nodes=n, executor=ex) as wf:
        arrs = [wf.array(np.arange(8.0) + r, rank=r) for r in range(n)]
        chains(wf, arrs, 4)
        wf.sync()
        repl = ex.decommission_rank(wf, 2)
        assert repl != 2 and repl not in ex._decommissioned
        chains(wf, arrs, 4, (1,))
        wf.sync()
        vals = [np.asarray(wf.fetch(a)) for a in arrs]
        assert not ex._stores[2]
        assert all(2 not in ranks for ranks in ex._where.values())
    ref, _, _ = _run("ref", lambda c, wf, a, _m: (c(wf, a, 4),
                                                  c(wf, a, 4, (1,))), n)
    for a, b in zip(ref, vals):
        np.testing.assert_array_equal(b, a)


def test_topology_prices_replacement_choice():
    from repro.core.recovery import choose_replacement as ref_choose
    from repro.launch.mesh import make_topology as ref_topology
    from repro_torch.launch.mesh import make_topology

    ring = make_topology("ring", n_nodes=6)
    ref_ring = ref_topology("ring", n_nodes=6)
    for dead, alive in ((3, [0, 1, 2, 4, 5]), (3, [0, 1, 5]), (0, [2, 3]),
                        (5, [0, 1, 2, 3, 4])):
        assert choose_replacement(dead, alive, ring) == ref_choose(
            dead, alive, ref_ring)
    assert choose_replacement(3, [0, 1, 2, 4, 5], ring) == 2
    assert choose_replacement(3, [0, 1, 5], ring) == 1
    assert choose_replacement(3, [4, 1, 5]) == 1
    with pytest.raises(ValueError, match="no surviving rank"):
        choose_replacement(3, [])


def test_supervisor_detects_pre_first_heartbeat_hang(tmp_path):
    from repro_torch.runtime import Supervisor

    hb = str(tmp_path / "never_written_hb")
    sup = Supervisor([sys.executable, "-c", "import time; time.sleep(60)"],
                     heartbeat_file=hb, heartbeat_timeout=0.5,
                     max_restarts=0)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="gave up"):
        sup.run(poll=0.1)
    assert time.time() - t0 < 30.0
    assert sup.restarts == 1


def test_rank_failure_carries_structured_context():
    n = 3
    got = {}
    for pkg in ("ref", "port"):
        bind = SIDES[pkg][0]
        ex = bind.LocalExecutor(n, backend="serial",
                                fault_injector=bind.FaultInjector.kill_rank(
                                    1, 2))
        with bind.Workflow(n_nodes=n, executor=ex) as wf:
            arrs = [wf.array(np.arange(4.0), rank=r) for r in range(n)]
            SIDES[pkg][1](wf, arrs, 5)
            wf.sync()
            wf.fetch(arrs[0])
        got[pkg] = ex.fault_injector.fired
    assert got["port"] == got["ref"] == [
        {"kind": "kill", "rank": 1, "wavefront": 2, "permanent": False,
         "fired": True}]
    with pytest.raises(port_bind.RankFailure,
                       match="rank 9 failed at wavefront 4"):
        raise port_bind.RankFailure(9, 4)
    assert str(port_bind.RankFailure(2, 3, kind="ship", permanent=True)) == \
        str(ref_bind.RankFailure(2, 3, kind="ship", permanent=True))


# ---------------------------------------------------------------------------
# fault-mode conformance on the pinned seeds, every port backend
# ---------------------------------------------------------------------------

FAULT_BACKENDS = {
    "serial": ("plan", lambda: "serial"),
    "threads": ("plan", lambda: "threads"),
    "fused": ("plan", lambda: "fused"),
    "mesh": ("plan", lambda: port_bind.MeshBackend(pallas=True)),
    "interpret": ("interpret", lambda: "serial"),
}


def _fault_trial(seed):
    """The reference's draw (``check_fault_conformance``, one trial)."""
    spec = make_spec(seed)
    _values, ref_stats = _reference_run(seed, "numpy", False)
    rng = np.random.default_rng(seed ^ 0xFA117)
    rank = int(rng.integers(0, spec["n_nodes"]))
    wavefront = int(rng.integers(0, len(ref_stats.wavefronts) + 1))
    return spec, rank, wavefront, ref_stats


def _check_fault(seed, name, mode, backend):
    spec, rank, wavefront, ref_stats = _fault_trial(seed)
    ref_values, _ = _reference_run(seed, "numpy", False)
    inj = port_bind.FaultInjector.kill_rank(rank, wavefront)
    ctx = f"seed {seed}: kill r{rank}@w{wavefront} {mode}/{name}"
    values, stats, ex = run_spec(PORT, spec, "numpy", mode, backend,
                                 attn=False, fault_injector=inj)
    _assert_values(ref_values, values, "numpy", ctx, seed, attn=False)
    assert sum(stats.wavefronts) == stats.ops_executed, ctx
    if stats.recoveries:
        assert stats.recomputed_ops < ref_stats.ops_executed, ctx
        assert stats.recompute_ratio < 1.0, ctx
    else:
        assert stats.recomputed_ops == 0, ctx
    return stats, ex


@pytest.mark.parametrize("seed", range(N_WORKFLOWS))
def test_port_fault_conformance_pinned_seeds(seed):
    fired = 0
    for name, (mode, backend) in FAULT_BACKENDS.items():
        stats, _ = _check_fault(seed, name, mode, backend())
        fired += stats.recoveries
    _spec, _rank, wavefront, ref_stats = _fault_trial(seed)
    if wavefront < len(ref_stats.wavefronts):
        assert fired == len(FAULT_BACKENDS), (seed, fired)


@pytest.mark.parametrize("seed", range(0, N_WORKFLOWS, 10))
def test_procs_fault_conformance_pinned_seeds(seed):
    """The same trial with the victim a real worker process: ``SIGKILL`` at
    the level's start, recovered from the slots the survivors proved."""
    stats, ex = _check_fault(seed, "procs", "plan",
                             port_bind.ProcessPoolBackend())
    assert ex.backend.fallbacks == 0, seed


def test_fault_conformance_fires_on_most_seeds():
    """Keep the sweep honest: most trials kill before the last boundary."""
    fired = 0
    for seed in range(N_WORKFLOWS):
        _spec, _rank, wavefront, ref_stats = _fault_trial(seed)
        fired += wavefront < len(ref_stats.wavefronts)
    assert fired >= N_WORKFLOWS // 2, fired
