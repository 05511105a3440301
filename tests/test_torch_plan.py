"""Plan parity: the same workflow, recorded through each package's own API
and intents, compiles to the same ``ExecutionPlan``.

Compared field by field: the schedule (op ids, functions by name, argument
and written version keys, exec ranks, ship schedules, GC drop lists,
levels), ``levels``, ``level_groups``, ``chains`` (members, width, carry,
payload positions, interior keys, ``lowerable``), ``level_kernels``,
``wavefront_counts``, ``level_flops`` and the round budget — plus the
relocatable program signature the program-trace cache keys on, and the
cache's hit/miss behaviour on a loop-shaped program.
"""

import numpy as np
import pytest
from test_conformance import N_WORKFLOWS, make_spec
from test_torch_conformance import PORT, REF, _record_op

from repro import core as ref_bind
from repro.core import plan as ref_plan
from repro.core import program as ref_program
from repro.core import versioning as ref_versioning
from repro.linalg import Tiled as RefTiled
from repro.linalg import gemm_strassen as ref_strassen
from repro.linalg.distributed import (distributed_gemm_listing1 as ref_listing1,
                                      make_distributed_inputs as ref_inputs)
from repro_torch import core as port_bind
from repro_torch.core import plan as port_plan
from repro_torch.core import program as port_program
from repro_torch.core import versioning as port_versioning
from repro_torch.linalg import Tiled as PortTiled
from repro_torch.linalg import gemm_strassen as port_strassen
from repro_torch.linalg.distributed import (
    distributed_gemm_listing1 as port_listing1,
    make_distributed_inputs as port_inputs)

PKGS = {
    "ref": (ref_bind, ref_plan, ref_program, ref_versioning),
    "port": (port_bind, port_plan, port_program, port_versioning),
}


@pytest.fixture(autouse=True)
def _fresh_state():
    for bind, _plan, _program, versioning in PKGS.values():
        versioning.reset_ids()
        bind.clear_plan_cache()
        bind.clear_program_cache()
    yield


def _name(fn):
    return getattr(fn, "__name__", repr(fn))


def plan_summary(plan) -> dict:
    """Every structural product of a plan, as plain comparable data."""
    return {
        "schedule": [(p.op_id, _name(p.fn), p.arg_keys, p.write_keys,
                      p.exec_ranks, p.ships, p.gc_keys, p.level)
                     for p in plan.schedule],
        "levels": plan.levels,
        "level_groups": plan.level_groups,
        "has_fusion_groups": plan.has_fusion_groups,
        "chains": [(c.members, c.width, c.first_level, _name(c.fn),
                    c.carry_pos, c.payload_positions,
                    sorted(c.interior_keys), c.lowerable, c.n_levels)
                   for c in plan.chains],
        "level_kernels": plan.level_kernels,
        "wavefront_counts": list(plan.wavefront_counts),
        "level_flops": list(plan.level_flops),
        "n_rounds": plan.n_rounds,
        "total_writes": plan.total_writes,
        "span": (plan.start, plan.end, plan.n_nodes, plan.collective_mode),
    }


def _holders(wf):
    return {k: {rank} for k, (_v, rank) in wf.initial.items()}


def _pinned(wf):
    return {ref.head.key for ref in wf.refs.values()}


def compiled(pkg, wf, n_nodes, collective_mode="tree"):
    _bind, plan_mod, program_mod, _v = PKGS[pkg]
    end = len(wf.ops)
    holders, pinned = _holders(wf), _pinned(wf)
    plan = plan_mod.build_plan(wf, 0, end, n_nodes, collective_mode,
                               holders, pinned)
    ops_sig, ext, pin, keys = program_mod._normalize(wf, 0, end, holders,
                                                      pinned)
    reloc = ([(_name(op[0]),) + op[1:] for op in ops_sig], ext, pin, keys)
    return plan_summary(plan), reloc


def _record_spec(pool, spec):
    bind = pool.bind
    wf = bind.Workflow(n_nodes=spec["n_nodes"],
                       executor=bind.LocalExecutor(spec["n_nodes"]))
    with wf.recording():
        handles = [wf.array(np.asarray(vals), f"a{i}", rank=rank)
                   for i, (_kind, rank, vals) in enumerate(spec["arrays"])]
        for spec_op in spec["ops"]:
            _record_op(pool, wf, handles, spec_op)
    return wf


@pytest.mark.parametrize("collective_mode", ["tree", "naive"])
@pytest.mark.parametrize("seed", range(0, N_WORKFLOWS, 5))
def test_conformance_workflows_plan_identically(seed, collective_mode):
    spec = make_spec(seed)
    got = {}
    for pkg, pool in (("ref", REF), ("port", PORT)):
        PKGS[pkg][3].reset_ids()
        wf = _record_spec(pool, spec)
        got[pkg] = compiled(pkg, wf, spec["n_nodes"], collective_mode)
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]


def test_fuzzer_plans_carry_chains_and_kernel_tags():
    """Keep the parity sweep honest: some compared plans hold chains,
    some of them lowerable, and some levels carry kernel tags."""
    chains = lowerable = tagged = 0
    for seed in range(N_WORKFLOWS):
        spec = make_spec(seed)
        summary, _ = compiled("port", _record_spec(PORT, spec),
                              spec["n_nodes"])
        chains += len(summary["chains"])
        lowerable += sum(1 for c in summary["chains"] if c[7] is not None)
        tagged += sum(1 for t in summary["level_kernels"] if t is not None)
    assert chains and lowerable and tagged


def _record_linalg(pkg, kind, flops=False):
    bind = PKGS[pkg][0]
    Tiled = RefTiled if pkg == "ref" else PortTiled
    rng = np.random.default_rng(0)
    A, B = rng.normal(size=(16, 16)), rng.normal(size=(16, 16))
    if kind == "listing1":
        n_nodes = 4
        wf = bind.Workflow(n_nodes=n_nodes,
                           executor=bind.LocalExecutor(n_nodes))
        with wf.recording():
            inputs = ref_inputs if pkg == "ref" else port_inputs
            listing1 = ref_listing1 if pkg == "ref" else port_listing1
            a, b, c = inputs(wf, A, B, 4, 2, 2)
            listing1(wf, a, b, c, 2, 2)
    else:
        n_nodes = 1
        wf = bind.Workflow(executor=bind.LocalExecutor(1))
        with wf.recording():
            ta = Tiled.from_array(wf, A, 4)
            tb = Tiled.from_array(wf, B, 4)
            tc = Tiled.zeros(wf, 4, 4, 4)
            (ref_strassen if pkg == "ref" else port_strassen)(ta, tb, tc)
    if flops:   # the cost model's input: per-op flops, one rank per level
        for node in wf.ops:
            node.flops = 2 * 4 ** 3 if node.name in ("gemm", "pgemm") else 0
    return wf, n_nodes


@pytest.mark.parametrize("flops", [False, True])
@pytest.mark.parametrize("kind", ["listing1", "strassen"])
def test_linalg_workflows_plan_identically(kind, flops):
    got = {}
    for pkg in PKGS:
        PKGS[pkg][3].reset_ids()
        wf, n_nodes = _record_linalg(pkg, kind, flops)
        got[pkg] = compiled(pkg, wf, n_nodes)
    assert got["port"] == got["ref"]
    if flops:
        assert any(got["port"][0]["level_flops"])


def _loop_program(pkg, steps=4):
    """A loop-shaped program flushed once per step: every step after the
    first must replay the relocatable template (no plan build)."""
    bind = PKGS[pkg][0]

    def scale(a, s):
        return a * s

    scale.__bind_intents__ = (bind.InOut, bind.In)
    ex = bind.LocalExecutor(2)
    wf = bind.Workflow(n_nodes=2, executor=ex)
    with wf.recording():
        x = wf.array(np.ones(4), "x", rank=0)
    wf.sync()
    ex.flush()
    for _ in range(steps):
        with wf.recording():
            with bind.node(1):
                wf.call(scale, (x, 2.0))
            wf.call(scale, (x, 0.5))
        wf.sync()
        ex.flush()
    stats = ex.stats
    return (np.asarray(ex.value(x.ref.head)), dict(PKGS[pkg][2]
            .PROGRAM_CACHE_STATS), dict(PKGS[pkg][1].PLAN_CACHE_STATS),
            [(t.version_key, t.src, t.dst, t.nbytes, t.round_id)
             for t in stats.transfers])


def test_relocatable_program_cache_matches_reference():
    ref = _loop_program("ref")
    port = _loop_program("port")
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1] == ref[1]        # program-trace cache hits and misses
    assert port[2] == ref[2]        # exact plan cache hits and misses
    assert port[3] == ref[3]        # transfer stream
    assert port[1]["hits"] >= 3


def test_rebind_equals_fresh_build():
    """A template re-bound to advanced keys is the plan a fresh build gives."""
    bind = port_bind

    def scale(a, s):
        return a * s

    scale.__bind_intents__ = (bind.InOut, bind.In)
    wf = bind.Workflow(n_nodes=2, executor=bind.LocalExecutor(2))
    with wf.recording():
        x = wf.array(np.ones(4), "x", rank=0)
        for _step in range(2):      # two structurally equal loop bodies
            with bind.node(1):
                wf.call(scale, (x, 2.0))
            wf.call(scale, (x, 2.0))
    holders = {x.ref.versions[0].key: {0}}
    first = port_plan.build_plan(wf, 0, 2, 2, "tree", holders,
                                 {x.ref.versions[2].key})
    tmpl = port_program.ProgramPlan(
        first, port_program._normalize(wf, 0, 2, holders,
                                       {x.ref.versions[2].key})[3], 0)
    holders2 = {x.ref.versions[2].key: {0}}
    pinned2 = {x.ref.head.key}
    keys2 = port_program._normalize(wf, 2, 4, holders2, pinned2)[3]
    rebound = port_program._bind(tmpl, keys2, 2, 4)
    fresh = port_plan.build_plan(wf, 2, 4, 2, "tree", holders2, pinned2)
    assert plan_summary(rebound) == plan_summary(fresh)
    assert fresh.n_rounds == 2 and fresh.chains == ()
