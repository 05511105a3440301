"""Core pieces of the port held against the reference: payload conversion,
byte accounting, the executable cache, collectives, latency stats, the
per-op replay primitives and planned-vs-interpreted accounting."""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_bind
from repro.core import stats as ref_stats
from repro_torch import compat
from repro_torch import core as bind
from repro_torch.core import stats as port_stats
from repro_torch.core.backends.base import (apply_ships, commit, gather_args,
                                            resolve_call)
from repro_torch.core.executable_cache import ExecutableCache, _abstract


# ---------------------------------------------------------------------------
# compat: state crosses the package boundary with dtype and values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32,
                                   np.int64, np.bool_, np.float16])
def test_numpy_round_trip(dtype):
    x = (np.random.default_rng(0).normal(size=(3, 5)) * 4).astype(dtype)
    t = compat.to_torch(x)
    assert t.dtype == compat.torch_dtype(dtype) and t.device.type == "cpu"
    back = compat.to_numpy(t)
    assert back.dtype == x.dtype
    np.testing.assert_array_equal(back, x)
    assert compat.numpy_dtype(t.dtype) == x.dtype


def test_jax_payloads_cross_with_their_values():
    x = np.random.default_rng(1).normal(size=(4, 4)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16),
                     (jnp.int32, torch.int32)):
        j = jnp.asarray(x * 8, dtype=jdt)
        t = compat.to_torch(j)
        assert t.dtype == tdt
        np.testing.assert_array_equal(compat.to_numpy(t),
                                      np.asarray(j, np.float32)
                                      .astype(compat.to_numpy(t).dtype))


def test_bfloat16_comes_back_as_float32_exactly():
    t = torch.tensor([1.0, 1.0078125, -3.5], dtype=torch.bfloat16)
    out = compat.to_numpy(t)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, [1.0, 1.0078125, -3.5])
    assert compat.numpy_dtype(torch.bfloat16) == np.float32


def test_unsupported_dtypes_raise_and_cuda_probe_is_a_bool():
    with pytest.raises(TypeError):
        compat.torch_dtype(np.dtype("U4"))
    with pytest.raises(TypeError):
        compat.to_torch(np.array(["a"]))
    assert isinstance(compat.cuda_available(), bool)


# ---------------------------------------------------------------------------
# byte accounting and the executable cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32, np.uint8])
def test_tensor_bytes_equal_numpy_bytes(dtype):
    x = np.zeros((7, 3), dtype)
    assert port_stats._nbytes(torch.from_numpy(x)) == \
        ref_stats._nbytes(x) == x.nbytes
    assert port_stats._nbytes(2.0) == 0 and port_stats._nbytes(None) == 0


def test_executable_cache_keys_and_counters():
    cache = ExecutableCache()

    def f(a, b):
        return a + b

    t = torch.zeros(4, 4)
    n = np.zeros((4, 4), np.float32)
    assert cache.lookup(f, (t, 1.0)) is f
    assert cache.lookup(f, (torch.ones(4, 4), 2.0)) is f   # same signature
    assert cache.lookup(f, (n, 1.0)) is f          # NumPy: its own signature
    assert cache.lookup(f, (t.double(), 1.0)) is f  # dtype is in the key
    assert (cache.hits, cache.misses, len(cache)) == (1, 3, 3)
    assert cache.compiles == 0 and cache.fallbacks == 0
    assert _abstract(t) == ((4, 4), torch.float32, torch.device("cpu"))
    assert _abstract(n) == ((4, 4), np.dtype(np.float32), None)
    assert _abstract(3) is int
    cache.clear()
    assert (cache.hits, cache.misses, len(cache)) == (0, 0, 0)


def test_numpy_payloads_are_never_promoted():
    """A NumPy float64 payload stays NumPy float64 through the executor."""
    def scale(a, s):
        return a * s

    scale.__bind_intents__ = (bind.InOut, bind.In)
    with bind.Workflow() as wf:
        a = wf.array(np.ones(3))
        wf.call(scale, (a, 2.0))
        out = wf.fetch(a)
    assert type(out) is np.ndarray and out.dtype == np.float64


# ---------------------------------------------------------------------------
# collectives and latency stats: pure ports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [(0, 1, 2, 3, 4, 5, 6), (3, 1, 7), (2,)])
def test_collective_schedules_match_reference(ranks):
    root = ranks[0]
    for name in ("broadcast_tree", "reduce_tree"):
        r = getattr(ref_bind, name)(root, ranks)
        p = getattr(bind, name)(root, ranks)
        assert (p.kind, p.root, p.ranks, p.rounds) == \
            (r.kind, r.root, r.ranks, r.rounds)
    r_red, r_bc = ref_bind.allreduce_tree(ranks)
    p_red, p_bc = bind.allreduce_tree(ranks)
    assert p_red.rounds == r_red.rounds and p_bc.rounds == r_bc.rounds


def _fanout(pkg):
    def produce(x):
        return x + 1

    def acc(c, x):
        return c + x

    produce.__bind_intents__ = (pkg.InOut,)
    acc.__bind_intents__ = (pkg.InOut, pkg.In)
    wf = pkg.Workflow(n_nodes=4, executor=pkg.LocalExecutor(4))
    with wf.recording():
        x = wf.array(np.ones(2), "x")
        c = wf.array(np.zeros(2), "c")
        wf.call(produce, (x,), name="produce")
        for r in (1, 3):
            with pkg.node(r):
                wf.call(acc, (c, x), name="acc")
    return wf


def test_inferred_collectives_match_reference():
    ref_wf, port_wf = _fanout(ref_bind), _fanout(bind)
    for name in ("infer_broadcasts", "infer_reductions"):
        r = getattr(ref_bind, name)(ref_wf)
        p = getattr(bind, name)(port_wf)
        assert [(c.version_key, c.schedule.rounds) for c in p] == \
            [(c.version_key, c.schedule.rounds) for c in r]


def test_latency_stats_match_reference():
    samples = [0.003, 0.001, 0.002, 0.010, 0.0005]
    r, p = ref_stats.LatencyStats(), port_stats.LatencyStats()
    for s in samples:
        r.record(s)
        p.record(s)
    assert p.summary() == r.summary()
    assert (p.p50, p.p99, len(p)) == (r.p50, r.p99, len(r))


# ---------------------------------------------------------------------------
# replay primitives and planned-vs-interpreted accounting
# ---------------------------------------------------------------------------

def _scale(a, s):
    return a * s


_scale.__bind_intents__ = (bind.InOut, bind.In)


def _gemm(a, b, c):
    return c + a @ b


_gemm.__bind_intents__ = (bind.In, bind.In, bind.InOut)


def _build(wf):
    a = wf.array(torch.arange(9.0).reshape(3, 3), "a", rank=1)
    c = wf.array(torch.zeros(3, 3), "c", rank=2)
    with bind.node(2):
        wf.call(_gemm, (a, a, c))
    with bind.nodes((0, 3)):
        wf.call(_scale, (a, 3.0))
    wf.call(_gemm, (a, a, c))
    return a, c


class _PrimitiveBackend(bind.Backend):
    """Per-op replay through the structured primitives of ``base``."""

    name = "primitives"

    def execute(self, ex, wf, plan):
        for p in plan.schedule:
            node = wf.ops[p.op_id]
            if p.ships:
                apply_ships(ex, p)
            args = gather_args(ex, p, node)
            commit(ex, p, node, resolve_call(ex, p, args)(*args))


def _run(backend=None, mode="plan"):
    ex = bind.LocalExecutor(4, mode=mode, backend=backend)
    with bind.Workflow(n_nodes=4, executor=ex) as wf:
        a, c = _build(wf)
        vals = (wf.fetch(a).clone(), wf.fetch(c).clone())
    st = ex.stats
    return vals, (st.transfers, st.wavefronts, st.ops_executed,
                  st.copies_elided, st.peak_live_bytes, st.peak_live_payloads)


def test_replay_primitives_match_the_serial_hot_loop():
    ref_vals, ref_acc = _run("serial")
    got_vals, got_acc = _run(_PrimitiveBackend())
    for r, g in zip(ref_vals, got_vals):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert got_acc == ref_acc
    assert len(ref_acc[0]) > 0          # the workflow ships between ranks


def test_planned_accounting_matches_interpreter():
    plan_vals, plan_acc = _run("serial")
    int_vals, int_acc = _run(mode="interpret")
    for r, g in zip(plan_vals, int_vals):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert plan_acc == int_acc


@pytest.mark.parametrize("mode", ["plan", "interpret"])
def test_finished_workflow_is_freed_without_the_cyclic_collector(mode):
    # a device-resident payload must go when its workflow and executor do,
    # not whenever the cyclic garbage collector next runs
    gc.disable()
    try:
        ex = bind.LocalExecutor(4, mode=mode)
        with bind.Workflow(n_nodes=4, executor=ex) as wf:
            a, c = _build(wf)
            result = weakref.ref(wf.fetch(c))
            source = weakref.ref(wf.initial[(a.ref.ref_id, 0)][0])
        assert result() is not None and source() is not None
        del ex, wf, a, c
        assert result() is None and source() is None
    finally:
        gc.enable()


def test_executor_rejects_unknown_modes():
    with pytest.raises(ValueError):
        bind.LocalExecutor(1, mode="eager")
    with pytest.raises(ValueError):
        bind.LocalExecutor(1, collective_mode="ring")
