"""The port's serving runtime against the reference's (``repro.serve``).

Every runtime case of ``tests/test_serve.py`` (its lines 1-130 are the LM
stack's decode) runs through both packages on ``serial``, ``threads`` and
``fused``, each side checked by the reference test's own assertions, and
then the two held against each other:

* ``numpy`` payloads: the same NumPy arrays go to both runtimes; the
  runtime starts after every submission (``autostart=False``) wherever the
  reference's test does, so batches are composed alike.  Results are
  bitwise equal with the same dtype, and every ``ServeMetrics`` counter is
  equal.
* ``tensor`` payloads: the reference gets jax arrays and the port CPU
  tensors, both float32 made from the same NumPy values; results agree
  within the stated tolerance (``tests/test_kernels.py``'s for the GEMM
  and attention steps) and the counters are equal.

A kernel-step case serves ``gemm_tile`` and ``attn_step`` requests beside
the decode step.  ``backend="procs"`` is not ported: asking for it raises
the ``ValueError`` that names its slice.
"""

import concurrent.futures
import gc
import threading
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_conformance_ops as procs_ops
from _serve_ops import bomb as ref_bomb
from _serve_ops import decay as ref_decay_op
from _serve_ops import ref_decay
from repro import core as ref_bind
from repro import serve as ref_serve
from repro.core.program import PROGRAM_CACHE_STATS as REF_PROGRAM_STATS
from repro.kernels.flash_attention.ops import attn_step as ref_attn_step
from repro.kernels.gemm.ops import gemm_tile as ref_gemm_tile
from repro_torch import core as port_bind
from repro_torch import serve as port_serve
from repro_torch.core.program import PROGRAM_CACHE_STATS as PORT_PROGRAM_STATS
from repro_torch.kernels.flash_attention.ops import attn_step as port_attn_step
from repro_torch.kernels.gemm.ops import gemm_tile as port_gemm_tile

BACKENDS = ["serial", "threads", "fused"]
KINDS = ["numpy", "tensor"]
# tensor payloads: float32 on both sides, XLA's and PyTorch's CPU kernels
# (decay: one rounding a step either way; GEMM and attention:
# tests/test_kernels.py's float32 tolerances)
DECAY_TOL = 1e-6
GEMM_TOL = (1e-4, 1e-3)
ATTN_TOL = 2e-5


@port_bind.op
def port_decay(c: port_bind.InOut, s: port_bind.In):
    return c * 0.99 + s


@port_bind.op
def port_bomb(c: port_bind.InOut, s: port_bind.In):
    raise ValueError("bomb: injected op failure")


class Side:
    """One package's serving surface, fed payloads of one kind."""

    def __init__(self, pkg: str, kind: str):
        self.pkg, self.kind = pkg, kind
        if pkg == "ref":
            self.bind, self.serve = ref_bind, ref_serve
            self.decay, self.bomb = ref_decay_op, ref_bomb
            self.gemm_tile, self.attn_step = ref_gemm_tile, ref_attn_step
            self.program_stats = REF_PROGRAM_STATS
        else:
            self.bind, self.serve = port_bind, port_serve
            self.decay, self.bomb = port_decay, port_bomb
            self.gemm_tile, self.attn_step = port_gemm_tile, port_attn_step
            self.program_stats = PORT_PROGRAM_STATS

    def payload(self, x):
        """The side's payload for the NumPy array ``x``."""
        if self.kind == "numpy":
            return np.array(x)
        x32 = np.array(x, dtype=np.float32)
        return jnp.asarray(x32) if self.pkg == "ref" else torch.from_numpy(x32)

    def runtime(self, **kw):
        return self.serve.ServingRuntime(**kw)


def host(v):
    """A served value as a NumPy array; a port tensor-kind value must be a
    tensor."""
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def expect(side, got, want, tol=DECAY_TOL):
    """``got`` (a served value) against the float64 NumPy ``want``: bitwise
    for NumPy payloads, within ``tol`` of it for float32 ones."""
    if side.pkg == "port" and side.kind == "tensor":
        assert isinstance(got, torch.Tensor), type(got)
    got = host(got)
    if side.kind == "numpy":
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def counters(rt) -> dict:
    summary = rt.metrics.summary()
    return {k: v for k, v in summary.items() if not k.endswith("_ms")}


def compare(got, exp, kind, tols=None):
    """The port's ``(values, counters)`` against the reference's."""
    got_values, got_counters = got
    exp_values, exp_counters = exp
    assert got_counters == exp_counters
    assert len(got_values) == len(exp_values)
    for i, (g, e) in enumerate(zip(got_values, exp_values)):
        if kind == "tensor":
            assert isinstance(g, torch.Tensor), (i, type(g))
        g, e = host(g), host(e)
        assert g.dtype == e.dtype and g.shape == e.shape, (i, g.dtype, e.dtype)
        tol = None if tols is None else tols[i]
        if tol is None:
            np.testing.assert_array_equal(g, e, err_msg=f"value {i}")
        else:
            rtol, atol = tol if isinstance(tol, tuple) else (tol, tol)
            np.testing.assert_allclose(g, e, rtol=rtol, atol=atol,
                                       err_msg=f"value {i}")


def both(scenario, kind, *args):
    """Run ``scenario`` on the reference and on the port; compare."""
    exp = scenario(Side("ref", kind), *args)
    got = scenario(Side("port", kind), *args)
    tols = [DECAY_TOL] * len(got[0]) if kind == "tensor" else None
    compare(got, exp, kind, tols)


# --------------------------------------------------------------------------
# the runtime cases of tests/test_serve.py
# --------------------------------------------------------------------------


def _concurrent_submitters(side, backend):
    n_sessions, steps = 4, 5
    with side.runtime(n_nodes=2, backend=backend,
                      admission_window=0.001) as rt:
        barrier = threading.Barrier(n_sessions)

        def client(i):
            sess = rt.session()

            def init(s):
                s.state["x"] = s.array(side.payload(np.arange(8.0) + i),
                                       name="x", rank=i % 2)

            sess.submit(init).result(timeout=60)
            barrier.wait(timeout=60)

            def step(s):
                side.decay(s.state["x"], 0.5)
                return s.state["x"]

            futs = [sess.submit(step) for _ in range(steps)]
            return futs[-1].result(timeout=60)

        with concurrent.futures.ThreadPoolExecutor(n_sessions) as pool:
            got = list(pool.map(client, range(n_sessions)))
        for i, val in enumerate(got):
            expect(side, val, ref_decay(np.arange(8.0) + i, 0.5, steps))
        m = rt.metrics
        assert m.requests_completed == n_sessions * (1 + steps)
        assert m.requests_failed == 0
        st = rt.executor.stats
        assert sum(st.wavefronts) == st.ops_executed
        # batch composition depends on the client threads' timing
        return got, {"completed": m.requests_completed,
                     "failed": m.requests_failed}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_concurrent_submitters_match_sequential(backend, kind):
    both(_concurrent_submitters, kind, backend)


def _cross_request_batching(side, backend):
    rt = side.runtime(n_nodes=1, backend=backend, max_batch=8,
                      autostart=False)
    try:
        def step(s):
            x = s.array(side.payload(np.full((16,), float(s.sid))), name="x")
            side.decay(x, 0.5)
            return x

        futs = [rt.session().submit(step) for _ in range(6)]
        rt.start()
        vals = [f.result(timeout=60) for f in futs]
        for sid, v in zip(range(1, 7), vals):
            expect(side, v, np.full((16,), float(sid) * 0.99 + 0.5))
        m = rt.metrics
        assert m.flushes == 1
        assert m.batched_flushes == 1
        assert m.coalesced_requests == 6
        assert m.max_batch == 6
        out = counters(rt)
        if backend == "fused":
            fb = rt.executor.backend
            out["dispatch"] = (fb.batches_dispatched, fb.ops_fused)
            if side.kind == "tensor":
                # array payloads are what the fused backend stacks
                assert fb.batches_dispatched >= 1
                assert fb.ops_fused >= 6
        return vals, out
    finally:
        rt.close()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_request_batching_fires(backend, kind):
    both(_cross_request_batching, kind, backend)


def _prefix_cache_replays(side):
    bind = side.bind
    bind.clear_plan_cache()
    bind.clear_program_cache()
    ex = bind.LocalExecutor(1, mode="plan", backend="serial", stitch=True,
                            prefix_cache=True)
    wf = bind.Workflow(n_nodes=1, executor=ex)
    with wf.recording():
        x = wf.array(side.payload(np.full(8, 1.0)), name="x")
    wf.sync()
    ex.flush()
    for _ in range(2):
        with wf.recording():
            side.decay(x, 0.5)
        wf.sync()
        ex.flush()
    st = ex.stats
    builds0 = st.plan_cache_misses
    hits0 = st.program_cache_hits
    for _ in range(3):
        with wf.recording():
            side.decay(x, 0.5)
        wf.sync()
    ex.flush()
    assert st.plan_cache_misses == builds0, "burst paid a plan build"
    assert st.program_cache_hits == hits0 + 3
    val = ex.value(x.ref.head)
    expect(side, val, ref_decay(np.full(8, 1.0), 0.5, 5))
    return [val], {"plan_cache_misses": st.plan_cache_misses,
                   "program_cache_hits": st.program_cache_hits}


@pytest.mark.parametrize("kind", KINDS)
def test_prefix_cache_replays_streamed_step_plans(kind):
    both(_prefix_cache_replays, kind)


def _cancel_queued(side, backend):
    rt = side.runtime(n_nodes=1, backend=backend, autostart=False)
    try:
        sess_a, sess_b = rt.session(), rt.session()

        def step(s):
            x = s.state.get("x")
            if x is None:
                x = s.state["x"] = s.array(side.payload(np.full(4, 2.0)),
                                           name="x")
            side.decay(x, 1.0)
            return x

        fut_a = sess_a.submit(step)
        fut_b = sess_b.submit(step)
        assert fut_b.cancel()
        rt.start()
        a = fut_a.result(timeout=60)
        expect(side, a, np.full(4, 2.0 * 0.99 + 1.0))
        with pytest.raises(concurrent.futures.CancelledError):
            fut_b.result(timeout=60)
        assert rt.metrics.requests_cancelled == 1
        assert rt.executor.stats.ops_executed == 1
        assert sess_b.poisoned is None
        b = sess_b.submit(step).result(timeout=60)
        expect(side, b, np.full(4, 2.0 * 0.99 + 1.0))
        return [a, b], counters(rt)
    finally:
        rt.close()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_cancel_queued_request_never_touches_executor(backend, kind):
    both(_cancel_queued, kind, backend)


def _timeout_on_queued(side, backend):
    rt = side.runtime(n_nodes=1, backend=backend, autostart=False)
    try:
        sess = rt.session()

        def step(s):
            x = s.array(side.payload(np.full(4, 3.0)), name="x")
            side.decay(x, 0.0)
            return x

        fut = sess.submit(step)
        with pytest.raises(concurrent.futures.TimeoutError):
            fut.result(timeout=0.05)
        rt.start()
        val = fut.result(timeout=60)
        expect(side, val, np.full(4, 3.0 * 0.99))
        assert rt.metrics.requests_completed == 1
        return [val], counters(rt)
    finally:
        rt.close()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_timeout_on_queued_request_leaves_request_intact(backend, kind):
    both(_timeout_on_queued, kind, backend)


def _bad_request(side, backend):
    rt = side.runtime(n_nodes=1, backend=backend, autostart=False)
    try:
        bad, good = rt.session(), rt.session()

        def bad_step(s):
            raise RuntimeError("malformed request")

        def good_step(s):
            x = s.array(side.payload(np.full(4, 5.0)), name="x")
            side.decay(x, 0.0)
            return x

        fut_bad = bad.submit(bad_step)
        fut_good = good.submit(good_step)
        rt.start()
        with pytest.raises(RuntimeError, match="malformed"):
            fut_bad.result(timeout=60)
        val = fut_good.result(timeout=60)
        expect(side, val, np.full(4, 5.0 * 0.99))
        assert bad.poisoned is not None
        with pytest.raises(side.serve.SessionPoisoned):
            bad.submit(bad_step)
        assert good.poisoned is None
        return [val], counters(rt)
    finally:
        rt.close()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_bad_request_poisons_only_its_session(backend, kind):
    both(_bad_request, kind, backend)


def _op_failure_mid_flush(side, backend):
    with side.runtime(n_nodes=1, backend=backend,
                      admission_window=0.0) as rt:
        doomed = rt.session()

        def bomb_step(s):
            x = s.array(side.payload(np.full(4, 1.0)), name="x")
            side.bomb(x, 0.0)
            return x

        fut = doomed.submit(bomb_step)
        with pytest.raises(ValueError, match="bomb"):
            fut.result(timeout=60)
        assert doomed.poisoned is not None
        assert rt.metrics.requests_failed == 1

        fresh = rt.session()

        def good_step(s):
            x = s.array(side.payload(np.full(4, 2.0)), name="x")
            side.decay(x, 1.0)
            return x

        val = fresh.submit(good_step).result(timeout=60)
        expect(side, val, np.full(4, 2.0 * 0.99 + 1.0))
        st = rt.executor.stats
        assert sum(st.wavefronts) == st.ops_executed
        return [val], counters(rt)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_op_failure_mid_flush_keeps_runtime_serving(backend, kind):
    both(_op_failure_mid_flush, kind, backend)


def _poison_pill(side, backend):
    n = 5
    rt = side.runtime(n_nodes=2, backend=backend, autostart=False)
    try:
        sessions = [rt.session() for _ in range(n)]

        def make_step(i):
            def step(s):
                s.state["x"] = s.array(side.payload(np.arange(6.0) + i),
                                       name="x", rank=i % 2)
                if i == 2:
                    side.bomb(s.state["x"], 0.0)
                else:
                    side.decay(s.state["x"], 0.5)
                return s.state["x"]
            return step

        futs = [sessions[i].submit(make_step(i)) for i in range(n)]
        rt.start()
        vals = []
        for i, f in enumerate(futs):
            if i == 2:
                with pytest.raises(ValueError, match="bomb"):
                    f.result(timeout=60)
            else:
                vals.append(f.result(timeout=60))
                expect(side, vals[-1], ref_decay(np.arange(6.0) + i, 0.5, 1))
        assert sessions[2].poisoned is not None
        assert all(sessions[i].poisoned is None for i in (0, 1, 3, 4))
        m = rt.metrics
        assert m.bisections == 1
        assert m.bisect_probes >= 2
        assert m.requests_salvaged == n - 1
        assert m.requests_completed == n - 1
        assert m.requests_failed == 1
        with pytest.raises(side.serve.SessionPoisoned):
            sessions[2].submit(make_step(2))
        assert rt.metrics.requests_rejected == 1

        def again(s):
            side.decay(s.state["x"], 0.5)
            return s.state["x"]

        vals.append(sessions[0].submit(again).result(timeout=60))
        expect(side, vals[-1], ref_decay(np.arange(6.0), 0.5, 2))
        st = rt.executor.stats
        assert sum(st.wavefronts) == st.ops_executed
        return vals, counters(rt)
    finally:
        rt.close()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_poison_pill_bisection_attribution(backend, kind):
    both(_poison_pill, kind, backend)


def _overload_shed(side, backend):
    rt = side.runtime(backend=backend, autostart=False, max_queue=3,
                      max_inflight=2)
    try:
        s1, s2 = rt.session(), rt.session()
        noop = lambda sess: None
        f1, f2 = s1.submit(noop), s1.submit(noop)
        with pytest.raises(side.serve.RuntimeOverloaded):
            s1.submit(noop)
        f3 = s2.submit(noop)
        with pytest.raises(side.serve.RuntimeOverloaded):
            s2.submit(noop)
        t0 = time.monotonic()
        with pytest.raises(side.serve.RuntimeOverloaded):
            s2.submit(noop, timeout=0.2)
        assert time.monotonic() - t0 >= 0.15
        m = rt.metrics
        assert m.requests_shed == 3
        assert m.queue_depth_hwm == 3
        rt.start()
        for f in (f1, f2, f3):
            assert f.result(timeout=60) is None
        s2.submit(noop, timeout=30).result(timeout=60)
        summary = rt.metrics.summary()
        for key in ("requests_rejected", "requests_shed", "queue_depth_hwm",
                    "bisections", "requests_salvaged", "compactions",
                    "trace_ops_hwm"):
            assert key in summary, f"summary missing {key}"
        assert s1.poisoned is None and s2.poisoned is None
        return [], counters(rt)
    finally:
        rt.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_overload_shed_and_blocking_submit(backend):
    both(_overload_shed, "numpy", backend)


def _close_unstarted(side, backend):
    rt = side.runtime(backend=backend, autostart=False)
    s = rt.session()
    futs = [s.submit(lambda sess: None) for _ in range(3)]
    rt.close()
    for f in futs:
        assert f.done()
        assert f.cancelled()
    assert rt.metrics.requests_cancelled == 3
    with pytest.raises(side.serve.RuntimeClosed):
        s.submit(lambda sess: None)
    return [], counters(rt)


@pytest.mark.parametrize("backend", BACKENDS)
def test_close_unstarted_runtime_resolves_queued_futures(backend):
    both(_close_unstarted, "numpy", backend)


def _close_drains(side, backend):
    rt = side.runtime(backend=backend, autostart=False)
    s = rt.session()

    def step(sess):
        if "x" not in sess.state:
            sess.state["x"] = sess.array(side.payload(np.full(4, 1.0)),
                                         name="x")
        side.decay(sess.state["x"], 0.5)
        return sess.state["x"]

    futs = [s.submit(step) for _ in range(3)]
    rt.start()
    rt.close()
    for f in futs:
        assert f.done()
    val = futs[-1].result(timeout=1)
    expect(side, val, ref_decay(np.full(4, 1.0), 0.5, 3))
    return [val], counters(rt)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_close_drains_admitted_requests(backend, kind):
    both(_close_drains, kind, backend)


def _dead_serving_loop(side, backend):
    rt = side.runtime(backend=backend, autostart=False)
    s = rt.session()
    fut = s.submit(lambda sess: None)

    def boom():
        raise RuntimeError("loop infrastructure failure")

    rt._next_batch = boom
    rt.start()
    with pytest.raises(side.serve.RuntimeClosed):
        fut.result(timeout=60)
    rt._thread.join(60)
    assert not rt._thread.is_alive()
    with pytest.raises(side.serve.RuntimeClosed) as exc_info:
        s.submit(lambda sess: None)
    assert isinstance(exc_info.value.__cause__, RuntimeError)
    assert "loop infrastructure" in str(exc_info.value.__cause__)
    rt.close()
    return [], counters(rt)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dead_serving_loop_surfaces_at_submit(backend):
    both(_dead_serving_loop, "numpy", backend)


def _steady_state(side, backend):
    warm, steps = 5, 30
    rt = side.runtime(n_nodes=1, backend=backend, admission_window=0.0,
                      compact_threshold=12)
    try:
        s = rt.session()

        def step(sess):
            if "x" not in sess.state:
                sess.state["x"] = sess.array(side.payload(np.full(8, 1.0)),
                                             name="x")
            side.decay(sess.state["x"], 0.5)
            return sess.state["x"]

        for _ in range(warm):
            s.submit(step).result(timeout=60)
        builds0 = side.program_stats["misses"]
        sizes = []
        for _ in range(steps):
            got = s.submit(step).result(timeout=60)
            expect(side, got[:1],
                   ref_decay(np.full(1, 1.0), 0.5, len(sizes) + warm + 1))
            sizes.append(len(rt._wf.ops))
        assert max(sizes) <= 12, f"trace grew to {max(sizes)} ops"
        m = rt.metrics
        assert m.compactions >= 2
        assert m.ops_compacted > 0
        assert m.trace_ops_hwm <= 12
        assert side.program_stats["misses"] - builds0 <= 2
        val = s.submit(lambda sess: sess.state["x"]).result(timeout=60)
        expect(side, val, ref_decay(np.full(8, 1.0), 0.5, warm + steps))
        return [val], {**counters(rt), "sizes": sizes}
    finally:
        rt.close()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_steady_state_trace_stays_bounded(backend, kind):
    both(_steady_state, kind, backend)


# --------------------------------------------------------------------------
# served kernel steps: gemm_tile and attn_step beside the decode step
# --------------------------------------------------------------------------

TILE, QROWS, KEYS, HEAD = 16, 8, 12, 16
SESSIONS, STEPS = 3, 3


def _kernel_inputs():
    rng = np.random.default_rng(18)
    shared = {"a": rng.normal(size=(TILE, TILE)),
              "b": rng.normal(size=(TILE, TILE)),
              "q": rng.normal(size=(QROWS, HEAD))}
    per = [{"c": rng.normal(size=(TILE, TILE)),
            "o": rng.normal(size=(QROWS, HEAD)),
            "x": rng.normal(size=(TILE, TILE)),
            "kv": [(rng.normal(size=(KEYS, HEAD)),
                    rng.normal(size=(KEYS, HEAD))) for _ in range(STEPS)]}
           for _ in range(SESSIONS)]
    return shared, per


def _kernel_steps(side, backend, max_batch):
    """``SESSIONS`` sessions, each one init request and ``STEPS`` step
    requests of ``gemm_tile`` on its C tile (A and B shared),
    ``attn_step`` on its carry (q shared, fresh k and v each step) and the
    decode step on its state; everything admitted before the runtime
    starts."""
    shared, per = _kernel_inputs()
    rt = side.runtime(n_nodes=1, backend=backend, max_batch=max_batch,
                      autostart=False)
    try:
        def init_for(i):
            def init(s):
                s.state["a"] = s.array(side.payload(shared["a"]), name="a")
                s.state["b"] = s.array(side.payload(shared["b"]), name="b")
                s.state["q"] = s.array(side.payload(shared["q"]), name="q")
                for name in ("c", "o", "x"):
                    s.state[name] = s.array(side.payload(per[i][name]),
                                            name=name)
            return init

        def step_for(i, t):
            k, v = (side.payload(x) for x in per[i]["kv"][t])

            def step(s):
                st = s.state
                wf = side.bind.current_workflow()
                wf.call(side.gemm_tile, (st["c"], st["a"], st["b"]),
                        name="gemm_tile")
                kk, vv = s.array(k, name="k"), s.array(v, name="v")
                wf.call(side.attn_step, (st["o"], st["q"], kk, vv),
                        name="attn_step")
                side.decay(st["x"], 0.5)
                return st["c"], st["o"], st["x"]
            return step

        sessions = [rt.session() for _ in range(SESSIONS)]
        futs = [[] for _ in range(SESSIONS)]
        for i, sess in enumerate(sessions):
            futs[i].append(sess.submit(init_for(i)))
        for t in range(STEPS):
            for i, sess in enumerate(sessions):
                futs[i].append(sess.submit(step_for(i, t)))
        rt.start()
        finals = [fs[-1].result(timeout=60) for fs in futs]
        for fs in futs:
            assert fs[0].result(timeout=60) is None
        m = rt.metrics
        assert m.requests_completed == SESSIONS * (1 + STEPS)
        if max_batch > 1:
            assert m.coalesced_requests > 0
        return [v for final in finals for v in final], counters(rt)
    finally:
        rt.close()


def _kernel_steps_oracle(i):
    """Session ``i``'s C, carry and state after ``STEPS`` steps, in float64."""
    shared, per = _kernel_inputs()
    c, o, x = per[i]["c"].copy(), per[i]["o"].copy(), per[i]["x"].copy()
    for k, v in per[i]["kv"]:
        c = c + shared["a"] @ shared["b"]
        s = shared["q"] @ k.T / np.sqrt(HEAD)
        p = np.exp(s - s.max(-1, keepdims=True))
        o = o + (p / p.sum(-1, keepdims=True)) @ v
        x = x * 0.99 + 0.5
    return c, o, x


@pytest.mark.parametrize("max_batch", [1, 8])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_served_gemm_and_attention_steps(backend, kind, max_batch):
    """C and the decode state are the same NumPy arithmetic on NumPy
    payloads (bitwise); the attention carry differs by the softmax's
    implementation (float32 on both sides, jax's ``softmax`` against the
    port's, attention's tolerance).  Float32 payloads: the GEMM and
    attention tolerances."""
    exp = _kernel_steps(Side("ref", kind), backend, max_batch)
    got = _kernel_steps(Side("port", kind), backend, max_batch)
    if kind == "numpy":
        tols = [None, ATTN_TOL, None] * SESSIONS
    else:
        tols = [GEMM_TOL, ATTN_TOL, DECAY_TOL] * SESSIONS
    compare(got, exp, kind, tols)
    for i in range(SESSIONS):
        for j, want in enumerate(_kernel_steps_oracle(i)):
            np.testing.assert_allclose(host(got[0][3 * i + j]), want,
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_procs_backend_names_its_slice(kind):
    """The serving runtime on ``backend="procs"`` (Slice 4 landed): the
    served ``gemm_tile`` / ``attn_step`` / decode steps run in the pool's
    worker processes and give the reference ``serial`` runtime's values
    (NumPy bit for bit but the softmax; CPU tensors within the float32
    tolerances) and the same serving counters.  The decode step's body is
    ``tests/_torch_conformance_ops.py``'s, which a worker can import."""
    exp = _kernel_steps(Side("ref", kind), "serial", 8)
    side = Side("port", kind)
    side.decay = procs_ops.decay
    got = _kernel_steps(side, "procs", 8)
    if kind == "numpy":
        tols = [None, ATTN_TOL, None] * SESSIONS
    else:
        tols = [GEMM_TOL, ATTN_TOL, DECAY_TOL] * SESSIONS
    compare(got, exp, kind, tols)


def _failed_batch_lifetime(side):
    """Whether a runtime that served a failing batch outlives ``close()``
    and its last reference, and goes at the next cyclic collection."""
    rt = side.runtime(n_nodes=1, backend="serial", autostart=False)
    sessions = [rt.session() for _ in range(2)]

    def step_for(bad):
        def step(s):
            x = s.array(side.payload(np.full(4, 1.0)), name="x")
            (side.bomb if bad else side.decay)(x, 0.5)
            return x
        return step

    futs = [sessions[0].submit(step_for(False)),
            sessions[1].submit(step_for(True))]
    rt.start()
    futs[0].result(timeout=60)
    with pytest.raises(ValueError, match="bomb"):
        futs[1].result(timeout=60)
    rt.close()
    rt._thread.join(60)
    alive = weakref.ref(rt)
    del rt, sessions, futs
    kept = alive() is not None
    gc.collect()
    return kept, alive() is None


def test_failed_batch_is_freed_at_the_next_cyclic_collection():
    """The reference's quirk, reproduced: the poisoned request's exception
    holds, through its traceback's frames, the batch whose futures hold the
    exception, so the runtime (and on the card its device memory) goes at
    the next ``gc.collect()``, not with its last reference."""
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        for pkg in ("ref", "port"):
            assert _failed_batch_lifetime(Side(pkg, "numpy")) == (True, True)
    finally:
        if was_enabled:
            gc.enable()
