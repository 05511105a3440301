"""The port's process-pool backend and its shared-memory arenas against the
reference.

The cases of ``tests/test_procs_backend.py`` run through both packages:
the reference's ``serial`` backend on NumPy payloads is the yardstick, and
the port's ``procs`` backend must give the same values bit for bit, the
same transfer-event stream and the same ``ExecutionStats``; CPU-tensor
payloads (the reference's jax arrays) come back as tensors, bit for bit the
port's ``serial``.  Then what is the port's own: the ``KIND_TORCH``
encoding (dtype, bfloat16 bits, shape and device in the header; a CPU
tensor a zero-copy view, a CUDA tensor never silently on the CPU), tensor
seeds and constants that never cross the control pipe (the sender's
storage stays where it was), and workers that hold no ``jax`` and no
``repro``.

The port's workers import their op bodies from ``tests/_torch_conformance_ops.py``
(jax-free, module level); the pools are the backend's shared ones, so a
pool of a world size is spawned once per test process.
"""

import itertools
import os
import pickle
import time

import numpy as np
import pytest
import torch

from _torch_conformance_ops import (chains, hang_step, step, worker_facts)
from repro import core as ref_bind
from repro_torch import core as port_bind
from repro_torch.core import shm_store
from repro_torch.core.backends import procs as procs_mod
from repro_torch.runtime.supervisor import heartbeat_age


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
                _ref_step(a, 1.5)
        if lv in mix_at:
            for r, a in enumerate(arrs):
                with ref_bind.node(r):
                    _ref_mix(a, arrs[(r + 1) % n])


def _port_chains(depth, mix_at=(), body=step):
    return lambda wf, arrs: chains(wf, arrs, depth, mix_at, body, const=1.5)


def _run(bind, build, n_nodes, backend="serial", injector=None,
         seeds=None):
    ex = bind.LocalExecutor(n_nodes, mode="plan", backend=backend,
                            fault_injector=injector)
    with bind.Workflow(n_nodes=n_nodes, executor=ex) as wf:
        if seeds is None:
            seeds = [np.arange(8.0) + r for r in range(n_nodes)]
        arrs = [wf.array(a, rank=r) for r, a in enumerate(seeds)]
        build(wf, arrs)
        wf.sync()
        vals = [wf.fetch(a) for a in arrs]
    return vals, ex.stats, ex


def _ref_run(build, n_nodes, seeds=None):
    return _run(ref_bind, build, n_nodes, seeds=seeds)


def _events(stats):
    return [(t.version_key, t.src, t.dst, t.nbytes, t.round_id, t.collective,
             t.wavefront) for t in stats.transfers]


def _same_stats(got, want):
    assert _events(got) == _events(want)
    for name in ("ops_executed", "copies_elided", "wavefronts",
                 "wavefront_flops", "bytes_transferred", "message_count",
                 "peak_live_bytes", "peak_live_payloads"):
        assert getattr(got, name) == getattr(want, name), name


# ---------------------------------------------------------------------------
# parity: values, transfer stream, stats
# ---------------------------------------------------------------------------

def test_procs_matches_serial_with_ships_and_gc():
    n = 3
    ref, ref_st, _ = _ref_run(lambda wf, a: _ref_chains(wf, a, 6, (1, 4)), n)
    vals, st, ex = _run(port_bind, _port_chains(6, (1, 4)), n, "procs")
    for a, b in zip(ref, vals):
        assert type(b) is np.ndarray
        np.testing.assert_array_equal(b, a)
        assert a.dtype == b.dtype
    _same_stats(st, ref_st)
    assert st.control_messages > 0 and ref_st.control_messages == 0
    assert ex.backend.plans_run == 1 and ex.backend.fallbacks == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_procs_tensor_payload_roundtrip(dtype):
    """CPU tensors (the reference's jax arrays) come back as tensors of
    their dtype, bit for bit the port's ``serial`` run, within the float32
    tolerance of the reference's jax run."""
    import jax.numpy as jnp

    n = 2
    build = _port_chains(4, (2,))
    seeds = [torch.arange(16.0, dtype=dtype) + r for r in range(n)]
    want, want_st, _ = _run(port_bind, build, n, seeds=seeds)
    got, st, ex = _run(port_bind, build, n, "procs", seeds=seeds)
    for a, b in zip(want, got):
        assert isinstance(b, torch.Tensor) and b.dtype == dtype
        assert b.device.type == "cpu"
        assert torch.equal(a, b)
    _same_stats(st, want_st)
    assert ex.backend.fallbacks == 0
    if dtype == torch.float32:
        ref, _, _ = _ref_run(lambda wf, a: _ref_chains(wf, a, 4, (2,)), n,
                             [jnp.arange(16.0) + r for r in range(n)])
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_fetch_is_zero_copy_shm_view():
    """A fetched NumPy payload is a read-only view of the worker's segment
    and a CPU tensor a view of it too (``fetch_bytes_copied`` stays 0; the
    reference's jax payload pays one host-to-device copy, a CPU tensor has
    no device to copy to)."""
    n = 2
    ex = port_bind.LocalExecutor(n, mode="plan", backend="procs")
    with port_bind.Workflow(n_nodes=n, executor=ex) as wf:
        a = wf.array(np.arange(64.0).reshape(8, 8), rank=0)
        with port_bind.node(0):
            step(a, 1.5)
        wf.sync()
    ex.flush()
    st = ex.stats
    v = ex.value(a.ref.head)
    assert isinstance(v, np.ndarray) and not v.flags.writeable
    assert st.fetch_bytes_copied == 0
    np.testing.assert_array_equal(
        v, np.arange(64.0).reshape(8, 8) * 1.01 + 1.5)
    assert ex.value(a.ref.head) is v        # written back: attached once

    with port_bind.Workflow(n_nodes=n, executor=ex) as wf2:
        c = wf2.array(torch.arange(16.0), rank=1)
        with port_bind.node(1):
            step(c, 0.5)
        wf2.sync()
    ex.flush()
    vc = ex.value(c.ref.head)
    assert isinstance(vc, torch.Tensor) and vc.device.type == "cpu"
    assert st.fetch_bytes_copied == 0
    assert torch.equal(vc, torch.arange(16.0) * 1.01 + 0.5)


# ---------------------------------------------------------------------------
# steady-state protocol: warm loop iterations cost one message per worker
# ---------------------------------------------------------------------------

def test_steady_state_iterations_send_one_message_per_worker():
    n = 2
    ex = port_bind.LocalExecutor(n, mode="plan", backend="procs")
    marks = []
    with port_bind.Workflow(n_nodes=n, executor=ex) as wf:
        arrs = [wf.array(np.arange(8.0) + r, rank=r) for r in range(n)]
        for _ in range(5):
            chains(wf, arrs, 2, (1,), const=1.5)
            wf.sync()
            ex.flush()
            marks.append(ex.stats.control_messages)
        vals = [np.asarray(wf.fetch(a)) for a in arrs]
    deltas = [b - a for a, b in zip(marks, marks[1:])]
    assert deltas[-1] == n and deltas[-2] == n, (marks, deltas)
    assert marks[0] > n
    ref, _, _ = _ref_run(lambda wf, a: [_ref_chains(wf, a, 2, (1,))
                                        for _ in range(5)], n)
    for a, b in zip(ref, vals):
        np.testing.assert_array_equal(b, a)


def _listing1_iterations(backend, iters=3):
    """Listing 1 run ``iters`` times in one workflow on the same A and B
    tiles, each time into fresh C tiles: C of each iteration, the stats,
    the control messages after each and the executor."""
    from repro_torch.linalg import Tiled
    from repro_torch.linalg.distributed import (distributed_gemm_listing1,
                                                make_distributed_inputs)

    g = torch.Generator().manual_seed(3)
    A, B = torch.randn(16, 16, generator=g), torch.randn(16, 16, generator=g)
    ex = port_bind.LocalExecutor(4, backend=backend)
    outs, marks = [], []
    with port_bind.Workflow(n_nodes=4, executor=ex) as wf:
        a, b, c = make_distributed_inputs(wf, A, B, ib=4, NP=2, NQ=2)
        for _ in range(iters):
            distributed_gemm_listing1(wf, a, b, c, 2, 2)
            outs.append(c.to_array())
            marks.append(ex.stats.control_messages)
            c = Tiled.zeros(wf, 4, 4, 4, torch.float32, "C",
                            rank_of=lambda i, k: (i % 2) * 2 + k % 2)
    return outs, ex.stats, marks, ex


def test_loop_with_fresh_outputs_sends_one_message_per_worker():
    """Iterations that bind the plan to fresh refs (new C tiles, new
    partial products) still replay the shipped slices: once the A and B
    replicas settle (iteration 2), iteration 3 sends one "run" a worker —
    the translation table maps the template's refs onto the new ones (the
    reference's ``key_delta`` keeps refs fixed and would re-ship)."""
    want, want_st, _, _ = _listing1_iterations("serial")
    got, st, marks, ex = _listing1_iterations("procs")
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    _same_stats(st, want_st)
    assert ex.backend.plans_run == 3 and ex.backend.fallbacks == 0
    assert marks[2] - marks[1] == 4, marks


# ---------------------------------------------------------------------------
# failure mechanics: respawn after SIGKILL, heartbeats, hang detection
# ---------------------------------------------------------------------------

def test_sigkill_respawns_worker_and_recovers():
    n = 2
    ref, ref_st, _ = _ref_run(lambda wf, a: _ref_chains(wf, a, 5, (2,)), n)
    build = _port_chains(5, (2,))
    _run(port_bind, build, n, "procs")        # warm the shared 2-rank pool
    pool = procs_mod._POOLS[n]
    pid_before = pool.procs[1].pid
    for r in pool.alive_ranks():
        assert heartbeat_age(pool.hb_path(r), pool.spawned_at[r]) < 60.0
    inj = port_bind.FaultInjector.kill_rank(1, 2)
    vals, st, ex = _run(port_bind, build, n, "procs", inj)
    for a, b in zip(ref, vals):
        np.testing.assert_array_equal(b, a)
    assert st.recoveries == 1
    assert 0 < st.recomputed_ops < ref_st.ops_executed
    assert inj.fired and inj.fired[0]["kind"] == "kill"
    assert pool.procs[1].pid != pid_before    # transient death => respawn
    assert pool.alive[1]
    assert ex.backend.fallbacks == 0


def test_hung_worker_heartbeat_timeout_is_permanent():
    # rank 1's worker wedges inside an op body (alive, no heartbeat): the
    # frontend must detect the stale heartbeat, kill it and decommission
    # the rank permanently (elastic rebind)
    n = 3
    ref, _, _ = _ref_run(lambda wf, a: _ref_chains(wf, a, 3), n)
    backend = port_bind.ProcessPoolBackend(heartbeat_timeout=1.0,
                                           heartbeat_interval=0.1)
    vals, st, ex = _run(port_bind, _port_chains(3, body=hang_step), n,
                        backend)
    for a, b in zip(ref, vals):
        np.testing.assert_array_equal(b, a)
    assert st.recoveries == 1
    assert 1 in ex._decommissioned
    assert not ex._stores[1]
    assert all(1 not in ranks for ranks in ex._where.values())


# ---------------------------------------------------------------------------
# graceful degradation: unpicklable op functions fall back to serial
# ---------------------------------------------------------------------------

def test_unpicklable_fn_falls_back_to_serial():
    @port_bind.op
    def local_step(c: port_bind.InOut, s: port_bind.In):  # a closure
        return c * 2.0 + s

    @ref_bind.op
    def ref_local_step(c: ref_bind.InOut, s: ref_bind.In):
        return c * 2.0 + s

    def build(bind, fn):
        def _b(wf, arrs):
            for _ in range(3):
                for r, a in enumerate(arrs):
                    with bind.node(r):
                        fn(a, 1.0)
        return _b

    ref, ref_st, _ = _ref_run(build(ref_bind, ref_local_step), 2)
    vals, st, ex = _run(port_bind, build(port_bind, local_step), 2, "procs")
    for a, b in zip(ref, vals):
        np.testing.assert_array_equal(b, a)
    _same_stats(st, ref_st)
    assert st.recoveries == 0
    assert ex.backend.fallbacks == 1 and ex.backend.plans_run == 0


# ---------------------------------------------------------------------------
# the port's own: the tensor encoding, the pipe, the workers' imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64, torch.int32,
                                   torch.bool])
def test_torch_encoding_round_trips_bit_for_bit(dtype):
    t = (torch.randn(3, 5, generator=torch.Generator().manual_seed(0)) * 7
         ).to(dtype)
    name = shm_store.segment_name(f"{os.getpid():x}-enc", (1, 2), 0)
    nb = shm_store.write_segment(name, t)
    try:
        assert nb == t.numel() * t.element_size()
        assert shm_store.peek_nbytes(name) == nb
        kind, back = shm_store.read_segment(name)
        assert kind == shm_store.KIND_TORCH
        assert back.dtype == dtype and back.shape == t.shape
        assert back.device.type == "cpu"
        if dtype == torch.bfloat16:     # the bits, not a rounded copy
            assert torch.equal(back.view(torch.int16), t.view(torch.int16))
        assert torch.equal(back, t)
        view, copied = shm_store.ShmRef((1, 2), 0, nb, f"{os.getpid():x}-enc"
                                        ).view()
        assert copied == 0 and torch.equal(view, t)
    finally:
        shm_store.unlink_segment(name)


def test_numpy_stays_numpy_and_is_never_promoted():
    for arr in (np.arange(6.0).reshape(2, 3), np.arange(4, dtype=np.int64),
                np.array(3.5)):
        name = shm_store.segment_name(f"{os.getpid():x}-np", (3, 4), 1)
        shm_store.write_segment(name, arr)
        try:
            kind, back = shm_store.read_segment(name)
            assert kind == shm_store.KIND_NUMPY and type(back) is np.ndarray
            assert back.dtype == arr.dtype and np.array_equal(back, arr)
        finally:
            shm_store.unlink_segment(name)


def test_cuda_payload_never_comes_back_on_the_cpu(monkeypatch):
    """A segment that holds a CUDA tensor, read in a process without CUDA,
    raises: it is never handed out as a CPU tensor."""
    t = torch.arange(4.0)
    name = shm_store.segment_name(f"{os.getpid():x}-cuda", (5, 6), 0)
    shm_store.write_segment(name, t)
    try:
        seg = shm_store._attach(name)
        try:
            seg.buf[2] = shm_store._DEVICE_TYPES.index("cuda")   # device type
        finally:
            shm_store._close_quiet(seg)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            shm_store.read_segment(name)
    finally:
        shm_store.unlink_segment(name)


def test_tensor_seeds_and_constants_leave_the_senders_storage():
    """A tensor seed reaches its worker through the arena and a tensor
    constant packed: torch's multiprocessing reducers never see them, so
    neither tensor is moved into shared memory under the sender."""
    n = 2
    seeds = [torch.arange(8.0) + r for r in range(n)]
    const = torch.tensor(1.5)
    ptrs = [t.data_ptr() for t in seeds] + [const.data_ptr()]

    def build(wf, arrs):
        for _ in range(3):
            for r, a in enumerate(arrs):
                with port_bind.node(r):
                    step(a, const)

    want, _, _ = _run(port_bind, build, n, seeds=seeds)
    got, _, ex = _run(port_bind, build, n, "procs", seeds=seeds)
    assert ex.backend.plans_run == 1 and ex.backend.fallbacks == 0
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    for t, p in zip(seeds + [const], ptrs):
        assert not t.is_shared() and t.data_ptr() == p
    packed = pickle.loads(pickle.dumps(shm_store.pack(const)))
    assert type(packed) is shm_store.Packed
    assert torch.equal(shm_store.unpack(packed), const)


def test_workers_hold_no_jax_and_no_reference():
    n = 3
    ex = port_bind.LocalExecutor(n, mode="plan", backend="procs")
    with port_bind.Workflow(n_nodes=n, executor=ex) as wf:
        arrs = [wf.array(np.zeros(2), rank=r) for r in range(n)]
        facts = []
        for r, a in enumerate(arrs):
            with port_bind.node(r):
                facts.append(wf.apply(worker_facts, (a,), name="facts"))
        got = [wf.fetch(f) for f in facts]
    assert ex.backend.plans_run == 1 and ex.backend.fallbacks == 0
    assert [g["rank"] for g in got] == list(range(n))
    assert len({g["pid"] for g in got} | {os.getpid()}) == n + 1
    assert all(g["loaded"] == [] for g in got), got


def test_shutdown_leaves_no_segment():
    n = 2
    _run(port_bind, _port_chains(3, (1,)), n, "procs")
    pool = procs_mod._POOLS[n]
    session = pool.session
    procs_mod.shutdown_pools()
    assert not procs_mod._POOLS
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        left = [f for f in os.listdir("/dev/shm")
                if f.startswith(f"{shm_store.SEGMENT_PREFIX}{session}-")]
        if not left:
            break
        time.sleep(0.05)
    assert left == []
    assert all(p is None for p in pool.procs)


def test_port_and_reference_segments_never_share_a_name(monkeypatch):
    """A reference pool and a port pool whose sessions are the same
    ``pid-seq`` string, both alive in one process (as when one test worker
    runs ``tests/test_procs_backend.py`` and then this file): no segment
    name of either package starts with the port's prefix for that session
    but the port's own, and the port's ``shutdown_pools()`` leaves none of
    its segments and unlinks none of the reference's."""
    from multiprocessing import shared_memory

    from repro.core import shm_store as ref_shm
    from repro.core.backends import procs as ref_procs

    def ref_shutdown():
        pool = ref_procs._POOLS.pop(n, None)
        if pool is not None:
            pool.shutdown()

    n = 2
    procs_mod.shutdown_pools()
    ref_shutdown()
    seq = 7919
    monkeypatch.setattr(ref_procs, "_OWNER_SEQ", itertools.count(seq))
    monkeypatch.setattr(procs_mod, "_OWNER_SEQ", itertools.count(seq))
    ref_vals, _, _ = _run(ref_bind,
                          lambda wf, a: _ref_chains(wf, a, 3, (1,)), n,
                          "procs")
    ref_session = ref_procs._POOLS[n].session
    # a segment the live reference pool could hold under its session
    ref_name = ref_shm.segment_name(ref_session, (1, 0), 0)
    held = shared_memory.SharedMemory(name=ref_name, create=True, size=64)
    try:
        vals, _, _ = _run(port_bind, _port_chains(3, (1,)), n, "procs")
        for a, b in zip(ref_vals, vals):
            np.testing.assert_array_equal(b, a)
        pool = procs_mod._POOLS[n]
        assert pool.session == ref_session
        port_prefix = f"{shm_store.SEGMENT_PREFIX}{pool.session}-"
        assert not ref_name.startswith(port_prefix)
        assert shm_store.segment_name(pool.session, (1, 0), 0) != ref_name
        procs_mod.shutdown_pools()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            left = [f for f in os.listdir("/dev/shm")
                    if f.startswith(port_prefix)]
            if not left:
                break
            time.sleep(0.05)
        assert left == []
        assert ref_name in os.listdir("/dev/shm")
    finally:
        held.close()
        held.unlink()
        ref_shutdown()
