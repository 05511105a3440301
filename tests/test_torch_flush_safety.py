"""The port's flush failure contract, trace compaction and executor lock.

Ports the cases of ``tests/test_flush_safety.py`` that touch this slice's
modules (the ``serial`` backend and the interpreter): a mid-program op
exception re-raises from ``flush()`` with the executor usable — accounting
rolled back, the failed program's writes discarded, pinned heads from
before it still fetchable — ``flush_slice`` re-drives sub-ranges,
``compact`` truncates the executed trace without losing values or plan
reuse, and concurrent ``value``/``stats`` readers serialise on the lock.

Every case runs with NumPy payloads (as the reference's do) and with CPU
tensors, the port's own payload type.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch import core as bind
from repro_torch.compat import to_numpy
from repro_torch.core import LocalExecutor
from repro_torch.core.program import PROGRAM_CACHE_STATS


@bind.op
def scale(c: bind.InOut, s: bind.In):
    return c * s


@bind.op
def shift(c: bind.InOut, s: bind.In):
    return c + s


@bind.op
def decay(c: bind.InOut, s: bind.In):
    return c * 0.99 + s


@bind.op
def bomb(c: bind.InOut, s: bind.In):
    raise ValueError("bomb: injected op failure")


def ref_decay(x, s, n):
    x = np.asarray(x, dtype=np.float64).copy()
    for _ in range(n):
        x = x * 0.99 + s
    return x


PAYLOADS = {
    "numpy": lambda a: np.asarray(a, dtype=np.float64),
    "tensor": lambda a: torch.tensor(np.asarray(a), dtype=torch.float64),
}


@pytest.fixture(params=sorted(PAYLOADS))
def mk(request):
    return PAYLOADS[request.param]


def val(ex, version):
    return to_numpy(ex.value(version))


def _recorded(wf, build):
    """Record ``build(wf)`` as one program segment (no flush)."""
    with wf.recording():
        out = build(wf)
    wf.sync()
    return out


def test_flush_failure_leaves_executor_usable(mk):
    ex = LocalExecutor(2, mode="plan", backend="serial")
    wf = bind.Workflow(n_nodes=2, executor=ex)

    def seed(wf):
        keep = wf.array(mk(np.full(8, 2.0)), name="keep", rank=0)
        scale(keep, 3.0)
        vict = wf.array(mk(np.full(8, 1.0)), name="vict", rank=1)
        return keep, vict

    keep, vict = _recorded(wf, seed)
    keep_head = keep.ref.head
    np.testing.assert_allclose(val(ex, keep_head), 6.0)
    ops_before = ex.stats.ops_executed

    def blast(wf):
        scale(vict, 2.0)
        bomb(vict, 0.0)
        scale(vict, 5.0)

    _recorded(wf, blast)
    with pytest.raises(ValueError):
        ex.flush()

    st = ex.stats
    assert st.ops_executed == ops_before
    assert sum(st.wavefronts) == st.ops_executed
    assert ex._live_entries == sum(len(s) for s in ex._stores.values())
    assert ex._live_bytes == sum(ex._key_bytes.get(k, 0) for k in ex._where)
    with pytest.raises(KeyError):
        ex.value(vict.ref.head)
    np.testing.assert_allclose(val(ex, keep_head), 6.0)

    def cont(wf):
        c = wf.array(mk(np.full(4, 4.0)), name="cont", rank=0)
        scale(c, 2.5)
        return c

    c = _recorded(wf, cont)
    np.testing.assert_allclose(val(ex, c.ref.head), 10.0)
    np.testing.assert_allclose(val(ex, keep_head), 6.0)

    # a brand-new Workflow on the same executor: version-id streams
    # restart, so run() must reset the stores instead of colliding
    wf2 = bind.Workflow(n_nodes=2, executor=ex)

    def fresh(wf):
        x = wf.array(mk(np.arange(8.0)), name="x", rank=1)
        scale(x, 2.0)
        shift(x, 1.0)
        return x

    x = _recorded(wf2, fresh)
    np.testing.assert_allclose(val(ex, x.ref.head), np.arange(8.0) * 2.0 + 1.0)
    st = ex.stats
    assert sum(st.wavefronts) == st.ops_executed


def test_flush_failure_interpret_mode(mk):
    ex = LocalExecutor(2, mode="interpret")
    wf = bind.Workflow(n_nodes=2, executor=ex)

    a = _recorded(wf, lambda wf: wf.array(mk(np.ones(4)), rank=0))
    _recorded(wf, lambda wf: scale(a, 4.0))
    a_head = a.ref.head
    np.testing.assert_allclose(val(ex, a_head), 4.0)
    ops_before = ex.stats.ops_executed

    _recorded(wf, lambda wf: bomb(a, 0.0))
    with pytest.raises(ValueError):
        ex.flush()
    st = ex.stats
    assert st.ops_executed == ops_before
    assert sum(st.wavefronts) == st.ops_executed
    with pytest.raises(KeyError):
        ex.value(a.ref.head)
    np.testing.assert_allclose(val(ex, a_head), 4.0)


def test_failed_flush_does_not_leak_round_ids(mk):
    ex = LocalExecutor(2, mode="plan", backend="serial")
    wf = bind.Workflow(n_nodes=2, executor=ex)

    def seed(wf):
        return (wf.array(mk(np.ones(4)), rank=0),
                wf.array(mk(np.ones(4)), rank=1))

    a, b = _recorded(wf, seed)
    ex.flush()
    rounds_before = ex._round_counter

    def blast(wf):
        with bind.node(1):
            scale(a, 2.0)       # cross-rank read: a ship before the bomb
        bomb(a, 0.0)

    _recorded(wf, blast)
    n_tr = len(ex._stats.transfers)
    with pytest.raises(ValueError):
        ex.flush()
    assert ex._round_counter == rounds_before
    assert len(ex._stats.transfers) == n_tr

    _recorded(wf, lambda wf: scale(b, 3.0))
    ex.flush()
    np.testing.assert_allclose(val(ex, b.ref.head), 3.0)


def test_flush_slice_redrives_innocent_range(mk):
    ex = LocalExecutor(2, mode="plan", backend="serial")
    wf = bind.Workflow(n_nodes=2, executor=ex)

    def seed(wf):
        return (wf.array(mk(np.ones(4)), name="a", rank=0),
                wf.array(mk(np.full(4, 2.0)), name="b", rank=1))

    a, b = _recorded(wf, seed)
    ex.flush()

    s1 = len(wf.ops)
    _recorded(wf, lambda wf: scale(a, 3.0))
    s2 = len(wf.ops)
    _recorded(wf, lambda wf: bomb(b, 0.0))
    s3 = len(wf.ops)

    with pytest.raises(ValueError):
        ex.flush(protect_inputs=True)

    ex.flush_slice(wf, s1, s2)
    np.testing.assert_array_equal(val(ex, a.ref.head), np.full(4, 3.0))
    with pytest.raises(ValueError):
        ex.flush_slice(wf, s2, s3)
    with pytest.raises(KeyError):
        ex.value(b.ref.head)

    _recorded(wf, lambda wf: scale(a, 2.0))
    ex.flush()
    np.testing.assert_array_equal(val(ex, a.ref.head), np.full(4, 6.0))
    st = ex.stats
    assert sum(st.wavefronts) == st.ops_executed
    assert ex._live_entries == sum(len(s) for s in ex._stores.values())


def test_flush_slice_attributes_dependent_failed_range(mk):
    ex = LocalExecutor(1, mode="plan", backend="serial")
    wf = bind.Workflow(n_nodes=1, executor=ex)
    a = _recorded(wf, lambda wf: wf.array(mk(np.ones(4)), name="a"))
    ex.flush()

    s1 = len(wf.ops)
    _recorded(wf, lambda wf: bomb(a, 0.0))
    s2 = len(wf.ops)
    _recorded(wf, lambda wf: scale(a, 2.0))   # reads the bomb's output
    s3 = len(wf.ops)
    with pytest.raises(ValueError):
        ex.flush(protect_inputs=True)
    with pytest.raises(ValueError):
        ex.flush_slice(wf, s1, s2)
    # the dependent range cannot be salvaged: its input was never written
    with pytest.raises(AssertionError):
        ex.flush_slice(wf, s2, s3)


def test_trace_compaction_roundtrip(mk):
    ex = LocalExecutor(1, mode="plan", backend="serial", prefix_cache=True)
    wf = bind.Workflow(n_nodes=1, executor=ex)
    x = _recorded(wf, lambda wf: wf.array(mk(np.ones(8)), name="x"))
    ex.flush()

    def step():
        _recorded(wf, lambda wf: decay(x, 0.5))
        ex.flush()

    for _ in range(5):
        step()
    assert len(wf.ops) == 5
    builds0 = PROGRAM_CACHE_STATS["misses"]
    assert ex.compact(wf) == 5
    assert len(wf.ops) == 0
    assert len(x.ref.versions) == 1          # history truncated to the head
    assert x.ref.head.index == 5             # ...but indices never rewind

    for _ in range(5):
        step()
    # every post-compaction step replayed a cached plan
    assert PROGRAM_CACHE_STATS["misses"] == builds0
    np.testing.assert_array_equal(val(ex, x.ref.head),
                                  ref_decay(np.ones(8), 0.5, 10))
    assert ex.compact(wf) == 5
    step()
    np.testing.assert_array_equal(val(ex, x.ref.head),
                                  ref_decay(np.ones(8), 0.5, 11))
    st = ex.stats
    assert sum(st.wavefronts) == st.ops_executed


def test_compact_after_aborted_flush_keeps_executor_usable(mk):
    ex = LocalExecutor(1, mode="plan", backend="serial")
    wf = bind.Workflow(n_nodes=1, executor=ex)

    def seed(wf):
        keep = wf.array(mk(np.full(4, 2.0)), name="keep")
        scale(keep, 3.0)
        return keep

    keep = _recorded(wf, seed)
    ex.flush()
    keep_head = keep.ref.head

    _recorded(wf, lambda wf: bomb(keep, 0.0))
    with pytest.raises(ValueError):
        ex.flush(protect_inputs=True)

    assert ex.compact(wf) == 2 and len(wf.ops) == 0
    np.testing.assert_array_equal(val(ex, keep_head), np.full(4, 6.0))

    def cont(wf):
        c = wf.array(mk(np.full(4, 4.0)), name="cont")
        scale(c, 2.5)
        return c

    c = _recorded(wf, cont)
    ex.flush()
    np.testing.assert_array_equal(val(ex, c.ref.head), np.full(4, 10.0))


def test_compacted_version_lookup(mk):
    ex = LocalExecutor(1, mode="plan", backend="serial")
    wf = bind.Workflow(n_nodes=1, executor=ex)
    x = _recorded(wf, lambda wf: wf.array(mk(np.ones(2)), name="x"))
    for _ in range(3):
        _recorded(wf, lambda wf: scale(x, 2.0))
    ex.flush()
    assert x.ref.version(2).index == 2
    ex.compact(wf)
    assert x.ref.version(3) is x.ref.head
    with pytest.raises(IndexError):
        x.ref.version(1)


def test_concurrent_fetch_and_stats_during_streaming(mk):
    ex = LocalExecutor(1, mode="plan", backend="serial", stitch=True)
    wf = bind.Workflow(n_nodes=1, executor=ex)

    def seed(wf):
        return (wf.array(mk(np.full(16, 1.0)), name="x"),
                wf.array(mk(np.full(4, 7.0)), name="probe"))

    x, probe = _recorded(wf, seed)
    ex.flush()
    probe_head = probe.ref.head

    stop = threading.Event()
    errors: list = []

    def reader():
        try:
            while not stop.is_set():
                assert val(ex, probe_head)[0] == 7.0
                assert ex.stats.ops_executed >= 0
        except BaseException as e:   # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    n = 200
    try:
        for _ in range(n):
            with wf.recording():
                scale(x, 1.01)
            wf.sync()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    np.testing.assert_allclose(val(ex, x.ref.head), np.full(16, 1.01 ** n),
                               rtol=1e-9)
    st = ex.stats
    assert st.ops_executed == n
    assert sum(st.wavefronts) == st.ops_executed
