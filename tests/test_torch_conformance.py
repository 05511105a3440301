"""Differential conformance of the port's executor against the reference.

The port's ``serial`` backend and ``interpret`` mode replay the seeded
random workflows of ``tests/test_conformance.py`` (its generator and its 50
pinned seeds) and are held against the reference ``serial`` backend on the
same workflow; so are the port's ``threads``, ``fused`` and
``MeshBackend(pallas=True)`` (chains of the tagged kernel bodies through
the chain kernels' plain route on the CPU), which may only report higher
live-set peaks.  Each seed runs in two payload families:

* ``numpy`` — every array a NumPy payload (the generator's jax payloads
  become NumPy float32 / int32 arrays).  Both packages run the same NumPy
  op bodies, so values and dtypes must be identical;
* ``tensor`` — every array a float32 tensor: ``jax.Array`` in the
  reference, a CPU ``torch.Tensor`` in the port.  XLA and PyTorch round at
  different places (XLA fuses ``y + x*s`` into one FMA; eager PyTorch
  rounds twice), so values agree within a float32 tolerance, dtypes map
  one to one.

In both families the executors' observable accounting must match: the
transfer-event stream (byte-identical for plan replay; as a multiset of
hops for the trace-order interpreter), ``ops_executed``,
``copies_elided``, ``wavefronts``, ``wavefront_flops``, message and byte
totals, and the live-set peaks.  Executable-cache counters are excluded:
the reference jit-compiles jax payloads, the port runs every body eagerly.

The op pool is built once per package by :func:`make_pool`, so each body
carries its own package's intents; the kernel-tagged bodies ``scan_step``
and ``gemm_tile`` are each package's own.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_conformance import N_WORKFLOWS, make_spec

from repro import core as ref_bind
from repro.kernels.gemm.ops import gemm_tile as ref_gemm_tile
from repro.kernels.linear_scan.ops import scan_step as ref_scan_step
from repro_torch import core as port_bind
from repro_torch.compat import to_numpy
from repro_torch.kernels.gemm.ops import gemm_tile as port_gemm_tile
from repro_torch.kernels.linear_scan.ops import scan_step as port_scan_step

SHAPE = (4, 4)


def make_pool(bind, scan_step, gemm_tile):
    """The conformance op pool with ``bind``'s intents (see
    ``tests/_conformance_ops.py`` for what each body exercises) and the
    package's own kernel-tagged bodies."""

    def _scale(a, s):
        return a * s

    def _shift(a, s):
        return a + s

    def _branchy(a, s):
        if float(np.asarray(a).sum()) >= 0:
            return a * s
        return a + s

    def _add(a, b):
        return a + b

    def _mix(a, b):
        return a * 0.5 + b

    def _mm(a, b):
        return a @ b

    def _combine(a, b):
        return a + b

    def _addr(x, y):
        return x + y

    def _mixr(x, y):
        return x * 0.5 + y

    def _bsel(a, b):
        if float(np.asarray(a).sum()) >= 0:
            return a + b
        return a * 0.5 + b

    def _axpy(y, x, s):
        return y + x * s

    In, InOut = bind.In, bind.InOut
    for fn in (_scale, _shift, _branchy, _add, _mix, _mm, _bsel):
        fn.__bind_intents__ = (InOut, In)
    for fn in (_addr, _mixr):
        fn.__bind_intents__ = (In, InOut)
    _axpy.__bind_intents__ = (InOut, In, In)
    return types.SimpleNamespace(
        bind=bind,
        UNARY=(_scale, _shift, _branchy),
        BINARY=(_add, _mix, _mm),
        BIN_CARRY0=(_add, _mix, _bsel),
        BIN_CARRY1=(_addr, _mixr),
        axpy=_axpy, combine=_combine, scan_step=scan_step,
        gemm_tile=gemm_tile)


REF = make_pool(ref_bind, ref_scan_step, ref_gemm_tile)
PORT = make_pool(port_bind, port_scan_step, port_gemm_tile)

# the port's backends beyond serial, each a fresh instance per run
PORT_BACKENDS = {
    "threads": lambda: "threads",
    "fused": lambda: "fused",
    "mesh": lambda: port_bind.MeshBackend(pallas=True),
}


def _record_op(pool, wf, handles, spec_op) -> None:
    """Record one generator op (mirror of ``test_conformance._record_op``)."""
    bind = pool.bind
    form = spec_op[0]
    placement = spec_op[-1]
    ctx = bind.node(placement) if placement is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        if form == "unary":
            _, fi, target, const, _ = spec_op
            fn = pool.UNARY[fi]
            wf.call(fn, (handles[target], const), name=fn.__name__)
        elif form == "binary":
            _, fi, target, other, _ = spec_op
            fn = pool.BINARY[fi]
            wf.call(fn, (handles[target], handles[other]), name=fn.__name__)
        elif form == "chain":
            _, fi, target, const, depth, sync_at, _ = spec_op
            fn = pool.UNARY[fi]
            for i in range(depth):
                if i == sync_at:
                    wf.sync()
                wf.call(fn, (handles[target], const), name=fn.__name__)
        elif form == "vchain":
            _, fi, target, consts, sync_at, _ = spec_op
            fn = pool.UNARY[fi]
            for i, c in enumerate(consts):
                if i == sync_at:
                    wf.sync()
                wf.call(fn, (handles[target], c), name=fn.__name__)
        elif form == "binchain":
            _, carry, fi, target, others, ship_at, p2, sync_at, _ = spec_op
            fn = (pool.BIN_CARRY1 if carry else pool.BIN_CARRY0)[fi]
            for i, other in enumerate(others):
                if i == sync_at:
                    wf.sync()
                ictx = (bind.node(p2)
                        if ship_at is not None and i >= ship_at else None)
                if ictx is not None:
                    ictx.__enter__()
                try:
                    args = ((handles[other], handles[target]) if carry
                            else (handles[target], handles[other]))
                    wf.call(fn, args, name=fn.__name__)
                finally:
                    if ictx is not None:
                        ictx.__exit__(None, None, None)
        elif form == "axpy":
            _, target, other, consts, sync_at, _ = spec_op
            for i, c in enumerate(consts):
                if i == sync_at:
                    wf.sync()
                wf.call(pool.axpy, (handles[target], handles[other], c),
                        name="axpy")
        elif form == "kchain":
            _, target, a_const, xs, sync_at, _ = spec_op
            for i, xh in enumerate(xs):
                if i == sync_at:
                    wf.sync()
                wf.call(pool.scan_step, (handles[target], a_const,
                                         handles[xh]), name="scan_step")
        elif form == "ktile":
            _, target, oa, ob, depth, sync_at, _ = spec_op
            for i in range(depth):
                if i == sync_at:
                    wf.sync()
                wf.call(pool.gemm_tile, (handles[target], handles[oa],
                                         handles[ob]), name="gemm_tile")
        else:
            _, a, b, _ = spec_op
            handles.append(wf.apply(pool.combine, [handles[a], handles[b]],
                                    name="combine"))
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)


def _payload(pool, family, kind, vals):
    if family == "numpy":
        if kind == "jax":
            return np.asarray(vals, np.float32)
        if kind == "jaxint":
            return (np.asarray(vals) * 8).astype(np.int32)
        return np.asarray(vals)
    if pool is REF:
        return jnp.asarray(vals, jnp.float32)
    return torch.tensor(vals, dtype=torch.float32)


def run_spec(pool, spec, family, mode, backend="serial"):
    bind = pool.bind
    ex = bind.LocalExecutor(spec["n_nodes"], mode=mode, backend=backend)
    with bind.Workflow(n_nodes=spec["n_nodes"], executor=ex) as wf:
        handles = []
        for kind, rank, vals in spec["arrays"]:
            handles.append(wf.array(_payload(pool, family, kind, vals),
                                    f"a{len(handles)}", rank=rank))
        syncs = set(spec["syncs"])
        for i, spec_op in enumerate(spec["ops"]):
            _record_op(pool, wf, handles, spec_op)
            if i + 1 in syncs:
                wf.sync()
        values = []
        for h in handles:
            try:
                v = to_numpy(wf.fetch(h))
                values.append((str(v.dtype), v))
            except KeyError:    # GC'd — must be GC'd on both sides
                values.append(("<collected>", None))
    return values, ex.stats, ex


def _events(stats):
    return [(t.version_key, t.src, t.dst, t.nbytes, t.round_id, t.collective,
             t.wavefront) for t in stats.transfers]


def _hops(stats):
    return sorted((t.version_key, t.src, t.dst, t.nbytes, t.collective)
                  for t in stats.transfers)


def _assert_values(ref, got, family, ctx):
    assert len(ref) == len(got), ctx
    for i, ((rd, rv), (gd, gv)) in enumerate(zip(ref, got)):
        assert rd == gd, f"{ctx}: handle {i} dtype {rd} != {gd}"
        if rv is None:
            continue
        if family == "numpy":
            np.testing.assert_array_equal(gv, rv, err_msg=f"{ctx}: handle {i}")
        else:
            # float32, ~30 ops of accumulated rounding differences
            scale = max(1.0, float(np.abs(rv).max()))
            np.testing.assert_allclose(gv, rv, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=f"{ctx}: handle {i}")


def check_conformance(seed: int, family: str) -> None:
    spec = make_spec(seed)
    ref_values, ref_stats, _ = run_spec(REF, spec, family, "plan")
    for mode in ("plan", "interpret"):
        ctx = f"seed {seed} {family} port {mode}"
        values, stats, ex = run_spec(PORT, spec, family, mode)
        _assert_values(ref_values, values, family, ctx)
        if mode == "plan":
            assert _events(stats) == _events(ref_stats), ctx
            assert stats.peak_live_bytes == ref_stats.peak_live_bytes, ctx
            assert stats.peak_live_payloads == ref_stats.peak_live_payloads, \
                ctx
        else:
            # trace-order replay: same hops, round ids may differ
            assert _hops(stats) == _hops(ref_stats), ctx
        assert stats.message_count == ref_stats.message_count, ctx
        assert stats.bytes_transferred == ref_stats.bytes_transferred, ctx
        assert stats.ops_executed == ref_stats.ops_executed, ctx
        assert stats.copies_elided == ref_stats.copies_elided, ctx
        assert stats.wavefronts == ref_stats.wavefronts, ctx
        assert stats.wavefront_flops == ref_stats.wavefront_flops, ctx
        assert sum(stats.wavefronts) == stats.ops_executed, ctx
        assert ex._live_bytes <= stats.peak_live_bytes, ctx
        assert ex._live_entries <= stats.peak_live_payloads, ctx


@pytest.mark.parametrize("family", ["numpy", "tensor"])
@pytest.mark.parametrize("seed", range(N_WORKFLOWS))
def test_port_conformance_pinned_seeds(seed, family):
    check_conformance(seed, family)


@functools.lru_cache(maxsize=None)
def _reference_run(seed: int, family: str):
    values, stats, _ = run_spec(REF, make_spec(seed), family, "plan")
    return values, stats


def check_backend_conformance(seed: int, family: str, backend: str) -> None:
    """A port backend against the reference ``serial`` stream: values,
    transfer stream and stats as for the port's serial backend, live-set
    peaks at least serial's (a concurrent level may be in flight)."""
    ref_values, ref_stats = _reference_run(seed, family)
    ctx = f"seed {seed} {family} port {backend}"
    values, stats, ex = run_spec(PORT, make_spec(seed), family, "plan",
                                 PORT_BACKENDS[backend]())
    _assert_values(ref_values, values, family, ctx)
    assert _events(stats) == _events(ref_stats), ctx
    assert stats.peak_live_bytes >= ref_stats.peak_live_bytes, ctx
    assert stats.peak_live_payloads >= ref_stats.peak_live_payloads, ctx
    assert stats.message_count == ref_stats.message_count, ctx
    assert stats.bytes_transferred == ref_stats.bytes_transferred, ctx
    assert stats.ops_executed == ref_stats.ops_executed, ctx
    assert stats.copies_elided == ref_stats.copies_elided, ctx
    assert stats.wavefronts == ref_stats.wavefronts, ctx
    assert stats.wavefront_flops == ref_stats.wavefront_flops, ctx
    assert ex._live_bytes <= stats.peak_live_bytes, ctx
    assert ex._live_entries <= stats.peak_live_payloads, ctx
    # every lazy row was released or copied out by the end of the flush
    assert not ex._lazy_buckets or all(
        len(b.live) == b.n for b in ex._lazy_buckets), ctx


@pytest.mark.parametrize("backend", sorted(PORT_BACKENDS))
@pytest.mark.parametrize("family", ["numpy", "tensor"])
@pytest.mark.parametrize("seed", range(N_WORKFLOWS))
def test_port_backends_conformance_pinned_seeds(seed, family, backend):
    check_backend_conformance(seed, family, backend)


def test_interpret_peaks_match_reference_interpreter():
    """The interpreter's live-set peaks (per-op accounting, no plan) match
    the reference interpreter's on a handful of seeds."""
    for seed in range(8):
        spec = make_spec(seed)
        _, ref_stats, _ = run_spec(REF, spec, "numpy", "interpret")
        _, stats, _ = run_spec(PORT, spec, "numpy", "interpret")
        assert stats.peak_live_bytes == ref_stats.peak_live_bytes, seed
        assert stats.peak_live_payloads == ref_stats.peak_live_payloads, seed
        assert _events(stats) == _events(ref_stats), seed


def test_unported_backends_name_their_slice():
    with pytest.raises(ValueError, match="Slice 4"):
        port_bind.LocalExecutor(2, backend="procs")
    with pytest.raises(ValueError, match="unknown execution backend"):
        port_bind.get_backend("nope")
    for name, cls in (("serial", port_bind.SerialPlanBackend),
                      ("threads", port_bind.ThreadPoolBackend),
                      ("fused", port_bind.FusedBatchBackend),
                      ("mesh", port_bind.MeshBackend)):
        assert isinstance(port_bind.get_backend(name), cls)
