"""Differential conformance of the port's executor against the reference.

The port's ``serial`` backend and ``interpret`` mode replay the seeded
random workflows of ``tests/test_conformance.py`` (its generator and its 50
pinned seeds) and are held against the reference ``serial`` backend on the
same workflow; so are the port's ``threads``, ``fused``,
``MeshBackend(pallas=True)`` (chains of the tagged kernel bodies through
the chain kernels' plain route on the CPU) and ``mesh_armed``, a
``MeshBackend`` on 4 CPU rank devices (every plan of 2-4 ranks lowers its
tensor ships to ``ppermute`` rounds; NumPy ships stay simulated), which
may only report higher live-set peaks.  Each seed runs in two payload families:

* ``numpy`` — every array a NumPy payload (the generator's jax payloads
  become NumPy float32 / int32 arrays).  Both packages run the same NumPy
  op bodies, so values and dtypes must be identical;
* ``tensor`` — every array a float32 tensor: ``jax.Array`` in the
  reference, a CPU ``torch.Tensor`` in the port.  XLA and PyTorch round at
  different places (XLA fuses ``y + x*s`` into one FMA; eager PyTorch
  rounds twice), so values agree within a float32 tolerance, dtypes map
  one to one;
* ``bfloat16`` — the same with every array a bfloat16 tensor against jax
  bfloat16 arrays.  Where XLA rounds once (a fused ``y + x*s``, a product
  and its sum) eager PyTorch rounds after every operator, and bfloat16
  keeps 8 bits, so values agree within :data:`BF16_TOL` of the largest
  magnitude a handle reaches, or else the port's value lies no farther
  from a float64 replay of the same workflow (the port on float64
  tensors) than the reference's does: a workflow that chains products of
  large values loses more than that tolerance to bfloat16 rounding in
  either package (seed 33: 15% of the scale in the reference, 5% in the
  port).

Besides the generator's ops, the port side adds chains of ``attn_step``
(``o ← o + softmax(q kᵀ / √d) v``, the third kernel-tagged body) to each
spec (:func:`with_attn_chains`): after every ``ktile`` chain one on the
same handles, and after every ``kchain`` one whose ``k`` and ``v`` vary
per level.  Both packages replay the extended spec.  On NumPy payloads the
reference's ``attn_step`` hands back a float32 jax array, which the port
maps to a CPU tensor: a value that is an array (jax or torch) in the
reference must be one in the port, and is compared within the ``tensor``
family's tolerance; a NumPy value must be NumPy, bit for bit.  The
``numpy`` family also replays the generator's spec as it is, without the
``attn_step`` chains: there every handle stays NumPy and must equal the
reference's bit for bit.

In both families the executors' observable accounting must match: the
transfer-event stream (byte-identical for plan replay; as a multiset of
hops for the trace-order interpreter), ``ops_executed``,
``copies_elided``, ``wavefronts``, ``wavefront_flops``, message and byte
totals, and the live-set peaks.  Executable-cache counters are excluded:
the reference jit-compiles jax payloads, the port runs every body eagerly.

The op pool is built once per package, so each body carries its own
package's intents; the kernel-tagged bodies ``scan_step``, ``gemm_tile``
and ``attn_step`` are each package's own.  The reference's is built by
:func:`make_pool`; the port's is the same pool at module level in
``tests/_torch_conformance_ops.py``, which the ``procs`` backend's worker
processes import (a closure cannot be pickled, and a worker that imported
this module would load ``jax``).  ``procs`` must run every plan in its
workers: a fallback to the serial path fails the case.
"""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_conformance_ops import POOL as PORT
from test_conformance import N_WORKFLOWS, make_spec

from repro import core as ref_bind
from repro.kernels.flash_attention.ops import attn_step as ref_attn_step
from repro.kernels.gemm.ops import gemm_tile as ref_gemm_tile
from repro.kernels.linear_scan.ops import scan_step as ref_scan_step
from repro_torch import core as port_bind
from repro_torch.compat import to_numpy

SHAPE = (4, 4)
FAMILIES = ("numpy", "tensor", "bfloat16")
# bfloat16 family: both sides round to 8 bits, at different places (see
# the module doc); the reference's own bfloat16 kernel tolerance
BF16_TOL = 3e-2


def with_attn_chains(spec: dict) -> dict:
    """``spec`` with an ``attn_step`` chain after each ``ktile`` chain (q
    and v the tile's a, k its b, every level) and each ``kchain`` (q the
    first x, k each level's x, v the levels' x in reverse)."""
    ops = []
    for op in spec["ops"]:
        ops.append(op)
        if op[0] == "ktile":
            _, target, oa, ob, depth, sync_at, placement = op
            ops.append(("kattn", target, oa, (ob,) * depth, (oa,) * depth,
                        sync_at, placement))
        elif op[0] == "kchain":
            _, target, _a, xs, sync_at, placement = op
            ops.append(("kattn", target, xs[0], xs, xs[::-1], sync_at,
                        placement))
    return {**spec, "ops": ops}


def make_pool(bind, scan_step, gemm_tile, attn_step):
    """The conformance op pool with ``bind``'s intents (see
    ``tests/_conformance_ops.py`` for what each body exercises) and the
    package's own kernel-tagged bodies: the reference's side (the port's
    is ``tests/_torch_conformance_ops.py``, which mixes NumPy operands
    into tensors as jax mixes them into arrays)."""

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
        gemm_tile=gemm_tile, attn_step=attn_step)


REF = make_pool(ref_bind, ref_scan_step, ref_gemm_tile, ref_attn_step)

# the port's backends beyond serial, each a fresh instance per run
PORT_BACKENDS = {
    "threads": lambda: "threads",
    "fused": lambda: "fused",
    "procs": lambda: port_bind.ProcessPoolBackend(),
    "mesh": lambda: port_bind.MeshBackend(pallas=True),
    # ship lowering armed: 4 CPU rank devices take every plan of 2-4 ranks
    "mesh_armed": lambda: port_bind.MeshBackend(devices=("cpu",) * 4),
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
        elif form == "kattn":
            _, target, oq, ks, vs, sync_at, _ = spec_op
            for i, (ok, ov) in enumerate(zip(ks, vs)):
                if i == sync_at:
                    wf.sync()
                wf.call(pool.attn_step, (handles[target], handles[oq],
                                         handles[ok], handles[ov]),
                        name="attn_step")
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
        return jnp.asarray(vals, jnp.bfloat16 if family == "bfloat16"
                           else jnp.float32)
    return torch.tensor(vals, dtype={"bfloat16": torch.bfloat16,
                                     "float64": torch.float64}.get(
                                         family, torch.float32))


def _fetched(payload):
    """(kind, dtype name, host values) of a fetched payload: ``numpy`` for
    a NumPy array, ``array`` for a jax array or a tensor."""
    if isinstance(payload, np.ndarray):
        return "numpy", str(payload.dtype), payload
    dtype = str(payload.dtype).removeprefix("torch.")
    return "array", dtype, to_numpy(payload).astype(np.float64) \
        if dtype == "bfloat16" else to_numpy(payload)


def run_spec(pool, spec, family, mode, backend="serial", attn=True,
             fault_injector=None):
    """Replay ``spec`` (with the ``attn_step`` chains of
    :func:`with_attn_chains` when ``attn``) in ``family``'s payloads."""
    bind = pool.bind
    if attn:
        spec = with_attn_chains(spec)
    ex = bind.LocalExecutor(spec["n_nodes"], mode=mode, backend=backend,
                            fault_injector=fault_injector)
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
                values.append(_fetched(wf.fetch(h)))
            except KeyError:    # GC'd — must be GC'd on both sides
                values.append(("<collected>", "<collected>", None))
    return values, ex.stats, ex


def _events(stats):
    return [(t.version_key, t.src, t.dst, t.nbytes, t.round_id, t.collective,
             t.wavefront) for t in stats.transfers]


def _hops(stats):
    return sorted((t.version_key, t.src, t.dst, t.nbytes, t.collective)
                  for t in stats.transfers)


@functools.lru_cache(maxsize=None)
def _float64_values(seed: int):
    """The port's serial replay of seed's workflow on float64 tensors: the
    yardstick of the bfloat16 family's rounding (module doc)."""
    values, _, _ = run_spec(PORT, make_spec(seed), "float64", "plan")
    return values


def _assert_values(ref, got, family, ctx, seed=None, attn=True):
    assert len(ref) == len(got), ctx
    for i, ((rk, rd, rv), (gk, gd, gv)) in enumerate(zip(ref, got)):
        assert rk == gk, f"{ctx}: handle {i} payload kind {rk} != {gk}"
        assert rd == gd, f"{ctx}: handle {i} dtype {rd} != {gd}"
        if family == "numpy" and not attn:
            # only NumPy bodies ran: every handle NumPy, bit for bit
            assert rk in ("numpy", "<collected>"), f"{ctx}: handle {i} {rk}"
        if rv is None:
            continue
        rv = np.asarray(rv, np.float64) if rd == "bfloat16" else rv
        if rk == "numpy":
            np.testing.assert_array_equal(gv, rv, err_msg=f"{ctx}: handle {i}")
        else:
            # float32, ~30 ops of accumulated rounding differences; in
            # bfloat16, BF16_TOL (the module doc)
            tol = BF16_TOL if family == "bfloat16" else 1e-4
            finite = np.isfinite(rv)
            scale = max(1.0, float(np.abs(rv[finite]).max())
                        if finite.any() else 1.0)
            if family == "bfloat16" and not np.allclose(
                    gv, rv, rtol=tol, atol=tol * scale, equal_nan=True):
                # bfloat16 rounding past the tolerance: the port must lie
                # no farther from the float64 replay than the reference
                tv = _float64_values(seed)[i][2]
                assert np.isfinite(tv).all(), f"{ctx}: handle {i}"
                port_err = np.abs(gv - tv).max()
                ref_err = np.abs(rv - tv).max()
                assert port_err <= ref_err + tol * scale, (
                    f"{ctx}: handle {i}: {port_err} from float64, the "
                    f"reference {ref_err}")
                continue
            np.testing.assert_allclose(gv, rv, rtol=tol, atol=tol * scale,
                                       err_msg=f"{ctx}: handle {i}")


def _attn_runs(family: str) -> tuple:
    """Whether each replay of a seed adds the ``attn_step`` chains: the
    ``numpy`` family replays the generator's spec as it is too."""
    return (False, True) if family == "numpy" else (True,)


def check_conformance(seed: int, family: str) -> None:
    for attn in _attn_runs(family):
        _check_conformance(seed, family, attn)


def _check_conformance(seed: int, family: str, attn: bool) -> None:
    spec = make_spec(seed)
    ref_values, ref_stats, _ = run_spec(REF, spec, family, "plan", attn=attn)
    for mode in ("plan", "interpret"):
        ctx = f"seed {seed} {family} attn {attn} port {mode}"
        values, stats, ex = run_spec(PORT, spec, family, mode, attn=attn)
        _assert_values(ref_values, values, family, ctx, seed, attn)
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


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", range(N_WORKFLOWS))
def test_port_conformance_pinned_seeds(seed, family):
    check_conformance(seed, family)


@functools.lru_cache(maxsize=None)
def _reference_run(seed: int, family: str, attn: bool = True):
    values, stats, _ = run_spec(REF, make_spec(seed), family, "plan",
                                attn=attn)
    return values, stats


def check_backend_conformance(seed: int, family: str, backend: str) -> None:
    """A port backend against the reference ``serial`` stream: values,
    transfer stream and stats as for the port's serial backend, live-set
    peaks at least serial's (a concurrent level may be in flight)."""
    for attn in _attn_runs(family):
        _check_backend_conformance(seed, family, backend, attn)


def _check_backend_conformance(seed: int, family: str, backend: str,
                               attn: bool) -> None:
    ref_values, ref_stats = _reference_run(seed, family, attn)
    ctx = f"seed {seed} {family} attn {attn} port {backend}"
    values, stats, ex = run_spec(PORT, make_spec(seed), family, "plan",
                                 PORT_BACKENDS[backend](), attn=attn)
    _assert_values(ref_values, values, family, ctx, seed, attn)
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
    if backend == "procs":      # every plan ran in the workers
        assert ex.backend.fallbacks == 0 and ex.backend.plans_run > 0, ctx
    if backend == "mesh_armed":
        _check_armed_ships(ex, family, ctx)


def _check_armed_ships(ex, family: str, ctx: str) -> None:
    """Every ship of a multi-rank plan went through the armed mesh: as
    ``ppermute`` rounds where the payload is a tensor (every payload of
    the tensor families), simulated where it is NumPy."""
    mb = ex.backend
    ships = len({(t.version_key, t.wavefront) for t in ex.stats.transfers})
    if ex.n_nodes < 2:
        assert mb.ships_lowered == mb.ships_simulated == 0, ctx
        return
    assert mb.ships_lowered + mb.ships_simulated == ships, ctx
    if family != "numpy":
        assert mb.ships_simulated == 0, ctx
        assert mb.mesh(ex.n_nodes).copies == (ex.n_nodes - 1) \
            * mb.ships_lowered, ctx


@pytest.mark.parametrize("backend", sorted(PORT_BACKENDS))
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", range(N_WORKFLOWS))
def test_port_backends_conformance_pinned_seeds(seed, family, backend):
    check_backend_conformance(seed, family, backend)


def test_armed_mesh_lowers_ships_over_the_sweep():
    """The armed mesh is not vacuous: over the 50 seeds in the tensor
    family it lowers ships of plans of 2, 3 and 4 ranks."""
    lowered = {}
    for seed in range(N_WORKFLOWS):
        _, _, ex = run_spec(PORT, make_spec(seed), "tensor", "plan",
                            PORT_BACKENDS["mesh_armed"]())
        lowered[ex.n_nodes] = (lowered.get(ex.n_nodes, 0)
                               + ex.backend.ships_lowered)
    assert all(lowered.get(n, 0) > 0 for n in (2, 3, 4)), lowered


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
    """Every backend of the reference resolves in the port now (``procs``
    landed with Slice 4); an unknown name still raises."""
    assert sorted(port_bind.BACKENDS) == sorted(ref_bind.BACKENDS)
    with pytest.raises(ValueError, match="unknown execution backend"):
        port_bind.get_backend("nope")
    for name, cls in (("serial", port_bind.SerialPlanBackend),
                      ("threads", port_bind.ThreadPoolBackend),
                      ("fused", port_bind.FusedBatchBackend),
                      ("procs", port_bind.ProcessPoolBackend),
                      ("mesh", port_bind.MeshBackend)):
        assert isinstance(port_bind.get_backend(name), cls)
    assert isinstance(port_bind.LocalExecutor(2, backend="procs").backend,
                      port_bind.ProcessPoolBackend)
