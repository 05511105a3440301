"""The port's ``fused``, ``mesh`` and ``threads`` backends against the
reference's, on the same workflows.

Each case records one workflow twice — with jax arrays through
:mod:`repro.core`, and with CPU tensors through :mod:`repro_torch.core` —
from the same NumPy values, and compares the fetched values and the
backends' dispatch counters (``batches_dispatched``, ``ops_fused``,
``chains_dispatched``, ``ops_chained``, and for ``mesh``
``pallas_chains_dispatched``, ``ops_pallas``).  The reference's mesh
backend runs its chain kernel in Pallas interpret mode, as its own tests
do; the port's runs the chain kernels' plain route (the CPU).  Values agree
bitwise where both packages do the same float32 arithmetic; where XLA
fuses differently the tolerance is stated.

The port differs from the reference on purpose in two places, each pinned
by its own test: the GEMM bodies launch a kernel that cannot read a tensor
batched by ``torch.func.vmap``, so ``gemm_tile`` / ``_t_gemm_acc`` are
marked ``__bind_vmap__ = False`` and run per op under ``fused``, never
stacked; and a width-1 generic chain is an eager loop, so a body with a
host branch still chains.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_bind
from repro.kernels.gemm.ops import gemm_tile as ref_gemm_tile
from repro.kernels.linear_scan.ops import scan_step as ref_scan_step
from repro.launch.mesh import make_topology as ref_make_topology
from repro_torch import core as port_bind
from repro_torch.compat import to_numpy
from repro_torch.core.backends.base import BatchSlice
from repro_torch.kernels.chain import ref as chain_ref
from repro_torch.kernels.gemm import ref as gemm_ref
from repro_torch.kernels.gemm.ops import gemm_tile as port_gemm_tile
from repro_torch.kernels.linear_scan.ops import scan_step as port_scan_step
from repro_torch.launch.mesh import make_topology
from repro_torch.linalg import tiles as port_tiles

FUSED_COUNTERS = ("batches_dispatched", "ops_fused", "chains_dispatched",
                  "ops_chained")
MESH_COUNTERS = FUSED_COUNTERS + ("pallas_chains_dispatched", "ops_pallas")


def _ops(bind, scan_step, gemm_tile):
    """One package's op bodies (fresh functions carrying its intents)."""

    def scale(a, s):
        return a * s

    def shift(a, s):
        return a + s

    def add_c0(y, x):
        return y + x

    def axpy3(y, x, s):
        return y + x * s

    def plain_step(y, a, x):
        return a * y + x        # scan_step's body without the kernel tag

    def branchy(a, s):
        if float(np.asarray(a).sum()) > 0:     # host branch
            return a * s
        return a

    for fn in (scale, shift, add_c0, branchy):
        fn.__bind_intents__ = (bind.InOut, bind.In)
    for fn in (axpy3, plain_step):
        fn.__bind_intents__ = (bind.InOut, bind.In, bind.In)
    return types.SimpleNamespace(
        bind=bind, scale=scale, shift=shift, add_c0=add_c0, axpy3=axpy3,
        plain_step=plain_step, branchy=branchy, scan_step=scan_step,
        gemm_tile=gemm_tile)


REF = _ops(ref_bind, ref_scan_step, ref_gemm_tile)
PORT = _ops(port_bind, port_scan_step, port_gemm_tile)
REF.arr = jnp.asarray
PORT.arr = lambda x: torch.from_numpy(np.array(x))


def _host(payload):
    return to_numpy(payload) if isinstance(payload, torch.Tensor) \
        else np.asarray(payload)


def run(pkg, backend, recipe, n_nodes=1, executable_cache=None):
    """Record ``recipe(pkg, wf)`` (it returns the handles to fetch) and run
    it under ``backend``; returns ``(host values, executor)``."""
    ex = pkg.bind.LocalExecutor(n_nodes, backend=backend,
                                executable_cache=executable_cache)
    with pkg.bind.Workflow(n_nodes=n_nodes, executor=ex) as wf:
        handles = recipe(pkg, wf)
        outs = [_host(wf.fetch(h)) for h in handles]
    return outs, ex


def _backend(pkg, kind):
    if kind == "mesh":
        return pkg.bind.MeshBackend(pallas=True)
    return {"fused": pkg.bind.FusedBatchBackend,
            "threads": pkg.bind.ThreadPoolBackend}[kind]()


def counters(backend, names=FUSED_COUNTERS):
    return {n: getattr(backend, n) for n in names}


def compare(recipe, kind="fused", rtol=0.0, n_nodes=1):
    """Run ``recipe`` on both packages under ``kind``; values must agree
    (bitwise at ``rtol=0``) and so must the dispatch counters.  Returns
    the port's ``(values, executor)``."""
    names = MESH_COUNTERS if kind == "mesh" else FUSED_COUNTERS
    rb, pb = _backend(REF, kind), _backend(PORT, kind)
    ref_out, _ = run(REF, rb, recipe, n_nodes)
    port_out, pex = run(PORT, pb, recipe, n_nodes)
    assert len(ref_out) == len(port_out)
    for r, p in zip(ref_out, port_out):
        assert r.dtype == p.dtype and r.shape == p.shape
        if rtol:
            np.testing.assert_allclose(p, r, rtol=rtol, atol=rtol)
        else:
            np.testing.assert_array_equal(p, r)
            np.testing.assert_array_equal(np.signbit(p), np.signbit(r))
    assert counters(pb, names) == counters(rb, names)
    return port_out, pex


def _full(shape, value, dtype=np.float32):
    return np.full(shape, value, dtype)


# ---------------------------------------------------------------------------
# Buckets and chains: values and counters against the reference
# ---------------------------------------------------------------------------

def _bucket(n, consts=None):
    def recipe(pkg, wf):
        xs = [wf.array(pkg.arr(_full((4, 4), i + 1.0)), f"x{i}")
              for i in range(n)]
        for i, x in enumerate(xs):
            wf.call(pkg.scale, (x, 3.0 if consts is None else consts[i]))
        return xs
    return recipe


def _unary_chain(width, consts, fn="scale", dtype=np.float32, value=1.0):
    def recipe(pkg, wf):
        xs = [wf.array(pkg.arr(_full((4, 4), value + i, dtype)), f"x{i}")
              for i in range(width)]
        for c in consts:
            for x in xs:
                wf.call(getattr(pkg, fn), (x, c))
        return xs
    return recipe


@pytest.mark.parametrize("recipe", [
    _bucket(8),
    _bucket(4, consts=[2, 2, 2.0, 2.0]),        # constant type splits buckets
    _unary_chain(1, [1.01] * 16),
    _unary_chain(8, [1.01] * 16),
    _unary_chain(1, [1.5, 2.0, 3.0, 0.5]),      # varying: hoisted xs_const
    _unary_chain(3, [1.5, 2.0, 3.0, 0.5]),
    _unary_chain(1, [2, 3, 4]),                 # int consts, float carry
    _unary_chain(1, [2, 3, 4], dtype=np.int32),  # int carry stays int
    _unary_chain(1, [2, 2.0, True, 3]),         # mixed types: per level
], ids=["bucket", "bucket-const-types", "chain-w1", "chain-w8",
        "hoist-w1", "hoist-w3", "int-consts", "int-carry", "mixed-types"])
def test_buckets_and_chains_match_reference(recipe):
    compare(recipe)


def test_chain_matches_serial_stats():
    """Interior levels never materialise, yet the accounting is
    byte-identical to serial replay."""
    recipe = _unary_chain(8, [1.01] * 16)
    fb = port_bind.FusedBatchBackend()
    out, ex = run(PORT, fb, recipe)
    ref, sex = run(PORT, "serial", recipe)
    assert fb.chains_dispatched == 1 and fb.ops_chained == 128
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    st, ss = ex.stats, sex.stats
    assert (st.peak_live_bytes, st.peak_live_payloads) == \
        (ss.peak_live_bytes, ss.peak_live_payloads)
    assert (ex._live_bytes, ex._live_entries) == \
        (sex._live_bytes, sex._live_entries)
    assert st.transfers == ss.transfers and st.wavefronts == ss.wavefronts


def test_signed_zero_constants_hoist_exactly():
    """0.0 == -0.0, but x * -0.0 flips a zero's sign: a signed-zero mix is
    *varying* and hoisted (preserving -0.0), never collapsed."""
    out, _ = compare(_unary_chain(1, [0.0, -0.0, 0.0]))
    assert np.signbit(out[0]).all()


def test_int32_range_hoist_is_rejected():
    """Ints outside int32 would wrap in the reference's hoisted array, so
    its rule rejects the hoist (the reference cannot even run such a
    constant per op: jax refuses it).  The port keeps the rule: the chain
    runs per level, with serial's values."""
    recipe = _unary_chain(1, [3, 2 ** 31, 2])
    fb = port_bind.FusedBatchBackend()
    out, _ = run(PORT, fb, recipe)
    assert fb.chains_dispatched == 0 and not fb._no_chain
    np.testing.assert_array_equal(out[0], run(PORT, "serial", recipe)[0][0])
    assert float(out[0][0, 0]) == 3.0 * 2 ** 32


def test_dtype_flipping_hoist_falls_back_without_pinning():
    """Float constants hoisted onto a float16 carry would upcast it in the
    reference (a float32 hoisted array) and round where serial does not in
    the port: rejected before dispatch, and the fn is not pinned."""
    compare(_unary_chain(1, [1.5, 2.0, 0.5], dtype=np.float16))
    fb = port_bind.FusedBatchBackend()
    run(PORT, fb, _unary_chain(1, [1.5, 2.0, 0.5], dtype=np.float16))
    assert fb.chains_dispatched == 0 and not fb._no_chain
    run(PORT, fb, _unary_chain(1, [2.0] * 3))
    assert fb.chains_dispatched == 1


def test_dtype_changing_chain_is_pinned_per_level():
    """int32 carry * 2.5 becomes float32: the carry is not loop-invariant,
    so the chain is pinned to per-level dispatch (``lax.scan``'s rule)."""
    compare(_unary_chain(1, [2.5] * 5, dtype=np.int32))
    fb = port_bind.FusedBatchBackend()
    run(PORT, fb, _unary_chain(1, [2.5] * 5, dtype=np.int32))
    assert PORT.scale in fb._no_chain


def test_numpy_payloads_are_never_promoted():
    def recipe(pkg, wf):
        xs = [wf.array(np.ones((4, 4)), f"x{i}") for i in range(6)]
        for x in xs:
            for _ in range(3):
                wf.call(pkg.scale, (x, 2.0))
        return xs
    for kind in ("fused", "mesh"):
        out, _ = compare(recipe, kind)
        assert all(o.dtype == np.float64 for o in out)


def _chain_then_bucket(pkg, wf):
    xs = [wf.array(pkg.arr(_full((4, 4), i + 1.0)), f"x{i}")
          for i in range(4)]
    for _ in range(5):
        for x in xs:
            wf.call(pkg.scale, (x, 2.0))
    for x in xs:
        wf.call(pkg.shift, (x, 1.0))     # a bucket fed by the chain's buffer
    return xs


def _bucket_then_chain(pkg, wf):
    xs = [wf.array(pkg.arr(_full((4, 4), i + 1.0)), f"x{i}")
          for i in range(4)]
    for x in xs:
        wf.call(pkg.shift, (x, 1.0))
    for _ in range(5):
        for x in xs:
            wf.call(pkg.scale, (x, 2.0))
    return xs


def _axpy_chain(width):
    def recipe(pkg, wf):
        ys = [wf.array(pkg.arr(_full((4, 4), i + 1.0)), f"y{i}")
              for i in range(width)]
        xs = [wf.array(pkg.arr(_full((4, 4), 0.5 * (i + 1))), f"x{i}")
              for i in range(width)]
        for lvl in range(12):
            for y, x in zip(ys, xs):
                wf.call(pkg.axpy3, (y, x, 1.0 + 0.1 * lvl))
        return ys
    return recipe


def _varying_exterior(width, prestacked):
    def recipe(pkg, wf):
        ys = [wf.array(pkg.arr(_full((4, 4), 0.0)), f"y{j}")
              for j in range(width)]
        zs = [[wf.array(pkg.arr(_full((4, 4), 10.0 * l + j + 1)), f"z{l}{j}")
               for j in range(width)] for l in range(6)]
        if prestacked:
            for row in zs:
                for z in row:
                    wf.call(pkg.shift, (z, 1.0))    # one bucket of rows
        for row in zs:
            for y, z in zip(ys, row):
                wf.call(pkg.add_c0, (y, z))
        return ys
    return recipe


@pytest.mark.parametrize("recipe", [
    _chain_then_bucket, _bucket_then_chain, _axpy_chain(1), _axpy_chain(4),
    _varying_exterior(1, False), _varying_exterior(3, False),
    _varying_exterior(1, True),
], ids=["chain-to-bucket", "bucket-to-chain", "axpy-w1", "axpy-w4",
        "xs-w1", "xs-w3", "xs-prestacked"])
def test_stacked_buffers_and_exteriors_match_reference(recipe):
    compare(recipe)


def test_prestacked_exterior_rows_pass_through():
    rb = ref_bind.FusedBatchBackend()
    pb = port_bind.FusedBatchBackend()
    run(REF, rb, _varying_exterior(1, True))
    run(PORT, pb, _varying_exterior(1, True))
    assert pb.xs_passthrough == rb.xs_passthrough == 1


def test_chain_broken_by_ship_matches_reference():
    def recipe(pkg, wf):
        a = wf.array(pkg.arr(_full((4, 4), 1.0)), "a")
        with pkg.bind.node(0):
            for _ in range(3):
                wf.call(pkg.scale, (a, 2.0))
        with pkg.bind.node(1):                 # a hop: two chains
            for _ in range(3):
                wf.call(pkg.scale, (a, 2.0))
        return [a]
    _, ex = compare(recipe, n_nodes=2)
    assert ex.backend.chains_dispatched == 2 and ex.stats.message_count == 1


# ---------------------------------------------------------------------------
# Batched residency: spilled rows are copies, not views of the buffer
# ---------------------------------------------------------------------------

def _owns_its_storage(t: torch.Tensor) -> bool:
    return (t._base is None
            and t.untyped_storage().nbytes() == t.numel() * t.element_size())


def test_surviving_row_spills_as_a_copy():
    """Once a bucket's other rows are GC'd, the survivor is copied out of
    the stacked buffer — a view would keep the whole buffer alive and
    device residency would exceed ``peak_live_bytes`` by the batch width."""
    n = 6

    def recipe(pkg, wf):
        xs = [wf.array(pkg.arr(_full((8, 8), i + 1.0)), f"x{i}")
              for i in range(n)]
        for x in xs:
            wf.call(pkg.scale, (x, 2.0))    # one bucket of n lazy rows
        for x in xs[1:]:
            wf.call(pkg.shift, (x, 1.0))    # consumes rows 1..n-1
        return xs

    compare(recipe)
    fb = port_bind.FusedBatchBackend()
    ex = port_bind.LocalExecutor(1, backend=fb)
    with port_bind.Workflow(executor=ex) as wf:
        xs = recipe(PORT, wf)
        wf.sync()
        ex.flush()
        assert fb.batches_dispatched == 2
        head = ex._stores[0][xs[0].ref.head.key]
        assert type(head) is torch.Tensor and _owns_its_storage(head)
        np.testing.assert_array_equal(to_numpy(head), _full((8, 8), 2.0))
        assert ex._live_bytes <= ex.stats.peak_live_bytes


def test_fully_live_bucket_stays_lazy_and_fetch_copies_a_row():
    fb = port_bind.FusedBatchBackend()
    ex = port_bind.LocalExecutor(1, backend=fb)
    with port_bind.Workflow(executor=ex) as wf:
        xs = [wf.array(torch.full((4, 4), i + 1.0), f"x{i}") for i in range(4)]
        for x in xs:
            wf.call(PORT.scale, (x, 3.0))
        wf.sync()
        ex.flush()
        rows = [ex._stores[0][x.ref.head.key] for x in xs]
        assert all(type(r) is BatchSlice for r in rows)
        assert to_numpy(rows[2])[0, 0] == 9.0       # compat materialises
        got = wf.fetch(xs[0])
        assert _owns_its_storage(got)
        assert ex.stats.fetch_bytes_copied == got.nbytes
        assert wf.fetch(xs[0]) is got               # written back: one copy
        wf.call(PORT.scale, (xs[0], 1.0))           # second segment
        wf.sync()
        ex.flush()
        assert not ex._lazy_buckets
        assert all(type(p) is not BatchSlice
                   for p in ex._stores[0].values())


def test_shipped_row_is_a_copy():
    def recipe(pkg, wf):
        xs = [wf.array(pkg.arr(_full((4, 4), i + 1.0)), f"x{i}", rank=0)
              for i in range(3)]
        with pkg.bind.node(0):
            for x in xs:
                wf.call(pkg.scale, (x, 2.0))
        with pkg.bind.node(1):
            wf.call(pkg.shift, (xs[0], 1.0))     # ships row 0 to rank 1
        return xs

    _, ex = compare(recipe, n_nodes=2)
    shipped = [p for p in ex._stores[1].values()
               if isinstance(p, torch.Tensor)]
    assert shipped and all(_owns_its_storage(p) for p in shipped)


# ---------------------------------------------------------------------------
# Mesh: kernel-tagged chains through the chain kernels' route
# ---------------------------------------------------------------------------

def _scan_chain(fn="scan_step", fresh_x=True, depth=8):
    def recipe(pkg, wf):
        y = wf.array(pkg.arr(np.linspace(0.0, 1.0, 16, dtype=np.float32)),
                     "y")
        x = wf.array(pkg.arr(_full(16, 2.0)), "x")
        for i in range(depth):
            if fresh_x:
                x = wf.array(pkg.arr(_full(16, float(2 ** (i % 3)))))
            wf.call(getattr(pkg, fn), (y, 0.5, x))
        return [y]
    return recipe


def _gemm_chain(fresh):
    def recipe(pkg, wf):
        rng = np.random.default_rng(3)
        c = wf.array(pkg.arr(rng.normal(size=(8, 8)).astype(np.float32)))
        a = wf.array(pkg.arr(rng.normal(size=(8, 5)).astype(np.float32)))
        b = wf.array(pkg.arr(rng.normal(size=(5, 8)).astype(np.float32)))
        for _ in range(4):
            if fresh:
                a = wf.array(pkg.arr(rng.normal(size=(8, 5)).astype(
                    np.float32)))
                b = wf.array(pkg.arr(rng.normal(size=(5, 8)).astype(
                    np.float32)))
            wf.call(pkg.gemm_tile, (c, a, b))
        return [c]
    return recipe


@pytest.mark.parametrize("recipe, n_levels, rtol", [
    (_scan_chain(fresh_x=True), 8, 0.0),
    (_scan_chain(fresh_x=False), 8, 0.0),
    (_gemm_chain(fresh=True), 4, 1e-5),     # XLA and PyTorch sum apart
    (_gemm_chain(fresh=False), 4, 1e-5),
], ids=["scan-xs", "scan-single", "gemm-xs", "gemm-single"])
def test_tagged_chain_is_one_kernel_dispatch(recipe, n_levels, rtol):
    out, ex = compare(recipe, "mesh", rtol=rtol)
    mb = ex.backend
    assert mb.pallas_chains_dispatched == 1 and mb.ops_pallas == n_levels
    serial, _ = run(PORT, "serial", recipe)
    np.testing.assert_array_equal(out[0], serial[0])


def test_untagged_body_takes_the_generic_chain_path():
    compare(_scan_chain("plain_step"), "mesh")
    mb = port_bind.MeshBackend(pallas=True)
    run(PORT, mb, _scan_chain("plain_step"))
    assert mb.pallas_chains_dispatched == 0 and mb.chains_dispatched == 1


def test_pallas_auto_is_off_without_two_gpus():
    mb = port_bind.MeshBackend()
    out, _ = run(PORT, mb, _scan_chain())
    assert mb.pallas_chains_dispatched == 0 and mb.chains_dispatched == 1
    np.testing.assert_array_equal(out[0], run(PORT, "serial",
                                              _scan_chain())[0][0])


def test_chain_kernel_route_is_resolved_once():
    cache = port_bind.ExecutableCache()
    mb = port_bind.MeshBackend(pallas=True)
    run(PORT, mb, _scan_chain(), executable_cache=cache)
    run(PORT, mb, _scan_chain(), executable_cache=cache)
    assert mb.pallas_chains_dispatched == 2 and cache.compiles == 1


# ---------------------------------------------------------------------------
# Where the port departs from the reference on purpose
# ---------------------------------------------------------------------------

def _gemm_bucket(pkg, wf):
    rng = np.random.default_rng(0)
    cs = [wf.array(pkg.arr(rng.normal(size=(4, 4)).astype(np.float32)))
          for _ in range(4)]
    a = wf.array(pkg.arr(rng.normal(size=(4, 4)).astype(np.float32)))
    for c in cs:
        wf.call(pkg.gemm_tile, (c, a, a))
    return cs


def test_gemm_bodies_are_pinned_to_per_op_dispatch(monkeypatch):
    """The GEMM bodies launch a kernel that cannot read a vmap-batched
    tensor, and say so with ``__bind_vmap__ = False``: a bucket of
    ``gemm_tile`` ops — which the reference batches — runs per op, and so
    does ``linalg.tiles._t_gemm_acc``, decided before anything is stacked
    (no vmapped entry is looked up, nothing is pinned by failing)."""
    assert PORT.gemm_tile.__bind_vmap__ is False
    assert port_tiles._t_gemm_acc.__bind_vmap__ is False

    def no_vmap(*args, **kwargs):
        raise AssertionError("a GEMM body was stacked for torch.func.vmap")

    monkeypatch.setattr(port_bind.ExecutableCache, "lookup_vmapped", no_vmap)
    rb, pb = ref_bind.FusedBatchBackend(), port_bind.FusedBatchBackend()
    ref_out, _ = run(REF, rb, _gemm_bucket)
    port_out, _ = run(PORT, pb, _gemm_bucket)
    for r, p in zip(ref_out, port_out):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)
    assert rb.batches_dispatched == 1
    assert pb.batches_dispatched == 0 and not pb._no_fuse

    fb = port_bind.FusedBatchBackend()
    ex = port_bind.LocalExecutor(1, backend=fb)
    with port_bind.Workflow(executor=ex) as wf:
        ta = port_tiles.Tiled.from_array(wf, torch.ones(8, 8), 4, "A")
        tc = port_tiles.Tiled.zeros(wf, 2, 2, 4, torch.float32, "C")
        port_tiles.gemm_tiles(ta, ta, tc)
        out = tc.to_array()
    assert torch.equal(out, torch.full((8, 8), 8.0))
    assert fb.batches_dispatched == 0 and fb.chains_dispatched == 0
    assert not fb._no_fuse and not fb._no_chain


def test_width1_generic_chain_runs_host_branching_bodies():
    """The reference cannot trace a host branch into ``lax.scan`` and pins
    the fn; the port's width-1 generic chain is an eager loop and runs it
    as one chain, with serial's values."""
    recipe = _unary_chain(1, [2.0] * 4, fn="branchy")
    rb, pb = ref_bind.FusedBatchBackend(), port_bind.FusedBatchBackend()
    ref_out, _ = run(REF, rb, recipe)
    port_out, _ = run(PORT, pb, recipe)
    np.testing.assert_array_equal(port_out[0], ref_out[0])
    assert rb.chains_dispatched == 0 and REF.branchy in rb._no_chain
    assert pb.chains_dispatched == 1


def test_unbatchable_body_is_pinned_per_op():
    """At width > 1 the port vmaps, and a host branch cannot be batched:
    pinned exactly like the reference."""
    compare(_unary_chain(4, [2.0] * 4, fn="branchy"))


# ---------------------------------------------------------------------------
# Errors propagate: nothing is absorbed into another route
# ---------------------------------------------------------------------------

def _boom(*args, **kwargs):
    raise RuntimeError("kernel launch failed")


@pytest.mark.parametrize("kind", ["fused", "mesh"])
def test_gemm_wrapper_runtime_error_propagates(kind, monkeypatch):
    monkeypatch.setattr(gemm_ref, "matmul_accumulate", _boom)
    ex = port_bind.LocalExecutor(1, backend=_backend(PORT, kind),
                                 stitch=False)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        with port_bind.Workflow(executor=ex) as wf:
            _gemm_chain(fresh=True)(PORT, wf)
            wf.sync()


@pytest.mark.parametrize("body", ["chain_ewise", "chain_dot"])
def test_chain_route_runtime_error_propagates(body, monkeypatch):
    monkeypatch.setattr(chain_ref, body, _boom)
    recipe = _scan_chain() if body == "chain_ewise" else _gemm_chain(True)
    mb = port_bind.MeshBackend(pallas=True)
    ex = port_bind.LocalExecutor(1, backend=mb, stitch=False)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        with port_bind.Workflow(executor=ex) as wf:
            recipe(PORT, wf)
            wf.sync()
    assert not mb._no_chain


# ---------------------------------------------------------------------------
# Thread pool: inlining, pooling and whole-plan delegation
# ---------------------------------------------------------------------------

def _wide_levels(pkg, wf):
    xs = [wf.array(pkg.arr(_full((64, 64), i + 1.0)), f"x{i}")
          for i in range(4)]
    for _ in range(3):
        for x in xs:
            wf.call(pkg.scale, (x, 1.5))
    return xs


@pytest.mark.parametrize("threshold, topology", [
    (None, None),                       # below the default: delegated
    (0, None),                          # pool every wide level
    (10 ** 9, None),
    (None, "calibrated"),               # threshold from the topology
])
def test_thread_pool_dispatch_matches_reference(threshold, topology):
    def make(pkg):
        topo = None
        if topology:
            topo = (ref_make_topology if pkg is REF else make_topology)(
                "flat", 1, flops_per_s=1e6)
        ex = pkg.bind.LocalExecutor(
            1, backend=pkg.bind.ThreadPoolBackend(
                dispatch_threshold=threshold), topology=topo)
        with pkg.bind.Workflow(executor=ex) as wf:
            outs = [_host(wf.fetch(h)) for h in _wide_levels(pkg, wf)]
        return outs, ex.backend

    ref_out, rb = make(REF)
    port_out, pb = make(PORT)
    for r, p in zip(ref_out, port_out):
        np.testing.assert_array_equal(p, r)
    names = ("inlined_levels", "pooled_levels", "plans_delegated")
    assert counters(pb, names) == counters(rb, names)
    assert pb._threshold == rb._threshold


def test_threshold_from_topology():
    from repro_torch.core.backends.threadpool import (
        DISPATCH_THRESHOLD, threshold_from_topology)
    assert threshold_from_topology(None) is None
    assert threshold_from_topology(make_topology("flat", 2)) is None
    assert threshold_from_topology(
        make_topology("flat", 2, flops_per_s=1e9)) == DISPATCH_THRESHOLD



def test_launch_counter_is_thread_safe():
    """Pool workers count kernel launches concurrently: with a tiny switch
    interval, an unlocked ``+= 1`` would lose updates."""
    import sys
    import threading

    from repro_torch.kernels import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per_thread = 16, 2000

    def work():
        for _ in range(per_thread):
            count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per_thread
