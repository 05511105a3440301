"""The port's chain route against the reference's Pallas chain kernel.

``ExecutableCache.lookup_chain_pallas`` resolves a width-1 chain of a
kernel-tagged body to one chain-kernel launch; on CPU tensors the kernels'
wrappers compute their plain version (a per-level loop of the same body),
which is what runs here.  It is held against the reference's
``lookup_chain_pallas(interpret=True)`` — the Pallas kernel run in
interpret mode, as the reference's own tests run it — for ``scan_step``,
``gemm_tile`` and ``attn_step`` in every layout the kernels take, float32,
from the same NumPy inputs.  Tolerances: ``scan_step`` rtol 1e-6 (XLA may
contract ``a*y + x`` into one FMA where eager PyTorch rounds twice, so
exact equality across frameworks is not promised); ``gemm_tile`` and
``attn_step`` rtol 1e-5 (the two sum the products in different orders).

The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them bitwise against the same plain version.  Here the operand
checks, the body-to-kernel map and the launch counters are pinned.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_bind
from repro.kernels.flash_attention.ops import attn_step as ref_attn_step
from repro.kernels.gemm.ops import gemm_tile as ref_gemm_tile
from repro.kernels.linear_scan.ops import scan_step as ref_scan_step
from repro_torch import core as port_bind
from repro_torch.kernels.chain import kernel, ops, ref
from repro_torch.kernels.flash_attention.ops import attn_step
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.ops import gemm_tile
from repro_torch.kernels.linear_scan.ops import scan_step
from test_torch_gemm import _includes, extern_c_symbols

N_LEVELS = 4
SCAN_LAYOUTS = list(itertools.product(("single", "xs", "const", "xs_const"),
                                      repeat=2))
DOT_LAYOUTS = list(itertools.product(("single", "xs"), repeat=2))
ATTN_LAYOUTS = list(itertools.product(("single", "xs"), repeat=3))
WRAPPERS = (ops.chain_ewise, ops.chain_dot, ops.chain_attn)


@pytest.fixture(autouse=True)
def _zero_counters():
    for wrapper in WRAPPERS:
        wrapper.launches = 0
    yield
    # a CPU call computes the plain version and never launches a kernel
    assert [w.launches for w in WRAPPERS] == [0, 0, 0]


def _operand(rng, layout, shape, const):
    """One exterior operand as NumPy (or a Python scalar for ``const``)."""
    if layout == "const":
        return const
    if layout == "xs_const":
        return rng.uniform(-1.5, 1.5, size=N_LEVELS).astype(np.float32)
    lead = (N_LEVELS,) if layout == "xs" else ()
    return rng.normal(size=lead + shape).astype(np.float32)


def _both(layout, values):
    """The same call arguments for the reference (jax) and the port."""
    ref_args = [v if lay == "const" else jnp.asarray(v)
                for lay, v in zip(layout, values)]
    port_args = [v if lay == "const" else torch.from_numpy(v)
                 for lay, v in zip(layout, values)]
    return ref_args, port_args


@pytest.mark.parametrize("la, lx", SCAN_LAYOUTS,
                         ids=[f"{a}-{x}" for a, x in SCAN_LAYOUTS])
def test_scan_step_chain_matches_reference(la, lx):
    rng = np.random.default_rng(len(la) * 10 + len(lx))
    shape = (6, 5)
    layout = ("single", la, lx)
    values = [rng.normal(size=shape).astype(np.float32),
              _operand(rng, la, shape, 0.75),
              _operand(rng, lx, shape, -0.25)]
    ref_args, port_args = _both(layout, values)
    exp = ref_bind.ExecutableCache().lookup_chain_pallas(
        ref_scan_step, layout, N_LEVELS, 0, ref_args,
        interpret=True)(*ref_args)
    assert ops.problem(scan_step, layout, 0, N_LEVELS, port_args) is None
    got = port_bind.ExecutableCache().lookup_chain_pallas(
        scan_step, layout, N_LEVELS, 0, port_args)(*port_args)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                               atol=1e-6)
    # the plain version is per-level serial replay of the body, exactly
    serial = port_args[0]
    for level in range(N_LEVELS):
        step = [a[level] if lay in ("xs", "xs_const") else a
                for lay, a in zip(layout, port_args)]
        serial = scan_step(serial, *step[1:])
    assert torch.equal(got, serial)


@pytest.mark.parametrize("la, lb", DOT_LAYOUTS,
                         ids=[f"{a}-{b}" for a, b in DOT_LAYOUTS])
def test_gemm_tile_chain_matches_reference(la, lb):
    rng = np.random.default_rng(7)
    m, k, n = 8, 6, 7
    layout = ("single", la, lb)
    values = [rng.normal(size=(m, n)).astype(np.float32),
              _operand(rng, la, (m, k), None),
              _operand(rng, lb, (k, n), None)]
    ref_args, port_args = _both(layout, values)
    exp = ref_bind.ExecutableCache().lookup_chain_pallas(
        ref_gemm_tile, layout, N_LEVELS, 0, ref_args,
        interpret=True)(*ref_args)
    assert ops.problem(gemm_tile, layout, 0, N_LEVELS, port_args) is None
    got = port_bind.ExecutableCache().lookup_chain_pallas(
        gemm_tile, layout, N_LEVELS, 0, port_args)(*port_args)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("lq, lk, lv", ATTN_LAYOUTS,
                         ids=["-".join(lay) for lay in ATTN_LAYOUTS])
def test_attn_step_chain_matches_reference(lq, lk, lv):
    rng = np.random.default_rng(11)
    m, n, d, dv = 6, 9, 4, 5
    layout = ("single", lq, lk, lv)
    values = [rng.normal(size=(m, dv)).astype(np.float32),
              _operand(rng, lq, (m, d), None),
              _operand(rng, lk, (n, d), None),
              _operand(rng, lv, (n, dv), None)]
    ref_args, port_args = _both(layout, values)
    exp = ref_bind.ExecutableCache().lookup_chain_pallas(
        ref_attn_step, layout, N_LEVELS, 0, ref_args,
        interpret=True)(*ref_args)
    assert ops.problem(attn_step, layout, 0, N_LEVELS, port_args) is None
    got = port_bind.ExecutableCache().lookup_chain_pallas(
        attn_step, layout, N_LEVELS, 0, port_args)(*port_args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-5,
                               atol=1e-5)
    # per-level replay of attn_step (what serial runs) equals the chain
    assert torch.equal(got, ref.run_levels(attn_step, layout, 0, N_LEVELS,
                                           port_args))


def test_bodies_map_to_their_kernels():
    assert ops.chain_for(scan_step) is ops.chain_ewise
    assert ops.chain_for(gemm_tile) is ops.chain_dot
    assert ops.chain_for(attn_step) is ops.chain_attn
    assert ops.chain_for(lambda y, a, x: a * y + x) is None
    with pytest.raises(ValueError, match="no chain kernel"):
        port_bind.ExecutableCache().lookup_chain_pallas(
            lambda y: y, ("single",), 2, 0, [torch.ones(2)])


def _scan_args():
    return [torch.ones(4, 3), 0.5, torch.ones(N_LEVELS, 4, 3)]


@pytest.mark.parametrize("edit, reason", [
    (lambda a, l: ([a[0].half()] + a[1:], l), "dtype"),
    (lambda a, l: ([a[0].int()] + a[1:], l), "dtype"),
    (lambda a, l: ([a[0].t()] + a[1:], l), "not contiguous"),
    (lambda a, l: (a[:2] + [torch.ones(N_LEVELS, 4, 3).double()], l),
     "float64"),
    (lambda a, l: (a[:2] + [torch.ones(3, 4, 3)], l), "shape"),
    (lambda a, l: (a[:2] + [np.ones((N_LEVELS, 4, 3))], l), "ndarray"),
    (lambda a, l: (a[:1] + [1 + 2j, a[2]], l), "complex"),
    (lambda a, l: (a[:1] + [2 ** 60, a[2]], l), "exact"),
    (lambda a, l: ([0.5, 0.5, a[0]], ("const", "const", "single")),
     "both constants"),
    (lambda a, l: (a, ("single", "const", "flat")), "layout"),
])
def test_ewise_problem_names_what_the_kernel_does_not_take(edit, reason):
    layout = ("single", "const", "xs")
    args, layout2 = edit(_scan_args(), layout)
    carry_pos = 2 if layout2 == ("const", "const", "single") else 0
    bad = ops.ewise_problem(layout2, carry_pos, N_LEVELS, args)
    assert bad is not None and reason in bad, bad
    with pytest.raises(ValueError, match="chain_ewise"):
        ops.chain_ewise(layout2, carry_pos, N_LEVELS, *args)


def test_dot_problem_names_what_the_kernel_does_not_take():
    c, a, b = torch.ones(4, 4), torch.ones(4, 3), torch.ones(3, 4)
    ok = ("single", "single", "single")
    assert ops.dot_problem(ok, 0, 2, (c, a, b)) is None
    assert "shape" in ops.dot_problem(ok, 0, 2, (c, a, torch.ones(2, 4)))
    assert "carry" in ops.dot_problem(ok, 1, 2, (a, c, b))
    assert "layout" in ops.dot_problem(("single", "const", "single"), 0, 2,
                                       (c, 0.5, b))
    assert "float64" in ops.dot_problem(ok, 0, 2, (c, a.double(), b))
    assert ops.dot_problem(("single", "xs", "single"), 0, 2,
                           (c, torch.ones(2, 4, 3), b)) is None


def _attn_args(levels=N_LEVELS):
    return [torch.ones(4, 3), torch.ones(4, 2), torch.ones(levels, 5, 2),
            torch.ones(levels, 5, 3)]


@pytest.mark.parametrize("edit, reason", [
    (lambda a, l: (a, ("single", "const", "xs", "xs")), "layout"),
    (lambda a, l: (a, ("single", "single", "xs_const", "xs")), "layout"),
    (lambda a, l: (a[:3], l), "expected 4 operands"),
    (lambda a, l: ([a[0][0]] + a[1:], l), "not a matrix"),
    (lambda a, l: ([a[0].half()] + a[1:], l), "dtype"),
    (lambda a, l: (a[:1] + [a[1].double()] + a[2:], l), "float64"),
    (lambda a, l: (a[:1] + [torch.ones(4, 3)] + a[2:], l), "shape"),
    (lambda a, l: (a[:3] + [torch.ones(N_LEVELS, 5, 4)], l), "shape"),
    (lambda a, l: (a[:2] + [torch.ones(3, 5, 2)] + a[3:], l), "shape"),
    (lambda a, l: (a[:2] + [a[2][0]] + a[3:], l), "shape"),
    (lambda a, l: (a[:1] + [torch.ones(4, 2).t().contiguous().t()] + a[2:],
                   l), "not contiguous"),
    (lambda a, l: (a[:1] + [a[1].numpy()] + a[2:], l), "ndarray"),
    (lambda a, l: ([torch.ones(4, 300)] + a[1:3]
                   + [torch.ones(N_LEVELS, 5, 300)], l), "dv = 300"),
    (lambda a, l: ([a[0], torch.ones(4, 0), torch.ones(N_LEVELS, 5, 0),
                    a[3]], l), "d = 0"),
])
def test_attn_problem_names_what_the_kernel_does_not_take(edit, reason):
    layout = ("single", "single", "xs", "xs")
    assert ops.attn_problem(layout, 0, N_LEVELS, _attn_args()) is None
    args, layout2 = edit(_attn_args(), layout)
    bad = ops.attn_problem(layout2, 0, N_LEVELS, args)
    assert bad is not None and reason in bad, bad
    with pytest.raises(ValueError, match="chain_attn"):
        ops.chain_attn(layout2, 0, N_LEVELS, *args)
    assert ops.attn_problem(layout, 1, N_LEVELS, _attn_args()) is not None


def _run_attn_chain(bind, attn, arr, backend):
    """An ``attn_step`` chain of N_LEVELS levels (q shared, fresh k and v
    per level) recorded through ``bind`` and run under ``backend``."""
    rng = np.random.default_rng(5)

    def array(*shape):
        return wf.array(arr(rng.normal(size=shape).astype(np.float32)))

    ex = bind.LocalExecutor(1, mode="plan", backend=backend)
    with bind.Workflow(n_nodes=1, executor=ex) as wf:
        o, q = array(8, 6), array(8, 4)
        for _ in range(N_LEVELS):
            wf.call(attn, (o, q, array(7, 4), array(7, 6)), name="attn_step")
        out = wf.fetch(o)
    return np.asarray(out)


def test_attn_step_workflow_is_one_chain_kernel_dispatch():
    """Under ``MeshBackend(pallas=True)`` the attn_step chain is one chain
    dispatch with the reference mesh backend's counters; the port's values
    equal its serial replay bit for bit and the reference's within 1e-5."""
    ref_mb = ref_bind.MeshBackend(pallas=True)
    exp = _run_attn_chain(ref_bind, ref_attn_step, jnp.asarray, ref_mb)
    port_mb = port_bind.MeshBackend(pallas=True)
    got = _run_attn_chain(port_bind, attn_step, torch.from_numpy, port_mb)
    names = ("pallas_chains_dispatched", "ops_pallas", "chains_dispatched",
             "ops_chained")
    assert ({n: getattr(port_mb, n) for n in names}
            == {n: getattr(ref_mb, n) for n in names})
    assert port_mb.pallas_chains_dispatched == 1
    assert port_mb.ops_pallas == N_LEVELS
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
    serial = _run_attn_chain(port_bind, attn_step, torch.from_numpy,
                             "serial")
    np.testing.assert_array_equal(got, serial)


def test_batched_operands_are_refused():
    def body(y, x):
        return ops.chain_ewise(("single", "const", "single"), 0, 2, y, 0.5,
                               x)
    with pytest.raises(ValueError, match="batched"):
        torch.func.vmap(body)(torch.ones(3, 4), torch.ones(3, 4))


def test_plain_version_is_the_per_level_body():
    y, x = torch.linspace(-1, 1, 6), torch.ones(3, 6)
    got = ref.chain_ewise(("single", "const", "xs"), 0, 3, y, 0.5, x)
    exp = y
    for level in range(3):
        exp = 0.5 * exp + x[level]
    assert torch.equal(got, exp)


def test_library_name_tracks_sources_and_the_shared_header():
    path = kernel.LIBRARY.path()
    assert path.name.startswith("libbind_chain_") and path.suffix == ".so"
    headers = {h.resolve() for h in kernel.LIBRARY.headers}
    assert _includes(kernel.SOURCES[0]) <= headers
    assert {"gemm_routes.cuh", "gemm_tile.cuh", "gemm_wgmma.cuh",
            "gemm_dmma.cuh"} <= {h.name for h in headers}
    assert set(kernel.SUFFIX) == set(ops.DTYPES)
    syms = set(kernel.LIBRARY.symbols)
    assert {f"bind_chain_ewise_{s}" for s in kernel.SUFFIX.values()} <= syms
    assert {f"bind_chain_dot_{s}" for s in kernel.SUFFIX.values()} <= syms
    assert {f"bind_chain_attn_{s}" for s in kernel.SUFFIX.values()} <= syms
    assert any(h.name == "attn_tile.cuh" for h in kernel.LIBRARY.headers)


def test_every_bound_symbol_is_an_extern_c_entry_point():
    """Static: each C symbol the wrapper binds is defined in the source's
    ``extern "C"`` block (no nvcc needed)."""
    assert set(kernel.LIBRARY.symbols) == extern_c_symbols(kernel.SOURCES[0])


def _levels(store, offset, lead, shape):
    """A contiguous (lead + shape) view ``offset`` elements into ``store``."""
    n = int(np.prod(lead + shape))
    return store[offset:offset + n].view(lead + shape)


@pytest.mark.parametrize("dname", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "odd-offset"])
@pytest.mark.parametrize("m, k, n", [(64, 64, 64), (130, 72, 264),
                                     (130, 70, 260), (1, 128, 1)])
@pytest.mark.parametrize("la, lb", DOT_LAYOUTS,
                         ids=[f"{a}-{b}" for a, b in DOT_LAYOUTS])
def test_chain_route_is_the_route_of_every_replayed_level(la, lb, m, k, n,
                                                          offset, dname):
    """``chain_dot`` must take, for its whole chain, the GEMM route that
    per-level replay (``gemm_tile`` -> ``matmul_accumulate``) takes at each
    level, or the two would not be bitwise equal."""
    dt = getattr(torch, dname)
    levels = 3
    store = torch.zeros(levels * (m * k + k * n) + 16, dtype=dt)
    a = _levels(store, offset, (levels,) if la == "xs" else (), (m, k))
    rest = store[a.numel() + offset:]
    b = _levels(rest, 0, (levels,) if lb == "xs" else (), (k, n))
    c = torch.zeros((m, n), dtype=dt)
    layout = ("single", la, lb)
    assert ops.dot_problem(layout, 0, levels, (c, a, b)) is None
    chain = ops.dot_route(layout, levels, c, a, b)
    replay = set()
    for level in range(levels):
        a_l = a[level] if la == "xs" else a
        b_l = b[level] if lb == "xs" else b
        replay.add(gemm_ops.route(dt, m, n, k,
                                  (a_l.data_ptr(), b_l.data_ptr())))
    assert replay == {chain}
