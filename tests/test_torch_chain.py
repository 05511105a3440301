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

import contextlib
import itertools
import re

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


# float16 chains: the reference's Pallas chain kernel computes each body
# in float16 as XLA does (which may keep a*y + x in float32 and round once,
# or round a @ b and softmax's output to float16 before the next operator),
# the port's plain version rounds where eager PyTorch does (scan_step after
# each operator, gemm_tile and attn_step once from the float32 sum): they
# differ by at most 1.34e-3 of the output's largest magnitude (one or two
# float16 ulps of it) at N_LEVELS levels, where the same chain computed in
# bfloat16 is 2.1e-3 to 9.5e-3 away: F16_TOL lies between
F16_TOL = 2e-3


def _f16(values):
    return [v.astype(np.float16) if isinstance(v, np.ndarray) else v
            for v in values]


F16_CASES = (
    [("scan_step", ("single", la, lx)) for la, lx in
     (("single", "xs"), ("const", "xs"), ("xs", "const"),
      ("xs_const", "single"))]
    + [("gemm_tile", ("single", la, lb)) for la, lb in DOT_LAYOUTS]
    + [("attn_step", ("single",) + lay) for lay in
       (("single", "xs", "xs"), ("xs", "xs", "xs"),
        ("single", "single", "single"))])


@pytest.mark.parametrize("body, layout", F16_CASES,
                         ids=[f"{b}-{'-'.join(lay[1:])}"
                              for b, lay in F16_CASES])
def test_float16_chains_match_reference(body, layout):
    """A float16 chain of each body is one chain-kernel dispatch (its plain
    version on the CPU), within F16_TOL of the output's largest magnitude
    of the reference's ``lookup_chain_pallas(interpret=True)`` on the same
    float16 inputs, where the chain computed in bfloat16 is not, and bit
    for bit the port's per-level replay of the body."""
    rng = np.random.default_rng(23)
    if body == "scan_step":
        shape = (6, 5)
        values = [rng.normal(size=shape).astype(np.float32),
                  _operand(rng, layout[1], shape, 0.75),
                  _operand(rng, layout[2], shape, -0.25)]
        fns = (ref_scan_step, scan_step)
    elif body == "gemm_tile":
        m, k, n = 8, 6, 7
        values = [rng.normal(size=(m, n)).astype(np.float32),
                  _operand(rng, layout[1], (m, k), None),
                  _operand(rng, layout[2], (k, n), None)]
        fns = (ref_gemm_tile, gemm_tile)
    else:
        m, n, d, dv = 6, 9, 4, 5
        values = [rng.normal(size=(m, dv)).astype(np.float32),
                  _operand(rng, layout[1], (m, d), None),
                  _operand(rng, layout[2], (n, d), None),
                  _operand(rng, layout[3], (n, dv), None)]
        fns = (ref_attn_step, attn_step)
    ref_args, port_args = _both(layout, _f16(values))
    exp = ref_bind.ExecutableCache().lookup_chain_pallas(
        fns[0], layout, N_LEVELS, 0, ref_args, interpret=True)(*ref_args)
    assert ops.problem(fns[1], layout, 0, N_LEVELS, port_args) is None
    got = port_bind.ExecutableCache().lookup_chain_pallas(
        fns[1], layout, N_LEVELS, 0, port_args)(*port_args)
    assert got.dtype == torch.float16 and np.asarray(exp).dtype == np.float16
    assert tuple(got.shape) == np.asarray(exp).shape
    exp = np.asarray(exp, np.float64)
    scale = np.abs(exp).max()
    err = np.abs(got.double().numpy() - exp).max()
    assert err <= F16_TOL * scale, (err, scale)
    replay = ref.run_levels(fns[1], layout, 0, N_LEVELS, port_args)
    assert torch.equal(got.view(torch.int16), replay.view(torch.int16))
    # the same chain computed in bfloat16 falls outside F16_TOL: it tells
    # float16 from the next lower precision
    in_bf16 = ref.run_levels(fns[1], layout, 0, N_LEVELS,
                             [a.bfloat16() if isinstance(a, torch.Tensor)
                              else a for a in port_args])
    assert np.abs(in_bf16.half().double().numpy() - exp).max() > \
        F16_TOL * scale


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
    (lambda a, l: ([a[0].to(torch.complex64)] + a[1:], l), "dtype"),
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
    (lambda a, l: ([a[0].to(torch.complex64)] + a[1:], l), "dtype"),
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


@pytest.mark.parametrize("stem", ["bind_chain_ewise_", "bind_chain_dot_",
                                  "bind_chain_attn_"])
def test_bound_arity_is_the_entry_points(stem):
    """Static: ctypes passes as many arguments as the C entry point takes
    (``chain_attn``'s carry the workspace and the row-tile counters)."""
    params = re.search(rf"int {stem}##SUFFIX\((.*?)\)",
                       kernel.SOURCES[0].read_text(), re.S).group(1)
    for sym, argtypes in kernel.LIBRARY.symbols.items():
        if sym.startswith(stem):
            assert params.count(",") + 1 == len(argtypes), sym


def test_row_tile_counters_grow_and_stay_zero_under_threads():
    """The per-(device, stream) counter buffers: every caller gets zeros
    covering what it asked for, whatever the other threads ask for at the
    same time, and a buffer only ever grows."""
    import random
    import sys
    import threading

    device, stream = torch.device("cpu"), 7
    kernel._COUNTERS.pop((device.index, stream), None)
    bad, asked = [], []

    def worker(seed):
        rnd = random.Random(seed)
        for _ in range(200):
            tiles = rnd.randrange(1, 5000)
            asked.append(tiles)
            buf = kernel.row_tile_counters(device, stream, tiles)
            if buf.numel() < tiles or bool(buf.any()):
                bad.append((tiles, buf.numel()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    kept = kernel._COUNTERS.pop((device.index, stream))
    assert kept.numel() >= max(asked) and not kept.any()


def _level_parallel(layout, n_levels, o, q, k, v):
    """The decomposition the level-parallel ``chain_attn`` kernel runs: each
    level's ``softmax(q kᵀ / √d) v`` in the accumulator type, computed
    without reading the carry (all levels at once), then added into the
    carry in level order, rounded to its dtype after each level."""
    acc = torch.float64 if o.dtype == torch.float64 else torch.float32

    def level(t, lay, lv):
        return (t[lv] if lay == "xs" else t).to(acc)

    scale = 1.0 / float(q.shape[-1]) ** 0.5
    work = [torch.softmax((level(q, layout[1], lv)
                           @ level(k, layout[2], lv).T) * scale, dim=-1)
            @ level(v, layout[3], lv) for lv in range(n_levels)]
    carry = o
    for w in work:
        carry = (carry.to(acc) + w).to(o.dtype)
    return carry


@pytest.mark.parametrize("dname", ["float32", "bfloat16", "float64",
                                   "float16"])
@pytest.mark.parametrize("lq, lk, lv", ATTN_LAYOUTS,
                         ids=["-".join(lay) for lay in ATTN_LAYOUTS])
def test_levels_are_independent_of_the_carry(lq, lk, lv, dname):
    """A level's ``acc / l`` reads only that level's q, k and v: computing
    every level first and summing into the carry in order afterwards is
    bitwise equal to per-level ``attn_step`` replay, in every dtype."""
    dt = getattr(torch, dname)
    rng = np.random.default_rng(5)
    m, n, d, dv = 7, 11, 6, 5
    layout = ("single", lq, lk, lv)
    args = [torch.from_numpy(rng.normal(size=(m, dv))).to(dt)]
    for lay, shape in zip(layout[1:], ((m, d), (n, d), (n, dv))):
        lead = (N_LEVELS,) if lay == "xs" else ()
        args.append(torch.from_numpy(rng.normal(size=lead + shape)).to(dt))
    replay = ref.run_levels(attn_step, layout, 0, N_LEVELS, args)
    got = _level_parallel(layout, N_LEVELS, *args)
    assert got.dtype == dt
    assert torch.equal(got.view(torch.uint8), replay.view(torch.uint8))
    # the carry moves: the sum really is over the levels, in order
    assert not torch.equal(replay, args[0])


def _levels(store, offset, lead, shape):
    """A contiguous (lead + shape) view ``offset`` elements into ``store``."""
    n = int(np.prod(lead + shape))
    return store[offset:offset + n].view(lead + shape)


@pytest.mark.parametrize("dname", ["float32", "bfloat16", "float64",
                                   "float16"])
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


@pytest.mark.parametrize("dname", ["float32", "bfloat16", "float64",
                                   "float16"])
@pytest.mark.parametrize("m, dv, n_levels", [(512, 128, 16), (512, 128, 300),
                                             (8192, 128, 1024), (1, 1, 70000),
                                             (7, 5, 1)])
def test_level_runs_bound_the_workspace(m, dv, n_levels, dname):
    """A chain's launches cover its levels in order, each within
    ``WORKSPACE_BYTES`` of workspace (or one level) and the grid's y."""
    dtype = getattr(torch, dname)
    acc_bytes = 8 if dtype == torch.float64 else 4
    runs = kernel.level_runs(m, dv, dtype, n_levels)
    assert [first for first, _ in runs] == list(
        itertools.accumulate([0] + [n for _, n in runs[:-1]]))
    assert sum(n for _, n in runs) == n_levels
    for _, n in runs:
        assert 1 <= n <= kernel.MAX_LEVELS_PER_LAUNCH
        assert n == 1 or n * m * dv * acc_bytes <= kernel.WORKSPACE_BYTES
    # as few launches as the bound allows: every run but the last is full
    assert len({n for _, n in runs[:-1]}) <= 1
    assert runs[-1][1] <= runs[0][1]
    if n_levels * m * dv * acc_bytes <= kernel.WORKSPACE_BYTES and \
            n_levels <= kernel.MAX_LEVELS_PER_LAUNCH:
        assert runs == [(0, n_levels)]


@pytest.mark.parametrize("per_launch, n_levels", [(16, 16), (6, 16), (5, 15),
                                                  (1, 3)])
@pytest.mark.parametrize("lq, lk, lv", [("single", "xs", "xs"),
                                        ("xs", "xs", "single")])
def test_launches_hand_the_carry_on(monkeypatch, per_launch, n_levels, lq,
                                    lk, lv):
    """Static (no nvcc): a chain longer than one launch's workspace is
    launches of at most that many levels, each reading the carry the last
    one wrote and writing the other buffer, the last writing ``out``; each
    launch's q, k and v start at its first level."""
    m, n, d, dv = 4, 3, 2, 5
    monkeypatch.setattr(kernel, "WORKSPACE_BYTES", per_launch * m * dv * 4)
    monkeypatch.setattr(kernel, "on_device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernel, "_stream", lambda t: 0)
    monkeypatch.setattr(kernel, "row_tile_counters",
                        lambda device, stream, tiles:
                        torch.zeros(tiles, dtype=torch.int32))
    calls = []
    monkeypatch.setattr(kernel.LIBRARY, "call",
                        lambda sym, *args: calls.append((sym, args)))
    o, out = torch.zeros(m, dv), torch.zeros(m, dv)
    operands = {}
    for name, lay, shape in (("q", lq, (m, d)), ("k", lk, (n, d)),
                             ("v", lv, (n, dv))):
        lead = (n_levels,) if lay == "xs" else ()
        t = torch.zeros(lead + shape)
        operands[name] = (t, t[0].numel() if lay == "xs" else 0)
    (q, qs), (k, ks), (v, vs) = operands.values()
    launches = kernel.launch_attn(out, o, q, qs, k, ks, v, vs, n_levels)
    runs = kernel.level_runs(m, dv, torch.float32, n_levels)
    assert launches == len(calls) == len(runs) == -(-n_levels // per_launch)
    carry = o.data_ptr()
    work = None
    for (sym, args), (first, levels) in zip(calls, runs):
        (o_ptr, q_ptr, q_stride, k_ptr, k_stride, v_ptr, v_stride, dst,
         work_ptr, _done, mm, nn, dd, ddv, lv_count, _scale, _st) = args
        assert sym == "bind_chain_attn_f32"
        assert o_ptr == carry and dst != o_ptr
        assert (q_ptr, k_ptr, v_ptr) == (q.data_ptr() + first * qs * 4,
                                         k.data_ptr() + first * ks * 4,
                                         v.data_ptr() + first * vs * 4)
        assert (q_stride, k_stride, v_stride) == (qs, ks, vs)
        assert (mm, nn, dd, ddv, lv_count) == (m, n, d, dv, levels)
        assert work in (None, work_ptr)
        work, carry = work_ptr, dst
    assert carry == out.data_ptr()


@pytest.mark.parametrize("dname", ["float32", "bfloat16", "float64",
                                   "float16"])
def test_runs_of_levels_equal_one_chain(dname):
    """The carry a launch hands on is the carry in its own dtype, which the
    kernel rounds to after every level anyway: a chain cut into runs of
    levels, each started from the last one's result, is bitwise the whole
    chain, and so per-level ``attn_step`` replay."""
    dt = getattr(torch, dname)
    rng = np.random.default_rng(9)
    m, n, d, dv, levels = 7, 11, 6, 5, 10
    layout = ("single", "single", "xs", "xs")
    o = torch.from_numpy(rng.normal(size=(m, dv))).to(dt)
    q = torch.from_numpy(rng.normal(size=(m, d))).to(dt)
    k = torch.from_numpy(rng.normal(size=(levels, n, d))).to(dt)
    v = torch.from_numpy(rng.normal(size=(levels, n, dv))).to(dt)
    whole = _level_parallel(layout, levels, o, q, k, v)
    carry = o
    for first in range(0, levels, 3):
        count = min(3, levels - first)
        carry = _level_parallel(layout, count, carry, q,
                                k[first:first + count], v[first:first + count])
    assert torch.equal(carry.view(torch.uint8), whole.view(torch.uint8))
    replay = ref.run_levels(attn_step, layout, 0, levels, (o, q, k, v))
    assert torch.equal(whole.view(torch.uint8), replay.view(torch.uint8))


# ---------------------------------------------------------------------------
# chain_ewise: one kernel per layout
# ---------------------------------------------------------------------------

def _ewise_layouts():
    """Every layout ``ewise_problem`` accepts: the carry at each position,
    the other two operands in every kind (y and a not both constants)."""
    for carry_pos in range(3):
        for k1, k2 in SCAN_LAYOUTS:
            layout = [k1, k2]
            layout.insert(carry_pos, "single")
            if layout[0] == layout[1] == "const":
                continue
            yield tuple(layout), carry_pos


def _ewise_operands(layout, carry_pos, n_levels=3, shape=(4, 5)):
    out = []
    for pos, lay in enumerate(layout):
        if pos == carry_pos or lay == "single":
            out.append(torch.ones(shape))
        elif lay == "xs":
            out.append(torch.ones((n_levels,) + shape))
        elif lay == "const":
            out.append(0.5)
        else:
            out.append(torch.ones(n_levels))
    return tuple(out)


def _ewise_table(src: str) -> dict:
    """csrc/chain.cu's layout-to-kernel table, read from the source: the
    class of each kind (``ewise_class``), the carry positions
    ``launch_ewise`` instantiates, whether it swaps a carry at position 1
    onto 0, and the classes each picker dispatches on."""
    kinds = {name: int(v) for name, v in re.findall(
        r"constexpr int (CARRY|SINGLE|XS|CONST|XS_CONST) = (\d);", src)}
    classes = {name: int(v) for name, v in re.findall(
        r"constexpr int C_(CARRY|HELD|XS|XS_CONST) = (\d);", src)}
    body = re.search(r"inline int ewise_class\(int k\) \{(.*?)\n\}", src,
                     re.S).group(1)
    mapped = dict(re.findall(r"case (\w+): return C_(\w+);", body))
    default = re.search(r"default: return C_(\w+);", body).group(1)
    launch = re.search(r"int launch_ewise\((.*?)\n\}", src, re.S).group(1)
    pickers = {}
    for picker in ("ewise_pick_a", "ewise_pick_b"):
        body = re.search(rf"cudaError_t {picker}\((.*?)\n\}}", src,
                         re.S).group(1)
        pickers[picker] = {classes[c] for c in
                           re.findall(r"case C_(\w+):", body)}
    return {
        "kinds": kinds, "classes": classes,
        "class_of": {kind.lower(): classes[mapped.get(kind, default)]
                     for kind in kinds},
        "carry_positions": {int(p) for p in
                            re.findall(r"ewise_pick_a<T, (\d)>", launch)},
        "swaps_1_onto_0": bool(re.search(
            r"if \(carry_pos == 1\) \{\s*const Operand y = o\[0\];\s*"
            r"o\[0\] = o\[1\];\s*o\[1\] = y;\s*carry_pos = 0;", launch)),
        "pickers": pickers}


def test_ewise_instantiations_cover_every_layout_ops_takes():
    """Every layout ``chain/ops.py`` takes has a kernel in csrc/chain.cu's
    table (:func:`_ewise_table`): the carry at position 0 or 2 (a carry at
    1 swapped onto 0: ``y * a`` and ``a * y`` round alike), the other two
    positions in classes the pickers dispatch on.  The 47 layouts fall on
    18 kernels a dtype, all that the launcher instantiates."""
    table = _ewise_table(kernel.SOURCES[0].read_text())
    assert table["swaps_1_onto_0"]
    assert table["carry_positions"] == {0, 2}
    seen = set()
    layouts = list(_ewise_layouts())
    assert len(layouts) == 47
    for layout, carry_pos in layouts:
        args = _ewise_operands(layout, carry_pos)
        assert ops.ewise_problem(layout, carry_pos, 3, args) is None, layout
        layout = list(layout)
        if carry_pos == 1:
            layout[0], layout[1], carry_pos = layout[1], layout[0], 0
        assert carry_pos in table["carry_positions"], layout
        others = [table["class_of"][lay] for pos, lay in enumerate(layout)
                  if pos != carry_pos]
        assert others[0] in table["pickers"]["ewise_pick_a"], layout
        assert others[1] in table["pickers"]["ewise_pick_b"], layout
        seen.add((carry_pos, *others))
    classes = table["pickers"]["ewise_pick_a"]
    assert seen == {(cp, a, b) for cp in (0, 2) for a in classes
                    for b in classes}
    assert len(seen) == 18


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64, torch.float16])
def test_ewise_carry_at_1_is_carry_at_0_with_y_and_a_swapped(dtype):
    """What the launcher's swap rests on, on the plain version: a chain
    whose carry is ``a`` gives the bits of the chain with ``y`` and ``a``
    swapped and the carry at 0, in every dtype and layout."""
    gen = torch.Generator().manual_seed(17)
    for layout, carry_pos in _ewise_layouts():
        if carry_pos != 1:
            continue
        args = []
        for pos, lay in enumerate(layout):
            if pos == carry_pos or lay == "single":
                args.append(torch.rand((6, 7), generator=gen) - 0.5)
            elif lay == "xs":
                args.append(torch.rand((5, 6, 7), generator=gen) - 0.5)
            elif lay == "const":
                args.append(0.3)
            else:
                args.append(torch.rand(5, generator=gen) - 0.5)
        args = [x.to(dtype) if isinstance(x, torch.Tensor) else x
                for x in args]
        got = ref.chain_ewise(layout, 1, 5, *args)
        swapped = (layout[1], layout[0], layout[2])
        want = ref.chain_ewise(swapped, 0, 5, args[1], args[0], args[2])
        assert torch.equal(got, want), layout


def test_ewise_classes_are_the_kernels_numbering():
    """kernel.py's kinds are the ones csrc/chain.cu numbers, and its
    kind-to-class map sends the carry to C_CARRY, a single tensor and a
    constant to C_HELD (read before the level loop), xs and xs_const to
    their own classes; both pickers dispatch on the three non-carry
    classes."""
    table = _ewise_table(kernel.SOURCES[0].read_text())
    assert {k.lower(): v for k, v in table["kinds"].items()} == kernel.KINDS
    c = table["classes"]
    assert c == {"CARRY": 0, "HELD": 1, "XS": 2, "XS_CONST": 3}
    assert table["class_of"] == {"carry": c["CARRY"], "single": c["HELD"],
                                 "const": c["HELD"], "xs": c["XS"],
                                 "xs_const": c["XS_CONST"]}
    for picker in ("ewise_pick_a", "ewise_pick_b"):
        assert table["pickers"][picker] == {c["HELD"], c["XS"],
                                            c["XS_CONST"]}, picker
