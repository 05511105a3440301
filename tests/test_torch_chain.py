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


@pytest.mark.parametrize("route", ["f32_simt", "f32_3xtf32"])
@pytest.mark.parametrize("per_launch, n_levels", [(16, 16), (6, 16), (5, 15),
                                                  (1, 3)])
@pytest.mark.parametrize("lq, lk, lv", [("single", "xs", "xs"),
                                        ("xs", "xs", "single")])
def test_launches_hand_the_carry_on(monkeypatch, per_launch, n_levels, lq,
                                    lk, lv, route):
    """Static (no nvcc): a chain longer than one launch's workspace is
    launches of at most that many levels, each reading the carry the last
    one wrote and writing the other buffer, the last writing ``out``; each
    launch's q, k and v start at its first level.  On a tensor-core route
    every launch takes the same chunks (the level's, whatever its run) and
    counters for its row tiles and levels."""
    m, n, d, dv = 4, 100, 32, 32
    chunks = kernel.attn_chunks(route, m, n, d)
    assert (chunks > 1) == (route in kernel.TC_ROUTES)
    per_level = kernel.level_bytes(
        m, dv, torch.float32, chunks if route in kernel.TC_ROUTES else None)
    monkeypatch.setattr(kernel, "WORKSPACE_BYTES", per_launch * per_level)
    monkeypatch.setattr(kernel, "on_device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernel, "_stream", lambda t: 0)
    counters = []
    monkeypatch.setattr(kernel, "row_tile_counters",
                        lambda device, stream, tiles:
                        counters.append(tiles)
                        or torch.zeros(tiles, dtype=torch.int32))
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
    launches = kernel.launch_attn(out, o, q, qs, k, ks, v, vs, n_levels,
                                  route)
    runs = kernel.level_runs(
        m, dv, torch.float32, n_levels,
        chunks if route in kernel.TC_ROUTES else None)
    assert launches == len(calls) == len(runs) == -(-n_levels // per_launch)
    assert counters == [kernel.attn_counters(route, m, runs[0][1])]
    carry = o.data_ptr()
    work = None
    for (sym, args), (first, levels) in zip(calls, runs):
        (o_ptr, q_ptr, q_stride, k_ptr, k_stride, v_ptr, v_stride, dst,
         work_ptr, _done, mm, nn, dd, ddv, lv_count, got_chunks, _scale,
         _st) = args
        assert sym == "bind_chain_attn_f32"
        assert o_ptr == carry and dst != o_ptr
        assert (q_ptr, k_ptr, v_ptr) == (q.data_ptr() + first * qs * 4,
                                         k.data_ptr() + first * ks * 4,
                                         v.data_ptr() + first * vs * 4)
        assert (q_stride, k_stride, v_stride) == (qs, ks, vs)
        assert (mm, nn, dd, ddv, lv_count) == (m, n, d, dv, levels)
        assert got_chunks == chunks
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


# ---------------------------------------------------------------------------
# chain_attn's tensor-core routes (csrc/chain_attn_tc.cuh): the route rule,
# the chunks of a level's keys, and their arithmetic emulated
# ---------------------------------------------------------------------------

def _attn_operands(dtype, layout, m, n, d, dv, levels, offsets=(0, 0, 0)):
    """o, q, k, v of ``dtype``; q, k and v each a contiguous view
    ``offsets`` elements into a storage of its own."""
    out = [torch.zeros((m, dv), dtype=dtype)]
    for lay, shape, off in zip(layout[1:], ((m, d), (n, d), (n, dv)),
                               offsets):
        lead = (levels,) if lay == "xs" else ()
        count = int(np.prod(lead + shape))
        store = torch.zeros(count + 16, dtype=dtype)
        out.append(store[off:off + count].view(lead + shape))
    return out


ROUTE_CASES = [
    # dtype, d, dv, n, offsets (elements), want
    (torch.float32, 128, 128, 512, (0, 0, 0), "f32_3xtf32"),
    (torch.float32, 80, 80, 7, (0, 0, 0), "f32_3xtf32"),
    (torch.float32, 32, 32, 1, (0, 0, 0), "f32_3xtf32"),
    (torch.float32, 256, 256, 64, (0, 0, 0), "f32_simt"),   # d 256's block
    (torch.float32, 192, 192, 64, (0, 0, 0), "f32_simt"),
    (torch.float32, 128, 64, 64, (0, 0, 0), "f32_simt"),    # d != dv
    (torch.float32, 40, 40, 64, (0, 0, 0), "f32_simt"),
    (torch.float32, 128, 128, 64, (1, 0, 0), "f32_simt"),   # q misaligned
    (torch.float32, 128, 128, 64, (0, 0, 2), "f32_simt"),   # v misaligned
    (torch.float32, 128, 128, 64, (4, 4, 4), "f32_3xtf32"),  # 16 bytes in
    (torch.float32, 128, 128, 0, (0, 0, 0), "f32_simt"),    # no key
    (torch.bfloat16, 128, 128, 512, (0, 0, 0), "bf16_wgmma"),
    (torch.bfloat16, 96, 96, 3, (0, 0, 0), "bf16_wgmma"),
    (torch.bfloat16, 256, 256, 64, (0, 0, 0), "bf16_wgmma"),
    (torch.bfloat16, 32, 32, 64, (0, 0, 0), "bf16_simt"),
    (torch.bfloat16, 100, 100, 64, (0, 0, 0), "bf16_simt"),
    (torch.bfloat16, 128, 128, 64, (0, 1, 0), "bf16_simt"),
    (torch.bfloat16, 128, 128, 64, (8, 8, 8), "bf16_wgmma"),
    (torch.float16, 64, 64, 64, (0, 0, 0), "f16_wgmma"),
    (torch.float16, 80, 80, 64, (0, 0, 0), "f16_wgmma"),
    (torch.float16, 128, 64, 64, (0, 0, 0), "f16_simt"),
    (torch.float16, 128, 128, 64, (0, 0, 3), "f16_simt"),
    (torch.float64, 128, 128, 64, (0, 0, 0), "f64_simt"),
]


@pytest.mark.parametrize("dtype, d, dv, n, offsets, want", ROUTE_CASES)
@pytest.mark.parametrize("layout", [("single", "single", "xs", "xs"),
                                    ("single", "xs", "xs", "xs"),
                                    ("single",) * 4],
                         ids=["q-single", "all-xs", "all-single"])
def test_attn_route_by_dtype_head_dim_and_alignment(dtype, d, dv, n,
                                                    offsets, want, layout):
    """``chain_attn``'s route: a tensor-core route for its dtype when d ==
    dv is one of the route's head dims, there is a key, and every level's
    q, k and v starts 16-byte aligned; the CUDA-core loop of the dtype
    otherwise.  The route of the whole chain is the one per-level replay
    takes at every level, and the one every launch's first level (a run
    of levels, offset into the stacks) takes."""
    levels = 3
    o, q, k, v = _attn_operands(dtype, layout, 5, n, d, dv, levels, offsets)
    if any(t.data_ptr() % 16 != (offsets[i] * t.element_size()) % 16
           for i, t in enumerate((q, k, v))):
        pytest.skip("the allocator's storage is not 16-byte aligned")
    assert ops.attn_route(layout, levels, o, q, k, v) == want
    assert want in ops.ATTN_ROUTES
    replay = set()
    for level in range(levels):
        step = [t[level] if lay == "xs" else t
                for lay, t in zip(layout[1:], (q, k, v))]
        replay.add(ops.attn_route(("single",) * 4, 1, o, *step))
        tail = [t[level:] if lay == "xs" else t
                for lay, t in zip(layout[1:], (q, k, v))]
        replay.add(ops.attn_route(layout, levels - level, o, *tail))
    assert replay == {want}


def test_attn_route_sees_every_level_of_a_stack():
    """A level stride that is no multiple of 16 bytes (m d elements of a
    float32 stack at d 1) leaves some levels misaligned: the chain takes
    the CUDA-core loop, as replay of those levels would."""
    o = torch.zeros((5, 1))
    q = torch.zeros((3, 5, 1))
    k, v = torch.zeros((4, 1)), torch.zeros((4, 1))
    addrs = ops.attn_level_addresses(("single", "xs", "single", "single"),
                                     3, q, k, v)
    assert addrs == [q.data_ptr(), q.data_ptr() + 20, q.data_ptr() + 40,
                     k.data_ptr(), v.data_ptr()]
    assert ops.attn_route(("single", "xs", "single", "single"), 3, o, q, k,
                          v) == "f32_simt"


def test_attn_routes_and_head_dims_are_the_c_sources():
    """``ATTN_ROUTES`` lists ``AttnRoute``'s names in its order (the
    launcher's answer indexes it); ``TF32_HEAD_DIMS`` is
    ``chain_tf32_head_dim``'s set; the key tiles, ``MAX_CHUNKS`` and the
    block's rows are those of the C source."""
    cu = kernel.SOURCES[0].read_text()
    enum = re.search(r"enum class AttnRoute : int \{(.*?)\};", cu,
                     re.S).group(1)
    pairs = re.findall(r"(\w+) = (\d+)", enum)
    assert ops.ATTN_ROUTES == tuple(name.lower() for name, i in sorted(
        pairs, key=lambda p: int(p[1])))
    assert set(kernel.TC_ROUTES) == {"f32_3xtf32", "bf16_wgmma",
                                     "f16_wgmma"}
    tc = (kernel.SOURCES[0].parent / "chain_attn_tc.cuh").read_text()
    body = re.search(r"constexpr bool chain_tf32_head_dim\(int64_t d\) "
                     r"\{(.*?)\}", tc, re.S).group(1)
    assert tuple(int(x) for x in re.findall(r"d == (\d+)", body)) == \
        ops.TF32_HEAD_DIMS
    assert f"constexpr int MAX_CHUNKS = {kernel.MAX_CHUNKS};" in tc
    assert f"constexpr int ROWS = {kernel.TC_ROWS};" in tc
    assert "return d <= 64 ? 64 : 32;" in tc
    assert "return d <= 128 ? 128 : 64;" in tc
    for d in ops.TF32_HEAD_DIMS:
        assert kernel.key_tile("f32_3xtf32", d) == (64 if d <= 64 else 32)
    for d in ops.WGMMA_HEAD_DIMS:
        for route in ("bf16_wgmma", "f16_wgmma"):
            assert kernel.key_tile(route, d) == (128 if d <= 128 else 64)


def test_route_symbol_arity_is_the_entry_points():
    """Static: ctypes passes as many arguments as
    ``bind_chain_route_attn`` takes."""
    params = re.search(r"int bind_chain_route_attn\((.*?)\)",
                       kernel.SOURCES[0].read_text(), re.S).group(1)
    assert params.count(",") + 1 == len(
        kernel.LIBRARY.symbols[kernel.ATTN_ROUTE_SYMBOL])


CHUNK_SHAPES = [(512, 512, 128), (512, 64, 128), (8192, 512, 128),
                (1, 1, 64), (100, 10000, 64), (640, 3000, 96),
                (128, 333, 256)]


@pytest.mark.parametrize("route, m, n, d", [
    (route, m, n, d) for route in ("f32_3xtf32", "bf16_wgmma", "f16_wgmma")
    for m, n, d in CHUNK_SHAPES
    if route != "f32_3xtf32" or d in ops.TF32_HEAD_DIMS])
def test_attn_chunks_split_the_keys_by_the_level_alone(route, m, n, d):
    """The chunks of a level's keys: a whole number of key tiles each
    (every chunk holds at least one), at most MAX_CHUNKS, enough that the
    level runs as CHUNK_BLOCKS blocks where it has the tiles; a function of
    the level's shape and route alone (it takes no level count)."""
    import inspect
    assert list(inspect.signature(kernel.attn_chunks).parameters) == [
        "route", "m", "n", "d"]
    chunks = kernel.attn_chunks(route, m, n, d)
    tiles = -(-n // kernel.key_tile(route, d))
    per = -(-tiles // chunks)
    assert 1 <= chunks <= min(tiles, kernel.MAX_CHUNKS)
    assert -(-tiles // per) == chunks          # no chunk is empty
    rows = -(-m // kernel.TC_ROWS)
    assert rows * chunks >= min(kernel.CHUNK_BLOCKS, rows * tiles)
    assert kernel.attn_chunks("f32_simt", m, n, d) == 1


def test_the_served_level_runs_as_16_blocks():
    """The served ``attn_step`` (a 512-row Qwen3-14B query tile over 512
    fresh keys) runs as at least 16 blocks on each tensor-core route, not
    the 4 row tiles alone."""
    for route in kernel.TC_ROUTES:
        chunks = kernel.attn_chunks(route, 512, 512, 128)
        assert -(-512 // kernel.TC_ROWS) * chunks >= 16


@pytest.mark.parametrize("route", ["f32_simt", "f32_3xtf32", "bf16_wgmma"])
@pytest.mark.parametrize("m, n, d, n_levels", [(512, 512, 128, 16),
                                               (512, 64, 128, 300),
                                               (8192, 512, 128, 64),
                                               (64, 100, 64, 70000)])
def test_level_runs_bound_the_tensor_core_workspace(route, m, n, d,
                                                    n_levels):
    """On the tensor-core routes a level's workspace is chunks x m x (dv +
    2) floats and the grid's y levels x chunks: the runs cover the chain
    in order within both bounds, and the counters a launch takes are one
    per row tile and level (its chunks' merge)."""
    dtype = torch.bfloat16 if route == "bf16_wgmma" else torch.float32
    tc = route in kernel.TC_ROUTES
    chunks = kernel.attn_chunks(route, m, n, d) if tc else None
    runs = kernel.level_runs(m, d, dtype, n_levels, chunks)
    assert sum(c for _, c in runs) == n_levels
    assert [f for f, _ in runs] == list(
        itertools.accumulate([0] + [c for _, c in runs[:-1]]))
    per_level = kernel.level_bytes(m, d, dtype, chunks)
    for _, count in runs:
        assert count == 1 or count * per_level <= kernel.WORKSPACE_BYTES
        assert count * (chunks or 1) <= kernel.MAX_LEVELS_PER_LAUNCH
    assert runs[0][1] == min(n_levels, kernel.levels_per_launch(
        route, m, n, d, d, dtype))
    if tc:
        assert per_level == chunks * m * (d + 2) * 4
        assert kernel.attn_counters(route, m, runs[0][1]) == \
            -(-m // kernel.TC_ROWS) * runs[0][1]
    else:
        assert kernel.attn_counters(route, m, runs[0][1]) == \
            -(-m // kernel.ROW_TILE)


LOG2E = 1.4426950408889634


def _tf32_split(x):
    """hi and lo halves of float32 ``x`` as the 3xTF32 staging makes them:
    hi = tf32_rna(x), lo = tf32_rna(x - hi)."""
    from test_torch_gemm import _tf32
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _products(route, a, b):
    """``a @ b`` as the route's tensor cores form it, float32: 3xTF32
    (hi.hi in one accumulator, the lo products in another, added once) or
    one product of 16-bit operands (exact products, a float32 sum)."""
    if route != "f32_3xtf32":
        return (a.double() @ b.double()).float()
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    hh = (ah.double() @ bh.double()).float()
    lo = (al.double() @ bh.double() + ah.double() @ bl.double()).float()
    return hh + lo


def _emulate_chain_attn(route, layout, n_levels, o, q, k, v, *,
                        chunks=None, p_through=None, rescale=True):
    """The tensor-core routes' arithmetic (csrc/chain_attn_tc.cuh and the
    flash-attention blocks it sweeps with), in float32 on the CPU: each
    level's keys in ``kernel.attn_chunks`` chunks of key tiles (or
    ``chunks(n_levels)``: the fault of a count taken from the chain's
    length); per chunk the online softmax over its tiles (scores scaled by
    scale log2(e), m from -1e30, p = 2^(s - m), l = corr l + sum p, O
    rescaled by corr, then O += P V: on 3xTF32 P split into hi / lo and
    the tile's product summed apart and added, on wgmma P rounded to the
    element type; ``p_through``: P rounded through that type first, the
    planted fault);
    chunks merged in chunk order (m* = max m_c, w_c = 2^(m_c - m*), the
    level's value (sum w_c O_c) (1 / sum w_c l_c); ``rescale=False``: the
    fault of chunks merged without their weights), or O (1 / l) for one
    chunk; the carry rounded to its type after every level."""
    dt = o.dtype
    m, dv = o.shape
    n, d = k.shape[-2:]
    count = (kernel.attn_chunks(route, m, n, d) if chunks is None
             else chunks(n_levels))
    bkv = kernel.key_tile(route, d)
    tiles = -(-n // bkv)
    per = -(-tiles // count)
    scale_log2 = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    carry = o.float()
    for level in range(n_levels):
        qq, kk, vv = ((t[level] if lay == "xs" else t).float()
                      for lay, t in zip(layout[1:], (q, k, v)))
        parts = []
        for c in range(-(-tiles // per)):
            acc = torch.zeros((m, dv))
            mx = torch.full((m,), -1e30)
            lsum = torch.zeros(m)
            for t in range(c * per, min((c + 1) * per, tiles)):
                keys = slice(t * bkv, min((t + 1) * bkv, n))
                s = _products(route, qq, kk[keys].T) * scale_log2
                new = torch.maximum(mx, s.amax(-1))
                corr = torch.exp2(mx - new)
                p = torch.exp2(s - new[:, None])
                lsum = corr * lsum + p.sum(-1)
                acc = acc * corr[:, None]
                if p_through is not None:
                    p = p.to(p_through).float()
                if route == "f32_3xtf32":
                    ph, pl = _tf32_split(p)
                    vh, vl = _tf32_split(vv[keys])
                    tile = (ph.double() @ vh.double()
                            + pl.double() @ vh.double()
                            + ph.double() @ vl.double()).float()
                else:
                    tile = (p.to(dt).double() @ vv[keys].double()).float()
                acc = acc + tile
                mx = new
            parts.append((acc, mx, lsum))
        if len(parts) == 1:
            value = parts[0][0] * torch.reciprocal(parts[0][2])[:, None]
        else:
            top = torch.stack([pm for _, pm, _ in parts]).amax(0)
            total = torch.zeros(m)
            value = torch.zeros((m, dv))
            for pa, pm, pls in parts:
                w = torch.exp2(pm - top) if rescale else torch.ones(m)
                total = total + w * pls
                value = value + w[:, None] * pa
            value = value * torch.reciprocal(total)[:, None]
        carry = (carry + value).to(dt).float()
    return carry.to(dt)


def _emulate_replay(route, layout, n_levels, o, q, k, v, **kw):
    """The emulated route run level by level, as per-level ``attn_step``
    replay launches it: one level each, from the last one's carry."""
    carry = o
    for level in range(n_levels):
        step = [t[level] if lay == "xs" else t
                for lay, t in zip(layout[1:], (q, k, v))]
        carry = _emulate_chain_attn(route, ("single",) * 4, 1, carry, *step,
                                    **kw)
    return carry


_EMU = {"f32_3xtf32": (torch.float32, 32), "bf16_wgmma": (torch.bfloat16, 64),
        "f16_wgmma": (torch.float16, 64)}


def _emu_operands(route, layout, n_levels, zero_carry=False, seed=41):
    dt, d = _EMU[route]
    m, n = 48, 300
    rng = np.random.default_rng(seed)
    shapes = ((m, d), (m, d), (n, d), (n, d))
    out = []
    for lay, shape in zip(layout, shapes):
        lead = (n_levels,) if lay == "xs" else ()
        out.append(torch.from_numpy(rng.normal(size=lead + shape)
                                    .astype(np.float32)).to(dt))
    if zero_carry:
        out[0] = torch.zeros_like(out[0])
    return out


def _jax_chain(layout, n_levels, o, q, k, v):
    """The reference's ``attn_step`` (jax on the CPU) run level by level on
    the same values in float32, the carry rounded to the element type after
    each level as the port's plain version rounds it."""
    import jax
    from repro.kernels.flash_attention.ops import attn_step as jax_attn_step

    carry = o
    for level in range(n_levels):
        step = [(t[level] if lay == "xs" else t).float().numpy()
                for lay, t in zip(layout[1:], (q, k, v))]
        with jax.default_device(jax.devices("cpu")[0]):
            out = jax_attn_step(jnp.asarray(carry.float().numpy()),
                                *(jnp.asarray(x) for x in step))
        carry = torch.from_numpy(np.array(out)).to(o.dtype)
    return carry


# How far the emulated routes may lie from the reference, in units of the
# element type's eps times the reference carry's size: (largest |gap| over
# max |ref|, rms gap over rms ref).  The gap is the carry's rounding to T
# landing on the other side now and then (P's rounding on wgmma, 3xTF32's
# on f32, moving a level's value by less than a carry ulp).  Measured over
# seeds 41 and 1-4, both layouts, 1, 3 and 16 levels, from a carry of unit
# size and from zero: f32 at most 7.2 / 3.8, bf16 1.12 / 0.59, f16 1.37 /
# 0.59; the limits are about twice that.  A level dropped lies at least
# 10x the limit away (bf16; f16 80x), and P rounded through bfloat16
# from a zero carry 1.4x (f16, rms) and 1200x (f32).
EMU_VS_REF = {"f32_3xtf32": (16.0, 8.0), "bf16_wgmma": (3.0, 1.0),
              "f16_wgmma": (3.0, 1.0)}


def _within_ref(got, want):
    """Whether ``got`` lies within ``EMU_VS_REF`` of the reference carry
    ``want`` (for ``got``'s element type): both measures, as booleans."""
    route = {torch.float32: "f32_3xtf32", torch.bfloat16: "bf16_wgmma",
             torch.float16: "f16_wgmma"}[want.dtype]
    eps = torch.finfo(want.dtype).eps
    gap = got.double() - want.double()
    top, rms = EMU_VS_REF[route]
    return (gap.abs().max() <= top * eps * want.double().abs().max(),
            gap.pow(2).mean().sqrt() <= rms * eps *
            want.double().pow(2).mean().sqrt())


@pytest.mark.parametrize("route", ["f32_3xtf32", "bf16_wgmma", "f16_wgmma"])
@pytest.mark.parametrize("n_levels", [1, 3, 16])
@pytest.mark.parametrize("layout", [("single", "single", "xs", "xs"),
                                    ("single", "xs", "xs", "xs")],
                         ids=["q-single", "all-xs"])
def test_emulated_route_is_its_own_replay_and_the_reference(route,
                                                            n_levels,
                                                            layout):
    """The tensor-core routes' arithmetic, emulated: bit for bit its own
    per-level replay (the chunks depend on the level alone, each level is
    computed apart from the carry, and the carry is rounded after every
    level), and within ``EMU_VS_REF`` of the reference's ``attn_step``
    chain on the same values, which the chain with its last level dropped
    is not."""
    args = _emu_operands(route, layout, n_levels)
    assert kernel.attn_chunks(route, 48, 300, args[1].shape[-1]) > 1
    got = _emulate_chain_attn(route, layout, n_levels, *args)
    replay = _emulate_replay(route, layout, n_levels, *args)
    assert torch.equal(got.view(torch.uint8), replay.view(torch.uint8))
    want = _jax_chain(layout, n_levels, *args)
    assert all(_within_ref(got, want)), _within_ref(got, want)
    dropped = _emulate_chain_attn(route, layout, n_levels - 1, *args)
    assert not any(_within_ref(dropped, want))


@pytest.mark.parametrize("route", ["f32_3xtf32", "f16_wgmma"])
@pytest.mark.parametrize("n_levels", [1, 3, 16])
def test_emulated_p_of_the_wrong_type_misses_the_reference(route, n_levels):
    """From a zero carry, where no carry's rounding hides a level's: the
    emulated route lies within ``EMU_VS_REF`` of the reference, and with P
    rounded through bfloat16 first (wider than P's own rounding on f16,
    far wider on f32's 3xTF32) it does not.  bfloat16 P has no coarser
    16-bit type to be rounded through."""
    layout = ("single", "single", "xs", "xs")
    args = _emu_operands(route, layout, n_levels, zero_carry=True)
    want = _jax_chain(layout, n_levels, *args)
    got = _emulate_chain_attn(route, layout, n_levels, *args)
    assert all(_within_ref(got, want)), _within_ref(got, want)
    bad = _emulate_chain_attn(route, layout, n_levels, *args,
                              p_through=torch.bfloat16)
    assert not all(_within_ref(bad, want))


def test_chunks_from_the_chain_length_break_replay():
    """The fault of a chunk count taken from ``n_levels`` (here one chunk
    for a chain, the level's own count for one level): a level's merge
    then rounds differently in a chain than in its replay, and the bits
    part."""
    route = "f32_3xtf32"
    layout = ("single", "single", "xs", "xs")
    args = _emu_operands(route, layout, 3)
    S = kernel.attn_chunks(route, 48, 300, 32)
    assert S > 1

    def from_length(n_levels):
        return S if n_levels == 1 else 1
    got = _emulate_chain_attn(route, layout, 3, *args, chunks=from_length)
    replay = _emulate_replay(route, layout, 3, *args, chunks=from_length)
    assert not torch.equal(got.view(torch.uint8), replay.view(torch.uint8))
    # the right rule keeps them equal on the same values
    assert torch.equal(
        _emulate_chain_attn(route, layout, 3, *args).view(torch.uint8),
        _emulate_replay(route, layout, 3, *args).view(torch.uint8))


def _f64_error(got, o, q, k, v):
    """The largest |got - exact| of one level from carry ``o`` in
    float64."""
    scale = 1.0 / q.shape[-1] ** 0.5
    exact = o.double() + torch.softmax(
        (q.double() @ k.double().T) * scale, -1) @ v.double()
    return (got.double() - exact).abs().max().item()


@pytest.mark.parametrize("route, limit", [("f32_3xtf32", 4.0),
                                          ("bf16_wgmma", 2.0),
                                          ("f16_wgmma", 2.0)])
def test_emulated_error_against_float64_and_the_faults_it_sees(route,
                                                               limit):
    """One level from a zero carry, where no carry's rounding hides a
    level's: the emulated route's float64 error is at most ``limit``
    times the CUDA-core loop's (the plain version: float32 inside, P kept
    in float32, one rounding), the limit ``chip_smoke.py`` holds the card
    to; chunks merged without their weights, and on f16 P rounded through
    bfloat16 first, fall outside it."""
    layout = ("single",) * 4
    errs = []
    for seed in range(3):
        o, q, k, v = _emu_operands(route, layout, 1, zero_carry=True,
                                   seed=seed)
        simt = _f64_error(ref.chain_attn(layout, 0, 1, o, q, k, v), o, q, k,
                          v)
        tc = _f64_error(_emulate_chain_attn(route, layout, 1, o, q, k, v),
                        o, q, k, v)
        no_w = _f64_error(_emulate_chain_attn(route, layout, 1, o, q, k, v,
                                              rescale=False), o, q, k, v)
        errs.append((tc / simt, no_w / simt))
        if route == "f16_wgmma":
            bad = _f64_error(_emulate_chain_attn(
                route, layout, 1, o, q, k, v, p_through=torch.bfloat16),
                o, q, k, v)
            assert bad > limit * simt, (bad, simt)
    assert all(r <= limit for r, _ in errs), errs
    assert all(bad > limit for _, bad in errs), errs
