"""The port against the reference where the two once disagreed.

Each test holds the port against the JAX package on the same NumPy inputs
(made from a seed), on one of five behaviours in which the port used to
differ from it:

1. ``attn_step`` on NumPy payloads: the reference's ``jax.nn.softmax``
   hands back a jax array, float32 for float64 NumPy, so the carry of an
   ``attn_step`` chain becomes a float32 array, and ``peak_live_bytes`` and
   the executable cache's hits follow.  The port returns a float32 CPU
   tensor (a ``jax.Array`` is a ``torch.Tensor`` in the port), on the CPU
   even when a card is present: a NumPy workflow stays on the host;
2. the tensor bodies ``gemm_tile``, ``_t_gemm_acc`` and ``attn_step`` on
   operands their kernels do not take (batched, integer, mixed dtypes,
   a float16 head dim past the chain kernel's, 3-D): they compute the
   reference's body expression instead of raising, decided by the
   kernel's own acceptance rule before any launch;
3. float16 at the kernels' entry points (``matmul``, ``matmul_accumulate``,
   ``linear_scan``, ``flash_attention``), against the reference's wrappers
   in Pallas interpret mode;
4. the ``threads`` backend's pricing of a level whose operands lie on the
   card: by its host enqueue cost, so a plan of card payloads delegates to
   ``serial``.  There is no card here, so the rule is driven by counting
   CPU tensors as on the card; on CPU tensors and NumPy the reference's
   counters hold (``tests/test_torch_backends.py``);
5. strided views at the kernels' entry points (``linear_scan``,
   ``flash_attention``, ``matmul``, ``matmul_accumulate``): the reference's
   wrappers take any array, the port's used to raise ``ValueError`` on a
   tensor that is not contiguous; they now copy it into a row-major one
   first and give the reference's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_bind
from repro.kernels import flash_attention as ref_fa
from repro.kernels import linear_scan as ref_ls
from repro.kernels.flash_attention.ops import attn_step as ref_attn_step
from repro.kernels.gemm import ops as ref_gemm_ops
from repro.kernels.gemm.ops import gemm_tile as ref_gemm_tile
from repro.linalg import tiles as ref_tiles
from repro_torch import core as port_bind
from repro_torch import compat
from repro_torch.compat import to_numpy
from repro_torch.core.backends import threadpool
from repro_torch.kernels.chain import ops as chain_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import attn_step
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.gemm.ops import gemm_tile
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.linalg import tiles as port_tiles


def _events(stats):
    return [(t.version_key, t.src, t.dst, t.nbytes, t.round_id, t.collective,
             t.wavefront) for t in stats.transfers]


# -- 1. attn_step on NumPy payloads ------------------------------------------

ATTN_LEVELS = 6


def _attn_inputs(dtype=np.float64):
    """ROADMAP's inputs: seed 3, carry (8, 6), q (8, 4), a fresh k (7, 4)
    and v (7, 6) per level."""
    rng = np.random.default_rng(3)
    o = rng.normal(size=(8, 6)).astype(dtype)
    q = rng.normal(size=(8, 4)).astype(dtype)
    kv = [(rng.normal(size=(7, 4)).astype(dtype),
           rng.normal(size=(7, 6)).astype(dtype))
          for _ in range(ATTN_LEVELS)]
    return o, q, kv


def _attn_chain(bind, step, backend, dtype=np.float64):
    o, q, kv = _attn_inputs(dtype)
    ex = bind.LocalExecutor(1, mode="plan", backend=backend)
    with bind.Workflow(executor=ex) as wf:
        ho = wf.array(o, "o")
        hq = wf.array(q, "q")
        for i, (k, v) in enumerate(kv):
            hk = wf.array(k, f"k{i}")
            hv = wf.array(v, f"v{i}")
            wf.call(step, (ho, hq, hk, hv), name="attn_step")
        out = wf.fetch(ho)
    return out, ex.stats


PORT_BACKENDS = {"serial": lambda: "serial", "fused": lambda: "fused",
                 "mesh": lambda: port_bind.MeshBackend(pallas=True)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("backend", sorted(PORT_BACKENDS))
def test_attn_step_on_numpy_gives_the_references_float32_array(backend,
                                                               dtype):
    ref_out, ref_stats = _attn_chain(ref_bind, ref_attn_step, "serial",
                                     dtype)
    out, stats = _attn_chain(port_bind, attn_step,
                             PORT_BACKENDS[backend](), dtype)
    # the payload kind: a jax array there, a tensor here, float32 both
    assert isinstance(ref_out, jax.Array)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert ref_out.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=2e-6,
                               atol=2e-6)
    assert stats.peak_live_bytes == ref_stats.peak_live_bytes
    assert stats.peak_live_payloads == ref_stats.peak_live_payloads
    assert _events(stats) == _events(ref_stats)
    assert stats.ops_executed == ref_stats.ops_executed
    assert stats.wavefronts == ref_stats.wavefronts


def test_attn_step_on_numpy_stays_on_the_host_with_a_card(monkeypatch):
    """The device a NumPy level's result lives on is the CPU, whether or
    not a card is present (ROADMAP, reference quirks the port
    reproduces)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    o, q, kv = _attn_inputs()
    got = attn_step(o, q, *kv[0])
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    # the next level: a tensor carry with NumPy q, k, v
    got2 = attn_step(got, q, *kv[1])
    assert got2.device.type == "cpu" and got2.dtype == torch.float32
    ref = ref_attn_step(ref_attn_step(o, q, *kv[0]), q, *kv[1])
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=2e-6)


# -- 2. tensor bodies on operands their kernels do not take -------------------

def _gemm_case(name):
    rng = np.random.default_rng(11)
    if name == "batched":
        return [rng.normal(size=(2, 4, 4)).astype(np.float32)
                for _ in range(3)]
    if name == "int32":
        return [rng.integers(-9, 9, size=(4, 4)).astype(np.int32)
                for _ in range(3)]
    c = rng.normal(size=(4, 4)).astype(np.float32)
    a, b = (rng.normal(size=(4, 4)).astype(np.float16) for _ in range(2))
    return [c, a, b]


def _one_op(bind, body, payloads, to_payload):
    ex = bind.LocalExecutor(1, mode="plan", backend="serial")
    with bind.Workflow(executor=ex) as wf:
        hs = [wf.array(to_payload(x), f"x{i}")
              for i, x in enumerate(payloads)]
        wf.call(body, tuple(hs), name=body.__name__)
        return wf.fetch(hs[0])


@pytest.mark.parametrize("case", ["batched", "int32", "mixed f32 c, f16 a b"])
@pytest.mark.parametrize("bodies", [(ref_gemm_tile, gemm_tile),
                                    (ref_tiles._t_gemm_acc,
                                     port_tiles._t_gemm_acc)],
                         ids=["gemm_tile", "_t_gemm_acc"])
def test_gemm_bodies_compute_what_the_kernel_does_not_take(bodies, case):
    ref_body, port_body = bodies
    payloads = _gemm_case(case)
    exp = _one_op(ref_bind, ref_body, payloads, jnp.asarray)
    launches = gemm_ops.matmul_accumulate.launches
    calls = gemm_ops.accumulate_body.calls
    got = _one_op(port_bind, port_body, payloads, torch.from_numpy)
    assert gemm_ops.matmul_accumulate.launches == launches
    assert gemm_ops.accumulate_body.calls == calls + 1
    assert gemm_ops.accumulate_problem(
        *(torch.from_numpy(x) for x in payloads)) is not None
    assert tuple(got.shape) == exp.shape
    assert str(got.dtype).split(".")[-1] == str(exp.dtype)
    if case == "int32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=2e-3,
                                   atol=2e-3)


def _attn_case(name):
    rng = np.random.default_rng(12)
    if name == "float16":
        # the chain kernel takes float16 tiles with d and dv in [1, 256]:
        # this one's dv is past it
        return [rng.normal(size=s).astype(np.float16)
                for s in ((8, 260), (8, 4), (7, 4), (7, 260))]
    return [rng.normal(size=s).astype(np.float32)
            for s in ((2, 8, 6), (2, 8, 4), (7, 4), (7, 6))]


@pytest.mark.parametrize("case, tol", [("float16", 2e-3), ("3-D o, q", 1e-5)])
def test_attn_step_computes_what_the_kernel_does_not_take(case, tol):
    payloads = _attn_case(case)
    exp = _one_op(ref_bind, ref_attn_step, payloads, jnp.asarray)
    calls = fa_ops.step_body.calls
    got = _one_op(port_bind, attn_step, payloads, torch.from_numpy)
    assert fa_ops.step_body.calls == calls + 1
    assert chain_ops.attn_problem(
        ("single",) * 4, 0, 1,
        tuple(torch.from_numpy(x) for x in payloads)) is not None
    assert chain_ops.chain_attn.launches == 0
    assert tuple(got.shape) == exp.shape
    assert str(got.dtype).split(".")[-1] == str(exp.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), rtol=tol,
                               atol=tol)


def test_bodies_take_the_kernel_exactly_when_its_rule_accepts():
    """The kernel path is decided by the wrapper's own checks: accepted
    operands go through ``matmul_accumulate`` / ``chain_attn`` (their
    plain versions on the CPU, bitwise), rejected ones never reach them."""
    rng = np.random.default_rng(5)
    c, a, b = (torch.from_numpy(rng.normal(size=(4, 4)).astype(np.float32))
               for _ in range(3))
    assert gemm_ops.accumulate_problem(c, a, b) is None
    assert torch.equal(gemm_tile(c, a, b), gemm_ops.matmul_accumulate(c, a, b))
    assert "2-D" in gemm_ops.accumulate_problem(c[None], a[None], b[None])
    assert "dtype" in gemm_ops.accumulate_problem(c.int(), a.int(), b.int())
    assert "mixed" in gemm_ops.accumulate_problem(c, a.half(), b.half())
    o, q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((8, 6), (8, 4), (7, 4), (7, 6)))
    one = ("single",) * 4
    assert chain_ops.attn_problem(one, 0, 1, (o, q, k, v)) is None
    assert torch.equal(attn_step(o, q, k, v),
                       chain_ops.chain_attn(one, 0, 1, o, q, k, v))
    assert chain_ops.attn_problem(one, 0, 1, (o.numpy(), q, k, v))


def test_bodies_copy_strided_tiles_of_a_kernel_dtype_into_row_major():
    """A 2-D tile of a kernel dtype that is not contiguous (a transposed
    view) goes to the kernel as a row-major copy, not to the body
    expression: on the card it launches the kernel instead of computing
    with PyTorch uncounted.  The result is the reference's."""
    rng = np.random.default_rng(6)
    c, a, b = (rng.normal(size=(5, 5)).astype(np.float32) for _ in range(3))
    exp = np.asarray(ref_gemm_tile(jnp.asarray(c), jnp.asarray(a).T,
                                   jnp.asarray(b)))
    at = torch.from_numpy(a).T
    assert not at.is_contiguous()
    for body in (gemm_tile, port_tiles._t_gemm_acc):
        calls = gemm_ops.accumulate_body.calls
        got = body(torch.from_numpy(c), at, torch.from_numpy(b))
        assert gemm_ops.accumulate_body.calls == calls, body.__name__
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)
    o, q, k, v = (rng.normal(size=s).astype(np.float32)
                  for s in ((8, 6), (4, 8), (7, 4), (7, 6)))
    exp = np.asarray(ref_attn_step(*(jnp.asarray(x) for x in (o, q.T, k,
                                                              v))))
    calls = fa_ops.step_body.calls
    got = attn_step(torch.from_numpy(o), torch.from_numpy(q).T,
                    torch.from_numpy(k), torch.from_numpy(v))
    assert fa_ops.step_body.calls == calls
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shapes", [((40, 50), (50, 30)),
                                    ((2, 40, 50), (50, 30)),
                                    ((3, 0), (0, 4))])
def test_integer_product_wraps_as_jax_in_bounded_memory(shapes):
    """The card's integer ``a @ b`` (``compat.int_matmul``, run here on
    CPU tensors): the reference's int32 product, wrapping on overflow,
    formed a few columns of ``a`` at a time so that no temporary passes
    its byte budget."""
    rng = np.random.default_rng(13)
    a, b = (rng.integers(-2 ** 20, 2 ** 20, size=s).astype(np.int32)
            for s in shapes)
    exp = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b)))
    wrapped = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)
    np.testing.assert_array_equal(exp, wrapped)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    budget = 16384      # 3 columns a time in the first case, 1 in the second
    step = compat.k_step(ta, tb, budget)
    assert step >= 1
    got = compat.int_matmul(ta, tb, budget)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)
    # at Listing 1's 1024^2 int32 tile: 16 columns, 64 MiB, a time
    tile = torch.empty((1024, 1024), dtype=torch.int32)
    step = compat.k_step(tile, tile)
    assert step * 1024 * 1024 * 4 <= compat.INT_PRODUCT_BYTES
    assert step == 16


# -- 3. float16 at the kernels' entry points ----------------------------------

def test_float16_matmul_matches_the_references_wrapper():
    rng = np.random.default_rng(21)
    a, b, c = (rng.normal(size=(16, 16)).astype(np.float16) for _ in range(3))
    exp = np.asarray(ref_gemm_ops.matmul(jnp.asarray(a), jnp.asarray(b),
                                         interpret=True))
    got = gemm_ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float16 and exp.dtype == np.float16
    np.testing.assert_allclose(got.float().numpy(), exp.astype(np.float32),
                               rtol=1e-2, atol=1e-2)
    acc = gemm_ops.matmul_accumulate(*(torch.from_numpy(x)
                                       for x in (c, a, b)))
    assert acc.dtype == torch.float16
    np.testing.assert_allclose(acc.float().numpy(),
                               c.astype(np.float32) + exp.astype(np.float32),
                               rtol=1e-2, atol=1e-2)


def test_float16_linear_scan_matches_the_references_wrapper():
    rng = np.random.default_rng(22)
    a = rng.uniform(0.5, 1.0, size=(1, 64, 16)).astype(np.float16)
    x = rng.normal(size=(1, 64, 16)).astype(np.float16)
    exp = np.asarray(ref_ls(jnp.asarray(a), jnp.asarray(x), bs=32,
                            interpret=True))
    got = ls_ops.linear_scan(torch.from_numpy(a), torch.from_numpy(x), bs=32)
    assert got.dtype == torch.float16 and exp.dtype == np.float16
    np.testing.assert_allclose(got.float().numpy(), exp.astype(np.float32),
                               rtol=1e-2, atol=1e-2)


def test_float16_flash_attention_matches_the_references_wrapper():
    rng = np.random.default_rng(23)
    q, k, v = (rng.normal(size=(1, 2, 32, 16)).astype(np.float16)
               for _ in range(3))
    exp = np.asarray(ref_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            bq=16, bkv=16, interpret=True))
    got = fa_ops.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                 bq=16, bkv=16)
    assert got.dtype == torch.float16 and exp.dtype == np.float16
    np.testing.assert_allclose(got.float().numpy(), exp.astype(np.float32),
                               rtol=1e-2, atol=1e-2)
    assert fa_ops.route(torch.float16, 16) == "f16_simt"


# -- 4. threads: card operands priced by their host enqueue cost -------------

def _wide_plan(backend, payload):
    ex = port_bind.LocalExecutor(1, backend=backend)
    with port_bind.Workflow(executor=ex) as wf:
        xs = [wf.array(payload(i), f"x{i}") for i in range(4)]
        for _ in range(3):
            for x in xs:
                wf.call(gemm_tile, (x, x, x), name="gemm_tile")
        outs = [to_numpy(wf.fetch(x)) for x in xs]
    return outs, ex.backend


def _big(i):
    # 256 x 256 float32 tiles: three operands of 256 KB and 33.5 MFLOP, far
    # above the pool's break-even of 200k work units
    return torch.full((256, 256), 1.0 / (256 * (i + 2)))


def test_threads_pool_wide_levels_of_host_tensors():
    outs, backend = _wide_plan(port_bind.ThreadPoolBackend(), _big)
    assert (backend.pooled_levels, backend.plans_delegated) == (3, 0)
    serial, _ = _wide_plan("serial", _big)
    for got, exp in zip(outs, serial):
        np.testing.assert_array_equal(got, exp)


def test_threads_delegate_a_plan_of_card_operands_to_serial(monkeypatch):
    # count every tensor as lying on the card: the rule a CUDA payload meets
    monkeypatch.setattr(threadpool, "_on_card",
                        lambda p: isinstance(p, torch.Tensor))
    outs, backend = _wide_plan(port_bind.ThreadPoolBackend(), _big)
    assert (backend.pooled_levels, backend.inlined_levels,
            backend.plans_delegated) == (0, 0, 1)
    serial, _ = _wide_plan("serial", _big)
    for got, exp in zip(outs, serial):
        np.testing.assert_array_equal(got, exp)


def test_threads_reuse_the_pre_sweep_of_a_cached_plan(monkeypatch):
    """A plan replayed from the plan cache on inputs of the same sizes and
    placement takes the last verdict without sweeping again; inputs that
    move off the card sweep again and pool."""
    port_bind.clear_plan_cache()
    sweeps = []
    sweep = threadpool.ThreadPoolBackend._sweep

    def counted(self, *args):
        sweeps.append(1)
        return sweep(self, *args)

    monkeypatch.setattr(threadpool.ThreadPoolBackend, "_sweep", counted)
    monkeypatch.setattr(threadpool, "_on_card",
                        lambda p: isinstance(p, torch.Tensor))
    delegated = []
    for _ in range(2):
        outs, backend = _wide_plan(port_bind.ThreadPoolBackend(), _big)
        delegated.append(backend.plans_delegated)
    assert (len(sweeps), delegated) == (1, [1, 1])
    monkeypatch.setattr(threadpool, "_on_card", lambda p: False)
    outs, backend = _wide_plan(port_bind.ThreadPoolBackend(), _big)
    assert len(sweeps) == 2
    assert (backend.pooled_levels, backend.plans_delegated) == (3, 0)
    serial, _ = _wide_plan("serial", _big)
    for got, exp in zip(outs, serial):
        np.testing.assert_array_equal(got, exp)


def test_threads_price_card_plans_apart_from_host_ones(monkeypatch):
    """Card operands cost no work, host ones what the reference prices:
    a flush of card tiles delegates to serial, a flush of NumPy tiles
    pools, and a level mixing both pools (its NumPy ops are worth it)."""
    monkeypatch.setattr(threadpool, "_on_card",
                        lambda p: isinstance(p, torch.Tensor))
    ex = port_bind.LocalExecutor(1, backend=port_bind.ThreadPoolBackend())
    with port_bind.Workflow(executor=ex) as wf:
        ts = [wf.array(_big(i), f"t{i}") for i in range(2)]
        ns = [wf.array(_big(i).numpy(), f"n{i}") for i in range(2)]
        for h in ts:
            wf.call(gemm_tile, (h, h, h), name="gemm_tile")
        wf.fetch(ts[0])
        backend = ex.backend
        assert (backend.plans_delegated, backend.pooled_levels) == (1, 0)
        for h in ns:
            wf.call(gemm_tile, (h, h, h), name="gemm_tile")
        wf.fetch(ns[0])
        assert (backend.plans_delegated, backend.pooled_levels) == (1, 1)
        for h in (ts[1], ns[1]):
            wf.call(gemm_tile, (h, h, h), name="gemm_tile")
        wf.fetch(ns[1])
        assert (backend.plans_delegated, backend.pooled_levels) == (1, 2)


# -- 5. strided views at the kernels' entry points -----------------------------

def test_strided_linear_scan_matches_the_references_wrapper():
    """Gates and inputs kept (B, D, S), every other step taken and
    transposed to (B, S, D): a view with two strides off row-major."""
    rng = np.random.default_rng(31)
    a = rng.uniform(0.2, 0.99, size=(2, 6, 80)).astype(np.float32)
    x = rng.normal(size=(2, 6, 80)).astype(np.float32)
    exp = np.asarray(ref_ls(jnp.asarray(a)[:, :, ::2].transpose(0, 2, 1),
                            jnp.asarray(x)[:, :, ::2].transpose(0, 2, 1),
                            bs=16, interpret=True))
    ta, tx = (torch.from_numpy(t)[:, :, ::2].transpose(1, 2) for t in (a, x))
    assert not ta.is_contiguous() and tuple(ta.shape) == (2, 40, 6)
    got = ls_ops.linear_scan(ta, tx, bs=16)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)


def test_strided_flash_attention_matches_the_references_wrapper():
    """q, k, v as slices of one fused (B, S, 3, H, D) projection,
    transposed to (B, H, S, D)."""
    rng = np.random.default_rng(32)
    qkv = rng.normal(size=(1, 48, 3, 2, 16)).astype(np.float32)
    exp = np.asarray(ref_fa(*(jnp.asarray(qkv)[:, :, i].transpose(0, 2, 1, 3)
                              for i in range(3)),
                            bq=16, bkv=16, interpret=True))
    views = [torch.from_numpy(qkv)[:, :, i].transpose(1, 2) for i in range(3)]
    assert not any(t.is_contiguous() for t in views)
    got = fa_ops.flash_attention(*views, bq=16, bkv=16)
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-5, atol=2e-5)


def test_strided_matmul_matches_the_references_wrapper():
    """``a`` a column slice of a wider matrix, ``b`` a transposed one."""
    rng = np.random.default_rng(33)
    wide = rng.normal(size=(20, 64)).astype(np.float32)
    bt = rng.normal(size=(12, 24)).astype(np.float32)
    exp = np.asarray(ref_gemm_ops.matmul(jnp.asarray(wide)[:, 8:32],
                                         jnp.asarray(bt).T, interpret=True))
    a, b = torch.from_numpy(wide)[:, 8:32], torch.from_numpy(bt).t()
    assert not (a.is_contiguous() or b.is_contiguous())
    got = gemm_ops.matmul(a, b)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-4, atol=1e-3)


def test_strided_matmul_accumulate_matches_the_references_wrapper():
    """``c`` transposed, ``a`` every other row of a taller matrix."""
    rng = np.random.default_rng(34)
    ct = rng.normal(size=(12, 20)).astype(np.float32)
    tall = rng.normal(size=(40, 24)).astype(np.float32)
    b = rng.normal(size=(24, 12)).astype(np.float32)
    exp = np.asarray(jnp.asarray(ct).T + ref_gemm_ops.matmul(
        jnp.asarray(tall)[::2], jnp.asarray(b), interpret=True))
    c, a = torch.from_numpy(ct).t(), torch.from_numpy(tall)[::2]
    assert not (c.is_contiguous() or a.is_contiguous())
    got = gemm_ops.matmul_accumulate(c, a, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-4, atol=1e-3)
