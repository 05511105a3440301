"""The port's linear scan against the reference Pallas kernel.

On the CPU the port's ``linear_scan`` pads S as the reference's wrapper
does and computes the plain version, a sequential float32 loop (the CUDA
kernel runs only on the card, where ``chip_smoke.py`` holds it against
this same plain version).  Here it is held against
``repro.kernels.linear_scan.ops.linear_scan`` run in Pallas interpret mode
on the same NumPy inputs, at the reference's shapes and tolerances
(``tests/test_kernels.py``: f32 1e-5, 2e-5 in the property test for any
``bs``; bf16 4e-2), and the wrapper's checks and launch counter are pinned.

The kernel's own algorithm in PyTorch, ``ref.linear_scan_chunked`` (the
version ``chip_smoke.py`` holds the kernel to bit for bit), is held against
the same reference at its shapes and at shapes that cross several 128-step
chunks with a short last one, and the source's chunk length, its one
kernel and its route rule are read from ``csrc/linear_scan.cu``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from test_kernels import SCAN_SHAPES

from test_torch_gemm import extern_c_symbols

from repro.kernels.linear_scan import ops as ref_ops
from repro_torch.kernels.linear_scan import kernel, ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 4e-2)}


@pytest.fixture(autouse=True)
def _zero_counter():
    ops.linear_scan.launches = 0
    yield
    # a CPU call computes the plain version and never launches the kernel
    assert ops.linear_scan.launches == 0


def _both(a, x, dname="float32"):
    jdt, tdt, _ = DTYPES[dname]
    return ((jnp.asarray(a, dtype=jdt), jnp.asarray(x, dtype=jdt)),
            (torch.from_numpy(a).to(tdt), torch.from_numpy(x).to(tdt)))


@pytest.mark.parametrize("b,s,d", SCAN_SHAPES)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_matches_reference(b, s, d, dname, rng):
    a = rng.uniform(0.2, 0.99, size=(b, s, d)).astype(np.float32)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    (ja, jx), (ta, tx) = _both(a, x, dname)
    exp = np.asarray(ref_ops.linear_scan(ja, jx, bs=32, interpret=True),
                     np.float32)
    got = ops.linear_scan(ta, tx, bs=32)
    assert got.dtype == DTYPES[dname][1] and tuple(got.shape) == (b, s, d)
    tol = DTYPES[dname][2]
    np.testing.assert_allclose(got.float().numpy(), exp, rtol=tol, atol=tol)


@given(b=st.integers(1, 3), s=st.integers(1, 130), d=st.integers(1, 9),
       bs=st.sampled_from([8, 32, 64]), seed=st.integers(0, 2 ** 16))
@settings(max_examples=10, deadline=None)
def test_property_any_shape_and_block(b, s, d, bs, seed):
    """Any (shape, bs): the padded scan equals the reference's."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, size=(b, s, d)).astype(np.float32)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    (ja, jx), (ta, tx) = _both(a, x)
    exp = np.asarray(ref_ops.linear_scan(ja, jx, bs=bs, interpret=True))
    got = ops.linear_scan(ta, tx, bs=bs)
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-5, atol=2e-5)


def test_zero_decay_is_identity(rng):
    x = torch.from_numpy(rng.normal(size=(2, 32, 4)).astype(np.float32))
    assert torch.equal(ops.linear_scan(torch.zeros_like(x), x, bs=16), x)


def test_padding_path(rng):
    """S = 100 with bs = 32 pads to 128 and slices back; the padded tail
    changes nothing before it."""
    a = rng.uniform(0.2, 0.99, size=(2, 100, 3)).astype(np.float32)
    x = rng.normal(size=(2, 100, 3)).astype(np.float32)
    (ja, jx), (ta, tx) = _both(a, x)
    got = ops.linear_scan(ta, tx, bs=32)
    assert tuple(got.shape) == (2, 100, 3)
    assert torch.equal(got, ref.linear_scan(ta, tx))
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(ref_ops.linear_scan(ja, jx, bs=32, interpret=True)),
        rtol=1e-5, atol=1e-5)


def test_plain_backend_is_the_oracle(rng):
    from repro.kernels.linear_scan import ref as ref_oracle

    a = rng.uniform(0.2, 0.99, size=(1, 40, 6)).astype(np.float32)
    x = rng.normal(size=(1, 40, 6)).astype(np.float32)
    (ja, jx), (ta, tx) = _both(a, x, "bfloat16")
    got = ops.linear_scan(ta, tx, backend="plain")
    assert got.dtype == torch.bfloat16
    exp = np.asarray(ref_oracle.linear_scan(ja, jx), np.float32)
    np.testing.assert_allclose(got.float().numpy(), exp, rtol=4e-2,
                               atol=4e-2)


@pytest.mark.parametrize("edit, error, match", [
    (lambda a, x: (a.double(), x.double()), TypeError, "float64"),
    (lambda a, x: (a, x.bfloat16()), TypeError, "mixed"),
    (lambda a, x: (a[0], x[0]), ValueError, "shape"),
    (lambda a, x: (a, x[:, :3].contiguous()), ValueError, "shape"),
    (lambda a, x: (a.numpy(), x), TypeError, "ndarray"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(edit, error, match):
    a, x = torch.ones(2, 4, 4), torch.ones(2, 4, 4)
    with pytest.raises(error, match=match):
        ops.linear_scan(*edit(a, x))
    with pytest.raises(ValueError, match="backend"):
        ops.linear_scan(a, x, backend="xla")


def test_library_is_named_by_its_source():
    path = kernel.LIBRARY.path()
    assert path.name.startswith("libbind_linear_scan_")
    assert set(kernel.SUFFIX) == set(ops.DTYPES)
    assert set(kernel.LIBRARY.symbols) == {
        f"bind_linear_scan_{s}" for s in kernel.SUFFIX.values()} | {
        kernel.ROUTE_SYMBOL}
    assert kernel.ROUTE_SYMBOL == "bind_linear_scan_route"


def test_transposed_views_match_the_reference(rng):
    """A transposed (B, D, S) -> (B, S, D) view is scanned as the
    reference scans the same array: the wrapper copies it into a row-major
    one first."""
    a = rng.uniform(0.2, 0.99, size=(2, 4, 16)).astype(np.float32)
    x = rng.normal(size=(2, 4, 16)).astype(np.float32)
    exp = np.asarray(ref_ops.linear_scan(
        jnp.asarray(a).transpose(0, 2, 1), jnp.asarray(x).transpose(0, 2, 1),
        bs=8, interpret=True))
    ta, tx = (torch.from_numpy(t).transpose(1, 2) for t in (a, x))
    assert not ta.is_contiguous()
    got = ops.linear_scan(ta, tx, bs=8)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)


# -- the kernel's algorithm in PyTorch: ref.linear_scan_chunked --------------

CHUNKED_SHAPES = [*SCAN_SHAPES, (2, 1000, 33), (3, 300, 5)]


def _gates(rng, shape, memory):
    """``a`` in a forget gate's range (0.2, 0.99), or in (0.999, 1], where
    a chunk's carry lives on into the next (0.999^128 ≈ 0.88)."""
    if memory == "forget":
        return rng.uniform(0.2, 0.99, size=shape).astype(np.float32)
    return (1 - rng.uniform(0, 1e-3, size=shape)).astype(np.float32)


@pytest.mark.parametrize("memory", ["forget", "long"])
@pytest.mark.parametrize("b,s,d", CHUNKED_SHAPES)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_chunked_matches_reference(b, s, d, dname, memory, rng):
    """The kernel's chunked algorithm against the reference's Pallas kernel
    (interpret mode) on the same inputs: f32 within 2e-5 (the property
    test's bound), bf16 within 4e-2, relative and absolute.  With long
    memory the values grow to tens over ~1000 steps and every f32 version's
    rounding error with them (the sequential loop's too, and near a zero
    crossing past 2e-5): the absolute part is then 2e-5 times the largest
    |y|, and the float64 test below bounds the error itself."""
    a = _gates(rng, (b, s, d), memory)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    (ja, jx), (ta, tx) = _both(a, x, dname)
    exp = np.asarray(ref_ops.linear_scan(ja, jx, interpret=True), np.float32)
    got = ref.linear_scan_chunked(ta, tx)
    assert got.dtype == DTYPES[dname][1] and tuple(got.shape) == (b, s, d)
    tol = 2e-5 if dname == "float32" else DTYPES[dname][2]
    scale = max(1.0, float(np.abs(exp).max())) if memory == "long" else 1.0
    np.testing.assert_allclose(got.float().numpy(), exp, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("b,s,d", [(2, 1000, 33), (3, 300, 5)])
def test_chunked_long_memory_is_no_farther_from_float64_than_the_loop(
        b, s, d, rng):
    """With a in (0.999, 1] the carry crosses chunks alive: the chunked
    version strays from the exact (float64) recurrence no farther than the
    sequential f32 loop does, on these draws (``chip_smoke.py`` holds the
    kernel to a float64 run of the chunked order within float32's worst
    case of rounding, and prints this comparison over several seeds)."""
    a = _gates(rng, (b, s, d), "long")
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    h = np.zeros((b, d))
    exact = np.empty((b, s, d))
    for t in range(s):
        h = a[:, t].astype(np.float64) * h + x[:, t]
        exact[:, t] = h
    ta, tx = torch.from_numpy(a), torch.from_numpy(x)
    err = np.abs(ref.linear_scan_chunked(ta, tx).numpy() - exact).max()
    loop = np.abs(ref.linear_scan(ta, tx).numpy() - exact).max()
    assert err <= loop


@pytest.mark.parametrize("b,s,d", [(2, 1000, 33), (1, 16, 4)])
def test_chunked_zero_decay_gives_x_exactly(b, s, d, rng):
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    for dt in ops.DTYPES:
        xt = x.to(dt)
        assert torch.equal(ref.linear_scan_chunked(torch.zeros_like(xt), xt),
                           xt)


@pytest.mark.parametrize("s", [1, 100, 128])
def test_one_chunk_is_the_sequential_loop_bit_for_bit(s, rng):
    """Up to one chunk there is no carry: the chunked version's output is
    the sequential oracle's, every bit, ragged chunk included."""
    a = torch.from_numpy(rng.uniform(-1, 1, size=(2, s, 7))
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(2, s, 7)).astype(np.float32))
    assert torch.equal(ref.linear_scan_chunked(a, x), ref.linear_scan(a, x))


def test_chunked_pads_the_last_chunk_with_the_identity_step():
    """A chunk length that does not divide S pads with a = 1, x = -0.0:
    the output before the pad is the same bits as with S padded by hand to
    the chunk length with the same identity, signs of zero included."""
    a = torch.tensor([[[-0.5], [2.0], [0.0], [-1.0], [0.25]]])
    x = torch.tensor([[[-0.0], [0.0], [-0.0], [3.0], [-0.0]]])
    got = ref.linear_scan_chunked(a, x, chunk=4)
    a8 = torch.cat([a, torch.ones(1, 3, 1)], dim=1)
    x8 = torch.cat([x, torch.full((1, 3, 1), -0.0)], dim=1)
    exp = ref.linear_scan_chunked(a8, x8, chunk=4)[:, :5]
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


# -- the source: one kernel, its chunk length, its route rule ----------------

_SOURCE = kernel.SOURCES[0]


def test_source_is_one_kernel_built_for_the_wrappers_chunk():
    """``csrc/linear_scan.cu`` is built for the chunk length ``kernel.py``
    passes (the entry points refuse any other), and the three-pass
    kernels are gone."""
    source = _SOURCE.read_text()
    built = re.search(r"constexpr int CHUNK = (\d+);", source)
    assert built and int(built.group(1)) == kernel.CHUNK
    for old in ("linear_scan_chunk_kernel", "linear_scan_carry_kernel",
                "linear_scan_apply_kernel"):
        assert old not in source
    assert len(re.findall(r"__global__", source)) == 1
    assert "chunk != CHUNK" in source


def test_every_bound_symbol_is_an_extern_c_entry_point_with_its_arity():
    source = _SOURCE.read_text()
    assert set(kernel.LIBRARY.symbols) == extern_c_symbols(_SOURCE)
    for sym, argtypes in kernel.LIBRARY.symbols.items():
        params = re.search(rf"int {sym}\((.*?)\)", source, re.S).group(1)
        assert params.count(",") + 1 == len(argtypes), sym


def test_route_names_follow_the_sources_enum():
    enum = re.search(r"enum Route : int \{(.*?)\};", _SOURCE.read_text())
    names = re.findall(r"ROUTE_(\w+) = (\d+)", enum.group(1))
    assert ops.ROUTES == tuple(n.lower() for n, i in sorted(
        names, key=lambda p: int(p[1])))
    assert kernel.DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1,
                                  torch.float16: 2}


KB = 1 << 10


@pytest.mark.parametrize("dtype, d, addresses, want", [
    # RG-LRU width: rows of 16 KB / 8 KB, aligned operands
    (torch.float32, 4096, (0, 64 * KB), "tma"),
    (torch.bfloat16, 4096, (0, 64 * KB), "tma"),
    (torch.float16, 4096, (0, 64 * KB), "tma"),
    # rows a multiple of 16 bytes: 4 f32, 8 bf16 / f16 columns
    (torch.float32, 4, (0, 16), "tma"),
    (torch.bfloat16, 8, (0, 16), "tma"),
    (torch.float32, 8, (), "tma"),
    # odd D: a row is not a multiple of 16 bytes
    (torch.float32, 5, (0, 16), "ldg"),
    (torch.float32, 33, (0, 16), "ldg"),
    (torch.bfloat16, 4, (0, 16), "ldg"),
    (torch.float16, 12, (0, 16), "ldg"),
    # misaligned: a view at an odd element offset, a or x
    (torch.float32, 4096, (4, 64 * KB), "ldg"),
    (torch.float32, 4096, (0, 64 * KB + 8), "ldg"),
    (torch.bfloat16, 4096, (2, 64 * KB), "ldg"),
])
def test_route_by_dtype_width_and_alignment(dtype, d, addresses, want):
    assert ops.route(dtype, d, addresses) == want
    assert want in ops.ROUTES


def test_route_of_a_contiguous_view_at_an_odd_offset():
    store = torch.zeros(1 + 2 * 64 * 8)
    view = store[1:].view(2, 64, 8)
    whole = torch.zeros(2, 64, 8)
    assert view.is_contiguous()
    assert ops.route(torch.float32, 8, (view.data_ptr(),
                                        whole.data_ptr())) == "ldg"
    assert ops.route(torch.float32, 8, (whole.data_ptr(),
                                        whole.data_ptr())) == "tma"


def test_route_rejects_dtypes_without_a_kernel():
    with pytest.raises(TypeError):
        ops.route(torch.float64, 8)


def test_cpu_calls_count_no_route(rng):
    ops.linear_scan.routes = {}
    x = torch.from_numpy(rng.normal(size=(1, 16, 8)).astype(np.float32))
    ops.linear_scan(x, x)
    assert ops.linear_scan.routes == {}


@pytest.mark.parametrize("agree", [True, False], ids=["agree", "disagree"])
def test_route_taken_is_the_launchers_held_to_the_rule(monkeypatch, agree):
    """The wrapper counts the route the built launcher reports for the very
    operands it launches on (here a stand-in for the library) and raises,
    before any launch, when that is not what ``ops.route`` gives them."""
    a = torch.zeros(1, 16, 8)
    want = ops.route(a.dtype, 8, (a.data_ptr(), a.data_ptr()))
    other = ops.ROUTES[1 - ops.ROUTES.index(want)]
    monkeypatch.setattr(
        kernel, "launcher_route",
        lambda *args: ops.ROUTES.index(want if agree else other))
    if agree:
        assert ops._route_taken(a, a) == want
    else:
        with pytest.raises(RuntimeError, match="ops.route says"):
            ops._route_taken(a, a)


def test_scratch_holds_every_chunks_words_and_the_ticket():
    """The scratch has a chunk's aggregate (two words) and carry out per
    (batch, chunk, column), and the ticket counter, as the source lays it
    out."""
    b, s, d = 3, 300, 5
    chunks = -(-s // kernel.CHUNK)
    assert kernel.scratch_words(b, s, d) == 3 * b * chunks * d + 1
    assert "3 * batch * ceil(s / CHUNK) * d + 1" in _SOURCE.read_text()


# -- the gradient: one more scan over the reversed sequence -----------------

import jax  # noqa: E402

from repro.kernels.linear_scan import ref as ref_oracle  # noqa: E402

# float32: the backward's recurrence h_t = g_t + a_{t+1} h_{t+1} is the
# same product-then-sum as the transpose XLA takes of the oracle's scan;
# only da's product order may differ: 1e-6 of the largest gradient
GRAD_TOL = 1e-6
GRAD_SHAPES = [*SCAN_SHAPES, (2, 37, 6), (1, 300, 5)]


def _ref_scan_grads(a, x, g):
    def f(a, x):
        return jnp.sum(ref_oracle.linear_scan(a, x) * g)
    return [np.asarray(t) for t in jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(x))]


@pytest.mark.parametrize("memory", ["forget", "long"])
@pytest.mark.parametrize("b,s,d", GRAD_SHAPES)
def test_gradient_matches_jax_grad_of_the_oracle(b, s, d, memory, rng):
    """(da, dx) through the entry point (its autograd Function, the plain
    backward on the CPU) against jax.grad of the reference's oracle, f32,
    with S ragged against ``bs`` (the padding differentiated as the forward
    pads) and ``a`` in (0.999, 1] as well as a forget gate's range."""
    a = _gates(rng, (b, s, d), memory)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    g = rng.normal(size=(b, s, d)).astype(np.float32)
    ta, tx = (torch.from_numpy(t).requires_grad_(True) for t in (a, x))
    y = ops.linear_scan(ta, tx, bs=32)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(g))
    for name, got, want in zip(("da", "dx"), (ta.grad, tx.grad),
                               _ref_scan_grads(a, x, g)):
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


def test_plain_backward_is_the_reversed_scan(rng):
    """``ref.linear_scan_grad`` is one scan of ``grad_operands`` reversed
    back (bit for bit the plain loop on them) and equals autograd through
    the plain loop; ``dx`` is the gradient at ``y_{-1} = 0``."""
    a = torch.from_numpy(rng.uniform(0.2, 0.99, (2, 40, 7)).astype(
        np.float32))
    x, g = (torch.from_numpy(rng.normal(size=(2, 40, 7)).astype(np.float32))
            for _ in range(2))
    y = ref.linear_scan(a, x)
    da, dx = ref.linear_scan_grad(a, y, g)
    ar, gr = ref.grad_operands(a, g)
    assert torch.equal(ar[:, 0], torch.zeros_like(ar[:, 0]))
    assert torch.equal(ar[:, 1:].flip(1), a[:, 1:])
    assert torch.equal(dx, ref.linear_scan(ar, gr).flip(1))
    la, lx = (t.clone().requires_grad_(True) for t in (a, x))
    ref.linear_scan(la, lx).backward(g)
    assert torch.equal(dx, lx.grad)
    torch.testing.assert_close(da, la.grad, rtol=1e-6, atol=1e-6)
    # the backward's scan on the chunked algorithm (what the kernel runs on
    # the card) agrees with the loop within the forward's f32 tolerance
    chunked = ref.linear_scan_chunked(ar, gr).flip(1)
    torch.testing.assert_close(chunked, dx, rtol=2e-5, atol=2e-5)


def test_backward_on_the_cpu_takes_the_plain_version(monkeypatch, rng):
    a = torch.from_numpy(rng.uniform(0.2, 0.99, (1, 20, 4)).astype(
        np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.normal(size=(1, 20, 4)).astype(
        np.float32)).requires_grad_(True)
    calls = []
    plain = ref.linear_scan_grad

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ref, "linear_scan_grad", counting)
    ops.linear_scan(a, x).sum().backward()
    assert calls == [{}]      # the plain loop as its scan, no kernel
    assert ops.linear_scan.launches == 0
    assert a.grad is not None and x.grad is not None
