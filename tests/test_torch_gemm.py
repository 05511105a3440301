"""The GEMM kernel's plain version against the reference Pallas kernel.

On the CPU the port's ``matmul`` / ``matmul_accumulate`` compute the plain
PyTorch version (the CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against this same plain version).  Here the
plain version is held against ``repro.kernels.gemm.ops.matmul`` run in
Pallas interpret mode, on the reference's shapes and tolerances
(``tests/test_kernels.py``), and the wrappers' checks and launch counters
are pinned.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import GEMM_SHAPES

from repro.kernels.gemm import ops as ref_ops
from repro_torch.compat import to_numpy
from repro_torch.kernels.gemm import kernel, ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32, (1e-4, 1e-3)),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, (2e-2, 2e-1))}


def _pair(rng, shape, dname):
    """The same values as a jax array and a CPU tensor of one dtype."""
    jdt, tdt, _ = DTYPES[dname]
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, dtype=jdt), torch.from_numpy(x).to(tdt)


@pytest.fixture(autouse=True)
def _zero_counters():
    ops.matmul.launches = 0
    ops.matmul_accumulate.launches = 0
    yield
    # a CPU call computes the plain version and never launches the kernel
    assert ops.matmul.launches == 0
    assert ops.matmul_accumulate.launches == 0


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_matmul_matches_reference_kernel(m, k, n, dname):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    ja, ta = _pair(rng, (m, k), dname)
    jb, tb = _pair(rng, (k, n), dname)
    exp = ref_ops.matmul(ja, jb, bm=64, bn=64, bk=64, interpret=True)
    got = ops.matmul(ta, tb)
    assert got.dtype == ta.dtype and tuple(got.shape) == exp.shape
    rtol, atol = DTYPES[dname][2]
    np.testing.assert_allclose(to_numpy(got), np.asarray(exp, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(64, 48, 32), (130, 70, 260)])
def test_matmul_accumulate_matches_reference_kernel(m, k, n, dname):
    rng = np.random.default_rng(7)
    jc, tc = _pair(rng, (m, n), dname)
    ja, ta = _pair(rng, (m, k), dname)
    jb, tb = _pair(rng, (k, n), dname)
    exp = ref_ops.matmul_accumulate(jc, ja, jb, bm=32, bn=32, bk=32,
                                    interpret=True)
    got = ops.matmul_accumulate(tc, ta, tb)
    assert got.dtype == tc.dtype
    # float32: the accumulate contract of tests/test_kernels.py
    rtol, atol = (1e-5, 1e-5) if dname == "float32" else DTYPES[dname][2]
    np.testing.assert_allclose(to_numpy(got), np.asarray(exp, np.float32),
                               rtol=rtol, atol=atol)


def test_float64_accumulates_in_float64():
    """A NumPy float64 matrix moved to the port stays float64 end to end
    (the paper's leaf is DGEMM): the plain version sums in float64."""
    rng = np.random.default_rng(3)
    a, b, c = (rng.normal(size=s) for s in ((33, 17), (17, 9), (33, 9)))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    got = ops.matmul_accumulate(tc, ta, tb)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), c + a @ b, rtol=1e-12,
                               atol=1e-12)
    assert ref.acc_dtype(torch.float64) == torch.float64
    assert ref.acc_dtype(torch.bfloat16) == torch.float32


@pytest.mark.parametrize("bad, err", [
    (lambda a, b: (a, b.double()), TypeError),              # mixed dtypes
    (lambda a, b: (a.int(), b.int()), TypeError),           # no kernel dtype
    (lambda a, b: (a[0], b), ValueError),                   # not 2-D
    (lambda a, b: (a, b[:3]), ValueError),                  # inner mismatch
    (lambda a, b: (a.numpy(), b), TypeError),               # not a tensor
    (lambda a, b: (a, b.to("meta")), ValueError),           # two devices
])
def test_wrappers_reject_what_the_kernel_does_not_take(bad, err):
    a, b = torch.ones(4, 4), torch.ones(4, 4)
    x, y = bad(a, b)
    with pytest.raises(err):
        ops.matmul(x, y)


@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_transposed_views_match_reference_kernel(dname):
    """A transposed view is multiplied as the reference multiplies the same
    array: the wrappers copy it into a row-major one first."""
    rng = np.random.default_rng(7)
    ja, ta = _pair(rng, (24, 40), dname)
    jb, tb = _pair(rng, (24, 16), dname)
    jc, tc = _pair(rng, (16, 40), dname)
    assert not ta.t().is_contiguous()
    exp = ref_ops.matmul(ja.T, jb, bm=64, bn=64, bk=64, interpret=True)
    rtol, atol = DTYPES[dname][2]
    got = ops.matmul(ta.t(), tb)
    np.testing.assert_allclose(to_numpy(got), np.asarray(exp, np.float32),
                               rtol=rtol, atol=atol)
    got = ops.matmul_accumulate(tc.t(), ta.t(), tb)
    np.testing.assert_allclose(
        to_numpy(got), np.asarray(jc.T, np.float32) + np.asarray(exp,
                                                                 np.float32),
        rtol=rtol, atol=atol)


def test_accumulate_rejects_wrong_c_shape():
    with pytest.raises(ValueError):
        ops.matmul_accumulate(torch.zeros(3, 3), torch.ones(4, 2),
                              torch.ones(2, 4))


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No compiler, no kernel: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel.nvcc()


def _includes(path):
    """Every header ``path`` includes with quotes, recursively."""
    found = set()
    for name in re.findall(r'#include "([^"]+)"', path.read_text()):
        header = (path.parent / name).resolve()
        if header not in found:
            found |= {header} | _includes(header)
    return found


def extern_c_symbols(path) -> set:
    """The functions defined in the ``extern "C"`` blocks of a CUDA
    source, entry points that a macro stamps out per suffix expanded."""
    names = set()
    for block in re.findall(r'extern "C" \{\n(.*?)\n\}  // extern "C"',
                            path.read_text(), re.S):
        stems = {macro: re.findall(r"int (\w+)##SUFFIX\(", body)
                 for macro, body in re.findall(
                     r"#define (\w+)\(SUFFIX, \w+\)((?:.*\\\n)+)", block)}
        for macro, suffix in re.findall(r"^(\w+)\((\w+), [\w ]+\)$", block,
                                        re.M):
            names |= {stem + suffix for stem in stems.get(macro, ())}
        names |= set(re.findall(r"^int (\w+)\(", block, re.M))
    return names


def test_library_name_tracks_the_sources():
    path = kernel.library_path()
    assert path.parent == kernel.BUILD_DIR
    assert path.name.startswith("libbind_gemm_") and path.suffix == ".so"
    assert path == kernel.library_path()        # deterministic
    assert set(kernel.SYMBOLS) == set(ops.DTYPES)
    assert "sm_90a" in " ".join(kernel.NVCC_FLAGS)
    # every header the source includes is hashed into the library's name
    headers = {h.resolve() for h in kernel.LIBRARY.headers}
    assert _includes(kernel.SOURCES[0]) <= headers
    assert {h.name for h in headers} == {
        "gemm_routes.cuh", "gemm_tile.cuh", "gemm_wgmma.cuh",
        "gemm_dmma.cuh", "gemm_tf32.cuh", "tf32.cuh"}


def test_every_bound_symbol_is_an_extern_c_entry_point():
    """Static: each C symbol the wrapper binds is defined in the source's
    ``extern "C"`` block (no nvcc needed)."""
    defined = extern_c_symbols(kernel.SOURCES[0])
    assert set(kernel.LIBRARY.symbols) <= defined
    assert set(kernel.SYMBOLS.values()) | {kernel.ROUTE_SYMBOL} == defined


KB = 1 << 10


@pytest.mark.parametrize("dtype, m, n, k, addresses, want", [
    (torch.float32, 1024, 1024, 1024, (0, 4 * KB), "f32_3xtf32"),
    (torch.float32, 130, 264, 72, (16, 32), "f32_3xtf32"),  # ragged M
    (torch.float32, 130, 260, 68, (0, 16), "f32_3xtf32"),   # K % 8 == 4
    (torch.float32, 1, 4, 4, (0, 16), "f32_3xtf32"),
    (torch.float32, 130, 260, 70, (4, 8), "f32_simt"),     # any alignment
    (torch.float32, 130, 260, 70, (0, 16), "f32_simt"),    # K % 4
    (torch.float32, 128, 258, 64, (0, 16), "f32_simt"),    # N % 4
    (torch.float32, 1, 1, 128, (0, 16), "f32_simt"),       # (1, 128, 1)
    (torch.float32, 64, 64, 0, (0, 16), "f32_simt"),       # K = 0
    (torch.float32, 1024, 1024, 1024, (4, 4 * KB), "f32_simt"),  # a odd
    (torch.float32, 1024, 1024, 1024, (0, 4 * KB, 8), "f32_simt"),  # level
    (torch.float64, 1024, 1024, 1024, (0, 8 * KB), "f64_dmma"),
    (torch.float64, 1, 1, 128, (8, 24), "f64_dmma"),
    (torch.bfloat16, 1024, 1024, 1024, (0, 2 * KB), "bf16_wgmma"),
    (torch.bfloat16, 130, 264, 72, (16, 32), "bf16_wgmma"),  # ragged M
    (torch.bfloat16, 1, 8, 8, (0, 16), "bf16_wgmma"),
    (torch.bfloat16, 130, 260, 70, (0, 16), "bf16_simt"),   # K % 8
    (torch.bfloat16, 128, 260, 64, (0, 16), "bf16_simt"),   # N % 8
    (torch.bfloat16, 1, 1, 128, (0, 16), "bf16_simt"),      # (1, 128, 1)
    (torch.bfloat16, 64, 64, 0, (0, 16), "bf16_simt"),      # K = 0
    (torch.bfloat16, 1024, 1024, 1024, (2, 2 * KB), "bf16_simt"),  # a odd
    (torch.bfloat16, 1024, 1024, 1024, (0, 8), "bf16_simt"),  # b at 8 bytes
    (torch.bfloat16, 1024, 1024, 1024, (0, 16, 34), "bf16_simt"),  # a level
    # float16 under bfloat16's TMA rule, on the same tile loop
    (torch.float16, 1024, 1024, 1024, (0, 2 * KB), "f16_wgmma"),
    (torch.float16, 130, 264, 72, (16, 32), "f16_wgmma"),  # ragged M
    (torch.float16, 1, 8, 8, (0, 16), "f16_wgmma"),
    (torch.float16, 130, 260, 70, (0, 16), "f16_simt"),    # K % 8
    (torch.float16, 128, 260, 64, (0, 16), "f16_simt"),    # N % 8
    (torch.float16, 1, 1, 128, (0, 16), "f16_simt"),       # (1, 128, 1)
    (torch.float16, 64, 64, 0, (0, 16), "f16_simt"),       # K = 0
    (torch.float16, 1024, 1024, 1024, (2, 2 * KB), "f16_simt"),  # a odd
    (torch.float16, 1024, 1024, 1024, (0, 8), "f16_simt"),  # b at 8 bytes
    (torch.float16, 1024, 1024, 1024, (0, 16, 34), "f16_simt"),  # a level
])
def test_route_by_dtype_shape_and_alignment(dtype, m, n, k, addresses,
                                            want):
    assert ops.route(dtype, m, n, k, addresses) == want
    assert want in ops.ROUTES


@pytest.mark.parametrize("offset, want", [(0, "bf16_wgmma"),
                                          (1, "bf16_simt"),
                                          (8, "bf16_wgmma")])
def test_route_of_a_contiguous_view_at_an_offset(offset, want):
    """A contiguous view that starts ``offset`` elements into its storage:
    TMA needs 16 bytes, so one bf16 element in is the CUDA-core route."""
    m = k = n = 64
    store = torch.zeros(m * k + 16, dtype=torch.bfloat16)
    a = store[offset:offset + m * k].view(m, k)
    b = torch.zeros((k, n), dtype=torch.bfloat16)
    assert a.is_contiguous() and b.data_ptr() % 16 == 0
    base_aligned = store.data_ptr() % 16 == 0
    got = ops.route(a.dtype, m, n, k, (a.data_ptr(), b.data_ptr()))
    assert got == (want if base_aligned else "bf16_simt")


def test_route_enum_matches_the_c_source():
    """``ROUTES`` lists ``bind_gemm::Route``'s names in its order, so the
    launcher's answer indexes it."""
    source = (kernel.SOURCES[0].parent / "gemm_routes.cuh").read_text()
    enum = re.search(r"enum Route : int \{(.*?)\};", source, re.S).group(1)
    pairs = re.findall(r"(\w+) = (\d+)", enum)
    assert ops.ROUTES == tuple(n.lower() for n, i in sorted(
        pairs, key=lambda p: int(p[1])))
    assert [int(i) for _, i in pairs] == list(range(len(pairs)))
    # routes are appended, so no earlier index moves: f16_wgmma came last
    assert ops.ROUTES[:6] == ("f32_simt", "bf16_simt", "bf16_wgmma",
                              "f64_dmma", "f16_simt", "f32_3xtf32")
    assert ops.ROUTES.index("f16_wgmma") == 6


def test_route_rejects_dtypes_without_a_kernel():
    with pytest.raises(TypeError):
        ops.route(torch.int32, 8, 8, 8)


@pytest.mark.parametrize("m, n, k", [(8, 8, 8), (130, 70, 260), (1, 1, 1)])
def test_float16_takes_the_cuda_core_route(m, n, k):
    """Unaligned float16 operands (bases TMA cannot read) run on the
    CUDA-core loop, fp32 inside, at any shape (its index in ROUTES is the
    C enum's, F16_SIMT = 4)."""
    assert ops.route(torch.float16, m, n, k, (2, 6)) == "f16_simt"
    assert ops.ROUTES.index("f16_simt") == 4
    assert kernel.DTYPE_CODES[torch.float16] == 3


def test_cpu_calls_count_no_route():
    a = torch.ones(4, 4)
    ops.matmul(a, a)
    ops.matmul_accumulate(a, a, a)
    assert ops.matmul.routes == {} and ops.matmul_accumulate.routes == {}


# every dtype the GEMM takes: (jax dtype, torch dtype, test_kernels.py's
# tolerance for it); float64 at float32's, since the reference sums
# float64 in float32 (preferred_element_type) where the port sums it in
# float64
ALL_DTYPES = {"float32": (jnp.float32, torch.float32, (1e-4, 1e-3)),
              "bfloat16": (jnp.bfloat16, torch.bfloat16, (2e-2, 2e-1)),
              "float16": (jnp.float16, torch.float16, (2e-2, 2e-1)),
              "float64": (jnp.float64, torch.float64, (1e-4, 1e-3))}


# the accumulator's type for each input type, and the types by precision
ACC = {"float32": "float32", "bfloat16": "float32", "float16": "float32",
       "float64": "float64"}
PRECISION = ("bfloat16", "float16", "float32", "float64")


def out_tolerance(in_name, out_name):
    """An output's tolerance: that of the less precise of the accumulator
    and the output type, so that a wide output of narrow inputs is held to
    the accumulator's precision, not the inputs'."""
    return ALL_DTYPES[min(ACC[in_name], out_name, key=PRECISION.index)][2]


@pytest.mark.parametrize("out_name", sorted(ALL_DTYPES))
@pytest.mark.parametrize("in_name", sorted(ALL_DTYPES))
def test_out_dtype_matches_the_references(in_name, out_name):
    """``matmul(a, b, out_dtype=)`` and ``ref.matmul(a, b, out_dtype)``
    hold to the reference's ``ref.matmul(a, b, out_dtype)`` and its
    interpret-mode ``matmul_pallas(out_dtype=)``, for every pair of the
    four dtypes, within ``out_tolerance`` (the sums run in another order,
    and one rounding to the output type may land an ulp of it apart)."""
    from repro.kernels.gemm import ref as ref_ref
    from repro.kernels.gemm.kernel import matmul_pallas

    jin, tin, _ = ALL_DTYPES[in_name]
    jout, tout, _ = ALL_DTYPES[out_name]
    rtol, atol = out_tolerance(in_name, out_name)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    y = rng.normal(size=(96, 32)).astype(np.float32)
    ta, tb = torch.from_numpy(x).to(tin), torch.from_numpy(y).to(tin)
    with jax.enable_x64(True):      # float64 stays float64 in jax
        ja, jb = jnp.asarray(x, dtype=jin), jnp.asarray(y, dtype=jin)
        outs = (ref_ref.matmul(ja, jb, jout),
                matmul_pallas(ja, jb, bm=32, bn=32, bk=32, out_dtype=jout,
                              interpret=True))
        assert all(o.dtype == jnp.dtype(jout) for o in outs)
        want = [np.asarray(o, np.float64) for o in outs]
    for got in (ref.matmul(ta, tb, tout), ops.matmul(ta, tb, out_dtype=tout)):
        assert got.dtype == tout and tuple(got.shape) == (64, 32)
        for exp in want:
            np.testing.assert_allclose(to_numpy(got).astype(np.float64), exp,
                                       rtol=rtol, atol=atol)
    # the input's own dtype is the default
    assert torch.equal(ops.matmul(ta, tb, out_dtype=tin), ops.matmul(ta, tb))


def _nearest_even(x, bits, emin):
    """float64 ``x`` rounded once to nearest even, to ``bits`` significant
    bits with ``emin`` the exponent of the smallest subnormal step."""
    _, e = np.frexp(x)
    step = np.ldexp(1.0, np.maximum(e - bits, emin))
    return np.rint(x / step) * step


def test_out_dtype_rounds_the_accumulator_once():
    """A float64 product written as bfloat16 or float16 is its float64 sum
    rounded once to nearest even (held to a rounding by hand, on sums that
    lie just past a tie of the narrow type, where torch's own cast, which
    rounds to float32 first, lands on the other side); a bfloat16 product
    written as float32 keeps the float32 sum (no element farther from the
    float64 sum than float32's rounding allows, and not the bfloat16
    output widened)."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(40, 72))
    b = rng.normal(size=(72, 24))
    # rows that are one element, against a first row of B of ones: their
    # sums are exact, a tie of the narrow type plus far less than a float32
    # ulp
    b[0] = 1.0
    ties = [1 + 2.0 ** -8 + 2.0 ** -30, -(3 + 2.0 ** -7 + 2.0 ** -31),
            1 + 2.0 ** -11 + 2.0 ** -40, -(5 + 2.0 ** -9 + 2.0 ** -35)]
    for i, t in enumerate(ties):
        a[i] = 0.0
        a[i, 0] = t
    a64, b64 = torch.from_numpy(a), torch.from_numpy(b)
    exact = (a64 @ b64).numpy()
    for dt, bits, emin in ((torch.bfloat16, 8, -133),
                           (torch.float16, 11, -24)):
        want = _nearest_even(exact, bits, emin)
        twice = (a64 @ b64).to(dt).double().numpy()
        assert (twice[:len(ties)] != want[:len(ties)]).any()
        for got in (ref.matmul(a64, b64, dt),
                    ops.matmul(a64, b64, out_dtype=dt)):
            assert got.dtype == dt
            np.testing.assert_array_equal(got.double().numpy(), want)
    a16 = a64.to(torch.bfloat16)
    b16 = b64.to(torch.bfloat16)
    wide = ops.matmul(a16, b16, out_dtype=torch.float32)
    exact = a16.double() @ b16.double()
    scale = (a16.double().abs() @ b16.double().abs())
    assert bool(((wide.double() - exact).abs()
                 <= 72 * 2.0 ** -24 * scale).all())
    assert not torch.equal(wide, ops.matmul(a16, b16).float())


def test_out_dtype_refuses_a_dtype_without_a_kernel():
    a = torch.ones(4, 4)
    with pytest.raises(TypeError, match="out_dtype"):
        ops.matmul(a, a, out_dtype=torch.int32)


def test_entry_points_take_the_output_type_code():
    """Static: each dtype's entry point of ``csrc/gemm.cu`` takes the
    output type's code before the stream, and ``kernel.launch`` binds
    it."""
    source = kernel.SOURCES[0].read_text()
    for sym in kernel.SYMBOLS.values():
        params = re.search(rf"int {sym}\(([^)]*)\)", source).group(1)
        assert "int out_dtype, void* stream" in " ".join(params.split())
        assert params.count(",") + 1 == len(kernel.LIBRARY.symbols[sym])


# --------------------------------------------------------------------------
# The f32_3xtf32 route's arithmetic, emulated on the CPU
# --------------------------------------------------------------------------

TF32_PANEL = 32        # csrc/gemm_tf32.cuh TF_BK: the K panel summed apart


FLT_MAX = float(np.finfo(np.float32).max)


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last 13 bits dropped: the TF32 the tensor cores read
    of a float32 register."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as the route's ``tf32_rna``
    (``cvt.rna.tf32.f32``) rounds it: to nearest with ties away from zero
    for finite values and +-inf, a NaN truncated (it stays a NaN unless its
    top 10 mantissa bits are 0)."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), _trunc(x), rounded)


def _lo(x: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``x``'s lo half beside ``hi = _tf32(x)`` as the tensor cores read
    it: x - hi (exact in float32) truncated to TF32; NaN for +-inf and
    NaN."""
    return torch.where(torch.isfinite(x), _trunc(x - hi),
                       torch.tensor(float("nan")))


def _emulate_3xtf32(a: torch.Tensor, b: torch.Tensor,
                    products=("hi.hi", "hi.lo", "lo.hi"),
                    nan_lo_dropped=True) -> torch.Tensor:
    """The route's sum for float32 ``a @ b``: each operand split into hi =
    tf32(x) and lo = x - hi; per 32-wide K panel hi.hi apart from the lo
    products (each panel's products exact, in float64, then rounded once
    to float32 as an fp32 accumulator would hold them), the panel's
    hi.hi + fmax(lo, -FLT_MAX) (hi.hi + lo if ``nan_lo_dropped`` is false)
    rounded to float32 and added to the float32 sum.  The tensor cores'
    truncating adds inside a panel are not modelled."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _lo(a, a_hi), _lo(b, b_hi)
    terms = {"hi.hi": (a_hi, b_hi), "hi.lo": (a_hi, b_lo),
             "lo.hi": (a_lo, b_hi)}
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], TF32_PANEL):
        ks = slice(k0, k0 + TF32_PANEL)
        panel = {name: (x[:, ks].double() @ y[ks].double()).float()
                 for name, (x, y) in terms.items() if name in products}
        hh = panel.get("hi.hi", torch.zeros_like(acc))
        lo = sum((panel[n] for n in ("hi.lo", "lo.hi") if n in panel),
                 torch.zeros_like(acc))
        if nan_lo_dropped:
            lo = torch.fmax(lo, torch.tensor(-FLT_MAX))
        acc = acc + (hh + lo)
    return acc


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """``_tf32`` keeps 10 mantissa bits: a value half a TF32 step above a
    TF32 number rounds away from zero, just below it rounds down, and lo
    recovers x to within 2^-21 of it.  +-inf keeps its bits and a NaN its
    top 10 mantissa bits: CUDA's canonical 0x7FFFFFFF (which the add alone
    would carry into -0.0), its negative and torch's 0x7FC00000 stay NaNs
    and so are their lo halves; a signalling NaN with nothing in its top 10
    mantissa bits becomes inf (as the tensor cores read it)."""
    one = 1.0
    step = 2.0 ** -10
    x = torch.tensor([one + step / 2, -(one + step / 2),
                      one + step / 2 - 2.0 ** -23, 3.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [one + step, -(one + step), one, 3.0]
    special = torch.tensor([0x7F800000, -0x800000, 0x7FFFFFFF, -1,
                            0x7FC00000, 0x7F800001],
                           dtype=torch.int32).view(torch.float32)
    assert _tf32(special).view(torch.int32).tolist() == [
        0x7F800000, -0x800000, 0x7FFFE000, -0x2000, 0x7FC00000, 0x7F800000]
    assert bool(torch.isnan(_lo(special, _tf32(special))).all())
    v = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    hi = _tf32(v)
    lo = _lo(v, hi)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_trunc(lo), lo)
    rel = ((hi.double() + lo.double() - v.double()).abs()
           / v.double().abs()).max().item()
    assert rel <= 2.0 ** -21


@pytest.mark.parametrize("m, k, n", [(256, 256, 256), (256, 2048, 256)])
def test_3xtf32_emulation_holds_the_reference_and_sees_its_faults(m, k, n):
    """The route's arithmetic (three TF32 products of hi and lo halves, each
    K panel summed apart, panel sums added in float32), emulated here, is
    within the float32 tolerance of the reference's ``ref.matmul`` on the
    same values; the faults the card's checks plant (``hi.hi`` alone,
    ``hi.lo`` dropped) fall outside it, so the tolerance sees them."""
    from repro.kernels.gemm import ref as ref_jax

    rng = np.random.default_rng(31)
    a_np = rng.normal(size=(m, k)).astype(np.float32)
    b_np = rng.normal(size=(k, n)).astype(np.float32)
    exp = torch.from_numpy(np.array(
        ref_jax.matmul(jnp.asarray(a_np), jnp.asarray(b_np))))
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    rtol, atol = DTYPES["float32"][2]
    got = _emulate_3xtf32(a, b)
    torch.testing.assert_close(got, exp, rtol=rtol, atol=atol)
    exact = a.double() @ b.double()
    err = (got.double() - exact).abs().max().item()
    for fault in (("hi.hi",), ("hi.hi", "lo.hi")):
        bad = _emulate_3xtf32(a, b, fault)
        assert not torch.allclose(bad, exp, rtol=rtol, atol=atol), fault
        assert (bad.double() - exact).abs().max().item() > 10 * err, fault


def test_3xtf32_emulation_is_non_finite_where_the_product_is():
    """NaNs (CUDA's canonical one, its negative, torch's and its negative)
    and infinities of both signs in ``a`` and ``b``: the route's sum is
    NaN, +inf and -inf exactly where the IEEE product is.  Without the
    panel's fmax (the lo products' NaN dropped) an infinite operand gives
    NaN where the product is +-inf: its lo is inf - inf."""
    rng = np.random.default_rng(31)
    a = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(96, 48)).astype(np.float32))
    for t, at, bits in ((a, (3, 5), 0x7FFFFFFF), (a, (10, 70), -1),
                        (a, (20, 0), 0x7FC00000), (a, (7, 95), 0x7F800000),
                        (a, (8, 40), -0x800000), (a, (9, 41), 0x7F800000),
                        (a, (9, 42), 0x7F800000), (b, (9, 20), -0x800000),
                        (b, (60, 33), 0x7F800000), (b, (90, 40), -0x400000),
                        (b, (95, 30), -0x800000)):
        t.view(torch.int32)[at] = bits
    b[40, 11] = 0.0                      # -inf x 0 in row 8
    exact = a.double() @ b.double()

    def pattern(x):
        return torch.isnan(x), torch.isposinf(x), torch.isneginf(x)

    want = pattern(exact)
    assert all(bool(w.any()) for w in want)
    got = pattern(_emulate_3xtf32(a, b))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    bad = pattern(_emulate_3xtf32(a, b, nan_lo_dropped=False))
    assert not torch.equal(bad[0], want[0])
