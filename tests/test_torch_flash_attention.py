"""The port's flash attention against the reference Pallas kernel.

On the CPU the port's ``flash_attention`` pads exactly as the reference's
wrapper does and computes the kernel's plain version, the oracle on the
padded inputs (the CUDA kernel runs only on the card, where
``chip_smoke.py`` holds it against this same plain version).  Here it is
held against ``repro.kernels.flash_attention.ops.flash_attention`` run in
Pallas interpret mode on the same NumPy inputs, at the reference's cases
and tolerances (``tests/test_kernels.py``: f32 2e-5, bf16 3e-2), and the
padding quirk, the wrapper's checks, ``attn_step`` and the launch counter
are pinned.
"""

import ctypes
import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import ATTN_CASES
from test_torch_gemm import _includes, extern_c_symbols

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention import ref as ref_oracle
from repro_torch.kernels.flash_attention import kernel, ops, ref


@pytest.fixture(autouse=True)
def _zero_counter():
    ops.flash_attention.launches = 0
    yield
    # a CPU call computes the plain version and never launches the kernel
    assert ops.flash_attention.launches == 0


def _qkv(rng, b, hq, hkv, sq, skv, d):
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _reference(qkv, **kw):
    return np.asarray(ref_ops.flash_attention(
        *(jnp.asarray(t) for t in qkv), interpret=True, **kw))


def _port(qkv, **kw):
    out = ops.flash_attention(*(torch.from_numpy(t) for t in qkv), **kw)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", ATTN_CASES)
def test_matches_reference(b, hq, hkv, sq, skv, d, causal, window, rng):
    qkv = _qkv(rng, b, hq, hkv, sq, skv, d)
    kw = dict(causal=causal, window=window, bq=16, bkv=16)
    got = _port(qkv, **kw)
    assert got.shape == (b, hq, sq, d)
    np.testing.assert_allclose(got, _reference(qkv, **kw), rtol=2e-5,
                               atol=2e-5)


def test_bf16(rng):
    qkv = _qkv(rng, 1, 4, 2, 64, 64, 16)
    exp = np.asarray(ref_ops.flash_attention(
        *(jnp.asarray(t, dtype=jnp.bfloat16) for t in qkv), bq=32, bkv=32,
        interpret=True), np.float32)
    got = ops.flash_attention(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in qkv), bq=32,
        bkv=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), exp, rtol=3e-2,
                               atol=3e-2)


def test_window_covering_the_sequence_equals_full_causal(rng):
    qkv = [torch.from_numpy(t) for t in _qkv(rng, 1, 2, 2, 32, 32, 8)]
    full = ops.flash_attention(*qkv, causal=True, bq=16, bkv=16)
    swa = ops.flash_attention(*qkv, causal=True, window=64, bq=16, bkv=16)
    np.testing.assert_allclose(full.numpy(), swa.numpy(), rtol=1e-6)


@pytest.mark.parametrize("sq,skv,window", [(24, 40, None), (48, 32, None),
                                           (40, 56, 12)],
                         ids=["sq<skv", "sq>skv", "sq<skv-window"])
def test_gqa_with_more_or_fewer_queries_than_keys(sq, skv, window, rng):
    """Positions are top-left aligned for both: row r sees keys <= r."""
    qkv = _qkv(rng, 2, 6, 2, sq, skv, 8)
    kw = dict(causal=True, window=window, bq=16, bkv=16)
    got = _port(qkv, **kw)
    np.testing.assert_allclose(got, _reference(qkv, **kw), rtol=2e-5,
                               atol=2e-5)
    oracle = np.asarray(ref_oracle.attention(
        *(jnp.asarray(t) for t in qkv), causal=True, window=window))
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


def test_padded_keys_quirk_is_the_reference_wrappers(rng):
    """Non-causal windowed attention over a ragged Skv: the reference's
    wrapper pads K and V with zeros that no mask hides, so every row also
    attends to the padded keys.  The port pads the same way: it equals the
    reference's wrapper and, like it, differs from the oracle."""
    qkv = _qkv(rng, 1, 2, 2, 33, 33, 8)
    kw = dict(causal=False, window=8, bq=16, bkv=16)
    got = _port(qkv, **kw)
    np.testing.assert_allclose(got, _reference(qkv, **kw), rtol=2e-5,
                               atol=2e-5)
    oracle = np.asarray(ref_oracle.attention(
        *(jnp.asarray(t) for t in qkv), causal=False, window=8))
    assert np.abs(got - oracle).max() > 0.1
    plain = ops.flash_attention(*(torch.from_numpy(t) for t in qkv),
                                causal=False, window=8, backend="plain")
    np.testing.assert_allclose(plain.numpy(), oracle, rtol=1e-6, atol=1e-6)


def test_row_that_sees_no_key_gives_zeros(rng):
    """Sq > Skv under causal + window: padded query rows past the keys see
    none.  The port gives them zeros, as the oracle does on the padded
    inputs, whatever the tiling; the reference's kernel gives such a row the
    mean of the values its running blocks masked (exp(-1e30 + 1e30) = 1),
    so the two differ there and only there (ROADMAP Queue 3)."""
    qkv = _qkv(rng, 1, 4, 2, 40, 24, 8)
    kw = dict(causal=True, window=6, bq=16, bkv=16)
    got = _port(qkv, **kw)
    padded = ops.pad(*(torch.from_numpy(t) for t in qkv), causal=True,
                     window=6, bq=16, bkv=16)
    seen = ref.mask(48, 32, causal=True, window=6, device="cpu")
    blind = ~seen.any(dim=-1)[:40]
    assert blind.any()
    assert not got[:, :, blind.numpy()].any()
    exp = ref.attention(*padded, causal=True, window=6)[:, :, :40]
    np.testing.assert_array_equal(got, exp.numpy())
    theirs = _reference(qkv, **kw)
    np.testing.assert_allclose(got[:, :, ~blind.numpy()],
                               theirs[:, :, ~blind.numpy()], rtol=2e-5,
                               atol=2e-5)
    assert np.abs(theirs[:, :, blind.numpy()]).max() > 0.1


def test_non_causal_unwindowed_ragged_keys_raise(rng):
    qkv = _qkv(rng, 1, 2, 2, 32, 33, 8)
    with pytest.raises(AssertionError, match="non-causal"):
        _reference(qkv, causal=False, bq=16, bkv=16)
    with pytest.raises(ValueError, match="non-causal"):
        _port(qkv, causal=False, bq=16, bkv=16)
    # unpadded, it runs
    qkv = _qkv(rng, 1, 2, 2, 32, 32, 8)
    _port(qkv, causal=False, bq=16, bkv=16)


def test_plain_backend_is_the_oracle(rng):
    qkv = _qkv(rng, 2, 4, 2, 33, 33, 8)
    got = _port(qkv, causal=True, window=5, scale=0.3, backend="plain")
    exp = ref_oracle.attention(*(jnp.asarray(t) for t in qkv), causal=True,
                               window=5, scale=0.3)
    np.testing.assert_allclose(got, np.asarray(exp), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("edit, error, match", [
    (lambda q, k, v: (q.double(), k.double(), v.double()), TypeError,
     "float64"),
    (lambda q, k, v: (q, k.bfloat16(), v), TypeError, "mixed"),
    (lambda q, k, v: (q[0], k[0], v[0]), ValueError, "shape"),
    (lambda q, k, v: (q, k[:, :1].expand(1, 3, 16, 8).contiguous(),
                      v[:, :1].expand(1, 3, 16, 8).contiguous()),
     ValueError, "kv heads"),
    (lambda q, k, v: (q, k, v[..., :4].contiguous()), ValueError,
     "fit together"),
    (lambda q, k, v: (torch.ones(1, 4, 16, 300), torch.ones(1, 2, 16, 300),
                      torch.ones(1, 2, 16, 300)), ValueError, "head dim"),
    (lambda q, k, v: (q.numpy(), k, v), TypeError, "ndarray"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(edit, error, match):
    q, k, v = torch.ones(1, 4, 16, 8), torch.ones(1, 2, 16, 8), \
        torch.ones(1, 2, 16, 8)
    with pytest.raises(error, match=match):
        ops.flash_attention(*edit(q, k, v))
    with pytest.raises(ValueError, match="backend"):
        ops.flash_attention(q, k, v, backend="xla")


def test_transposed_views_match_reference(rng):
    """Views laid out (B, S, H, D), as a projection gives them, transposed
    to (B, H, S, D): attended as the reference attends the same arrays
    (the wrapper copies them into row-major ones first)."""
    q, k, v = (t.transpose(0, 2, 1, 3).copy()
               for t in _qkv(rng, 1, 4, 2, 32, 32, 8))
    kw = dict(causal=True, window=None, bq=16, bkv=16)
    exp = np.asarray(ref_ops.flash_attention(
        *(jnp.asarray(t).transpose(0, 2, 1, 3) for t in (q, k, v)),
        interpret=True, **kw))
    views = [torch.from_numpy(t).transpose(1, 2) for t in (q, k, v)]
    assert not any(t.is_contiguous() for t in views)
    got = ops.flash_attention(*views, **kw)
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-5, atol=2e-5)


def test_attn_step_matches_the_reference_body(rng):
    from repro.kernels.flash_attention.ops import attn_step as ref_step

    o, q = rng.normal(size=(6, 5)), rng.normal(size=(6, 4))
    k, v = rng.normal(size=(7, 4)), rng.normal(size=(7, 5))
    vals = [t.astype(np.float32) for t in (o, q, k, v)]
    exp = np.asarray(ref_step(*(jnp.asarray(t) for t in vals)))
    got = ops.attn_step(*(torch.from_numpy(t) for t in vals))
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 5)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)
    # NumPy tiles give what jax gives them: a float32 array (a CPU tensor
    # here), with the body's arithmetic
    got_np = ops.attn_step(*vals)
    assert isinstance(got_np, torch.Tensor) and got_np.device.type == "cpu"
    assert got_np.dtype == torch.float32
    np.testing.assert_allclose(got_np.numpy(), exp, rtol=1e-5, atol=1e-5)
    assert ops.attn_step.__bind_kernel__ == ref_step.__bind_kernel__ == "dot"
    assert ops.attn_step.__bind_vmap__ is False


def test_library_is_named_by_its_sources_and_headers():
    path = kernel.LIBRARY.path()
    assert path.name.startswith("libbind_flash_attention_")
    assert {h.name for h in kernel.LIBRARY.headers} == {
        "attn_tile.cuh", "attn_wgmma.cuh", "attn_tf32.cuh",
        "attn_tf32_wide.cuh", "gemm_tile.cuh", "gemm_wgmma.cuh", "tf32.cuh"}
    # every header the source includes, the new route's too, is hashed
    # into the library's name
    headers = {h.resolve() for h in kernel.LIBRARY.headers}
    assert _includes(kernel.SOURCES[0]) <= headers
    assert set(kernel.SUFFIX) == set(ops.DTYPES)
    assert set(kernel.LIBRARY.symbols) == {
        f"bind_flash_attention_{s}" for s in kernel.SUFFIX.values()} | {
        kernel.ROUTE_SYMBOL, kernel.LSE_SYMBOL, kernel.F16_LSE_SYMBOL,
        kernel.F32_LSE_SYMBOL}
    assert kernel.ROUTE_SYMBOL == "bind_flash_attention_route"
    # the log-sum-exp entry points are the bf16, f16 and f32 ones with one
    # more pointer
    assert kernel.LSE_SYMBOL == "bind_flash_attention_bf16_lse"
    assert kernel.F16_LSE_SYMBOL == "bind_flash_attention_f16_lse"
    assert kernel.F32_LSE_SYMBOL == "bind_flash_attention_f32_lse"
    assert kernel.LSE_SYMBOLS == {torch.bfloat16: kernel.LSE_SYMBOL,
                                  torch.float16: kernel.F16_LSE_SYMBOL,
                                  torch.float32: kernel.F32_LSE_SYMBOL}
    for dtype, sym in kernel.LSE_SYMBOLS.items():
        plain = kernel.LIBRARY.symbols[
            f"bind_flash_attention_{kernel.SUFFIX[dtype]}"]
        assert kernel.LIBRARY.symbols[sym] == (
            plain[:4] + (ctypes.c_void_p,) + plain[4:])


def test_every_bound_symbol_is_an_extern_c_entry_point_with_its_arity():
    """Static: each C symbol the wrapper binds is defined in the source's
    ``extern "C"`` block, with as many parameters as ctypes passes (no
    nvcc needed)."""
    source = kernel.SOURCES[0].read_text()
    assert set(kernel.LIBRARY.symbols) == extern_c_symbols(kernel.SOURCES[0])
    for sym, argtypes in kernel.LIBRARY.symbols.items():
        params = re.search(rf"int {sym}\((.*?)\)", source, re.S).group(1)
        assert params.count(",") + 1 == len(argtypes), sym



def test_wgmma_head_dims_are_one_rule_in_python_and_both_c_routes():
    """Static: ``ops.WGMMA_HEAD_DIMS`` is the set ``wgmma_head_dim`` of
    ``csrc/attn_wgmma.cuh`` admits, both C ``route_of``s (forward and
    backward) ask that one function for bfloat16 and for float16 alike,
    and each tensor-core launcher instantiates exactly those head dims (no
    nvcc needed)."""
    csrc = kernel.SOURCES[0].parent
    rule = re.search(r"bool wgmma_head_dim\(int64_t d\) \{(.*?)\}",
                     (csrc / "attn_wgmma.cuh").read_text(), re.S).group(1)
    assert tuple(sorted(int(x) for x in re.findall(r"d == (\d+)", rule))) \
        == ops.WGMMA_HEAD_DIMS
    forward = kernel.SOURCES[0].read_text()
    backward = kernel.BWD_SOURCES[0].read_text()
    for source in (forward, backward):
        body = re.search(r"route_of\([^)]*\) \{.*?\n\}", source,
                         re.S).group(0)
        assert "bind_attn_wg::wgmma_head_dim(d)" in body
        assert "% 64" not in body
        # each 16-bit tensor-core route is chosen by that one rule: the
        # statement that returns it asks wgmma_head_dim
        for route in ("BF16_WGMMA", "F16_WGMMA"):
            chosen = [s for s in body.split(";")
                      if re.search(rf"\b{route}\b", s)]
            assert len(chosen) == 1, route
            assert "bind_attn_wg::wgmma_head_dim(d)" in chosen[0], route
    switches = (
        re.search(r"cudaError_t launch_wgmma\(.*?\n\}", forward, re.S),
        re.search(r"inline cudaError_t launch\(.*?\n\}",
                  (csrc / "attn_bwd_wgmma.cuh").read_text(), re.S))
    for switch in switches:
        cases = re.findall(r"case (\d+):", switch.group(0))
        assert tuple(int(c) for c in cases) == ops.WGMMA_HEAD_DIMS


def test_tf32_head_dims_are_one_rule_in_python_and_both_c_routes():
    """Static: ``ops.TF32_HEAD_DIMS`` is the set ``tf32_head_dim`` of
    ``csrc/attn_tf32.cuh`` admits (80 and 256 among them, 32 / 64 / 96 /
    128 kept; 256 runs the blocks of ``attn_tf32_wide.cuh`` and
    ``attn_bwd_tf32_wide.cuh``), both C ``route_of``s (forward and
    backward) ask that one function, and each 3xTF32 launcher instantiates
    exactly those head dims (no nvcc needed)."""
    csrc = kernel.SOURCES[0].parent
    rule = re.search(r"bool tf32_head_dim\(int64_t d\) \{(.*?)\}",
                     (csrc / "attn_tf32.cuh").read_text(), re.S).group(1)
    assert tuple(sorted(int(x) for x in re.findall(r"d == (\d+)", rule))) \
        == ops.TF32_HEAD_DIMS
    assert {32, 64, 80, 96, 128, 256} <= set(ops.TF32_HEAD_DIMS)
    assert all(d % 16 == 0 and (d <= 128 or d == 256)
               for d in ops.TF32_HEAD_DIMS)
    forward = kernel.SOURCES[0].read_text()
    backward = kernel.BWD_SOURCES[0].read_text()
    for source in (forward, backward):
        body = re.search(r"route_of\([^)]*\) \{.*?\n\}", source,
                         re.S).group(0)
        assert "bind_attn_tf::tf32_head_dim(d)" in body
        assert "% 32" not in body
    switches = (
        re.search(r"cudaError_t launch_tf32\(.*?\n\}", forward, re.S),
        re.search(r"inline cudaError_t launch\(.*?\n\}",
                  (csrc / "attn_bwd_tf32.cuh").read_text(), re.S))
    for switch in switches:
        cases = re.findall(r"case (\d+):", switch.group(0))
        assert tuple(int(c) for c in cases) == ops.TF32_HEAD_DIMS

KB = 1 << 10


@pytest.mark.parametrize("dtype, d, addresses, want", [
    # float32 goes to the tensor cores (3xTF32) at TF32_HEAD_DIMS (whole
    # 32-column panels, or d 80's last panel of 16; d 256 on blocks of its
    # own), else it stays on the CUDA cores
    *[(torch.float32, d, (0, 4 * KB, 8 * KB, 12 * KB),
       "f32_3xtf32" if d in (64, 80, 128, 256) else "f32_simt")
      for d in (16, 64, 80, 128, 256, 320)],
    (torch.float32, 128, (4, 8, 12, 20), "f32_simt"),
    # bfloat16: the head dims of the 64-column panels, whole or with a last
    # panel of 16 / 32 real columns, up to 256
    (torch.bfloat16, 16, (0, 16, 32, 48), "bf16_simt"),
    (torch.bfloat16, 48, (0, 16, 32, 48), "bf16_simt"),
    (torch.bfloat16, 64, (0, 16, 32, 48), "bf16_wgmma"),
    (torch.bfloat16, 80, (0, 16, 32, 48), "bf16_wgmma"),   # h2o-danube
    (torch.bfloat16, 96, (0, 16, 32, 48), "bf16_wgmma"),   # Phi-3-vision
    (torch.bfloat16, 112, (0, 16, 32, 48), "bf16_simt"),
    (torch.bfloat16, 128, (0, 16, 32, 48), "bf16_wgmma"),  # Qwen3-14B
    (torch.bfloat16, 160, (0, 16, 32, 48), "bf16_simt"),
    (torch.bfloat16, 192, (0, 16, 32, 48), "bf16_wgmma"),
    (torch.bfloat16, 256, (0, 16, 32, 48), "bf16_wgmma"),  # RecurrentGemma
    (torch.bfloat16, 320, (0, 16, 32, 48), "bf16_simt"),
    (torch.bfloat16, 0, (0, 16, 32, 48), "bf16_simt"),
    # and TMA must read every operand: q, k, v, out each 16-byte aligned
    (torch.bfloat16, 128, (2, 16, 32, 48), "bf16_simt"),
    (torch.bfloat16, 128, (0, 8, 32, 48), "bf16_simt"),
    (torch.bfloat16, 128, (0, 16, 34, 48), "bf16_simt"),
    (torch.bfloat16, 256, (0, 16, 32, 56), "bf16_simt"),
    (torch.bfloat16, 96, (0, 16, 34, 48), "bf16_simt"),
    (torch.bfloat16, 80, (0, 16, 32, 50), "bf16_simt"),
    (torch.bfloat16, 128, (), "bf16_wgmma"),
    (torch.bfloat16, 96, (), "bf16_wgmma"),
])
def test_route_by_dtype_head_dim_and_alignment(dtype, d, addresses, want):
    assert ops.route(dtype, d, addresses) == want
    assert want in ops.ROUTES


@pytest.mark.parametrize("d, addresses, want", [
    # the 32-column panels of the 3xTF32 loop: d 32, 64, 96, 128, and 80
    # (h2o-danube) with a last panel of 16 real columns; d 256
    # (RecurrentGemma-9B, Gemma-7B) on the 64-row blocks of its own
    *[(d, (0, 16, 32, 48), "f32_3xtf32") for d in (32, 64, 80, 96, 128,
                                                   256)],
    (128, (), "f32_3xtf32"),
    (80, (), "f32_3xtf32"),
    # head dims outside TF32_HEAD_DIMS (192: no key tile fits beside 128
    # rows of Q hi and lo, and no model has it)
    *[(d, (0, 16, 32, 48), "f32_simt") for d in (0, 8, 16, 48, 100, 160,
                                                 192)],
    (80, (0, 16, 32, 52), "f32_simt"),
    # misaligned operands: any of q, k, v, out off 16 bytes (a view at an
    # odd element offset)
    (128, (4, 16, 32, 48), "f32_simt"),
    (128, (0, 20, 32, 48), "f32_simt"),
    (128, (0, 16, 40, 48), "f32_simt"),
    (64, (0, 16, 32, 52), "f32_simt"),
])
def test_float32_route_takes_the_tensor_cores_where_panels_fit(d, addresses,
                                                              want):
    assert ops.route(torch.float32, d, addresses) == want


def test_float16_route_and_route_order():
    """float16 takes bfloat16's rule: the tensor cores (``f16_wgmma``, the
    same loop instantiated for f16) at :data:`ops.WGMMA_HEAD_DIMS` with q,
    k, v and out 16-byte aligned, the CUDA-core loop (``f16_simt``) at any
    other head dim or alignment; the names are in the C enum's order
    (Route of flash_attention.cu, ``f16_wgmma`` appended)."""
    for d in (16, 64, 128, 256):
        assert ops.route(torch.float16, d, (2, 6, 10, 14)) == "f16_simt"
        assert ops.route(torch.float16, d, (0, 16, 32, 48)) == (
            "f16_wgmma" if d in ops.WGMMA_HEAD_DIMS else "f16_simt")
    assert ops.ROUTES == ("f32_simt", "bf16_simt", "bf16_wgmma",
                          "f32_3xtf32", "f16_simt", "f16_wgmma")
    source = kernel.SOURCES[0].read_text()
    enum = re.search(r"enum Route : int \{([^}]*)\}", source).group(1)
    names = [n.split("=")[0].strip().lower() for n in enum.split(",")]
    assert tuple(names) == ops.ROUTES
    assert kernel.DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1,
                                  torch.float16: 2}


@pytest.mark.parametrize("d, addresses, want", [
    # the head dims of the 64-column panels, whole or with a last panel of
    # 16 / 32 real columns, as bfloat16's
    *[(d, (0, 16, 32, 48),
       "f16_wgmma" if d in (64, 80, 96, 128, 192, 256) else "f16_simt")
      for d in (0, 16, 48, 64, 80, 96, 112, 128, 160, 192, 256, 320)],
    (128, (), "f16_wgmma"),
    (80, (), "f16_wgmma"),
    # TMA must read each of q, k, v and out: one 2-byte element off 16
    *[(d, (0, 16, 32, 48)[:i] + ((0, 16, 32, 48)[i] + 2,)
       + (0, 16, 32, 48)[i + 1:], "f16_simt")
      for d in (80, 96, 128, 256) for i in range(4)],
])
def test_float16_route_mirrors_bfloat16s(d, addresses, want):
    assert ops.route(torch.float16, d, addresses) == want
    bf16 = ops.route(torch.bfloat16, d, addresses)
    assert want == bf16.replace("bf16", "f16")


def test_odd_offset_float32_views_take_the_cuda_cores():
    """A contiguous view one element into its storage is 4 bytes off 16:
    the 3xTF32 loop's 16-byte loads cannot read it."""
    base = torch.zeros(1 + 2 * 4 * 128)
    view = base[1:].view(1, 2, 4, 128)
    whole = torch.zeros(1, 2, 4, 128)
    addrs = [t.data_ptr() for t in (view, whole, whole, whole)]
    assert ops.route(torch.float32, 128, addrs) == "f32_simt"
    addrs = [t.data_ptr() for t in (whole, whole, whole, whole)]
    assert all(a % 16 == 0 for a in addrs)
    assert ops.route(torch.float32, 128, addrs) == "f32_3xtf32"


def test_route_rejects_dtypes_without_a_kernel():
    with pytest.raises(TypeError):
        ops.route(torch.float64, 128)


def test_cpu_calls_count_no_route(rng):
    ops.flash_attention.routes = {}
    qkv = _qkv(rng, 1, 2, 2, 16, 16, 64)
    _port(qkv, bq=16, bkv=16)
    assert ops.flash_attention.routes == {}


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "odd-offset"])
@pytest.mark.parametrize("agree", [True, False], ids=["agree", "disagree"])
def test_route_taken_is_the_launchers_held_to_the_rule(monkeypatch, offset,
                                                       agree):
    """The wrapper counts the route the built launcher reports for the very
    operands it launches on (here a stand-in for the library) and raises,
    before any launch, when that is not what ``ops.route`` gives them."""
    store = torch.zeros(4 * 2 * 64 * 128 + 1, dtype=torch.bfloat16)
    q, k, v, out = (store[offset + i * 2 * 64 * 128:][:2 * 64 * 128]
                    .view(1, 2, 64, 128) for i in range(4))
    addresses = [t.data_ptr() for t in (q, k, v, out)]
    want = ops.route(torch.bfloat16, 128, addresses)
    assert want == ("bf16_wgmma" if addresses[0] % 16 == 0 and offset == 0
                    else "bf16_simt")
    other = next(r for r in ops.ROUTES if r != want)
    asked = []

    def launcher_route(dtype, *args):
        asked.append((dtype, args))
        return ops.ROUTES.index(want if agree else other)

    monkeypatch.setattr(kernel, "launcher_route", launcher_route)
    if agree:
        assert ops._route_taken(q, k, v, out) == want
    else:
        with pytest.raises(RuntimeError, match="the launcher takes"):
            ops._route_taken(q, k, v, out)
    assert asked == [(torch.bfloat16, (*addresses, 128))]


# ---------------------------------------------------------------------------
# the gradient: the autograd Function around the entry point, and the
# backward kernel's plain version, against jax.grad of the reference oracle
# ---------------------------------------------------------------------------

import jax  # noqa: E402

# float32 sums in another order (the port's explicit softmax backward
# against XLA's autodiff of the einsum oracle): a few float32 ulps of the
# largest gradient
GRAD_TOL = 2e-5

GRAD_CASES = [
    *ATTN_CASES,                                  # MHA, GQA 2:1, MQA, ...
    (1, 8, 2, 40, 40, 16, True, 12),              # GQA 4:1, windowed
    (2, 4, 1, 37, 37, 8, True, 9),                # MQA, ragged, windowed
    # the head dims whose last 64-column panel is partly real on the card
    (1, 4, 1, 48, 48, 80, True, None),            # h2o-danube: GQA 4:1
    (1, 2, 2, 40, 40, 96, True, None),            # Phi-3-vision: MHA
    (1, 4, 2, 33, 33, 96, True, 10),              # GQA, ragged, windowed
]


def _ref_grads(qkv, dout, *, causal, window, pad_to=None):
    """jax.grad of the reference oracle (on zero-padded q, k, v when
    ``pad_to`` = (Sq', Skv'), cut back to Sq: the padded function the
    entry point computes)."""
    sq = qkv[0].shape[2]

    def f(q, k, v):
        if pad_to is not None:
            q = jnp.pad(q, ((0, 0), (0, 0), (0, pad_to[0] - sq), (0, 0)))
            pk = ((0, 0), (0, 0), (0, pad_to[1] - k.shape[2]), (0, 0))
            k, v = jnp.pad(k, pk), jnp.pad(v, pk)
        out = ref_oracle.attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out[:, :, :sq] * dout)

    return [np.asarray(g) for g in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(t) for t in qkv))]


def _port_grads(qkv, dout, **kw):
    q, k, v = (torch.from_numpy(t).requires_grad_(True) for t in qkv)
    out = ops.flash_attention(q, k, v, **kw)
    out.backward(torch.from_numpy(dout))
    return out, [t.grad.numpy() for t in (q, k, v)]


def _close_grads(got, want, tol=GRAD_TOL):
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", GRAD_CASES)
def test_gradient_matches_jax_grad_of_the_oracle(b, hq, hkv, sq, skv, d,
                                                 causal, window, rng):
    qkv = _qkv(rng, b, hq, hkv, sq, skv, d)
    dout = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    # one tile of 64: where the keys are ragged, the padded keys stay
    # hidden from every row (causal), so this is the oracle's own gradient
    kw = dict(causal=causal, window=window, bq=64, bkv=64)
    out, got = _port_grads(qkv, dout, **kw)
    assert out.grad_fn is not None
    _close_grads(got, _ref_grads(qkv, dout, causal=causal, window=window))


def test_gradient_of_the_padded_function_with_small_tiles(rng):
    """Ragged Sq and Skv padded to tiles of 16: the entry point
    differentiates the padded function, whose padding rows its slice
    cuts."""
    qkv = _qkv(rng, 1, 4, 2, 33, 33, 8)
    dout = rng.normal(size=(1, 4, 33, 8)).astype(np.float32)
    _, got = _port_grads(qkv, dout, causal=True, window=None, bq=16, bkv=16)
    _close_grads(got, _ref_grads(qkv, dout, causal=True, window=None,
                                 pad_to=(48, 48)))


def test_gradient_of_the_padded_keys_quirk_is_the_padded_functions(rng):
    """Non-causal windowed attention over a ragged Skv attends to the
    padded zero keys (the reference wrapper's quirk): the gradient is that
    of the padded function, not of the oracle on the unpadded inputs."""
    qkv = _qkv(rng, 1, 2, 2, 33, 33, 8)
    dout = rng.normal(size=(1, 2, 33, 8)).astype(np.float32)
    kw = dict(causal=False, window=8)
    _, got = _port_grads(qkv, dout, bq=16, bkv=16, **kw)
    _close_grads(got, _ref_grads(qkv, dout, pad_to=(48, 48), **kw))
    unpadded = _ref_grads(qkv, dout, **kw)
    assert np.abs(got[0] - unpadded[0]).max() > 1e-2


def test_row_that_sees_no_key_gets_a_zero_gradient(rng):
    """Rows past Skv + window see no key: their output is zero and so is
    their gradient, as jax.grad of the oracle gives on the padded inputs
    (the pinned divergence from the reference's kernel is in the forward
    only)."""
    qkv = _qkv(rng, 1, 4, 2, 40, 24, 8)
    dout = rng.normal(size=(1, 4, 40, 8)).astype(np.float32)
    kw = dict(causal=True, window=6)
    _, got = _port_grads(qkv, dout, bq=16, bkv=16, **kw)
    blind = ~ref.mask(48, 32, causal=True, window=6,
                      device="cpu").any(dim=-1)[:40].numpy()
    assert blind.any()
    assert not got[0][:, :, blind].any()
    _close_grads(got, _ref_grads(qkv, dout, pad_to=(48, 32), **kw))


def test_plain_backward_is_autograd_through_the_oracle(rng):
    """``ref.attention_grad`` against PyTorch's autograd through
    ``ref.attention`` on the same (padded) operands, bf16 included (the
    plain version accumulates in float32, autograd in bf16: bf16
    tolerance there)."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        q, k, v = (torch.from_numpy(t).to(dtype)
                   for t in _qkv(rng, 2, 4, 1, 24, 24, 16))
        g = torch.from_numpy(rng.normal(size=(2, 4, 24, 16)).astype(
            np.float32)).to(dtype)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref.attention(*leaves, causal=True, window=5).backward(g)
        got = ref.attention_grad(q, k, v, g, causal=True, window=5)
        for t, want in zip(got, leaves):
            assert t.dtype == dtype
            torch.testing.assert_close(t.float(), want.grad.float(),
                                       rtol=tol, atol=tol)


def test_backward_entry_point_on_the_cpu_is_the_plain_version(rng,
                                                              monkeypatch):
    qkv = [torch.from_numpy(t) for t in _qkv(rng, 1, 4, 2, 32, 32, 16)]
    out = ops.flash_attention(*qkv, causal=True)
    dout = torch.from_numpy(rng.normal(size=(1, 4, 32, 16)).astype(
        np.float32))
    calls = []
    plain = ref.attention_grad

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ref, "attention_grad", counting)
    ops.flash_attention_bwd.launches = 0
    got = ops.flash_attention_bwd(*qkv, out, dout, causal=True)
    assert len(calls) == 1 and ops.flash_attention_bwd.launches == 0
    for t, want in zip(got, plain(*qkv, dout, causal=True)):
        assert torch.equal(t, want)
    with pytest.raises(ValueError, match="out and dout"):
        ops.flash_attention_bwd(*qkv, out[:, :, :8], dout)


def test_backward_route_is_the_cuda_cores_for_every_dtype():
    """Without a saved log-sum-exp every dtype takes its CUDA-core route
    (the tensor-core routes read the forward's); the names are in the C
    enum's order, the tensor-core routes appended (``f16_wgmma`` last)."""
    assert ops.BWD_ROUTES == ("f32_simt", "bf16_simt", "f16_simt",
                              "bf16_wgmma", "f32_3xtf32", "f16_wgmma")
    for dtype, want in zip(ops.DTYPES, ops.BWD_ROUTES):
        assert ops.bwd_route(dtype, 256, (0, 16, 32, 48, 64, None)) == want
        assert ops.bwd_route(dtype, 256, (0, 16, 32, 48, 64)) == want
    with pytest.raises(TypeError):
        ops.bwd_route(torch.float64, 64)
    with pytest.raises(ValueError):
        ops.bwd_route(torch.float32, 257)
    source = kernel.BWD_SOURCES[0].read_text()
    enum = re.search(r"enum Route : int \{([^}]*)\}", source).group(1)
    names = [n.split("=")[0].strip().lower() for n in enum.split(",")]
    assert tuple(names) == ops.BWD_ROUTES


# q, k, v, out, dout and the saved log-sum-exp, all 16-byte aligned
_ALIGNED6 = (0, 16, 32, 48, 64, 80)


@pytest.mark.parametrize("dtype, d, addresses, want", [
    # bfloat16 with a saved log-sum-exp: tiles of 64 columns must cover d,
    # up to 256
    *[(torch.bfloat16, d, _ALIGNED6,
       "bf16_wgmma" if d in (64, 80, 96, 128, 192, 256) else "bf16_simt")
      for d in (16, 48, 64, 80, 96, 112, 128, 160, 192, 256)],
    (torch.bfloat16, 128, (), "bf16_wgmma"),
    (torch.bfloat16, 96, (), "bf16_wgmma"),
    # and TMA must read each of the six operands
    *[(torch.bfloat16, 128, _ALIGNED6[:i] + (_ALIGNED6[i] + 2,)
       + _ALIGNED6[i + 1:], "bf16_simt") for i in range(6)],
    *[(torch.bfloat16, 96, _ALIGNED6[:i] + (_ALIGNED6[i] + 2,)
       + _ALIGNED6[i + 1:], "bf16_simt") for i in range(6)],
    # no log-sum-exp saved (an f32 forward, a misaligned forward, a call
    # without one)
    (torch.bfloat16, 256, _ALIGNED6[:5] + (None,), "bf16_simt"),
    (torch.bfloat16, 256, _ALIGNED6[:5] + (0,), "bf16_simt"),
    (torch.bfloat16, 256, _ALIGNED6[:5], "bf16_simt"),
    (torch.bfloat16, 96, _ALIGNED6[:5] + (None,), "bf16_simt"),
    (torch.bfloat16, 80, _ALIGNED6[:5] + (0,), "bf16_simt"),
    # float32 with a saved log-sum-exp: the 3xTF32 tensor cores at
    # TF32_HEAD_DIMS (h2o-danube's 80, Qwen3-14B's 128, RecurrentGemma-9B's
    # and Gemma-7B's 256), the CUDA cores elsewhere (192)
    *[(torch.float32, d, _ALIGNED6,
       "f32_3xtf32" if d in (32, 64, 80, 96, 128, 256) else "f32_simt")
      for d in (16, 32, 48, 64, 80, 96, 112, 128, 192, 256)],
    (torch.float32, 128, _ALIGNED6, "f32_3xtf32"),
    (torch.float32, 80, (), "f32_3xtf32"),
    (torch.float32, 256, (), "f32_3xtf32"),
    # and each of the six operands 16-byte aligned
    *[(torch.float32, 80, _ALIGNED6[:i] + (_ALIGNED6[i] + 4,)
       + _ALIGNED6[i + 1:], "f32_simt") for i in range(6)],
    # no log-sum-exp saved: the CUDA cores
    (torch.float32, 80, _ALIGNED6[:5] + (None,), "f32_simt"),
    (torch.float32, 128, _ALIGNED6[:5] + (0,), "f32_simt"),
    (torch.float32, 64, _ALIGNED6[:5], "f32_simt"),
    # float16 with a saved log-sum-exp: bfloat16's rule, on the same
    # kernels instantiated for f16
    (torch.float16, 128, _ALIGNED6, "f16_wgmma"),
    *[(torch.float16, d, _ALIGNED6,
       "f16_wgmma" if d in (64, 80, 96, 128, 192, 256) else "f16_simt")
      for d in (16, 48, 64, 80, 96, 112, 160, 192, 256)],
    (torch.float16, 128, (), "f16_wgmma"),
    (torch.float16, 80, (), "f16_wgmma"),
    # and TMA must read each of the six operands
    *[(torch.float16, 128, _ALIGNED6[:i] + (_ALIGNED6[i] + 2,)
       + _ALIGNED6[i + 1:], "f16_simt") for i in range(6)],
    *[(torch.float16, 80, _ALIGNED6[:i] + (_ALIGNED6[i] + 2,)
       + _ALIGNED6[i + 1:], "f16_simt") for i in range(6)],
    # no log-sum-exp saved: the CUDA cores
    (torch.float16, 256, _ALIGNED6[:5] + (None,), "f16_simt"),
    (torch.float16, 96, _ALIGNED6[:5] + (0,), "f16_simt"),
    (torch.float16, 128, _ALIGNED6[:5], "f16_simt"),
])
def test_backward_route_by_dtype_head_dim_alignment_and_lse(dtype, d,
                                                           addresses, want):
    assert ops.bwd_route(dtype, d, addresses) == want
    assert want in ops.BWD_ROUTES


@pytest.mark.parametrize("agree", [True, False], ids=["agree", "disagree"])
def test_backward_route_taken_is_the_launchers_held_to_the_rule(
        monkeypatch, agree):
    """The backward asks the built library (here a stand-in) for its route
    on the very operands' addresses and raises, before any launch, where
    ``ops.bwd_route`` disagrees."""
    asked = []

    def launcher_route(dtype, d, addresses):
        asked.append((dtype, d, tuple(addresses)))
        return 1 if agree else 0

    monkeypatch.setattr(kernel, "bwd_launcher_route", launcher_route)
    addresses = _ALIGNED6[:5] + (0,)
    if agree:
        assert ops._bwd_route_taken(torch.bfloat16, 256,
                                    addresses) == "bf16_simt"
    else:
        with pytest.raises(RuntimeError, match="the launcher takes"):
            ops._bwd_route_taken(torch.bfloat16, 256, addresses)
    assert asked == [(torch.bfloat16, 256, addresses)]


@pytest.mark.parametrize("offset, lse, want", [
    (0, True, "bf16_wgmma"),
    (1, True, "bf16_simt"),      # a view one element in: 2 bytes off 16
    (0, False, "bf16_simt"),
])
def test_backward_route_taken_follows_the_rule_on_real_operands(
        monkeypatch, offset, lse, want):
    """The wrapper hands the library the addresses of q, k, v, out, dout
    and the saved log-sum-exp (0 without one); a stand-in library that
    answers by the rule agrees with ``ops.bwd_route`` on each."""
    n = 2 * 64 * 128
    store = torch.zeros(5 * n + 1, dtype=torch.bfloat16)
    q, k, v, out, dout = (store[offset + i * n:][:n].view(1, 2, 64, 128)
                          for i in range(5))
    saved = torch.zeros((1, 2, 64)) if lse else None
    addresses = ops._bwd_addresses(q, k, v, out, dout, saved)
    assert addresses[5] == (saved.data_ptr() if lse else 0)
    asked = []

    def launcher_route(dtype, d, addrs):
        asked.append(tuple(addrs))
        return ops.BWD_ROUTES.index(ops.bwd_route(dtype, d, addrs))

    monkeypatch.setattr(kernel, "bwd_launcher_route", launcher_route)
    assert ops._bwd_route_taken(torch.bfloat16, 128, addresses) == want
    assert asked == [addresses]


def test_dkv_groups_fill_the_card_and_divide_the_group():
    """The tensor-core dk/dv kernel splits a kv head's query heads into
    head groups only while its blocks stay within the card's SMs:
    RecurrentGemma-9B's training shape (16 heads over 1, S 4096) takes 4
    on 132 SMs, Qwen3-14B's (40 over 8) needs none."""
    assert kernel.dkv_groups(16, 1, 1, 4096, 132) == 4
    assert kernel.dkv_groups(40, 8, 1, 4096, 132) == 1
    assert kernel.dkv_groups(16, 1, 1, 128, 132) == 16
    assert kernel.dkv_groups(6, 1, 1, 1024, 132) == 6
    assert kernel.dkv_groups(6, 1, 1, 4096, 100) == 3
    assert kernel.dkv_groups(1, 1, 4, 64, 132) == 1


def test_dkv_groups_of_the_float32_route_at_head_dim_256():
    """f32_3xtf32's dk / dv blocks at d 256 hold 64 keys: RecurrentGemma-
    9B's training shape (64 key blocks over one kv head) takes 2 head
    groups on 132 SMs, Gemma-7B's (16 kv heads) none; below d 256 the
    route never splits, whatever the shape, and the launcher is handed
    partials only with more than one group."""
    key_block = kernel.BWD_TF32_KEY_BLOCK
    assert key_block == 64
    assert kernel.dkv_groups(16, 1, 1, 4096, 132, key_block) == 2
    assert kernel.dkv_groups(16, 16, 1, 4096, 132, key_block) == 1
    assert kernel.dkv_groups(4, 1, 1, 1024, 132, key_block) == 4
    calls = []

    class Library:
        def call(self, symbol, *args):
            calls.append((symbol, args))

    dev = torch.device("meta")
    for d, (hq, hkv, s), want in ((256, (16, 1, 4096), 2),
                                  (128, (16, 1, 4096), 1),
                                  (256, (16, 16, 4096), 1)):
        q = torch.empty((1, hq, s, d), device=dev)
        kv = torch.empty((1, hkv, s, d), device=dev)
        calls.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kernel, "BWD_LIBRARY", Library())
            mp.setattr(torch.cuda, "device", lambda _d: _Null())
            mp.setattr(torch.cuda, "current_stream",
                       lambda _d: type("S", (), {"cuda_stream": 0})())
            mp.setattr(torch.cuda, "get_device_properties",
                       lambda _d: type("P", (), {
                           "multi_processor_count": 132})())
            kernel.launch_bwd(q, kv, kv, q, q, q, kv, kv, causal=True,
                              window=None, scale=d ** -0.5,
                              lse=torch.empty(q.shape[:3], device=dev))
        (symbol, args), = calls
        assert symbol == kernel.BWD_F32_LSE_SYMBOL
        assert args[-2] == want
        assert (args[10] is None) == (want == 1)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_backward_library_is_its_own_with_every_symbol_bound():
    """The backward builds into a library of its own (the forward's
    sources and symbols unchanged) with the tensor-core route's header and
    those it draws on hashed into its name, and each symbol it binds is an
    ``extern "C"`` entry point with as many parameters as ctypes
    passes."""
    assert kernel.BWD_LIBRARY.path().name.startswith(
        "libbind_flash_attention_bwd_")
    assert kernel.BWD_LIBRARY.sources == kernel.BWD_SOURCES
    assert kernel.BWD_SOURCES[0] not in kernel.SOURCES
    source = kernel.BWD_SOURCES[0].read_text()
    headers = {h.resolve() for h in kernel.BWD_LIBRARY.headers}
    assert _includes(kernel.BWD_SOURCES[0]) == headers
    assert {h.name for h in headers} == {
        "attn_bwd_wgmma.cuh", "attn_mask.cuh", "attn_bwd_tf32.cuh",
        "attn_bwd_tf32_wide.cuh", "attn_tf32.cuh", "attn_tf32_wide.cuh",
        "attn_wgmma.cuh", "attn_tile.cuh", "gemm_tile.cuh",
        "gemm_wgmma.cuh", "tf32.cuh"}
    assert set(kernel.BWD_LIBRARY.symbols) == extern_c_symbols(
        kernel.BWD_SOURCES[0])
    assert set(kernel.BWD_LIBRARY.symbols) == {
        f"bind_flash_attention_bwd_{s}" for s in kernel.SUFFIX.values()} | {
        kernel.BWD_ROUTE_SYMBOL, kernel.BWD_LSE_SYMBOL,
        kernel.BWD_F16_LSE_SYMBOL, kernel.BWD_F32_LSE_SYMBOL}
    # the f16 tensor-core route is the bf16 one's kernels of another
    # element type, with its arguments
    assert kernel.BWD_F16_LSE_SYMBOL == "bind_flash_attention_bwd_f16_lse"
    assert kernel.BWD_LSE_SYMBOLS == {
        torch.bfloat16: kernel.BWD_LSE_SYMBOL,
        torch.float16: kernel.BWD_F16_LSE_SYMBOL,
        torch.float32: kernel.BWD_F32_LSE_SYMBOL}
    assert (kernel.BWD_LIBRARY.symbols[kernel.BWD_F16_LSE_SYMBOL]
            == kernel.BWD_LIBRARY.symbols[kernel.BWD_LSE_SYMBOL])
    # the float32 tensor-core route takes the bf16 one's arguments: lse
    # the forward's, and the head groups' partials and count (d 256's
    # dk / dv blocks split a kv head's query heads as bf16_wgmma's do)
    assert kernel.BWD_F32_LSE_SYMBOL == "bind_flash_attention_bwd_f32_lse"
    assert (kernel.BWD_LIBRARY.symbols[kernel.BWD_F32_LSE_SYMBOL]
            == kernel.BWD_LIBRARY.symbols[kernel.BWD_LSE_SYMBOL])
    for sym, argtypes in kernel.BWD_LIBRARY.symbols.items():
        params = re.search(rf"int {sym}\((.*?)\)", source, re.S).group(1)
        assert params.count(",") + 1 == len(argtypes), sym


# ---------------------------------------------------------------------------
# the log-sum-exp the forward hands the backward, and the plain version of
# the backward that reads it
# ---------------------------------------------------------------------------

def _masked_scores(q, k, *, causal, window, scale):
    """(B, Hq, Sq, Skv) float32 scaled scores, -inf where hidden."""
    group = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(group, dim=1)
    s = (q.float() @ kk.transpose(-1, -2)) * scale
    seen = ref.mask(q.shape[2], k.shape[2], causal=causal, window=window,
                    device="cpu")
    return torch.where(seen, s, float("-inf"))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", GRAD_CASES)
def test_attention_lse_is_the_oracle_and_its_logsumexp(b, hq, hkv, sq, skv,
                                                       d, causal, window,
                                                       rng):
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, b, hq, hkv, sq, skv,
                                                 d))
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    out, lse = ref.attention_lse(q, k, v, **kw)
    assert torch.equal(out, ref.attention(q, k, v, **kw))
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    want = torch.logsumexp(_masked_scores(q, k, **kw), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


# RecurrentGemma-9B's and Gemma-7B's head dim, which f32_3xtf32 runs on
# blocks of its own on the card: windowed GQA 4:1, causal MHA
D256_CASES = [
    (1, 4, 1, 96, 96, 256, True, 40),
    (1, 2, 2, 96, 96, 256, True, None),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", D256_CASES)
def test_lse_plain_versions_at_head_dim_256_match_the_reference(
        b, hq, hkv, sq, skv, d, causal, window, rng):
    """The plain versions the card's d 256 float32 routes are held to: the
    forward with its log-sum-exp against the reference's Pallas kernel
    (interpret mode) and the log-sum-exp of the reference's masked
    scores, the backward from the log-sum-exp against ``jax.grad`` of the
    reference's oracle, each within 2e-5."""
    qkv = _qkv(rng, b, hq, hkv, sq, skv, d)
    dout = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(t) for t in qkv)
    kw = dict(causal=causal, window=window)
    out, lse = ref.attention_lse(q, k, v, scale=d ** -0.5, **kw)
    np.testing.assert_allclose(out.numpy(), _reference(qkv, **kw),
                               rtol=2e-5, atol=2e-5)
    jq, jk, jv = (jnp.asarray(t) for t in qkv)
    jk = jnp.repeat(jk, hq // hkv, axis=1)
    scores = jnp.einsum("bhqd,bhkd->bhqk", jq, jk) * d ** -0.5
    seen = np.asarray(ref.mask(sq, skv, causal=causal, window=window,
                               device="cpu"))
    want = jax.scipy.special.logsumexp(
        jnp.where(seen, scores, -jnp.inf), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    got = ref.attention_grad_lse(q, k, v, out, torch.from_numpy(dout), lse,
                                 **kw)
    _close_grads([t.numpy() for t in got], _ref_grads(qkv, dout, **kw),
                 tol=2e-5)


def test_attention_lse_is_inf_on_a_row_that_sees_no_key(rng):
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, 1, 4, 2, 40, 24, 8))
    out, lse = ref.attention_lse(q, k, v, causal=True, window=6)
    blind = ~ref.mask(40, 24, causal=True, window=6,
                      device="cpu").any(dim=-1)
    assert blind.any() and not blind.all()
    assert torch.isinf(lse[:, :, blind]).all() and (lse[:, :, blind] > 0).all()
    assert torch.isfinite(lse[:, :, ~blind]).all()
    assert not out[:, :, blind].any()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", GRAD_CASES)
def test_gradient_from_the_lse_matches_jax_grad_of_the_oracle(
        b, hq, hkv, sq, skv, d, causal, window, rng):
    qkv = _qkv(rng, b, hq, hkv, sq, skv, d)
    dout = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(t) for t in qkv)
    kw = dict(causal=causal, window=window)
    out, lse = ref.attention_lse(q, k, v, **kw)
    got = ref.attention_grad_lse(q, k, v, out, torch.from_numpy(dout), lse,
                                 **kw)
    assert all(t.dtype == torch.float32 for t in got)
    _close_grads([t.numpy() for t in got],
                 _ref_grads(qkv, dout, **kw))


def test_gradient_from_the_lse_is_zero_on_rows_that_see_no_key(rng):
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, 1, 4, 2, 40, 24, 8))
    dout = torch.from_numpy(rng.normal(size=(1, 4, 40, 8)).astype(
        np.float32))
    kw = dict(causal=True, window=6)
    out, lse = ref.attention_lse(q, k, v, **kw)
    dq, dk, dv = ref.attention_grad_lse(q, k, v, out, dout, lse, **kw)
    blind = ~ref.mask(40, 24, causal=True, window=6,
                      device="cpu").any(dim=-1)
    assert blind.any()
    assert not dq[:, :, blind].any()
    # and they add nothing to dk or dv: the same sums without those rows
    keep = ~blind
    _, dk2, dv2 = ref.attention_grad_lse(
        q[:, :, keep], k, v, out[:, :, keep], dout[:, :, keep],
        lse[:, :, keep], scale=8 ** -0.5, causal=False, window=None)
    exp = ref.attention_grad(q, k, v, dout, **kw)
    torch.testing.assert_close(dk, exp[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv, exp[2], rtol=1e-5, atol=1e-5)
    assert torch.isfinite(dk2).all() and torch.isfinite(dv2).all()


def test_gradient_from_the_lse_in_bf16_is_close_to_float32(rng):
    """bf16 operands: the plain version sums in float32 and rounds each
    gradient once, within the bf16 tolerance of the float32 result."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, 1, 4, 1, 48, 48, 64))
    dout = torch.from_numpy(rng.normal(size=(1, 4, 48, 64)).astype(
        np.float32))
    kw = dict(causal=True, window=20)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, dout)]
    out, lse = ref.attention_lse(*bf[:3], **kw)
    got = ref.attention_grad_lse(*bf[:3], out, bf[3], lse, **kw)
    exp = ref.attention_grad(*(t.float() for t in bf), **kw)
    for g, e in zip(got, exp):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), e, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_function_on_the_cpu_saves_an_lse_and_matches_jax(dtype, rng,
                                                          monkeypatch):
    """The autograd Function asks the CPU's plain forward for the
    log-sum-exp when the call records a gradient, saves it, and its
    backward takes the plain version of the route the same call takes on
    the card: ``attention_grad_lse`` for bf16 (``bf16_wgmma``), f16
    (``f16_wgmma``) and float32 (``f32_3xtf32``) at d 64; each matches
    ``jax.value_and_grad`` of the oracle (bf16 within the reference's
    3e-2, f16 within the 1e-2 ``chip_smoke.py`` holds f16 attention to on
    the card)."""
    b, hq, hkv, s, d = 1, 4, 2, 64, 64
    qkv = _qkv(rng, b, hq, hkv, s, s, d)
    dout = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    calls = {"lse": 0, "grad": 0, "grad_lse": 0}
    saved = []
    for name, key in (("attention_lse", "lse"), ("attention_grad", "grad"),
                      ("attention_grad_lse", "grad_lse")):
        def counting(*args, _fn=getattr(ref, name), _key=key, **kwargs):
            calls[_key] += 1
            result = _fn(*args, **kwargs)
            if _key == "lse":
                saved.append(result[1])
            return result
        monkeypatch.setattr(ref, name, counting)
    q, k, v = (torch.from_numpy(t).to(dtype).requires_grad_(True)
               for t in qkv)
    out = ops.flash_attention(q, k, v, causal=True, window=24)
    node = out.grad_fn
    while type(node).__name__ != "_AttentionBackward":
        node = node.next_functions[0][0]     # the slice back to Sq
    _, _, _, _, lse = node.saved_tensors
    assert saved and lse is saved[0] and lse.shape == (b, hq, s)
    out.backward(torch.from_numpy(dout).to(dtype))
    half = {torch.bfloat16: 3e-2, torch.float16: 1e-2}.get(dtype)
    assert calls == {"lse": 1, "grad": 0, "grad_lse": 1}
    got = [t.grad.float().numpy() for t in (q, k, v)]
    if half:
        want = _ref_grads([t.detach().float().numpy() for t in (q, k, v)],
                          torch.from_numpy(dout).to(dtype).float().numpy(),
                          causal=True, window=24)
        _close_grads(got, want, tol=half)
    else:
        _close_grads(got, _ref_grads(qkv, dout, causal=True, window=24))
    # without a gradient to record, the forward asks for no log-sum-exp
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=True, window=24)
    assert calls["lse"] == 1


def test_backward_entry_point_on_the_cpu_takes_the_lse_route(rng,
                                                             monkeypatch):
    """On CPU tensors the backward with a saved log-sum-exp computes the
    plain version of the route the card would take: bf16 at d 64 reads
    the log-sum-exp (``attention_grad_lse``), bit for bit; without one
    it is ``attention_grad``; it checks the log-sum-exp's shape."""
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
               for t in _qkv(rng, 1, 4, 2, 64, 64, 64))
    dout = torch.from_numpy(rng.normal(size=(1, 4, 64, 64)).astype(
        np.float32)).to(torch.bfloat16)
    out, lse = ref.attention_lse(q, k, v, causal=True)
    got = ops.flash_attention_bwd(q, k, v, out, dout, lse=lse, causal=True)
    want = ref.attention_grad_lse(q, k, v, out, dout, lse, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = ops.flash_attention_bwd(q, k, v, out, dout, causal=True)
    for g, w in zip(got, ref.attention_grad(q, k, v, dout, causal=True)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="lse must be"):
        ops.flash_attention_bwd(q, k, v, out, dout, lse=lse[:, :2])
    assert ops.flash_attention_bwd.launches == 0



@pytest.mark.parametrize("d, hq, hkv, window", [(80, 4, 1, None),
                                                (96, 2, 2, None),
                                                (96, 4, 2, 20)])
def test_bf16_at_d_80_and_96_differentiates_through_the_lse_route(
        d, hq, hkv, window, rng, monkeypatch):
    """h2o-danube's d 80 and Phi-3-vision's d 96 take both tensor-core
    routes on the card, so a bf16 call that records a gradient saves the
    CPU forward's log-sum-exp and its backward is their plain version,
    ``ref.attention_grad_lse``, never ``ref.attention_grad``; the
    gradient matches ``jax.grad`` of the oracle on the bf16 inputs within
    the bf16 tolerance."""
    b, s = 1, 40
    assert ops.route(torch.bfloat16, d) == "bf16_wgmma"
    assert ops.bwd_route(torch.bfloat16, d) == "bf16_wgmma"
    qkv = _qkv(rng, b, hq, hkv, s, s, d)
    dout = torch.from_numpy(rng.normal(size=(b, hq, s, d)).astype(
        np.float32)).to(torch.bfloat16)
    calls = []
    plain = ref.attention_grad_lse

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return plain(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("the CUDA-core route's plain version ran")

    monkeypatch.setattr(ref, "attention_grad_lse", counting)
    monkeypatch.setattr(ref, "attention_grad", refused)
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16).requires_grad_(True)
               for t in qkv)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    out.backward(dout)
    assert len(calls) == 1
    got = [t.grad.float().numpy() for t in (q, k, v)]
    want = _ref_grads([t.detach().float().numpy() for t in (q, k, v)],
                      dout.float().numpy(), causal=True, window=window)
    _close_grads(got, want, tol=3e-2)


def test_float32_at_d_80_saves_an_lse_and_matches_jax_value_and_grad(
        rng, monkeypatch):
    """h2o-danube's d 80 takes both float32 tensor-core routes on the card,
    so the ``_Attention`` Function at float32, GQA 4/1 and a window saves
    the CPU forward's log-sum-exp and its backward is their plain
    version, ``ref.attention_grad_lse``, never ``ref.attention_grad``;
    the output and the gradient match ``jax.value_and_grad`` of the
    oracle within 2e-5 on the same NumPy inputs."""
    b, hq, hkv, s, d, window = 1, 4, 1, 40, 80, 12
    assert ops.route(torch.float32, d) == "f32_3xtf32"
    assert ops.bwd_route(torch.float32, d) == "f32_3xtf32"
    qkv = _qkv(rng, b, hq, hkv, s, s, d)
    dout = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    calls = []
    plain = ref.attention_grad_lse

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return plain(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("the CUDA-core route's plain version ran")

    monkeypatch.setattr(ref, "attention_grad_lse", counting)
    monkeypatch.setattr(ref, "attention_grad", refused)
    q, k, v = (torch.from_numpy(t).requires_grad_(True) for t in qkv)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    node = out.grad_fn
    while type(node).__name__ != "_AttentionBackward":
        node = node.next_functions[0][0]
    assert node.saved_tensors[4].shape == (b, hq, s)
    out.backward(torch.from_numpy(dout))
    assert len(calls) == 1

    def f(q, k, v):
        o = ref_oracle.attention(q, k, v, causal=True, window=window)
        return jnp.sum(o * dout), o

    (_, want_out), want = jax.value_and_grad(f, argnums=(0, 1, 2),
                                             has_aux=True)(
        *(jnp.asarray(t) for t in qkv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=2e-5)
    _close_grads([t.grad.numpy() for t in (q, k, v)],
                 [np.asarray(g) for g in want], tol=2e-5)


# ---------------------------------------------------------------------------
# f16_wgmma's roundings, emulated: the float16 tensor-core route rounds P
# (forward and backward) and dS (backward) to f16 before their products
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """``chip_smoke.py`` (it imports nothing but the standard library at
    module level), for the limits it holds the card's f16 outputs to."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_limits", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _emulate_f16_wgmma(q, k, v, dout, *, causal, window, through=None):
    """``f16_wgmma``'s arithmetic on float16 ``q``, ``k``, ``v``, ``dout``
    (B, H, S, D), in float32 on the CPU: the scores and every sum in
    float32, the weights p (and, in the backward, dS = p (dp - delta))
    rounded to float16 before their products, each output rounded once
    to float16, delta from the rounded output.  ``through``: a dtype P and
    dS are rounded through first (bfloat16: the planted fault).  Returns
    ``(out, (dq, dk, dv))``."""
    group = q.shape[1] // k.shape[1]
    scale = q.shape[3] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    kk, vv = (t.repeat_interleave(group, dim=1) for t in (kf, vf))
    seen = ref.mask(q.shape[2], k.shape[2], causal=causal, window=window,
                    device="cpu")
    s = torch.where(seen, (qf @ kk.transpose(-1, -2)) * scale,
                    float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(-1, keepdim=True)
    l = torch.where(l > 0, l, 1.0)

    def rounded(x):
        if through is not None:
            x = x.to(through).float()
        return x.half().float()

    out = ((rounded(p) @ vv) / l).half()
    pn = p / l
    dp = gf @ vv.transpose(-1, -2)
    delta = (gf * out.float()).sum(-1, keepdim=True)
    ds = rounded(pn * (dp - delta))
    pr = rounded(pn)

    def per_kv_head(x):
        return x.unflatten(1, (k.shape[1], group)).sum(2)

    dq = (scale * (ds @ kk)).half()
    dk = per_kv_head(scale * (ds.transpose(-1, -2) @ qf)).half()
    dv = per_kv_head(pr.transpose(-1, -2) @ gf).half()
    return out, (dq, dk, dv)


def test_f16_wgmma_emulation_holds_the_f16_limits_and_sees_bf16_rounding(
        rng):
    """The route's roundings, emulated, stay within ``chip_smoke.py``'s
    float16 limits of the reference's oracle on the same float16 values
    (the forward: ``half_attention_error``'s per-element, slice and row
    limits; each gradient: ``F16_SLICE_NRMS`` rms per head slice of
    ``jax.grad`` of the oracle); P and dS rounded through bfloat16 first
    (3 bits fewer: the fault ``tools/attn_faults.py`` plants) fall outside
    them, so the card's f16 checks tell that fault apart."""
    cs = _chip_smoke()
    b, hq, hkv, s, d, window = 1, 4, 2, 256, 64, None
    qkv = [t.astype(np.float16) for t in _qkv(rng, b, hq, hkv, s, s, d)]
    dout = rng.normal(size=(b, hq, s, d)).astype(np.float16)
    q, k, v, g = (torch.from_numpy(t) for t in (*qkv, dout))
    f32 = [t.astype(np.float32) for t in qkv]
    exp = torch.from_numpy(np.array(ref_oracle.attention(
        *(jnp.asarray(t) for t in f32), causal=True, window=window)))
    exp_g = [torch.from_numpy(x) for x in _ref_grads(
        f32, dout.astype(np.float32), causal=True, window=window)]
    stats = {}
    for through in (None, torch.bfloat16):
        out, grads = _emulate_f16_wgmma(q, k, v, g, causal=True,
                                        window=window, through=through)
        fwd = cs.half_attention_error(out, exp, v)
        bwd = max(cs.slice_nrms(x, e) for x, e in zip(grads, exp_g))
        stats[through] = (fwd, bwd)
    (fwd, bwd), (bad_fwd, bad_bwd) = stats[None], stats[torch.bfloat16]
    assert cs.half_within(fwd, "float16"), fwd
    assert bwd <= cs.F16_SLICE_NRMS, bwd
    # f16's unit roundoff is 2^-11, eight times below bf16's: the f16
    # limits are the bf16 ones' multiples of it, never looser
    assert cs.F16_SLICE_NRMS == cs.BF16_SLICE_NRMS / 8
    assert cs.F16_ROW_NRMS == cs.BF16_ROW_NRMS / 8
    assert cs.F16_ELEMENT == cs.BF16_ELEMENT / 8
    assert not cs.half_within(bad_fwd, "float16"), bad_fwd
    assert bad_fwd["slice"] > 2 * fwd["slice"]
    assert bad_bwd > cs.F16_SLICE_NRMS and bad_bwd > 2 * bwd, (bad_bwd, bwd)


def test_f16_wgmma_emulation_overflows_where_ds_passes_the_f16_range(rng):
    """A pinned divergence (ROADMAP Queue 3): ``f16_wgmma`` rounds dS =
    p (dp - delta) to float16 before dQ += dS K and dK += dS^T Q, so where
    |dS| passes 65504 those gradients are inf or NaN, where the CUDA-core
    route and the plain version, float32 inside, round only the (finite)
    gradients.  Scores near zero (q, k ~ 0.003) spread p over the 256
    keys; |dout| ~ 1e4 and |v| ~ 1e3 put |dp - delta| near 1e8 and most
    |dS| past 65504, while every gradient stays below 1e4."""
    b, h, s, d = 1, 2, 256, 64
    q, k = (torch.from_numpy(3e-3 * rng.normal(size=(b, h, s, d))).half()
            for _ in range(2))
    v = torch.from_numpy(1e3 * rng.normal(size=(b, h, s, d))).half()
    g = torch.from_numpy(1e4 * rng.normal(size=(b, h, s, d))).half()
    plain = ref.attention_grad(q, k, v, g, causal=False, window=None)
    assert all(bool(torch.isfinite(x).all()) for x in plain)
    _, (dq, dk, dv) = _emulate_f16_wgmma(q, k, v, g, causal=False,
                                         window=None)
    assert not torch.isfinite(dq).all() and not torch.isfinite(dk).all()
    assert torch.isfinite(dv).all()
    # where dS stays in range the emulation is the plain version's to f16
    small = _emulate_f16_wgmma(q, k, v / 64, g / 64, causal=False,
                               window=None)[1]
    want = ref.attention_grad(q, k, v / 64, g / 64, causal=False,
                              window=None)
    cs = _chip_smoke()
    for x, w in zip(small, want):
        assert torch.isfinite(x).all()
        assert cs.slice_nrms(x, w) <= cs.F16_SLICE_NRMS
