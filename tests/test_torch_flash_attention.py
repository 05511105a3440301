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

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import ATTN_CASES

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
    (lambda q, k, v: (q.transpose(2, 3), k, v), ValueError, "contiguous"),
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


def test_attn_step_matches_the_reference_body(rng):
    from repro.kernels.flash_attention.ops import attn_step as ref_step

    o, q = rng.normal(size=(6, 5)), rng.normal(size=(6, 4))
    k, v = rng.normal(size=(7, 4)), rng.normal(size=(7, 5))
    vals = [t.astype(np.float32) for t in (o, q, k, v)]
    exp = np.asarray(ref_step(*(jnp.asarray(t) for t in vals)))
    got = ops.attn_step(*(torch.from_numpy(t) for t in vals))
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 5)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)
    # NumPy tiles stay NumPy, with the body's arithmetic
    got_np = ops.attn_step(*vals)
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_allclose(got_np, exp, rtol=1e-5, atol=1e-5)
    assert ops.attn_step.__bind_kernel__ == ref_step.__bind_kernel__ == "dot"
    assert ops.attn_step.__bind_vmap__ is False


def test_library_is_named_by_its_sources_and_headers():
    path = kernel.LIBRARY.path()
    assert path.name.startswith("libbind_flash_attention_")
    assert {h.name for h in kernel.LIBRARY.headers} == {"attn_tile.cuh",
                                                        "gemm_tile.cuh"}
    assert set(kernel.SUFFIX) == set(ops.DTYPES)
    assert set(kernel.LIBRARY.symbols) == {
        f"bind_flash_attention_{s}" for s in kernel.SUFFIX.values()}
