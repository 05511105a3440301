"""The port's linear scan against the reference Pallas kernel.

On the CPU the port's ``linear_scan`` pads S as the reference's wrapper
does and computes the plain version, a sequential float32 loop (the CUDA
kernel runs only on the card, where ``chip_smoke.py`` holds it against
this same plain version).  Here it is held against
``repro.kernels.linear_scan.ops.linear_scan`` run in Pallas interpret mode
on the same NumPy inputs, at the reference's shapes and tolerances
(``tests/test_kernels.py``: f32 1e-5, 2e-5 in the property test for any
``bs``; bf16 4e-2), and the wrapper's checks and launch counter are pinned.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from test_kernels import SCAN_SHAPES

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
    (lambda a, x: (a.transpose(1, 2), x.transpose(1, 2)), ValueError,
     "contiguous"),
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
        f"bind_linear_scan_{s}" for s in kernel.SUFFIX.values()}
