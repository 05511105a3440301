"""The port's optimizer, schedule and int8 quantisers against the JAX
package's (``repro.optim``) on the same NumPy inputs.

``AdamW.update`` is held on identical gradients, step by step, to the
reference's update: its own cases (``tests/test_optim.py``: the math with
weight decay on matrices only, clipping to the global norm, bfloat16
parameters over float32 masters), several steps of a schedule, and
``grad_reduce``-style bfloat16 gradients.  Parameters, masters and
moments agree to float32 rounding (the port takes the same operations in
place, with the product and the sum of ``m * b1 + (1 - b1) g`` possibly
fused: a few float32 ulps); ``grad_norm`` to 1e-6 relative (the port
sums per-tensor norms).  ``warmup_cosine`` gives the reference's values to
float32 rounding; ``quantize_int8`` / ``dequantize_int8`` its codes and
scales exactly (round half to even on both sides); ``compressed_allreduce``
on a rank mesh gives the mean of the reference's dequantised codes.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import AdamW as RefAdamW
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.optim.compression import BLOCK as REF_BLOCK
from repro.optim.compression import dequantize_int8 as ref_dequantize
from repro.optim.compression import quantize_int8 as ref_quantize
from repro_torch.compat import to_numpy, to_torch
from repro_torch.optim import (AdamW, OptState, compressed_allreduce,
                               dequantize_int8, quantize_int8, warmup_cosine)
from repro_torch.optim.compression import BLOCK

# float32 results of the same operations, some fused on one side
RTOL, ATOL = 2e-6, 1e-7


def _ref_tree(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def _port_tree(arrays):
    # copies: the port updates in place
    return {k: to_torch(np.asarray(v), "cpu").clone()
            for k, v in arrays.items()}


def _close(port, ref, what):
    for k in ref:
        np.testing.assert_allclose(
            np.asarray(to_numpy(port[k]), np.float32),
            np.asarray(ref[k], np.float32), rtol=RTOL, atol=ATOL,
            err_msg=f"{what} {k}")


def _run_both(opt_kwargs, params, grads_per_step, schedule=None):
    """Run ``len(grads_per_step)`` updates of both optimizers from the same
    parameters on the same gradients; check every step."""
    ref_opt = RefAdamW(**opt_kwargs, **(
        {"learning_rate": ref_warmup_cosine(*schedule)} if schedule else {}))
    opt = AdamW(**opt_kwargs, **(
        {"learning_rate": warmup_cosine(*schedule)} if schedule else {}))
    rp = _ref_tree(params)
    rs = ref_opt.init(rp)
    pp = _port_tree(params)
    ps = opt.init(pp)
    assert isinstance(ps, OptState) and ps.count == 0
    for step, grads in enumerate(grads_per_step):
        rp, rs, rm = jax.jit(ref_opt.update)(_ref_tree(grads), rs, rp)
        pp, ps, pm = opt.update(_port_tree(grads), ps, pp)
        assert ps.count == int(rs.count) == step + 1
        _close(pp, rp, f"step {step} params")
        _close(ps.master, rs.master, f"step {step} master")
        _close(ps.m, rs.m, f"step {step} m")
        _close(ps.v, rs.v, f"step {step} v")
        for k in params:
            assert pp[k].dtype == to_torch(np.asarray(rp[k]), "cpu").dtype
        assert float(pm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        assert pm["lr"] == pytest.approx(float(rm["lr"]), rel=1e-6)
    return pp, ps


def test_update_matches_the_reference_math(rng):
    params = {"w": rng.normal(size=(8, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = {"w": rng.normal(size=(8, 4)).astype(np.float32),
             "b": rng.normal(size=(4,)).astype(np.float32)}
    kwargs = dict(learning_rate=1e-2, b1=0.9, b2=0.95, eps=1e-8,
                  weight_decay=0.1, grad_clip=None)
    _run_both(kwargs, params, [grads])
    # and the reference test's NumPy oracle, step 1
    opt = AdamW(**kwargs)
    pp = _port_tree(params)
    pp, _, _ = opt.update(_port_tree(grads), opt.init(pp), pp)
    for k, wd in (("w", 0.1), ("b", 0.0)):   # 1-D params skip weight decay
        g = grads[k]
        step = (0.1 * g / 0.1) / (np.sqrt(0.05 * g ** 2 / 0.05) + 1e-8) \
            + wd * params[k]
        np.testing.assert_allclose(pp[k].numpy(), params[k] - 1e-2 * step,
                                   rtol=1e-5, err_msg=k)


def test_grad_clip_caps_the_global_norm(rng):
    params = {"w": np.zeros((4, 4), np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    big = {"w": np.full((4, 4), 100.0, np.float32),
           "b": rng.normal(size=(3,)).astype(np.float32) * 50}
    pp, _ = _run_both(dict(learning_rate=1.0, grad_clip=1.0,
                           weight_decay=0.0), params, [big, big])
    opt = AdamW(learning_rate=1.0, grad_clip=1.0, weight_decay=0.0)
    p = {"w": torch.zeros((4, 4))}
    _, _, metrics = opt.update({"w": torch.full((4, 4), 100.0)},
                               opt.init(p), p)
    assert float(metrics["grad_norm"]) == pytest.approx(400.0)


def test_steps_under_a_schedule_with_decay_and_clipping(rng):
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "s": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 3).astype(np.float32)
              for k, v in params.items()} for _ in range(6)]
    _run_both(dict(weight_decay=0.1, grad_clip=1.0), params, grads,
              schedule=(3e-2, 2, 6))


def test_bf16_params_keep_float32_masters(rng):
    w = rng.normal(size=(16, 16)).astype(ml_dtypes.bfloat16)
    g = np.full((16, 16), 1e-4, ml_dtypes.bfloat16)
    kwargs = dict(learning_rate=1e-4, weight_decay=0.0, grad_clip=None)
    pp, ps = _run_both(kwargs, {"w": w}, [{"w": g}] * 4)
    assert ps.master["w"].dtype == torch.float32
    assert pp["w"].dtype == torch.bfloat16
    # tiny updates accumulate in the master below bf16 resolution
    drift = (ps.master["w"] - torch.from_numpy(w.astype(np.float32))).abs()
    assert float(drift.mean()) > 0


def test_bf16_gradients_on_float32_params(rng):
    params = {"w": rng.normal(size=(12, 8)).astype(np.float32)}
    grads = [{"w": rng.normal(size=(12, 8)).astype(ml_dtypes.bfloat16)}
             for _ in range(3)]
    _run_both(dict(learning_rate=1e-3), params, grads)


def test_update_runs_in_place_and_reads_the_gradients_only(rng):
    opt = AdamW(learning_rate=1e-2, grad_clip=0.5)
    w = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    g0 = g.clone()
    state = opt.init({"w": w})
    master, m = state.master["w"], state.m["w"]
    assert master.data_ptr() != w.data_ptr()     # never an alias
    params, new, _ = opt.update({"w": g}, state, {"w": w})
    assert params["w"] is w and new.master["w"] is master
    assert new.m["w"] is m and new.count == 1 and state.count == 0
    assert torch.equal(g, g0)
    assert torch.equal(w, master)


def test_update_takes_a_module(rng):
    lin = torch.nn.Linear(4, 3)
    opt = AdamW(learning_rate=1e-2)
    state = opt.init(lin)
    assert set(state.master) == {"weight", "bias"}
    grads = {n: torch.ones_like(p) for n, p in lin.named_parameters()}
    before = lin.weight.detach().clone()
    opt.update(grads, state, lin)
    assert not torch.equal(lin.weight.detach(), before)


@pytest.mark.parametrize("peak, warmup, total, floor", [
    (1.0, 10, 100, 0.1), (3e-3, 20, 100, 0.1), (1e-3, 20, 50, 0.1),
    (2e-4, 0, 30, 0.0), (5e-2, 7, 7, 0.3)])
def test_warmup_cosine_gives_the_references_values(peak, warmup, total,
                                                   floor):
    ref = ref_warmup_cosine(peak, warmup, total, floor)
    port = warmup_cosine(peak, warmup, total, floor)
    for count in range(0, total + 12):
        want = float(ref(jnp.int32(count)))
        assert port(count) == pytest.approx(want, rel=1e-6, abs=1e-12), count
    assert port(torch.tensor(3)) == port(3)


def test_warmup_cosine_shape():
    lr = warmup_cosine(1.0, warmup=10, total=100, floor=0.1)
    assert lr(0) == 0.0
    assert lr(10) == pytest.approx(1.0, rel=1e-3)
    assert lr(100) == pytest.approx(0.1, rel=1e-3)
    assert lr(55) < 1.0


@pytest.mark.parametrize("n, scale", [(1, 1.0), (255, 3.0), (256, 1e-3),
                                      (1000, 1e3), (2000, 0.5)])
def test_quantize_int8_matches_the_reference(n, scale, rng):
    assert BLOCK == REF_BLOCK == 256
    x = (rng.normal(size=(n,)) * scale).astype(np.float32)
    x[::7] = 0.0
    want_codes, want_scale = ref_quantize(jnp.asarray(x))
    codes, scales = quantize_int8(torch.from_numpy(x))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scale))
    back = dequantize_int8(codes, scales, x.shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_dequantize(want_codes, want_scale,
                                                x.shape)))


def test_quantize_int8_shapes_dtypes_and_zero_blocks(rng):
    x = rng.normal(size=(3, 100)).astype(np.float32)
    x[0] = 0.0
    codes, scales = quantize_int8(torch.from_numpy(x).to(torch.bfloat16))
    want_codes, want_scale = ref_quantize(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scale))
    back = dequantize_int8(codes, scales, (3, 100), torch.bfloat16)
    want = ref_dequantize(want_codes, want_scale, (3, 100), jnp.bfloat16)
    assert back.dtype == torch.bfloat16 and back.shape == (3, 100)
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(want, np.float32))


def test_compressed_allreduce_names_its_slice():
    """Where Slice 3 refused it, ``compressed_allreduce`` runs on a rank
    mesh: the mean of the ranks' dequantised codes and each rank's
    residual, as the reference's quantisers give them (the reference's
    collective itself: ``tests/test_torch_dp.py``)."""
    from repro_torch.core import spmd

    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(3, 100)).astype(np.float32) for _ in range(4)]
    mesh = spmd.make_mesh((4,), ("pod",), ("cpu",) * 4)
    x = spmd.Sharded(mesh, [torch.from_numpy(v) for v in xs])
    with spmd.in_mesh(mesh):
        mean, res = compressed_allreduce(x, "pod")
    deq = []
    for v in xs:
        c, sc = ref_quantize(jnp.asarray(v))
        deq.append(np.asarray(ref_dequantize(c, sc, v.shape)))
    want = (((deq[0] + deq[1]) + deq[2]) + deq[3]) / 4
    for r in range(4):
        np.testing.assert_allclose(mean.shards[r].numpy(), want, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(res.shards[r].numpy(), xs[r] - deq[r],
                                   rtol=0, atol=1e-6)
        assert torch.equal(mean.shards[r], mean.shards[0])
    # codes and scales each all-gathered on a ring of 4: 2 · 4 · 3 copies
    assert mesh.copies == 24