"""The port's xLSTM blocks and the xlstm-350m family against the JAX
package.

Module level (float32, 1e-5): the mLSTM block in its parallel form and
chunked over query blocks (the reference's ``lax.scan`` as a Python
loop, with its ``S % cq`` check), its closed-form final state, and decode
steps continuing a prefill from that state; the sLSTM block (one Python
step per token, float32 inside) and its decode; the per-head norm; the
state inits.  Model level (the reduced xlstm-350m with the reference's
parameters carried in, 1e-4): forward, prefill, every decode step, the
loss and every gradient, and the weight carry bit for bit in bf16.  The
xLSTM blocks call no kernel: on the CPU none is launched, and on the card
neither (``chip_smoke.py``'s ``[lm_families]`` checks it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import LanguageModel as RefModel
from repro.models import xlstm as ref_xlstm
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.models import LanguageModel, weights, xlstm

import _lm_parity as lp

TOL = 1e-5
ARCH = "xlstm_350m"


@pytest.fixture(autouse=True)
def _no_kernel_launch():
    fa_ops.flash_attention.launches = ls_ops.linear_scan.launches = 0
    yield
    assert fa_ops.flash_attention.launches == 0
    assert ls_ops.linear_scan.launches == 0


def _cfgs(**overrides):
    return (ref_configs.get(ARCH).reduced(**overrides),
            configs.get(ARCH).reduced(**overrides))


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _x(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _mlstm(rng, seed=3):
    rcfg, cfg = _cfgs()
    p = ref_xlstm.init_mlstm(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    # the init's bias and norm are constant: make them count
    for name in ("conv_b", "norm"):
        p[name] = jnp.asarray(rng.normal(size=p[name].shape) * 0.3,
                              jnp.float32)
    return rcfg, cfg, p, _port(p)


def _slstm(rng, seed=4):
    rcfg, cfg = _cfgs()
    p = ref_xlstm.init_slstm(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    for name in ("b_gates", "norm"):
        p[name] = jnp.asarray(rng.normal(size=p[name].shape) * 0.3,
                              jnp.float32)
    return rcfg, cfg, p, _port(p)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def test_head_norm_matches_reference(rng):
    jx, tx = _x(rng, 2, 5, 4, 16)
    js, ts = _x(rng, 64)
    _close(xlstm._head_norm(tx, ts, 1e-6), ref_xlstm._head_norm(jx, js, 1e-6))


@pytest.mark.parametrize("chunked,cq,seq", [(False, 512, 24), (True, 8, 24),
                                            (True, 512, 24), (False, 512, 1)])
def test_mlstm_block_and_its_state_match_reference(chunked, cq, seq, rng):
    rcfg, cfg, p, tp = _mlstm(rng)
    jx, tx = _x(rng, 2, seq, rcfg.d_model)
    want, wst = jax.jit(lambda p, x: ref_xlstm.mlstm_block(
        p, x, rcfg, return_state=True, chunked=chunked, cq=cq))(p, jx)
    got, st = xlstm.mlstm_block(tp, tx, cfg, return_state=True,
                                chunked=chunked, cq=cq)
    _close(got, want)
    assert sorted(st) == sorted(wst) == ["C", "conv", "m", "n"]
    for name in st:
        _close(st[name], wst[name], msg=name)
    assert st["C"].dtype == torch.float32


def test_chunked_mlstm_keeps_the_reference_chunk_check(rng):
    _, cfg, _, tp = _mlstm(rng)
    with pytest.raises(ValueError, match="S % cq"):
        xlstm.mlstm_block(tp, torch.zeros(1, 12, cfg.d_model), cfg,
                          chunked=True, cq=8)


def test_mlstm_decode_continues_a_prefill(rng):
    """Decode steps from the closed-form state of a prefill give what the
    reference's do, and what the full-sequence form gives at those
    positions."""
    rcfg, cfg, p, tp = _mlstm(rng)
    jx, tx = _x(rng, 2, 14, rcfg.d_model)
    _, wst = ref_xlstm.mlstm_block(p, jx[:, :10], rcfg, return_state=True)
    _, st = xlstm.mlstm_block(tp, tx[:, :10], cfg, return_state=True)
    full = xlstm.mlstm_block(tp, tx, cfg)
    step = jax.jit(lambda p, x, s: ref_xlstm.mlstm_block_decode(p, x, s,
                                                                rcfg))
    for t in range(10, 14):
        want, wst = step(p, jx[:, t:t + 1], wst)
        got, st = xlstm.mlstm_block_decode(tp, tx[:, t:t + 1], st, cfg)
        _close(got, want, msg=f"t={t}")
        for name in st:
            _close(st[name], wst[name], msg=f"t={t} {name}")
        _close(got, full[:, t:t + 1].numpy(), tol=1e-4, msg=f"t={t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_inits_match_reference(dtype):
    rcfg, cfg = _cfgs()
    for ref_init, port_init in ((ref_xlstm.init_mlstm_state,
                                 xlstm.init_mlstm_state),
                                (ref_xlstm.init_slstm_state,
                                 xlstm.init_slstm_state)):
        want = ref_init(rcfg, 3, jnp.dtype(dtype))
        got = port_init(cfg, 3, getattr(torch, dtype), "cpu")
        assert sorted(got) == sorted(want)
        for name in got:
            assert tuple(got[name].shape) == want[name].shape, name
            assert str(got[name].dtype).split(".")[-1] == str(
                want[name].dtype), name
            np.testing.assert_array_equal(got[name].float().numpy(),
                                          np.asarray(want[name], np.float32))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 17])
def test_slstm_block_matches_reference(seq, rng):
    rcfg, cfg, p, tp = _slstm(rng)
    jx, tx = _x(rng, 2, seq, rcfg.d_model)
    want, wst = jax.jit(lambda p, x: ref_xlstm.slstm_block(
        p, x, rcfg, return_state=True))(p, jx)
    got, st = xlstm.slstm_block(tp, tx, cfg, return_state=True)
    _close(got, want)
    assert sorted(st) == sorted(wst) == ["c", "h", "m", "n"]
    for name in st:
        _close(st[name], wst[name], msg=name)


def test_slstm_decode_matches_reference(rng):
    rcfg, cfg, p, tp = _slstm(rng)
    jx, tx = _x(rng, 2, 12, rcfg.d_model)
    _, wst = ref_xlstm.slstm_block(p, jx[:, :8], rcfg, return_state=True)
    _, st = xlstm.slstm_block(tp, tx[:, :8], cfg, return_state=True)
    full = xlstm.slstm_block(tp, tx, cfg)
    step = jax.jit(lambda p, x, s: ref_xlstm.slstm_block_decode(p, x, s,
                                                                rcfg))
    for t in range(8, 12):
        want, wst = step(p, jx[:, t:t + 1], wst)
        got, st = xlstm.slstm_block_decode(tp, tx[:, t:t + 1], st, cfg)
        _close(got, want, msg=f"t={t}")
        for name in st:
            _close(st[name], wst[name], msg=f"t={t} {name}")
        _close(got, full[:, t:t + 1].numpy(), tol=1e-4, msg=f"t={t}")


def test_slstm_gradients_match_jax_grad(rng):
    """The Python loop over time carries the gradient as the reference's
    ``lax.scan`` does."""
    rcfg, cfg, p, tp = _slstm(rng)
    jx, tx = _x(rng, 2, 9, rcfg.d_model)
    jg, tg = _x(rng, 2, 9, rcfg.d_model)
    want_p, want_x = jax.jit(jax.grad(
        lambda p, x: jnp.sum(ref_xlstm.slstm_block(p, x, rcfg) * jg),
        argnums=(0, 1)))(p, jx)
    for t in (*tp.values(), tx):
        t.requires_grad_(True)
    torch.sum(xlstm.slstm_block(tp, tx, cfg) * tg).backward()
    for name, t in tp.items():
        scale = float(np.abs(np.asarray(want_p[name])).max())
        _close(t.grad, want_p[name], tol=1e-4 * max(scale, 1.0), msg=name)
    _close(tx.grad, want_x, tol=1e-4)


# ---------------------------------------------------------------------------
# the family, end to end
# ---------------------------------------------------------------------------

def test_serving_matches_reference(rng):
    lp.serving_matches(ARCH, rng)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_the_reference(remat, rng):
    metrics = lp.loss_and_grads_match(ARCH, rng, remat=remat)
    assert metrics["aux"] == 0.0


def test_bfloat16_weights_carry_bit_for_bit():
    rcfg, cfg = _cfgs(dtype="bfloat16")
    params = lp.np_tree(jax.jit(RefModel(rcfg).init)(jax.random.PRNGKey(7)))
    model = weights.carry_params(LanguageModel(cfg, device="cpu"), params)
    ours = dict(model.named_parameters())
    kinds = [kind for _, kind in model.layers()]
    assert kinds == ["mlstm", "slstm"] * 2
    for name, leaf in weights.leaves(weights.port_tree(params)).items():
        if leaf.dtype.name == "bfloat16":
            assert np.array_equal(ours[name].view(torch.int16).numpy(),
                                  leaf.view(np.int16)), name
        else:
            assert np.array_equal(ours[name].numpy(), leaf), name
    assert "groups.1.b1.slstm.r_gates" in ours
    assert "groups.0.b0.mlstm.w_if" in ours
