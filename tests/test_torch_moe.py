"""The port's mixture-of-experts layer and the two MoE families against the
JAX package.

Module level (float32, 1e-5): the router (``_route``: the same experts,
weights and balance loss), the dispatch (``_dispatch``: the same (E, C, d)
buffer and metadata, bit for bit, from the same routing), the combine
(``_combine``) and ``moe_layer`` at the reduced configs' capacity (no
token drops), at a capacity small enough that tokens drop (the same
tokens drop: the dispatch sort is stable in both), and at a decode step's
capacity (``C = T``); ``aux`` and every gradient of the layer against
``jax.grad``.  The combine is deterministic: it sums each token's k
outputs in a fixed order with no scatter-add (ROADMAP Queue 3), pinned
here by two calls giving the same bits.

Model level (the reduced granite-moe-3b-a800m and moonshot-v1-16b-a3b,
reference parameters carried in, 1e-4): forward, prefill, every decode
step, the loss with a non-zero ``aux`` and every gradient, with tokens
dropping too; the weight carry keeps the router float32 in a bf16 model
and every bf16 leaf bit for bit; under a sharding policy the MoE path runs
its expert-parallel ``all_to_all`` on the policy's mesh (held to the
reference in ``tests/test_torch_policy.py``).  On the CPU no kernel is
launched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import LanguageModel as RefModel
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.models import LanguageModel, moe, weights
from repro_torch.optim import AdamW
from repro_torch.sharding import constraints
from repro_torch.train import (make_decode_step, make_eval_step,
                               make_prefill_step, make_train_step)

import _lm_parity as lp

TOL = 1e-5
MOE = ("granite_moe_3b_a800m", "moonshot_v1_16b_a3b")


@pytest.fixture(autouse=True)
def _no_kernel_launch():
    fa_ops.flash_attention.launches = ls_ops.linear_scan.launches = 0
    yield
    # on CPU tensors the entry points compute their plain versions
    assert fa_ops.flash_attention.launches == 0
    assert ls_ops.linear_scan.launches == 0


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _layer(arch="granite_moe_3b_a800m", seed=1, **overrides):
    """(reference config, port config, reference params, the same as CPU
    tensors)."""
    rcfg = ref_configs.get(arch).reduced(**overrides)
    cfg = configs.get(arch).reduced(**overrides)
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    tp = {"router": torch.from_numpy(np.array(p["router"])),
          "experts": {k: torch.from_numpy(np.array(v))
                      for k, v in p["experts"].items()}}
    return rcfg, cfg, p, tp


def _x(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# routing, dispatch, combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_route_matches_reference(arch, rng):
    rcfg, cfg, p, tp = _layer(arch)
    jx, tx = _x(rng, 40, rcfg.d_model)
    want_i, want_w, want_aux = jax.jit(
        lambda p, x: ref_moe._route(p, x, rcfg))(p, jx)
    top_i, top_w, aux = moe._route(tp, tx, cfg)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want_i))
    _close(top_w, want_w)
    _close(aux, want_aux)
    assert aux.dtype == torch.float32 and float(aux) > 0


@pytest.mark.parametrize("capacity", [2, 5, 40])
def test_dispatch_matches_reference_bit_for_bit(capacity, rng):
    rcfg, cfg, p, _ = _layer()
    jx, tx = _x(rng, 24, rcfg.d_model)
    top_i, top_w, _ = ref_moe._route(p, jx, rcfg)
    want_buf, want_meta = ref_moe._dispatch(jx, top_i, top_w,
                                            rcfg.n_experts, capacity)
    buf, meta = moe._dispatch(
        tx, torch.from_numpy(np.array(top_i)),
        torch.from_numpy(np.array(top_w)), cfg.n_experts, capacity)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want_buf))
    for name, got, want in zip(("slot", "token_idx", "w", "valid"), meta,
                               want_meta):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    kept = int(meta[3].sum())
    assert kept == min(24 * rcfg.n_experts_active,
                       int(np.minimum(np.bincount(np.asarray(top_i).ravel(),
                                                  minlength=8),
                                      capacity).sum()))


@pytest.mark.parametrize("capacity", [3, 48])
def test_combine_matches_reference_and_is_deterministic(capacity, rng):
    rcfg, _, p, _ = _layer()
    T = 24
    jx, _ = _x(rng, T, rcfg.d_model)
    top_i, top_w, _ = ref_moe._route(p, jx, rcfg)
    _, want_meta = ref_moe._dispatch(jx, top_i, top_w, rcfg.n_experts,
                                     capacity)
    jout, tout = _x(rng, rcfg.n_experts, capacity, rcfg.d_model)
    meta = tuple(torch.from_numpy(np.array(m)) for m in want_meta)
    want = ref_moe._combine(jout, want_meta, T)
    got = moe._combine(tout, meta, T)
    _close(got, want)
    assert torch.equal(got, moe._combine(tout, meta, T))


# ---------------------------------------------------------------------------
# the layer: capacities, drops, aux and its gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,factor,seq", [
    ("granite_moe_3b_a800m", None, 12),   # the reduced capacity: no drop
    ("granite_moe_3b_a800m", 0.5, 12),    # tokens drop
    ("moonshot_v1_16b_a3b", 0.3, 16),     # tokens drop
    ("moonshot_v1_16b_a3b", 0.3, 1),      # decode: C = T, none drops
])
def test_moe_layer_matches_reference(arch, factor, seq, rng):
    over = {} if factor is None else {"capacity_factor": factor}
    rcfg, cfg, p, tp = _layer(arch, **over)
    jx, tx = _x(rng, 3, seq, rcfg.d_model)
    want, want_aux = jax.jit(
        lambda p, x: ref_moe.moe_layer(p, x, rcfg))(p, jx)
    got, aux = moe.moe_layer(tp, tx, cfg)
    _close(got, want)
    _close(aux, want_aux)
    t = 3 * seq
    C = t if seq == 1 else moe._capacity(t, cfg)
    assert C == (t if seq == 1 else ref_moe._capacity(t, rcfg))
    top_i, _, _ = moe._route(tp, tx.reshape(t, -1), cfg)
    drops = int(np.maximum(np.bincount(top_i.numpy().ravel(),
                                       minlength=cfg.n_experts) - C, 0).sum())
    if factor is None or seq == 1:
        assert drops == 0
    else:
        assert drops > 0


def test_moe_layer_gradients_match_jax_grad(rng):
    """``aux`` carries its gradient through the mean router probability
    (the dispatch share is a count); the output through the weights and
    the experts.  Tokens drop here."""
    rcfg, cfg, p, tp = _layer(capacity_factor=0.6)
    jx, tx = _x(rng, 2, 10, rcfg.d_model)
    jg, tg = _x(rng, 2, 10, rcfg.d_model)

    def f(params, x):
        y, aux = ref_moe.moe_layer(params, x, rcfg)
        return jnp.sum(y * jg) + 3.0 * aux

    want_p, want_x = jax.jit(jax.grad(f, argnums=(0, 1)))(p, jx)
    leaves = {"router": tp["router"], **tp["experts"]}
    for t in (*leaves.values(), tx):
        t.requires_grad_(True)
    y, aux = moe.moe_layer(tp, tx, cfg)
    (torch.sum(y * tg) + 3.0 * aux).backward()
    want = {"router": want_p["router"], **want_p["experts"]}
    for name, t in leaves.items():
        scale = float(np.abs(np.asarray(want[name])).max())
        _close(t.grad, want[name], tol=TOL * max(scale, 1.0), msg=name)
    _close(tx.grad, want_x)


def test_aux_gradient_reaches_the_router_only_through_the_probabilities(rng):
    rcfg, cfg, p, tp = _layer()
    jx, tx = _x(rng, 16, rcfg.d_model)
    want = jax.jit(jax.grad(lambda r: ref_moe._route(
        {**p, "router": r}, jx, rcfg)[2]))(p["router"])
    router = tp["router"].clone().requires_grad_(True)
    _, _, aux = moe._route({**tp, "router": router}, tx, cfg)
    aux.backward()
    _close(router.grad, want)
    assert float(router.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# the two MoE families, end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,factor", [(MOE[0], None), (MOE[1], None),
                                         (MOE[1], 0.5)])
def test_serving_matches_reference(arch, factor, rng):
    """Forward, prefill and every decode step; with ``factor`` 0.5 the
    forward and the prefill drop tokens (decode never does)."""
    over = {} if factor is None else {"capacity_factor": factor}
    want = lp.serving_matches(arch, rng, **over)
    assert want["forward aux"] > 0


@pytest.mark.parametrize("arch,factor", [(MOE[0], None), (MOE[1], None),
                                         (MOE[0], 0.5)])
def test_loss_and_every_gradient_match_the_reference(arch, factor, rng):
    over = {} if factor is None else {"capacity_factor": factor}
    metrics = lp.loss_and_grads_match(arch, rng, **over)
    assert metrics["aux"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_draws_the_reference_tree(dtype):
    """The port's ``init_moe`` gives the reference's names, shapes and
    dtypes: the router float32 whatever the model's dtype."""
    rcfg, cfg, _, _ = _layer()
    want = lp.np_tree(ref_moe.init_moe(jax.random.PRNGKey(0), rcfg,
                                       jnp.dtype(dtype)))
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg,
                       getattr(torch, dtype), "cpu")
    want, got = weights.leaves(want), weights.leaves(got)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == leaf.dtype.name, name
    assert got["router"].dtype == torch.float32


def test_bfloat16_weights_carry_bit_for_bit_with_a_float32_router():
    rcfg = ref_configs.get(MOE[0]).reduced(dtype="bfloat16")
    params = lp.np_tree(jax.jit(RefModel(rcfg).init)(jax.random.PRNGKey(7)))
    model = weights.carry_params(
        LanguageModel(configs.get(MOE[0]).reduced(dtype="bfloat16"),
                      device="cpu"), params)
    ours = dict(model.named_parameters())
    routers = [n for n in ours if n.endswith("moe.router")]
    assert len(routers) == rcfg.n_layers
    assert all(ours[n].dtype == torch.float32 for n in routers)
    for name, leaf in weights.leaves(weights.port_tree(params)).items():
        if leaf.dtype.name == "bfloat16":
            assert np.array_equal(ours[name].view(torch.int16).numpy(),
                                  leaf.view(np.int16)), name
        else:
            assert np.array_equal(ours[name].numpy(), leaf), name
    assert ours["groups.1.b0.moe.experts.w_down"].shape == (
        rcfg.n_experts, rcfg.d_ff, rcfg.d_model)
    # the port's own draw keeps the router float32 too
    own = LanguageModel(configs.get(MOE[0]).reduced(dtype="bfloat16"),
                        device="cpu").init(torch.Generator().manual_seed(0))
    assert own["groups"][0]["b0"]["moe"]["router"].dtype == torch.float32
    assert own["groups"][0]["b0"]["moe"]["experts"]["w_up"].dtype == \
        torch.bfloat16


def test_a_sharding_policy_names_slice_3_on_the_moe_path(rng):
    """Where Slice 3 refused a policy, the expert-parallel path runs: the
    tokens cross the model axis in two ``all_to_all`` (no token drops at
    the reduced capacity, so the output is the unsharded layer's), and
    every policy-taking step builds and runs."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import make_policy

    model = LanguageModel(configs.get(MOE[1]).reduced(), device="cpu").init(
        torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.normal(size=(1, 4, 64)).astype(np.float32))
    p = model["groups"][0]["b0"]["moe"]
    policy = make_policy(make_host_mesh(1, 4, device="cpu"))
    want, _ = moe.moe_layer(p, x, model.cfg)
    with constraints.use_policy(policy):
        got, aux = moe.moe_layer(p, x, model.cfg)
    # 2 all_to_all of 4 · 3 copies, and the ring pmean of aux (2 · 4 · 3)
    assert policy.mesh.copies == 2 * 12 + 24
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert aux.shape == ()
    tokens = torch.from_numpy(rng.integers(0, 512, (1, 8)))
    batch = {"tokens": tokens, "labels": tokens}
    logits, states = make_prefill_step(model, policy, s_max=12)(tokens)
    make_decode_step(model, make_policy(make_host_mesh(1, 4, device="cpu"),
                                        seq_sharded=False))(
        states, logits.argmax(-1), 8)
    opt = AdamW(learning_rate=1e-3)
    _, metrics = make_train_step(model, opt, policy)(opt.init(model), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert set(make_eval_step(model, policy)(batch)) == {"loss", "nll",
                                                         "aux", "tokens"}