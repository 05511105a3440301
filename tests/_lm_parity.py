"""Shared model-level parity checks of the port's LM stack against the JAX
package, for families with an encoder, a vision front end, xLSTM blocks or
a mixture of experts.

Parameters drawn by the reference's ``LanguageModel.init`` from a
``jax.random`` key are carried into the port; tokens, labels, frames and
patches come from NumPy with a seed.  :func:`serving_matches` runs the
full-sequence forward, the prefill through ``make_prefill_step`` and each
decode step through ``make_decode_step`` on both packages and compares
every output and every decode-state leaf; :func:`loss_and_grads_match`
compares ``model.loss`` and every gradient with ``jax.value_and_grad`` of
the reference's ``loss``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import LanguageModel as RefModel
from repro.train import serve as ref_serve
from repro_torch import configs
from repro_torch.models import LanguageModel, weights
from repro_torch.train import make_decode_step, make_prefill_step

MODEL_TOL = 1e-4
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def f32_leaves(tree) -> dict:
    """``{dotted path: float32 array}`` of a reference tree, groups
    unstacked as the port keeps them."""
    return {k: np.asarray(v, np.float32)
            for k, v in weights.leaves(weights.port_tree(np_tree(tree))).items()}


def carried(arch, *, dtype="float32", seed=2, **overrides):
    """(reference config, reference model, its parameters, the port's
    model holding them) for the reduced ``arch``."""
    rcfg = ref_configs.get(arch).reduced(dtype=dtype, **overrides)
    cfg = configs.get(arch).reduced(dtype=dtype, **overrides)
    ref = RefModel(rcfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    model = weights.carry_params(LanguageModel(cfg, device="cpu"),
                                 np_tree(params))
    return rcfg, ref, params, model


def extras(cfg, rng, batch: int, enc_len: int) -> dict:
    """The stub front ends' inputs ``cfg`` takes, float32 NumPy: the
    encoder's ``frames`` (batch, enc_len, d) and the ``pixels``."""
    out = {}
    if cfg.encoder_layers:
        out["frames"] = rng.normal(size=(batch, enc_len, cfg.d_model)
                                   ).astype(np.float32)
    if cfg.frontend == "vision":
        out["pixels"] = rng.normal(size=(batch, cfg.vision_tokens,
                                         cfg.d_model)).astype(np.float32)
    return out


def n_image(cfg) -> int:
    return cfg.vision_tokens if cfg.frontend == "vision" else 0


def reference_run(ref, params, toks, ext, p_pre, p_dec) -> dict:
    """{name: float32 array} of the reference's forward, prefill and decode
    steps on ``toks`` with the front ends' inputs ``ext``."""
    jext = {k: jnp.asarray(v) for k, v in ext.items()}
    n_img = n_image(ref.cfg)
    out = {}
    hidden, aux = jax.jit(lambda p, t, e: ref.forward(p, t, remat=False,
                                                      **e))(params, toks, jext)
    out["forward"] = hidden
    out["forward aux"] = aux
    out["forward logits"] = ref.logits(params, hidden)
    prefill = ref_serve.make_prefill_step(ref, s_max=n_img + p_pre + p_dec)
    last, states = jax.jit(lambda p, t, e: prefill(p, t, **e))(
        params, toks[:, :p_pre], jext)
    out["prefill logits"] = last
    out.update({f"prefill {k}": v for k, v in f32_leaves(states).items()})
    step = jax.jit(ref_serve.make_decode_step(ref))
    for t in range(p_pre, p_pre + p_dec):
        logits, states = step(params, states, toks[:, t:t + 1],
                              jnp.int32(n_img + t))
        out[f"decode {t} logits"] = logits
        out.update({f"decode {t} {k}": v
                    for k, v in f32_leaves(states).items()})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def port_run(model, toks, ext, p_pre, p_dec) -> dict:
    """The same names as :func:`reference_run`, from the port (states
    copied as they stand: decode writes the caches in place)."""
    ttoks = torch.from_numpy(toks)
    text = {k: torch.from_numpy(v) for k, v in ext.items()}
    n_img = n_image(model.cfg)
    out = {}
    hidden, aux = model.hidden_and_aux(ttoks, remat=False, **text)
    out["forward"] = hidden
    out["forward aux"] = aux
    out["forward logits"] = model.logits(hidden)
    last, states = make_prefill_step(model, s_max=n_img + p_pre + p_dec)(
        ttoks[:, :p_pre], **text)
    out["prefill logits"] = last
    out.update({f"prefill {k}": v.clone()
                for k, v in weights.leaves(states).items()})
    step = make_decode_step(model)
    for t in range(p_pre, p_pre + p_dec):
        logits, states = step(states, ttoks[:, t:t + 1], n_img + t)
        out[f"decode {t} logits"] = logits
        out.update({f"decode {t} {k}": v.clone()
                    for k, v in weights.leaves(states).items()})
    return {k: v.detach().float().numpy() for k, v in out.items()}


def serving_matches(arch, rng, *, batch=2, p_pre=20, p_dec=4, enc_len=12,
                    **overrides) -> dict:
    """Forward, prefill and every decode step of the reduced ``arch`` on
    both packages agree within MODEL_TOL; returns the reference's
    results."""
    rcfg, ref, params, model = carried(arch, **overrides)
    toks = rng.integers(0, rcfg.vocab_size, (batch, p_pre + p_dec)).astype(
        np.int32)
    ext = extras(rcfg, rng, batch, enc_len)
    want = reference_run(ref, params, toks, ext, p_pre, p_dec)
    got = port_run(model, toks, ext, p_pre, p_dec)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=f"{arch}: {name}")
    return want


def batch_of(cfg, rng, *, batch=2, seq=20, enc_len=12) -> dict:
    """A training batch for ``cfg``: tokens and labels (some -1, masked),
    and the front ends' inputs, NumPy."""
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, ::7] = -1
    return {"tokens": toks[:, :-1], "labels": labels,
            **extras(cfg, rng, batch, enc_len)}


def loss_and_grads_match(arch, rng, *, remat=True, **overrides) -> dict:
    """``model.loss`` (with ``remat``) and every parameter's gradient agree
    with ``jax.value_and_grad`` of the reference's loss (LOSS_TOL, and
    GRAD_TOL of each leaf's largest |gradient|); returns the reference's
    metrics as floats."""
    rcfg, ref, params, model = carried(arch, **overrides)
    batch = batch_of(rcfg, rng)

    def loss_fn(p):
        return ref.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                        remat=False)

    (want_loss, want_metrics), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model.requires_grad_(True)
    loss, metrics = model.loss({k: torch.from_numpy(v)
                                for k, v in batch.items()}, remat=remat)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert float(loss.detach()) == _approx(float(want_loss))
    for key in ("nll", "aux"):
        assert float(metrics[key].detach()) == _approx(
            float(want_metrics[key])), key
    assert int(metrics["tokens"]) == int(want_metrics["tokens"])
    theirs = f32_leaves(want_grads)
    assert set(theirs) == set(grads)
    for name, want in theirs.items():
        got = grads[name].numpy()
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TOL * scale, (
            f"{arch} {name}: max error {err:.3e}, largest |grad| {scale:.3e}")
    return {k: float(v) for k, v in want_metrics.items()}


def _approx(value):
    return pytest.approx(value, rel=LOSS_TOL, abs=LOSS_TOL)
