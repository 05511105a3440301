"""The port's LM serving path against the JAX package, end to end.

Parameters drawn by the reference's ``LanguageModel.init`` from a
``jax.random`` key are carried into the port
(``repro_torch.models.weights.carry_params``); tokens come from NumPy with
a seed.  For each ported reduced configuration the full-sequence
``forward`` (hidden states and logits), ``prefill`` through
``make_prefill_step`` (the last token's logits and every decode-state
leaf) and each ``decode_step`` through ``make_decode_step`` (logits and
states) agree with the reference's within 1e-4 in float32.  A bfloat16
RecurrentGemma is held, as the reference is, to a float32 run on the same
weights (see its test).  The prompt is longer than the reduced window
(16), so windowed attention and its caches bind.

Then the reference's own serving checks (``tests/test_serve.py``: decode
after prefill, and decode from zero states, reproduce the full-sequence
logits; the ring cache reproduces the full cache), run on the port for
the ported architectures, and the deliberate divergence of ROADMAP Queue
3 pinned: the port's prefill sends attention and the RG-LRU scan through
the ``flash_attention`` and ``linear_scan`` entry points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import LanguageModel as RefModel
from repro.train import serve as ref_serve
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.models import LanguageModel, attention_xla, layers, recurrent
from repro_torch.models import weights
from repro_torch.train import make_decode_step, make_prefill_step

PORTED = ("recurrentgemma_9b", "gemma_7b", "h2o_danube_1_8b", "qwen2_5_32b",
          "qwen3_14b")
CASES = [(arch, "float32", 1e-4) for arch in PORTED]
P_PRE, P_DEC = 20, 4          # against the reference: past the window (16)
S_PRE, S_DEC = 6, 6           # the reference's own serving checks
S = S_PRE + S_DEC
# bfloat16: the port's rms error against a float32 run on the same weights
# at most BF16_RATIO times the reference's, plus one bf16 rounding
BF16_RATIO = 2.0
BF16_ULP = 2.0 ** -8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in weights.leaves(weights.port_tree(_np(tree))).items()}


def _reference_run(ref, params, toks):
    """{name: float32 array} of the reference's forward, prefill and decode
    steps (through its serving step factories) on ``toks``."""
    out = {}
    hidden, _ = jax.jit(lambda p, t: ref.forward(p, t, remat=False))(
        params, toks)
    out["forward"] = hidden
    out["forward logits"] = ref.logits(params, hidden)
    last, states = jax.jit(ref_serve.make_prefill_step(
        ref, s_max=P_PRE + P_DEC))(params, toks[:, :P_PRE])
    out["prefill logits"] = last
    out.update({f"prefill {k}": v for k, v in _f32(states).items()})
    step = jax.jit(ref_serve.make_decode_step(ref))
    for t in range(P_PRE, P_PRE + P_DEC):
        logits, states = step(params, states, toks[:, t:t + 1], jnp.int32(t))
        out[f"decode {t} logits"] = logits
        out.update({f"decode {t} {k}": v for k, v in _f32(states).items()})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _port_run(model, toks):
    """The same names as :func:`_reference_run`, from the port (states
    copied as they stand: decode writes the caches in place)."""
    ttoks = torch.from_numpy(toks)
    out = {}
    hidden = model(ttoks)
    out["forward"] = hidden
    out["forward logits"] = model.logits(hidden)
    last, states = make_prefill_step(model, s_max=P_PRE + P_DEC)(
        ttoks[:, :P_PRE])
    out["prefill logits"] = last
    out.update({f"prefill {k}": v.clone()
                for k, v in weights.leaves(states).items()})
    step = make_decode_step(model)
    for t in range(P_PRE, P_PRE + P_DEC):
        logits, states = step(states, ttoks[:, t:t + 1], t)
        out[f"decode {t} logits"] = logits
        out.update({f"decode {t} {k}": v.clone()
                    for k, v in weights.leaves(states).items()})
    return {k: v.float().numpy() for k, v in out.items()}


def _carried(arch, dtype, seed=2):
    rcfg = ref_configs.get(arch).reduced(dtype=dtype)
    cfg = configs.get(arch).reduced(dtype=dtype)
    ref = RefModel(rcfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    model = weights.carry_params(LanguageModel(cfg, device="cpu"),
                                 _np(params))
    return rcfg, ref, params, model


@pytest.mark.parametrize("arch", PORTED)
def test_serving_matches_reference(arch, rng):
    rcfg, ref, params, model = _carried(arch, "float32")
    toks = rng.integers(0, rcfg.vocab_size, (2, P_PRE + P_DEC)).astype(
        np.int32)
    want = _reference_run(ref, params, toks)
    got = _port_run(model, toks)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{arch}: {name}")


def test_bfloat16_serving_is_as_accurate_as_the_reference(rng):
    """RecurrentGemma in bfloat16.  Rounding to bf16 in other places than
    XLA's fusions moves values by a few bf16 steps: the reference differs
    from itself (jit against eager) by 2.1% rms on this forward, and from
    float32 by 2.7%.  So both are held to the float32 computation on the
    same weights: for every compared tensor the port's rms error is at most
    BF16_RATIO times the reference's, plus one bf16 rounding."""
    rcfg, ref, params, model = _carried("recurrentgemma_9b", "bfloat16")
    toks = rng.integers(0, rcfg.vocab_size, (2, P_PRE + P_DEC)).astype(
        np.int32)
    ref32 = RefModel(dataclasses.replace(rcfg, dtype="float32"))
    truth = _reference_run(
        ref32, jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                      params), toks)
    want = _reference_run(ref, params, toks)
    got = _port_run(model, toks)
    assert sorted(got) == sorted(want) == sorted(truth)

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))

    for name, exact in truth.items():
        ref_err, port_err = rms(want[name] - exact), rms(got[name] - exact)
        bound = BF16_RATIO * ref_err + BF16_ULP * rms(exact)
        assert port_err <= bound, (
            f"{name}: port rms error {port_err:.3e} against float32, the "
            f"reference's {ref_err:.3e} (bound {bound:.3e})")


def _forward_logits(model, toks):
    return model.logits(model(toks)).numpy()


@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_forward(arch, rng):
    cfg = configs.get(arch).reduced()
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(2))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
    full_logits = _forward_logits(model, toks)

    last_pre, states = make_prefill_step(model, s_max=S)(toks[:, :S_PRE])
    np.testing.assert_allclose(
        last_pre[:, 0].numpy(), full_logits[:, S_PRE - 1], rtol=2e-3,
        atol=2e-3, err_msg=f"{arch}: prefill logits diverge")
    step = make_decode_step(model)
    for t in range(S_PRE, S):
        logits, states = step(states, toks[:, t:t + 1], t)
        np.testing.assert_allclose(
            logits[:, 0].numpy(), full_logits[:, t], rtol=2e-3, atol=2e-3,
            err_msg=f"{arch}: decode diverges at t={t}")


def test_decode_from_scratch_matches_forward(rng):
    """Pure decode (no prefill) for a dense arch: zero states, every token
    fed in turn; the logits track the forward pass."""
    cfg = configs.get("gemma_7b").reduced()
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
    full_logits = _forward_logits(model, toks)
    states = model.init_states(2, S)
    step = make_decode_step(model)
    for t in range(S):
        logits, states = step(states, toks[:, t:t + 1], t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full_logits[:, t],
                                   rtol=2e-3, atol=2e-3, err_msg=f"t={t}")


def test_ring_cache_matches_full_cache_swa(rng):
    """The W-slot ring cache reproduces full-cache SWA decode, including
    after the buffer wraps (a prefill longer than W exercises the slot
    permutation)."""
    base = configs.get("h2o_danube_1_8b").reduced()
    cfg_full = dataclasses.replace(base, window=4)
    cfg_ring = dataclasses.replace(base, window=4, ring_cache=True)
    model_f = LanguageModel(cfg_full, device="cpu").init(
        torch.Generator().manual_seed(5))
    model_r = LanguageModel(cfg_ring, device="cpu")
    model_r.load_state_dict(model_f.state_dict())
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, (2, S)))
    full_logits = _forward_logits(model_f, toks)

    _, st_r = make_prefill_step(model_r, s_max=S)(toks[:, :S_PRE])
    step_r = make_decode_step(model_r)
    for t in range(S_PRE, S):
        logits, st_r = step_r(st_r, toks[:, t:t + 1], t)
        np.testing.assert_allclose(
            logits[:, 0].numpy(), full_logits[:, t], rtol=2e-3, atol=2e-3,
            err_msg=f"ring decode t={t}")
    caches = [leaf for leaf in weights.leaves(st_r).values()
              if leaf.dim() == 4]
    assert caches and all(c.shape[2] == 4 for c in caches), [
        c.shape for c in caches]


def test_ring_cache_prefill_matches_reference(rng):
    """The ring slots prefill hands to decode are the reference's."""
    rcfg = dataclasses.replace(
        ref_configs.get("h2o_danube_1_8b").reduced(), window=4,
        ring_cache=True)
    cfg = dataclasses.replace(configs.get("h2o_danube_1_8b").reduced(),
                              window=4, ring_cache=True)
    ref = RefModel(rcfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(5))
    model = weights.carry_params(LanguageModel(cfg, device="cpu"),
                                 _np(params))
    toks = rng.integers(0, cfg.vocab_size, (2, S_PRE)).astype(np.int32)
    _, rstates = jax.jit(lambda p, t: ref.prefill(p, t, s_max=S))(params, toks)
    _, states = model.prefill(torch.from_numpy(toks), s_max=S)
    want = _f32(rstates)
    got = weights.leaves(states)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_prefill_runs_the_kernel_entry_points(rng, monkeypatch):
    """ROADMAP Queue 3, a deliberate divergence: the port's prefill sends
    every attention block through ``flash_attention`` (via
    ``chunked_attention``) and every RG-LRU scan through ``linear_scan``,
    where the reference calls its chunked XLA loop and its scan oracle;
    ``forward`` takes ``flash_attention`` directly (the reference: its
    attention oracle).  Decode calls neither."""
    calls = {"prefill": [], "forward": [], "scan": []}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name].append(tuple(args[0].shape))
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(attention_xla, "flash_attention",
                        counting("prefill", fa_ops.flash_attention))
    monkeypatch.setattr(layers, "flash_attention",
                        counting("forward", fa_ops.flash_attention))
    monkeypatch.setattr(recurrent, "linear_scan",
                        counting("scan", ls_ops.linear_scan))
    cfg = configs.get("recurrentgemma_9b").reduced()
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S_PRE)))
    kinds = [kind for _, kind in model.layers()]
    n_attn, n_rec = kinds.count("local_attn"), kinds.count("rglru")
    assert (n_attn, n_rec) == (2, 4)

    _, states = model.prefill(toks, s_max=S)
    assert calls == {"prefill": [(2, cfg.n_heads, S_PRE, cfg.head_dim)] * 2,
                     "forward": [], "scan": [(2, S_PRE, 64)] * 4}
    model.decode_step(states, toks[:, :1], S_PRE)
    assert len(calls["prefill"]) == 2 and len(calls["scan"]) == 4
    model(toks)
    assert len(calls["forward"]) == n_attn and len(calls["scan"]) == 8


def test_decode_writes_the_caches_in_place(rng):
    """ROADMAP Queue 3, a deliberate divergence: decode writes the new key
    and value into the cache tensors it is given (the reference returns
    updated copies and leaves its arguments as they were); the values are
    the reference's (``test_serving_matches_reference``)."""
    cfg = configs.get("recurrentgemma_9b").reduced()
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S_PRE + 1)))
    _, states = model.prefill(toks[:, :S_PRE], s_max=S)
    cache = states["groups"][0]["b2"]["k"]
    assert not bool(cache[:, :, S_PRE].any())
    _, new = model.decode_step(states, toks[:, S_PRE:], S_PRE)
    assert new["groups"][0]["b2"]["k"] is cache
    assert bool(cache[:, :, S_PRE].any())
