"""The port's cross-attention, encoder-decoder stack and vision front end
against the JAX package: seamless-m4t-medium and phi-3-vision-4.2b.

Module level (float32, 1e-5): ``project_kv``; ``attention`` with
``memory_h`` and with ``kv_override`` (never causal), on the oracle path
and the chunked one, including an encoder of 600 frames on the oracle
path, where the entry point must pad no key (a zero key would be
attended: non-causal attention has no mask to hide it); encoder
self-attention over 600 frames; ``attention_decode(is_cross=True)``,
which reads the encoder cache and writes nothing.  Model level (the two
reduced families with the reference's parameters carried in, 1e-4):
forward (an encoder of 600 frames too), prefill, every decode step, the
loss (image positions unlabelled) and every gradient; the chunked prefill
keeps the reference's chunk check on the encoder.  ``launch/train.py``
runs a reduced Seamless and a reduced Phi-3 on the host.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as ref_layers
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import LanguageModel, layers
from repro_torch.train import make_prefill_step

import _lm_parity as lp

TOL = 1e-5
SEAMLESS, PHI3 = "seamless_m4t_medium", "phi_3_vision_4_2b"


@pytest.fixture(autouse=True)
def _no_kernel_launch():
    fa_ops.flash_attention.launches = ls_ops.linear_scan.launches = 0
    yield
    assert fa_ops.flash_attention.launches == 0
    assert ls_ops.linear_scan.launches == 0


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _x(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _attn(rng, arch=SEAMLESS, **overrides):
    rcfg = ref_configs.get(arch).reduced(**overrides)
    cfg = configs.get(arch).reduced(**overrides)
    p = ref_layers.init_attention(jax.random.PRNGKey(3), rcfg, jnp.float32)
    if rcfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            p[name] = jnp.asarray(rng.normal(size=p[name].shape), jnp.float32)
    return rcfg, cfg, p, {k: torch.from_numpy(np.array(v))
                          for k, v in p.items()}


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

# (arch, overrides): Seamless's MHA; GQA with qk_norm (qwen3) and
# qkv_bias (qwen2.5), whose K/V projections project_kv also runs
KV_CASES = [(SEAMLESS, {}), ("qwen3_14b", {"n_kv_heads": 2}),
            ("qwen2_5_32b", {"n_kv_heads": 2})]


@pytest.mark.parametrize("arch,over", KV_CASES)
def test_project_kv_matches_reference(arch, over, rng):
    rcfg, cfg, p, tp = _attn(rng, arch, **over)
    jm, tm = _x(rng, 2, 9, rcfg.d_model)
    wk, wv = ref_layers.project_kv(p, jm, rcfg)
    k, v = layers.project_kv(tp, tm, cfg)
    _close(k, wk)
    _close(v, wv)


@pytest.mark.parametrize("enc_len,chunked", [(12, False), (12, True),
                                             (600, False), (40, True)])
@pytest.mark.parametrize("arch,over", KV_CASES[:2])
def test_cross_attention_matches_reference(arch, over, enc_len, chunked,
                                           rng):
    rcfg, cfg, p, tp = _attn(rng, arch, **over)
    jx, tx = _x(rng, 2, 16, rcfg.d_model)
    jm, tm = _x(rng, 2, enc_len, rcfg.d_model)
    want, (wk, wv) = jax.jit(lambda p, x, m: ref_layers.attention(
        p, x, rcfg, memory_h=m, return_kv=True, chunked=chunked))(p, jx, jm)
    got, (k, v) = layers.attention(tp, tx, cfg, memory_h=tm, return_kv=True,
                                   chunked=chunked)
    _close(got, want)
    _close(k, wk)
    _close(v, wv)
    # the same keys and values handed over precomputed; causal is ignored
    over_want = jax.jit(lambda p, x, kv: ref_layers.attention(
        p, x, rcfg, kv_override=kv, causal=True, chunked=chunked))(
        p, jx, (wk, wv))
    _close(layers.attention(tp, tx, cfg, kv_override=(k, v), causal=True,
                            chunked=chunked), over_want)


@pytest.mark.parametrize("window", [None, 7])
def test_non_causal_self_attention_over_600_frames_pads_no_key(window, rng):
    """An encoder block's attention (non-causal) over 600 positions: the
    reference's oracle pads nothing, and neither may the port (600 is no
    multiple of the entry point's 512-key block)."""
    rcfg, cfg, p, tp = _attn(rng)
    jx, tx = _x(rng, 1, 600, rcfg.d_model)
    want = jax.jit(lambda p, x: ref_layers.attention(
        p, x, rcfg, causal=False, window=window))(p, jx)
    _close(layers.attention(tp, tx, cfg, causal=False, window=window), want)


def test_cross_attention_decode_reads_the_encoder_cache(rng):
    rcfg, cfg, p, tp = _attn(rng)
    shape = (2, rcfg.n_kv_heads, 11, rcfg.head_dim_)
    jk, tk = _x(rng, *shape)
    jv, tv = _x(rng, *shape)
    kept = (tk.clone(), tv.clone())
    for pos in (0, 5, 30):
        jx, tx = _x(rng, 2, 1, rcfg.d_model)
        want, wcache = ref_layers.attention_decode(
            p, jx, {"k": jk, "v": jv}, jnp.int32(pos), rcfg, is_cross=True)
        got, cache = layers.attention_decode(tp, tx, {"k": tk, "v": tv}, pos,
                                             cfg, is_cross=True)
        _close(got, want, msg=f"pos {pos}")
        assert cache["k"] is tk and cache["v"] is tv
        assert torch.equal(tk, kept[0]) and torch.equal(tv, kept[1])


# ---------------------------------------------------------------------------
# the two families, end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [SEAMLESS, PHI3])
def test_serving_matches_reference(arch, rng):
    lp.serving_matches(arch, rng)


@pytest.mark.parametrize("arch", [SEAMLESS, PHI3])
def test_loss_and_every_gradient_match_the_reference(arch, rng):
    metrics = lp.loss_and_grads_match(arch, rng)
    # Phi-3: the 8 image positions carry no label
    assert metrics["tokens"] == 34.0 and metrics["aux"] == 0.0


def test_encoder_of_600_frames_matches_reference(rng):
    """The full-sequence forward runs the encoder on the oracle path, so
    600 frames (no multiple of 512) run, as in the reference; the chunked
    prefill keeps the reference's chunk check on the encoder and
    refuses them, as the reference's assertion does."""
    rcfg, ref, params, model = lp.carried(SEAMLESS)
    toks = rng.integers(0, rcfg.vocab_size, (1, 8)).astype(np.int32)
    frames = rng.normal(size=(1, 600, rcfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, t, f: ref.forward(p, t, frames=f,
                                                  remat=False))(
        params, toks, frames)
    got = model(torch.from_numpy(toks), frames=torch.from_numpy(frames),
                remat=False)
    _close(got, want, tol=lp.MODEL_TOL)
    with pytest.raises(ValueError, match="Sq % cq"):
        make_prefill_step(model, s_max=10)(torch.from_numpy(toks),
                                           frames=torch.from_numpy(frames))


def test_decode_states_carry_the_encoder_cache(rng):
    cfg = configs.get(SEAMLESS).reduced()
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    zero = model.init_states(2, 10, enc_len=6)
    block = zero["groups"][0]["b0"]
    assert sorted(block) == ["cross", "self"]
    assert tuple(block["cross"]["k"].shape) == (2, cfg.n_kv_heads, 6,
                                                cfg.head_dim)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    frames = torch.from_numpy(rng.normal(size=(2, 6, cfg.d_model)).astype(
        np.float32))
    _, states = make_prefill_step(model, s_max=10)(toks, frames=frames)
    cross = states["groups"][1]["b0"]["cross"]["k"].clone()
    _, states = model.decode_step(states, toks[:, :1], 8)
    assert torch.equal(states["groups"][1]["b0"]["cross"]["k"], cross)


@pytest.mark.parametrize("arch", [SEAMLESS, PHI3])
def test_launch_train_runs_on_the_host(arch, tmp_path, capsys):
    out = tmp_path / "metrics.json"
    assert launch_train.main(["--arch", arch, "--reduced", "--steps", "2",
                              "--batch", "2", "--seq", "24", "--cpu",
                              "--metrics-out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "[train] done"
    final = json.loads(out.read_text())["final"]
    assert np.isfinite(final["loss"]) and final["aux"] == 0.0
    # Phi-3's 8 image positions carry no label: 2 x 24 text labels
    assert final["tokens"] == 48
