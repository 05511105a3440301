"""The port's LM layers, configurations and weight carry against the JAX
package, module by module.

The same inputs, made with NumPy from a seed, and the same parameters,
drawn by the reference's ``init_*`` functions from a ``jax.random`` key and
carried across as NumPy arrays, go through ``repro.models.*`` and
``repro_torch.models.*``; float32 results agree within 1e-5.  On the CPU
the port's attention and scan entry points take their plain versions (the
hand-written kernels run on the card, where ``chip_smoke.py`` holds them
to those plain versions), and a CPU call never launches a kernel.

Also here: every configuration answers as the reference's, the port's
parameter count equals ``param_count()`` at full size for all ten (built
on the ``meta`` device, which allocates nothing), an unknown block kind
raises a ``ValueError``, and the weight carry is bit for bit for
bfloat16.  The other five families (mixture of experts, encoder-decoder,
vision, xLSTM) are held against the reference in
``test_torch_{moe,encdec,xlstm}.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import LanguageModel as RefModel
from repro.models import attention_xla as ref_attention_xla
from repro.models import layers as ref_layers
from repro.models import recurrent as ref_recurrent
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.models import LanguageModel, attention_xla, layers, recurrent
from repro_torch.models import blocks, weights
from repro_torch.sharding import constraints
from repro_torch.train import serve

TOL = 1e-5
PORTED = ("recurrentgemma_9b", "gemma_7b", "h2o_danube_1_8b", "qwen2_5_32b",
          "qwen3_14b")


@pytest.fixture(autouse=True)
def _no_kernel_launch():
    fa_ops.flash_attention.launches = ls_ops.linear_scan.launches = 0
    yield
    # on CPU tensors the entry points compute their plain versions
    assert fa_ops.flash_attention.launches == 0
    assert ls_ops.linear_scan.launches == 0


def _cfgs(arch, **overrides):
    """(reference config, port config), reduced with ``overrides``."""
    return (ref_configs.get(arch).reduced(**overrides),
            configs.get(arch).reduced(**overrides))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    """A reference dict of arrays as a dict of CPU tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in _np(tree).items()}


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _x(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# norms, RoPE, MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype, rng):
    jx, tx = _x(rng, 2, 5, 64)
    js, ts = _x(rng, 64)
    tol = TOL if dtype == "float32" else 1e-2
    want = ref_layers.rmsnorm(jx.astype(dtype), js.astype(dtype), 1e-6)
    got = layers.rmsnorm(tx.to(getattr(torch, dtype)),
                         ts.to(getattr(torch, dtype)), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want.astype(jnp.float32), tol)


@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_reference(batched, rng):
    jx, tx = _x(rng, 2, 3, 7, 16)
    pos = rng.integers(0, 5000, (2, 7) if batched else (7,)).astype(np.int32)
    want = ref_layers.rope(jx, jnp.asarray(pos), 10_000.0)
    got = layers.rope(tx, torch.from_numpy(pos), 10_000.0)
    _close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_mlp_matches_reference(kind, rng):
    rcfg, _ = _cfgs("gemma_7b")
    p = ref_layers.init_mlp(jax.random.PRNGKey(1), rcfg, jnp.float32)
    jx, tx = _x(rng, 2, 5, rcfg.d_model)
    _close(layers.mlp(_port(p), tx, kind), ref_layers.mlp(p, jx, kind))


# ---------------------------------------------------------------------------
# prefill attention
# ---------------------------------------------------------------------------

# (arch, n_kv_heads, window): GQA, MQA and MHA; qk_norm (qwen3) and
# qkv_bias (qwen2.5) included
ATTN_CASES = [("h2o_danube_1_8b", 2, None), ("h2o_danube_1_8b", 2, 5),
              ("recurrentgemma_9b", 1, None), ("recurrentgemma_9b", 1, 5),
              ("gemma_7b", 4, 5), ("qwen3_14b", 2, None),
              ("qwen2_5_32b", 2, 5)]


@pytest.mark.parametrize("chunked", [False, True], ids=["oracle", "chunked"])
@pytest.mark.parametrize("arch,kv,window", ATTN_CASES)
def test_attention_matches_reference(arch, kv, window, chunked, rng):
    rcfg, cfg = _cfgs(arch, n_kv_heads=kv)
    p = ref_layers.init_attention(jax.random.PRNGKey(3), rcfg, jnp.float32)
    if rcfg.qkv_bias:   # the init's biases are zero: make them count
        for name in ("bq", "bk", "bv"):
            p[name] = jnp.asarray(rng.normal(size=p[name].shape), jnp.float32)
    jx, tx = _x(rng, 2, 16, rcfg.d_model)
    want, (wk, wv) = ref_layers.attention(p, jx, rcfg, window=window,
                                          chunked=chunked, return_kv=True)
    got, (k, v) = layers.attention(_port(p), tx, cfg, window=window,
                                   chunked=chunked, return_kv=True)
    _close(got, want)
    _close(k, wk)
    _close(v, wv)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_chunked_attention_matches_reference(causal, window, rng):
    jq, tq = _x(rng, 1, 4, 64, 16)
    jk, tk = _x(rng, 1, 2, 64, 16)
    jv, tv = _x(rng, 1, 2, 64, 16)
    kw = dict(causal=causal, window=window, scale=0.3, cq=16, ckv=32)
    _close(attention_xla.chunked_attention(tq, tk, tv, **kw),
           ref_attention_xla.chunked_attention(jq, jk, jv, **kw))


def test_chunked_attention_keeps_the_reference_chunk_check(rng):
    _, tq = _x(rng, 1, 2, 24, 8)
    with pytest.raises(ValueError, match="Sq % cq"):
        attention_xla.chunked_attention(tq, tq, tq, cq=16, ckv=16)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 9, 13])
@pytest.mark.parametrize("arch,kv,window,ring", [
    ("h2o_danube_1_8b", 2, None, False), ("h2o_danube_1_8b", 2, 4, False),
    ("h2o_danube_1_8b", 2, 4, True), ("recurrentgemma_9b", 1, 4, False),
    ("qwen3_14b", 4, None, False)])
def test_attention_decode_matches_reference(arch, kv, window, ring, pos, rng):
    rcfg, cfg = _cfgs(arch, n_kv_heads=kv, window=window, ring_cache=ring)
    p = ref_layers.init_attention(jax.random.PRNGKey(4), rcfg, jnp.float32)
    s_max = window if ring else 16
    shape = (2, kv, s_max, rcfg.head_dim_)
    jk, tk = _x(rng, *shape)
    jv, tv = _x(rng, *shape)
    jx, tx = _x(rng, 2, 1, rcfg.d_model)
    want, wcache = ref_layers.attention_decode(
        p, jx, {"k": jk, "v": jv}, jnp.int32(pos), rcfg, window=window,
        ring=ring)
    got, cache = layers.attention_decode(
        _port(p), tx, {"k": tk, "v": tv}, pos, cfg, window=window, ring=ring)
    _close(got, want)
    _close(cache["k"], wcache["k"])
    _close(cache["v"], wcache["v"])


def test_attention_decode_refuses_a_slot_past_the_cache(rng):
    _, cfg = _cfgs("h2o_danube_1_8b")
    p = layers.init_attention(torch.Generator().manual_seed(0), cfg,
                              torch.float32, "cpu")
    cache = layers.init_attention_cache(cfg, 1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="past the cache"):
        layers.attention_decode(p, torch.zeros(1, 1, cfg.d_model), cache, 4,
                                cfg)


# ---------------------------------------------------------------------------
# the recurrent block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 7, 40])
def test_recurrent_block_matches_reference(seq, rng):
    rcfg, cfg = _cfgs("recurrentgemma_9b")
    p = ref_recurrent.init_recurrent(jax.random.PRNGKey(5), rcfg, jnp.float32)
    p["conv_b"] = jnp.asarray(rng.normal(size=p["conv_b"].shape), jnp.float32)
    jx, tx = _x(rng, 2, seq, rcfg.d_model)
    want, wst = ref_recurrent.recurrent_block(p, jx, rcfg, return_state=True)
    got, st = recurrent.recurrent_block(_port(p), tx, cfg, return_state=True)
    _close(got, want)
    _close(st["conv"], wst["conv"])
    _close(st["h"], wst["h"])
    assert st["h"].dtype == torch.float32


def test_recurrent_block_decode_matches_reference(rng):
    rcfg, cfg = _cfgs("recurrentgemma_9b")
    p = ref_recurrent.init_recurrent(jax.random.PRNGKey(6), rcfg, jnp.float32)
    w = rcfg.lru_width_
    jconv, tconv = _x(rng, 2, rcfg.conv_width - 1, w)
    jh, th = _x(rng, 2, w)
    jstate, state = {"conv": jconv, "h": jh}, {"conv": tconv, "h": th}
    for step in range(3):
        jx, tx = _x(rng, 2, 1, rcfg.d_model)
        want, jstate = ref_recurrent.recurrent_block_decode(p, jx, jstate,
                                                            rcfg)
        got, state = recurrent.recurrent_block_decode(_port(p), tx, state, cfg)
        _close(got, want, msg=f"step {step}")
        _close(state["conv"], jstate["conv"], msg=f"step {step}")
        _close(state["h"], jstate["h"], msg=f"step {step}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_state_init_matches_reference(dtype):
    rcfg, cfg = _cfgs("recurrentgemma_9b")
    want = ref_recurrent.init_recurrent_state(rcfg, 3, jnp.dtype(dtype))
    got = recurrent.init_recurrent_state(cfg, 3, getattr(torch, dtype), "cpu")
    for name in ("conv", "h"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)


# ---------------------------------------------------------------------------
# configurations and parameter counts
# ---------------------------------------------------------------------------

def test_registry_answers_as_the_reference():
    assert configs.all_names() == ref_configs.all_names()
    for alias in ("recurrentgemma-9b", "qwen2.5-32b", "h2o-danube-1.8b",
                  "phi-3-vision-4.2b", "gemma_7b"):
        assert (dataclasses.asdict(configs.get(alias))
                == dataclasses.asdict(ref_configs.get(alias)))
    with pytest.raises(KeyError):
        configs.get("no-such-model")


@pytest.mark.parametrize("arch", ref_configs.all_names())
def test_config_and_param_count_match_at_full_size(arch):
    ref, cfg = ref_configs.get(arch), configs.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    # the module's weight matrices, built without allocating
    model = LanguageModel(cfg, device="meta")
    assert model.param_count() == ref.param_count()
    if arch == "recurrentgemma_9b":
        assert ref.param_count() == 9_395_666_944
    if arch == "granite_moe_3b_a800m":
        assert ref.param_count() == 3_298_693_632
        assert ref.active_param_count() == 882_774_528


def test_unknown_block_kind_raises():
    cfg = configs.get("recurrentgemma_9b").reduced()
    for make in (lambda: blocks.Block("conv", cfg, torch.float32, "cpu"),
                 lambda: blocks.init_block_state("conv", cfg, 1, 4,
                                                 torch.float32, "cpu"),
                 lambda: LanguageModel(dataclasses.replace(
                     cfg, block_pattern=("attn", "conv")), device="meta")):
        with pytest.raises(ValueError, match="unknown block kind 'conv'"):
            make()


def test_model_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LanguageModel(configs.get("gemma_7b").reduced())


# ---------------------------------------------------------------------------
# init and the weight carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_parameters_have_the_reference_paths_shapes_and_dtypes(arch):
    rcfg, cfg = _cfgs(arch, dtype="bfloat16")
    ref = weights.leaves(weights.port_tree(
        _np(RefModel(rcfg).init(jax.random.PRNGKey(0)))))
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    ours = dict(model.named_parameters())
    assert sorted(ours) == sorted(ref)
    for name, leaf in ref.items():
        assert tuple(ours[name].shape) == leaf.shape, name
        assert str(ours[name].dtype).split(".")[-1] == leaf.dtype.name, name
        assert bool(torch.isfinite(ours[name].float()).all()), name
    # the draws follow the reference's scales: the embedding at 0.02
    assert 0.015 < float(ours["emb"].float().std()) < 0.025


def test_init_is_deterministic_in_its_generator():
    cfg = configs.get("recurrentgemma_9b").reduced()

    def draw(seed):
        model = LanguageModel(cfg, device="cpu")
        return model.init(torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = draw(1), draw(1), draw(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["emb"], c["emb"])
    block = blocks.init_block(torch.Generator().manual_seed(1), "rglru", cfg,
                              torch.float32, "cpu")
    assert block.kind == "rglru" and block["rec"]["lam"].dtype == torch.float32
    assert all(bool(torch.isfinite(p).all()) for p in block.parameters())


def test_bfloat16_weights_carry_bit_for_bit():
    rcfg, cfg = _cfgs("recurrentgemma_9b", dtype="bfloat16")
    params = _np(RefModel(rcfg).init(jax.random.PRNGKey(7)))
    model = weights.carry_params(LanguageModel(cfg, device="cpu"), params)
    ours = dict(model.named_parameters())
    n_bf16 = 0
    for name, leaf in weights.leaves(weights.port_tree(params)).items():
        if leaf.dtype.name == "bfloat16":
            n_bf16 += 1
            assert np.array_equal(ours[name].view(torch.int16).numpy(),
                                  leaf.view(np.int16)), name
        else:
            assert np.array_equal(ours[name].numpy(), leaf), name
    assert n_bf16 > 10
    assert ours["groups.1.b2.attn.wq"].shape == params["groups"]["b2"][
        "attn"]["wq"].shape[1:]


def test_weight_carry_refuses_a_tree_that_does_not_fit():
    rcfg, cfg = _cfgs("gemma_7b")
    params = _np(RefModel(rcfg).init(jax.random.PRNGKey(0)))
    model = LanguageModel(cfg, device="cpu")
    params["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        weights.carry_params(model, params)
    del params["extra"]
    params["ln_f"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="ln_f"):
        weights.carry_params(model, params)


def test_carried_states_unstack_the_groups(rng):
    rcfg, cfg = _cfgs("recurrentgemma_9b")
    ref_states = _np(RefModel(rcfg).init_states(2, 8))
    port_states = weights.carry_states(ref_states, "cpu")
    assert len(port_states["groups"]) == cfg.n_groups
    zero = LanguageModel(cfg, device="cpu").init_states(2, 8)
    got = weights.leaves(port_states)
    want = weights.leaves(zero)
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == want[name].dtype, name


# ---------------------------------------------------------------------------
# sharding hooks and the serving steps for policy=None
# ---------------------------------------------------------------------------

def test_sharding_hooks_are_the_identity_without_a_policy():
    x = torch.ones(3)
    with constraints.use_policy(None) as pol:
        assert pol is None and constraints.current_policy() is None
        assert constraints.shard_act(x, "residual") is x
        tree = {"w": x}
        assert constraints.shard_param_slice(tree) is tree
    assert serve.state_spec(None, ("groups", "b0", "k"), (2, 3, 4)) == (
        None, None, None)


def test_a_sharding_policy_names_its_slice():
    """A sharding policy is accepted where Slice 3 refused it: the context
    holds it, ``state_spec`` gives the reference's layout, and the serving
    steps run under it with the values they have without one (a dense
    model: no layer reads the policy)."""
    from repro_torch.core.spmd import Mesh, P
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import make_policy

    big = make_policy(Mesh(np.full((16, 16), "meta", dtype=object),
                           ("data", "model")))
    with constraints.use_policy(big) as pol:
        assert pol is big and constraints.current_policy() is big
        x = torch.ones(3)
        assert constraints.shard_act(x, "residual") is x
    assert constraints.current_policy() is None
    # the reference's own rules (tests/test_dryrun_tools.py)
    assert serve.state_spec(big, ("groups", "b0", "k"),
                            (2, 128, 16, 32768, 256)) == P(
        None, ("data",), None, "model", None)
    assert serve.state_spec(big, ("h",), (128, 4096)) == P(("data",),
                                                           "model")
    model = LanguageModel(configs.get("gemma_7b").reduced(),
                          device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 512, (2, 8), generator=torch.Generator()
                           .manual_seed(1))
    policy = make_policy(make_host_mesh(2, 2, device="cpu"))
    want, states0 = serve.make_prefill_step(model, s_max=16)(tokens)
    got, states = serve.make_prefill_step(model, policy, s_max=16)(tokens)
    assert torch.equal(got, want)
    nxt = got.argmax(-1)
    assert torch.equal(serve.make_decode_step(model, policy)(states, nxt,
                                                             8)[0],
                       serve.make_decode_step(model)(states0, nxt, 8)[0])
