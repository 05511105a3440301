"""The port's sharding policy and the mixture of experts under it, against
the JAX package.

Spec arithmetic needs no devices (as ``tests/test_dryrun_tools.py``): the
reference's policy runs on a stand-in mesh with the production shapes
((16, 16) over ``("data", "model")`` and (2, 16, 16) over ``("pod",
"data", "model")``), the port's on a :class:`repro_torch.core.spmd.Mesh`
of ``meta`` devices of the same shapes.  For every parameter of all ten
configurations at full size (the port's model built on ``meta``, the
reference's shapes from ``jax.eval_shape``), with ``params_tp`` off and
on, ``tree_param_shardings`` gives the reference's spec of the layer (the
stacked spec without its group entry); every activation tag × rank, and
``state_spec`` for every decode-state leaf, equal the reference's.

The MoE layer under a policy (moonshot reduced on a (2, 4) ``("data",
"model")`` mesh of 8 CPU ranks): expert parallel, replicated, and expert
parallel with a capacity factor of 1.0 (shards drop tokens), each against
the reference's section ``moe`` of ``tests/_multidevice_reference.py`` (8
fake CPU devices): the layer's output and ``aux`` within 1e-5, the model's
loss and every gradient within 1e-4 of each leaf's largest value.  The
serving steps under a policy give the unsharded steps' values when no
token drops.
"""

import dataclasses
from unittest.mock import MagicMock

import jax
import numpy as np
import pytest
import torch
from _multidevice_reference import MOE_CASES, moe_inputs, run

import repro.sharding.policy as ref_policy_mod
from repro import configs as ref_configs
from repro.models import LanguageModel as RefModel
from repro.train.serve import state_spec as ref_state_spec
from repro_torch import configs
from repro_torch.core.spmd import Mesh, P
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LanguageModel, moe
from repro_torch.models.weights import leaves
from repro_torch.sharding import make_policy, use_policy
from repro_torch.train import make_decode_step, make_prefill_step
from repro_torch.train.serve import state_spec, tree_state_shardings

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pods2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TAGS = ("residual", "tokens", "kv_gathered", "seq_gathered", "ffn_hidden",
        "logits_vp", "logits_seq", "kv_cache", "recurrent_state",
        "expert_buffer", "unknown")


def _norm(spec, ndim) -> list:
    """A spec as a list of ``ndim`` entries, each ``None`` or a tuple of
    axis names (jax and the port may write one name bare or in a
    tuple)."""
    if spec is None:
        return None
    out = [None if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in tuple(spec)]
    return out + [None] * (ndim - len(out))


def _policies(mesh_name, **kw):
    shape, names = MESHES[mesh_name]
    fake = MagicMock()
    fake.shape = dict(zip(names, shape))
    fake.axis_names = names
    ours = Mesh(np.full(shape, "meta", dtype=object), names)
    return (ref_policy_mod.make_policy(fake, **kw), make_policy(ours, **kw))


@pytest.fixture
def spec_only(monkeypatch):
    """The reference's policy returns bare specs (its ``NamedSharding``
    needs real devices)."""
    monkeypatch.setattr(ref_policy_mod, "NamedSharding",
                        lambda mesh, spec: spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_make_policy_matches_the_reference(mesh_name):
    for kw in ({}, {"fsdp": False}, {"batch_sharded": False,
                                     "seq_sharded": False},
               {"params_tp": True}):
        ref, ours = _policies(mesh_name, **kw)
        for field in ("dp_axes", "model_axis", "fsdp_axes", "batch_sharded",
                      "seq_sharded", "params_tp", "min_shard_elems",
                      "fsdp_size", "model_size", "dp_size"):
            assert getattr(ours, field) == getattr(ref, field), field


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("sharded", [(True, True), (True, False),
                                     (False, True)])
def test_activation_specs_match_the_reference(mesh_name, sharded):
    ref, ours = _policies(mesh_name, batch_sharded=sharded[0],
                          seq_sharded=sharded[1])
    for tag in TAGS:
        for ndim in (2, 3, 4):
            assert _norm(ours.activation_spec(tag, ndim), ndim) == _norm(
                ref.activation_spec(tag, ndim), ndim), (tag, ndim)


_REF_SHAPES: dict = {}


def _ref_params(arch):
    if arch not in _REF_SHAPES:
        _REF_SHAPES[arch] = jax.eval_shape(
            RefModel(ref_configs.get(arch)).init, jax.random.PRNGKey(0))
    return _REF_SHAPES[arch]


@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_match_the_reference(arch, mesh_name, tp, spec_only):
    ref, ours = _policies(mesh_name, params_tp=tp)
    shapes = _ref_params(arch)
    want = _port_named(ref.tree_param_shardings(shapes), shapes)
    model = LanguageModel(configs.get(arch), device="meta")
    got = ours.tree_param_shardings(model)
    assert set(got) == set(want)
    groups = {n for n in got if "groups." in n}
    assert groups, arch
    for name, sh in got.items():
        assert sh.mesh is ours.mesh
        spec = want[name]
        ndim = len(dict(model.named_parameters())[name].shape)
        if name in groups:
            # the reference's stacked spec keeps its group dim whole
            full = _norm(spec, ndim + 1)
            assert full[0] is None, name
            spec = full[1:]
        assert _norm(sh.spec, ndim) == _norm(spec, ndim), name


def _port_named(specs, shapes) -> dict:
    """``{port parameter name: spec}`` of the reference's spec tree: a
    stacked leaf's spec under the name of each of its groups."""
    from jax.sharding import PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    n = {pre: next(iter(leaves(sub).values())).shape[0]
         for pre, sub in (("", shapes.get("groups")),
                          ("enc.", (shapes.get("enc") or {}).get("groups")))
         if sub}
    out = {}
    for path, spec in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", None)))
                for k in path]
        name = ".".join(keys)
        for pre in n:
            head = f"{pre}groups."
            if name.startswith(head):
                for g in range(n[pre]):
                    out[f"{head}{g}.{name[len(head):]}"] = spec
                break
        else:
            out[name] = spec
    return out


def test_stacked_shapes_decide_small_layers(spec_only):
    """A layer too small to shard alone shards where the reference
    shards its stack (``min_shard_elems`` counts the stacked elements)."""
    _, ours = _policies("pod16x16")
    small = {f"groups.{g}.b0.mlp.w_up": torch.empty(256, 64, device="meta")
             for g in range(8)}
    got = ours.tree_param_shardings(small)
    assert 256 * 64 < ours.min_shard_elems <= 8 * 256 * 64
    assert all(_norm(s.spec, 2) == [("data", "model"), None]
               for s in got.values())
    alone = ours.tree_param_shardings({"tail.0.mlp.w_up":
                                       torch.empty(256, 64, device="meta")})
    assert _norm(alone["tail.0.mlp.w_up"].spec, 2) == [None, None]


@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_state_specs_match_the_reference(arch, mesh_name, tp):
    ref, ours = _policies(mesh_name, params_tp=tp)
    cfg = configs.get(arch)
    enc = 64 if cfg.encoder_layers else 0
    rmodel = RefModel(ref_configs.get(arch))
    shapes = jax.eval_shape(lambda: rmodel.init_states(32, 256,
                                                       enc_len=enc))
    states = LanguageModel(cfg, device="meta").init_states(32, 256,
                                                           enc_len=enc)
    got = tree_state_shardings(ours, states)
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        ndim = len(leaf.shape)
        want = _norm(ref_state_spec(ref, keys, leaf.shape), ndim)
        if keys[0] == "groups":
            # the reference's stacked spec keeps its group dim whole
            assert want[0] is None, keys
            for g in range(len(states["groups"])):
                sh = _at(got["groups"][g], keys[1:])
                assert _norm(sh.spec, ndim - 1) == want[1:], keys
                seen += 1
        else:
            assert _norm(_at(got, keys).spec, ndim) == want, keys
            # the rule itself, on the port's leaf
            assert _norm(state_spec(ours, keys, _at(states, keys).shape),
                         ndim) == want, keys
            seen += 1
    assert seen


def _at(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the mixture of experts under a policy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run("moe", tmp_path_factory.mktemp("moe"))


def _moe_model(ref, case):
    mode, factor = MOE_CASES[case]
    cfg = dataclasses.replace(configs.get("moonshot_v1_16b_a3b").reduced(),
                              moe_mode=mode)
    if factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=factor)
    model = LanguageModel(cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(ref[f"params0/{name}"]))
    return model


def _policy():
    return make_policy(make_host_mesh(2, 4, device="cpu"))


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_layer_under_a_policy_matches_the_reference(case, ref):
    model = _moe_model(ref, case)
    cfg = model.cfg
    x = torch.from_numpy(moe_inputs(cfg.d_model, cfg.vocab_size)["x"])
    pol = _policy()
    with use_policy(pol):
        y, aux = moe.moe_layer(model["groups"][0]["b0"]["moe"], x, cfg)
    np.testing.assert_allclose(y.numpy(), ref[f"{case}/y"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux.numpy(), ref[f"{case}/aux"], rtol=1e-5,
                               atol=1e-5)
    # the shards' mean balance loss is not the whole batch's
    assert abs(float(aux) - float(ref[f"{case}/aux_unsharded"])) > 1e-4
    n = pol.model_size
    if cfg.moe_mode == "ep":
        # two all_to_all of n (n - 1) copies in each of the 2 data groups,
        # and the pmean of aux over all 8 ranks (a ring: 2 · 8 · 7)
        assert pol.mesh.copies == 2 * n * (n - 1) * 2 + 2 * 8 * 7
    else:
        assert pol.mesh.copies == 2 * 8 * 7


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_loss_and_gradient_under_a_policy_match_the_reference(case, ref):
    model = _moe_model(ref, case)
    cfg = model.cfg
    inp = moe_inputs(cfg.d_model, cfg.vocab_size)
    batch = {k: torch.from_numpy(inp[k]).long() for k in ("tokens",
                                                           "labels")}
    model.requires_grad_(True)
    with use_policy(_policy()):
        loss, _ = model.loss(batch, remat=False)
        loss.backward()
    loss = loss.detach()
    np.testing.assert_allclose(loss.item(), float(ref[f"{case}/loss"]),
                               rtol=1e-5, atol=1e-5)
    experts = 0
    for name, p in model.named_parameters():
        want = ref[f"{case}/grad/{name}"]
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
        if ".experts." in name:
            experts += 1
            assert float(p.grad.abs().max()) > 0, name
    assert experts == 3 * cfg.n_layers


def test_drops_differ_from_the_unsharded_layer(ref):
    """At capacity factor 1.0 a shard's capacity comes from its own 16
    tokens: the output is the reference's under its policy, not the
    unsharded layer's."""
    model = _moe_model(ref, "ep-drops")
    cfg = model.cfg
    x = torch.from_numpy(moe_inputs(cfg.d_model, cfg.vocab_size)["x"])
    y0, _ = moe.moe_layer(model["groups"][0]["b0"]["moe"], x, cfg)
    assert float((y0 - torch.from_numpy(ref["ep-drops/y"])).abs().max()) > 1e-3


def test_serving_steps_under_a_policy_give_the_unsharded_values(ref):
    model = _moe_model(ref, "ep")
    cfg = model.cfg
    tokens = torch.from_numpy(moe_inputs(cfg.d_model, cfg.vocab_size)[
        "tokens"]).long()
    logits0, states0 = make_prefill_step(model, s_max=72)(tokens)
    pol = _policy()
    logits, states = make_prefill_step(model, pol, s_max=72)(tokens)
    assert pol.mesh.copies > 0
    torch.testing.assert_close(logits, logits0, rtol=1e-5, atol=1e-5)
    dec = make_policy(make_host_mesh(2, 4, device="cpu"), seq_sharded=False)
    nxt = logits.argmax(-1)
    got, _ = make_decode_step(model, dec)(states, nxt, 64)
    want, _ = make_decode_step(model)(states0, nxt, 64)
    assert dec.mesh.copies > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
