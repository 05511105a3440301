"""Placement at rest under a sharding policy, against the JAX package.

The reference's half runs once per configuration in a subprocess
(``tests/_fsdp_reference.py``: 8 fake CPU devices, the two side by side);
the port's runs the same inputs on 8 CPU ranks that share the host, on a
(4, 2) ``("data", "model")`` mesh under ``make_policy`` with
``min_shard_elems`` 1024 (at the reduced widths every leaf is under the
default 65,536 elements, which would replicate them all):

* ``make_train_step(model, opt, policy)`` on gemma reduced (dense) and
  moonshot reduced (``moe_mode="ep"``, the experts on ``"model"``) for 3
  AdamW steps against the reference's ``make_train_step(...).jit_with``:
  losses within 1e-5, parameters within 2e-4 (as
  ``tests/test_torch_dp.py``), gemma with ``grad_reduce_dtype="bfloat16"``
  too; every parameter, master and moment a per-rank shard whose shape
  and index are the reference's ``devices_indices_map`` for the same rank
  (a pattern group's leaf without its group entry); each step's copies and
  bytes the closed form of ``launch/meter_gradsync.py``; the dense step
  bit for bit the policy-free step's, the per-rank resident bytes the
  closed form;
* the prefill and decode steps under ``params_tp=True`` against the
  reference's policy steps (f32, 1e-4), the weights placed as the
  reference's, each pass's copies the closed form; the expert-parallel
  prefill with its experts at rest, which splits no expert weight, against
  the split-per-call path (bit for bit, the splits fewer by the closed
  form);
* checkpoints: the reference restores the port's FSDP checkpoint and the
  port the reference's (onto the 8 ranks, 2 ranks and no policy), bit for
  bit; one saved on 4 ranks restores onto 2 and onto no policy; a run
  resumed on the 8 ranks, and the trainer's under ``--fake-devices``,
  are the uninterrupted run bit for bit;
* ``make_host_mesh()`` with no argument against the reference's.
"""

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from _fsdp_reference import (BATCH, DECODE, DENSE, MESH, MIN_SHARD, PROMPT,
                             SEQ, batches, prompt, run)

from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.spmd import Sharded, assemble, block_ranks
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.meter_gradsync import (fsdp_expected_copies,
                                              moe_expected_splits,
                                              serving_expected_copies)
from repro_torch.models import LanguageModel
from repro_torch.optim import AdamW
from repro_torch.sharding import make_policy, use_policy
from repro_torch.sharding.placement import place_model, unplace
from repro_torch.train import make_decode_step, make_prefill_step
from repro_torch.train.step import make_train_step

ARCHS = ("gemma_7b", "moonshot_v1_16b_a3b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' ops are tiny: one intra-op thread a worker
    keeps them from contending with the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _policy(*mesh, **kw):
    return dataclasses.replace(
        make_policy(make_host_mesh(*mesh, device="cpu"), **kw),
        min_shard_elems=MIN_SHARD)


def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _port_checkpoint(root, arch) -> dict:
    """The port's FSDP checkpoint of ``arch`` reduced (its own seeded
    weights placed on the (4, 2) mesh), written before the reference
    starts, with each leaf's spec in ``specs.json``; returns the global
    values and the placement."""
    cfg = configs.get(arch).reduced()
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(7))
    placement = place_model(model, _policy(*MESH))
    path = str(root / f"port_{arch}")
    CheckpointManager(path, async_save=False).save(0, placement.params)
    with open(os.path.join(path, "specs.json"), "w") as f:
        json.dump({n: {"shape": list(v.global_shape),
                       "spec": _spec_json(v.spec)}
                   for n, v in placement.params.items()}, f)
    return {"values": placement.assembled(), "placement": placement}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp")
    port = {arch: _port_checkpoint(root, arch) for arch in ARCHS}
    with ThreadPoolExecutor(len(ARCHS)) as pool:
        jobs = {arch: pool.submit(run, arch, root, root) for arch in ARCHS}
        out = {arch: job.result() for arch, job in jobs.items()}
    out["root"] = root
    out["port"] = port
    return out


def _model(ref, arch):
    cfg = configs.get(arch).reduced()
    model = LanguageModel(cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(ref[arch][f"params0/{name}"]))
    return model


def _batches(cfg):
    return [{k: torch.from_numpy(v).long() for k, v in b.items()}
            for b in batches(cfg.vocab_size)]


def _train(model, policy, *, grad_reduce_dtype=None, steps=None):
    opt = AdamW(learning_rate=1e-3)
    step = make_train_step(model, opt, policy,
                           grad_reduce_dtype=grad_reduce_dtype)
    state = opt.init(model)
    mesh = policy.mesh if policy is not None else None
    losses, counts = [], []
    for b in _batches(model.cfg)[:steps]:
        c0 = (mesh.copies, mesh.bytes_copied) if mesh else (0, 0)
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if mesh:
            counts.append((mesh.copies - c0[0], mesh.bytes_copied - c0[1]))
    return {"state": state, "losses": losses, "counts": counts,
            "model": model}


@pytest.fixture(scope="module")
def runs(ref):
    out = {}
    for arch in ARCHS:
        out[arch] = _train(_model(ref, arch), _policy(*MESH))
    out["bf16"] = _train(_model(ref, "gemma_7b"), _policy(*MESH),
                         grad_reduce_dtype="bfloat16")
    return out


def _close(got, want, tol, msg):
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [*ARCHS, "bf16"])
def test_policy_step_matches_the_references(name, ref, runs):
    arch, variant = ("gemma_7b", "bf16") if name == "bf16" else (name, "f32")
    r = runs[name]
    _close(r["losses"], ref[arch][f"{variant}/losses"], 1e-5, "losses")
    for n, v in r["model"].placement.assembled().items():
        _close(v.numpy(), ref[arch][f"{variant}/{n}"], 2e-4, n)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tree", ["params", "master", "m", "v"])
def test_shards_are_placed_as_the_references(arch, tree, ref, runs):
    r = runs[arch]
    placement = r["model"].placement
    values = (placement.params if tree == "params"
              else getattr(r["state"], tree))
    assert set(values) == set(placement.params)
    for n, v in values.items():
        assert isinstance(v, Sharded) and v.spec == placement.params[n].spec
        want = ref[arch][f"index/{tree}/{n}"]
        sharding = placement.shardings[n]
        for rank, t in enumerate(v.shards):
            index = sharding.index(v.global_shape, rank)
            got = [(s.indices(d)[0], s.indices(d)[1])
                   for s, d in zip(index, v.global_shape)]
            assert got == [tuple(x) for x in want[rank]], (n, rank)
            assert tuple(t.shape) == tuple(int(b - a) for a, b in
                                           want[rank]), (n, rank)
            assert t.dtype == (torch.float32 if tree != "params"
                               else placement.params[n].dtype)


def test_some_leaves_are_sharded_and_some_replicated(runs):
    """The placement at this width exercises both kinds, and the experts
    rest on the model axis."""
    placement = runs["moonshot_v1_16b_a3b"]["model"].placement
    blocks = {n: len(block_ranks(placement.mesh, v.spec))
              for n, v in placement.params.items()}
    assert {1, 8} <= set(blocks.values())
    experts = [n for n in blocks if ".experts." in n]
    assert experts and all(placement.params[n].spec[0] == "model"
                           for n in experts)


@pytest.mark.parametrize("name", [*ARCHS, "bf16"])
def test_copies_a_step_are_the_closed_form(name, runs):
    r = runs[name]
    want = fsdp_expected_copies(
        r["model"], _policy(*MESH), tokens=BATCH * SEQ,
        grad_itemsize=2 if name == "bf16" else None,
        shardings=r["model"].placement.shardings)
    assert r["counts"] == [want] * len(r["counts"])


@pytest.mark.parametrize("grad_reduce_dtype", [None, "bfloat16"])
def test_dense_policy_step_is_the_policy_free_step_bit_for_bit(
        grad_reduce_dtype, ref):
    """Each leaf's norm is taken on its whole gradient, the scatter is a
    split and AdamW is element-wise: the shards hold the policy-free
    step's bits."""
    free = _train(_model(ref, "gemma_7b"), None,
                  grad_reduce_dtype=grad_reduce_dtype, steps=2)
    placed = _train(_model(ref, "gemma_7b"), _policy(*MESH),
                    grad_reduce_dtype=grad_reduce_dtype, steps=2)
    assert free["losses"] == placed["losses"]
    got = placed["model"].placement.params
    for n, p in free["model"].named_parameters():
        assert torch.equal(p, assemble(got[n])), n
    for tree in ("master", "m", "v"):
        want, have = getattr(free["state"], tree), getattr(placed["state"],
                                                           tree)
        for n in want:
            assert torch.equal(want[n], assemble(have[n])), (tree, n)


def test_resident_bytes_a_rank_are_the_closed_form(runs):
    """A rank holds 1 / 8 of every sharded leaf and the whole of every
    replicated one; the whole storage is gone (the module keeps ``meta``
    placeholders)."""
    model = runs["gemma_7b"]["model"]
    placement = model.placement
    want = 0
    for n, v in placement.params.items():
        nbytes = v.shards[0].element_size() * int(np.prod(v.global_shape))
        want += nbytes // len(block_ranks(placement.mesh, v.spec))
    assert placement.rank_bytes() == [want] * placement.mesh.size
    assert all(p.device.type == "meta" for p in model.parameters())
    state = runs["gemma_7b"]["state"]
    for tree in (state.master, state.m, state.v):
        assert [sum(v.shards[r].numel() * 4 for v in tree.values())
                for r in range(8)] == [want] * 8


def test_a_placed_parameter_outside_a_gather_is_no_tensor_to_compute_on(
        runs):
    model = runs["gemma_7b"]["model"]
    with pytest.raises((NotImplementedError, RuntimeError)):
        torch.equal(model["emb"], model["emb"])
    x = torch.zeros(1, 3, dtype=torch.long)
    assert torch.isfinite(model.logits(model(x))).all()


def test_eval_step_runs_on_shards(ref):
    from repro_torch.train.step import make_eval_step

    model = _model(ref, "gemma_7b")
    batch = _batches(model.cfg)[0]
    want = make_eval_step(model)(batch)["loss"]
    policy = _policy(*MESH)
    place_model(model, policy)
    c0 = policy.mesh.copies
    got = make_eval_step(model, policy)(batch)["loss"]
    assert float(got) == float(want)
    assert policy.mesh.copies - c0 == serving_expected_copies(
        model, policy, tokens=BATCH * SEQ, decode=False)[0]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_tp_prefill_and_decode_match_the_references(ref):
    arch = DENSE[0]
    model = _model(ref, arch)
    tp = _policy(*MESH, params_tp=True, seq_sharded=False)
    prefill = make_prefill_step(model, tp, s_max=PROMPT + DECODE)
    placement = model.placement
    for n, v in placement.params.items():
        want = ref[arch][f"index/tp/{n}"]
        for rank in range(8):
            index = placement.shardings[n].index(v.global_shape, rank)
            assert [s.indices(d)[:2] for s, d in zip(index, v.global_shape)
                    ] == [tuple(x) for x in want[rank]], (n, rank)
    assert any(v.spec == (None, "model") for v in placement.params.values())
    mesh = tp.mesh
    tokens = torch.from_numpy(prompt(model.cfg.vocab_size)).long()
    c0 = mesh.copies
    logits, states = prefill(tokens)
    assert mesh.copies - c0 == serving_expected_copies(
        model, tp, tokens=tokens.numel(), decode=False)[0]
    _close(logits.numpy(), ref[arch]["tp/prefill"], 1e-4, "prefill")
    decode = make_decode_step(model, tp)
    token = logits[:, -1].argmax(-1, keepdim=True)
    for i in range(DECODE):
        c0, b0 = mesh.copies, mesh.bytes_copied
        logits, states = decode(states, token, PROMPT + i)
        assert (mesh.copies - c0, mesh.bytes_copied - b0) == \
            serving_expected_copies(model, tp, tokens=2, decode=True)
        _close(logits.numpy(), ref[arch][f"tp/decode{i}"], 1e-4,
               f"decode {i}")
        token = logits[:, -1].argmax(-1, keepdim=True)


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_ep_prefill_with_experts_at_rest_splits_no_expert_weight(mesh, ref):
    """The split-per-call path (whole weights under ``use_policy``) cuts
    the expert weights every call; at rest they pass through (a gather
    over ``"data"`` first where the at-rest spec names it): the splits
    fall by the expert weights' blocks, the logits are the same bits."""
    arch = "moonshot_v1_16b_a3b"
    model = _model(ref, arch)
    policy = make_policy(make_host_mesh(*mesh, device="cpu"))
    tokens = torch.from_numpy(prompt(model.cfg.vocab_size)).long()
    m = policy.mesh
    with use_policy(policy):
        want, _ = model.prefill(tokens, s_max=PROMPT + DECODE)
    before = (m.splits, m.bytes_split)
    kw = dict(batch=tokens.shape[0], seq=tokens.shape[1])
    assert before == moe_expected_splits(model, policy, at_rest=False, **kw)
    prefill = make_prefill_step(model, policy, s_max=PROMPT + DECODE)
    s0, sb0 = m.splits, m.bytes_split
    c0, b0 = m.copies, m.bytes_copied
    got, _ = prefill(tokens)
    assert torch.equal(got, want)
    at_rest = moe_expected_splits(model, policy, at_rest=True, **kw)
    assert (m.splits - s0, m.bytes_split - sb0) == at_rest
    assert before[0] - at_rest[0] == 3 * m.size * model.cfg.n_layers
    assert (m.copies - c0, m.bytes_copied - b0) == serving_expected_copies(
        model, policy, tokens=tokens.numel(), decode=False)


def test_ep_gradient_with_experts_at_rest_is_the_split_paths(ref):
    """On (1, 4) the experts rest with the in-spec's blocks: the layer takes
    the shards themselves, and the loss and every gradient (assembled
    from the shards) are the split-per-call path's bits; a step's copies
    are the closed form."""
    arch = "moonshot_v1_16b_a3b"
    policy = _policy(1, 4)
    batch = _batches(configs.get(arch).reduced())[0]
    free = _model(ref, arch)
    free.requires_grad_(True)
    with use_policy(policy):
        want, _ = free.loss(batch)
    want.backward()
    model = _model(ref, arch)
    opt = AdamW(learning_rate=1e-3)
    step = make_train_step(model, opt, policy)
    placement = model.placement
    experts = [n for n in placement.params if ".experts." in n]
    assert experts and all(placement.params[n].spec[0] == "model"
                           for n in experts)
    with use_policy(policy):
        got, _ = model.loss(batch)
    got.backward()
    assert float(got.detach()) == float(want.detach())
    for n, p in free.named_parameters():
        v = placement.params[n]
        grad = assemble(Sharded(v.mesh, [t.grad for t in v.shards], v.spec))
        assert torch.equal(grad, p.grad), n
    placement.zero_grad()
    c0 = policy.mesh.copies
    step(opt.init(model), batch)
    assert policy.mesh.copies - c0 == fsdp_expected_copies(
        model, policy, tokens=BATCH * SEQ, shardings=placement.shardings)[0]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_the_reference_restores_the_ports_fsdp_checkpoint(ref):
    for arch in ARCHS:
        port = ref["port"][arch]
        placement = port["placement"]
        for n, v in port["values"].items():
            assert np.array_equal(ref[arch][f"restored/{n}"], v.numpy()), n
            sharding = placement.shardings[n]
            for rank in range(8):
                index = sharding.index(v.shape, rank)
                assert [s.indices(d)[:2] for s, d in zip(index, v.shape)] \
                    == [tuple(x) for x in
                        ref[arch][f"restored.index/{n}"][rank]], (n, rank)


@pytest.mark.parametrize("target", ["4x2", "2", "none"])
def test_the_port_restores_the_references_fsdp_checkpoint(target, ref):
    """The reference's trained parameters, saved placed, restore onto the
    (4, 2) placement, onto 2 ranks and onto no policy, bit for bit."""
    for arch in ARCHS:
        model = _model(ref, arch)
        manager = CheckpointManager(str(ref["root"] / f"ref_{arch}"))
        if target == "none":
            like = {n: p.detach() for n, p in model.named_parameters()}
            got, extra = manager.restore(like)
        else:
            policy = (_policy(*MESH) if target == "4x2"
                      else _policy(2))
            placement = place_model(model, policy)
            got, extra = manager.restore(placement.params,
                                         shardings=placement.shardings)
            for n, v in got.items():
                assert isinstance(v, Sharded)
                assert v.sharding == placement.shardings[n], n
            placement.load(got)
            got = placement.assembled()
        assert extra == {"arch": arch}
        for n, t in got.items():
            assert np.array_equal(t.numpy(), ref[arch][f"f32/{n}"]), n


def test_a_run_resumed_on_the_ranks_is_the_uninterrupted_run(ref, tmp_path):
    arch = "moonshot_v1_16b_a3b"
    whole = _train(_model(ref, arch), _policy(*MESH))
    opt = AdamW(learning_rate=1e-3)
    data = _batches(configs.get(arch).reduced())
    model = _model(ref, arch)
    step = make_train_step(model, opt, _policy(*MESH))
    state, _ = step(opt.init(model), data[0])
    manager = CheckpointManager(str(tmp_path), async_save=False)
    manager.save(0, (model.placement.params, state))
    del model, step, state
    model = _model(ref, arch)
    policy = _policy(*MESH)
    placement = place_model(model, policy)
    like = (placement.params, opt.init(model))
    (params, state), _ = manager.restore(like, shardings=(
        placement.shardings, type(like[1])(placement.shardings,
                                           placement.shardings,
                                           placement.shardings,
                                           policy.replicated())))
    assert state.count == 1
    placement.load(params)
    step = make_train_step(model, opt, policy)
    losses = []
    for b in data[1:]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert losses == whole["losses"][1:]
    for n, v in placement.params.items():
        assert torch.equal(assemble(v),
                           assemble(whole["model"].placement.params[n])), n


def test_the_trainer_resumes_an_fsdp_run_bit_for_bit(tmp_path, monkeypatch):
    """``launch/train.py --fake-devices 4 --mesh-model 2`` (the policy's
    step, its state at rest): a run crashed after its step-1 checkpoint
    and resumed ends with the uninterrupted run's metrics."""
    import contextlib
    import io

    from repro_torch.launch import train as launch_train

    base = ["--arch", "gemma_7b", "--reduced", "--steps", "4", "--batch",
            "4", "--seq", "32", "--lr", "1e-3", "--ckpt-every", "2",
            "--fake-devices", "4", "--mesh-model", "2", "--cpu"]
    ck, m1, m2 = (str(tmp_path / n) for n in ("ck", "m1.json", "m2.json"))

    def crash(code):
        raise SystemExit(code)

    monkeypatch.setattr(os, "_exit", crash)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        with pytest.raises(SystemExit) as exc:
            launch_train.main([*base, "--ckpt-dir", ck, "--crash-at-step",
                               "3"])
        assert exc.value.code == 42
        assert launch_train.main([*base, "--metrics-out", m1]) == 0
        assert launch_train.main([*base, "--ckpt-dir", ck, "--metrics-out",
                                  m2]) == 0
    assert "[train] resumed from step 1" in buf.getvalue()
    with open(m1) as f1, open(m2) as f2:
        assert json.load(f2)["final"] == json.load(f1)["final"]


@pytest.mark.parametrize("target", ["2", "none"])
def test_a_checkpoint_saved_on_4_ranks_restores_elsewhere(target, ref,
                                                          tmp_path):
    """Parameters and AdamW state trained at rest on (2, 2) ranks, saved
    as global arrays, restore onto 2 ranks and onto no policy bit for
    bit."""
    arch = "gemma_7b"
    opt = AdamW(learning_rate=1e-3)
    model = _model(ref, arch)
    step = make_train_step(model, opt, _policy(2, 2))
    state, _ = step(opt.init(model), _batches(model.cfg)[0])
    want = (model.placement.assembled(),
            [{n: assemble(v) for n, v in tree.items()} for tree in state[:3]])
    manager = CheckpointManager(str(tmp_path), async_save=False)
    manager.save(0, (model.placement.params, state))
    other = _model(ref, arch)
    if target == "none":
        like = ({n: p.detach() for n, p in other.named_parameters()},
                opt.init(other))
        (params, got), _ = manager.restore(like)
    else:
        policy = _policy(2)
        placement = place_model(other, policy)
        sh = placement.shardings
        like = (placement.params, opt.init(other))
        (params, got), _ = manager.restore(
            like, shardings=(sh, type(like[1])(sh, sh, sh,
                                               policy.replicated())))
        assert all(v.mesh is policy.mesh and v.sharding == sh[n]
                   for n, v in params.items())
        placement.load(params)
        params = placement.assembled()
    assert got.count == 1
    for n, t in want[0].items():
        assert torch.equal(assemble(params[n]), t), n
    for tree, have in zip(want[1], got[:3]):
        for n, t in tree.items():
            assert torch.equal(assemble(have[n]), t), n


def test_unplace_gives_the_whole_parameters_back(runs, ref):
    model = _model(ref, "gemma_7b")
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    place_model(model, _policy(*MESH))
    unplace(model)
    assert model.placement is None
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n]), n


@pytest.mark.parametrize("build", ["train", "prefill", "decode"])
def test_a_model_is_placed_again_only_by_the_caller(build, ref):
    """A step under a policy that would place the model otherwise raises
    when it is built, the model left as it rests; after the caller's
    ``unplace`` and the other placement, a step built on the first one
    raises when it is called."""
    model = _model(ref, DENSE[0])
    fsdp = _policy(*MESH)
    tp = _policy(*MESH, params_tp=True, seq_sharded=False)
    opt = AdamW(learning_rate=1e-3)
    builders = {
        "train": lambda pol: make_train_step(model, opt, pol),
        "prefill": lambda pol: make_prefill_step(model, pol, s_max=8),
        "decode": lambda pol: make_decode_step(model, pol)}
    old = builders[build](fsdp)
    placement = model.placement
    with pytest.raises(ValueError, match="unplace"):
        builders[build](tp)
    assert model.placement is placement
    unplace(model)
    builders[build](tp)
    assert model.placement is not placement
    assert model.placement.rests_by(tp.tree_param_shardings(model))
    args = {"train": (None, None), "prefill": (None,),
            "decode": (None, None, 0)}[build]
    with pytest.raises(RuntimeError, match="build the step again"):
        old(*args)


def test_a_policy_on_a_mesh_built_alike_runs_on_the_placement(ref):
    """Two meshes built alike (the same devices, the same axes) are one
    layout: the second policy's step runs on the shards the first placed,
    with the same bits, and nothing is placed again."""
    model = _model(ref, DENSE[0])
    tokens = torch.from_numpy(prompt(model.cfg.vocab_size)).long()
    first, second = _policy(*MESH), _policy(*MESH)
    assert first.mesh is not second.mesh
    want, _ = make_prefill_step(model, first, s_max=PROMPT)(tokens)
    placement = model.placement
    s0 = first.mesh.splits + second.mesh.splits
    got, _ = make_prefill_step(model, second, s_max=PROMPT)(tokens)
    assert model.placement is placement
    assert first.mesh.splits + second.mesh.splits == s0
    assert torch.equal(got, want)


def test_the_expert_parallel_rule_is_the_layers(ref):
    """``moe.uses_ep`` decides both the layer's path and the closed
    forms': expert parallelism needs ``moe_mode="ep"`` and the experts
    split evenly over a model axis of more than one rank."""
    from repro_torch.models.moe import uses_ep

    cfg = configs.get("moonshot_v1_16b_a3b").reduced()
    assert uses_ep(cfg, _policy(*MESH))
    assert not uses_ep(cfg, None)
    assert not uses_ep(cfg, _policy(8))
    assert not uses_ep(dataclasses.replace(cfg, moe_mode="replicated"),
                       _policy(*MESH))
    assert not uses_ep(dataclasses.replace(cfg, n_experts=3), _policy(*MESH))


# ---------------------------------------------------------------------------
# the host mesh
# ---------------------------------------------------------------------------

def test_make_host_mesh_defaults_as_the_references():
    from repro.launch.mesh import make_host_mesh as ref_make_host_mesh

    want = ref_make_host_mesh()
    got = make_host_mesh(device="cpu")
    assert tuple(got.shape.values()) == tuple(want.devices.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.rank_devices == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        make_host_mesh(n_model=2, device="cpu")
    assert make_host_mesh(4, device="cpu").size == 4
