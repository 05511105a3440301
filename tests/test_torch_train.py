"""The port's training half against the JAX package's, end to end.

Parameters drawn by the reference's ``LanguageModel.init`` are carried
into the port (``repro_torch.models.weights.carry_params``); tokens and
labels come from NumPy with a seed (some labels -1, masked).  For each
ported reduced configuration ``model.loss`` and every parameter's
gradient (autograd through the port's two kernel entry points, whose
backwards run their plain versions here) agree with
``jax.value_and_grad`` of the reference's ``loss`` in float32: the loss
within 1e-5, each gradient within 1e-4 of its leaf's largest |gradient|
(float32 sums in another order through ~10 layers of products).  Then:
``remat`` changes no bit; the kernels' autograd Functions are on the graph
and their backwards run (a cut graph fails here, where the values alone
would not show it on the CPU); a 5-step ``make_train_step`` loss curve
follows the reference's within 1e-3 (the parameters are not compared
element by element after several steps: Adam's first step moves a
near-zero gradient by lr times its sign); the data pipeline gives the
reference's batches bit for bit; ``launch/train.py`` runs, on one device
and on a rank mesh (``--fake-devices``), and the multi-device steps run
where Slice 3 refused them.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import SyntheticLMDataset as RefDataset
from repro.data import make_batch_specs as ref_batch_specs
from repro.models import LanguageModel as RefModel
from repro.optim import AdamW as RefAdamW
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.train import step as ref_step
from repro_torch import configs
from repro_torch.data import SyntheticLMDataset, make_batch_specs
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.kernels.linear_scan import ref as ls_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import LanguageModel, weights
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import (make_eval_step, make_manual_dp_train_step,
                               make_train_step)

PORTED = ("recurrentgemma_9b", "gemma_7b", "h2o_danube_1_8b", "qwen2_5_32b",
          "qwen3_14b")
B, S = 2, 20                # S past the reduced window (16)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
CURVE_TOL = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carried(arch, seed=2, **overrides):
    rcfg = ref_configs.get(arch).reduced(**overrides)
    ref = RefModel(rcfg)
    params = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    model = weights.carry_params(
        LanguageModel(configs.get(arch).reduced(**overrides), device="cpu"),
        _np(params))
    return rcfg, ref, params, model


def _batch(rng, vocab, b=B, s=S):
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, ::7] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_loss_and_grads(model, batch, remat=True):
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    loss, metrics = model.loss(_port_batch(batch), remat=remat)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("arch", PORTED)
def test_loss_and_every_gradient_match_the_reference(arch, rng):
    rcfg, ref, params, model = _carried(arch)
    batch = _batch(rng, rcfg.vocab_size)

    def loss_fn(p):
        return ref.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                        remat=False)

    (want_loss, want_metrics), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    loss, metrics, grads = _port_loss_and_grads(model, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_TOL)
    assert float(metrics["nll"]) == pytest.approx(float(want_metrics["nll"]),
                                                  rel=LOSS_TOL)
    assert float(metrics["aux"]) == float(want_metrics["aux"]) == 0.0
    assert int(metrics["tokens"]) == int(want_metrics["tokens"]) == int(
        (batch["labels"] >= 0).sum())
    theirs = weights.leaves(weights.port_tree(_np(want_grads)))
    assert set(theirs) == set(grads)
    for name, want in theirs.items():
        want = np.asarray(want, np.float32)
        got = grads[name].numpy()
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TOL * scale, (
            f"{arch} {name}: max error {err:.3e}, largest |grad| {scale:.3e}")


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "qwen3_14b"])
def test_remat_changes_no_bit(arch, rng):
    cfg = configs.get(arch).reduced()
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(4))
    batch = _batch(rng, cfg.vocab_size)
    loss_r, _, grads_r = _port_loss_and_grads(model, batch, remat=True)
    loss_n, _, grads_n = _port_loss_and_grads(model, batch, remat=False)
    assert torch.equal(loss_r, loss_n)
    for name in grads_r:
        assert torch.equal(grads_r[name], grads_n[name]), name


def _graph_nodes(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return names


def test_the_graph_runs_through_both_kernels_backwards(rng, monkeypatch):
    """A reduced RecurrentGemma group (rglru, rglru, local_attn): the
    output's autograd graph holds the port's attention and scan Functions,
    and the backward runs their backwards (counted on the plain versions
    they take on the CPU), once per layer even with remat.  Every parameter
    gets a non-zero gradient: a kernel entry point that cut the graph
    (an output without a ``grad_fn``) would leave the parameters below it
    without one."""
    cfg = configs.get("recurrentgemma_9b").reduced()
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(5))
    model.requires_grad_(True)
    calls = {"attention": 0, "scan": 0, "attention_fwd": 0, "scan_fwd": 0}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(fa_ref, "attention_grad",
                        counting("attention", fa_ref.attention_grad))
    monkeypatch.setattr(ls_ref, "linear_scan_grad",
                        counting("scan", ls_ref.linear_scan_grad))
    monkeypatch.setattr(fa_ref, "attention",
                        counting("attention_fwd", fa_ref.attention))
    # a forward that records a gradient hands the backward its log-sum-exp
    monkeypatch.setattr(fa_ref, "attention_lse",
                        counting("attention_fwd", fa_ref.attention_lse))
    monkeypatch.setattr(ls_ref, "linear_scan",
                        counting("scan_fwd", ls_ref.linear_scan))
    batch = _port_batch(_batch(rng, cfg.vocab_size))
    hidden = model(batch["tokens"], remat=False)
    names = _graph_nodes(hidden)
    assert "_AttentionBackward" in names and "_ScanBackward" in names
    kinds = [kind for _, kind in model.layers()]
    n_attn, n_scan = kinds.count("local_attn"), kinds.count("rglru")
    assert names.count("_AttentionBackward") == n_attn
    assert names.count("_ScanBackward") == n_scan
    calls.update(attention_fwd=0, scan_fwd=0)
    loss, _ = model.loss(batch, remat=True)
    loss.backward()
    # remat runs each group's forward twice; each backward once
    assert calls["attention"] == n_attn and calls["scan"] == n_scan
    # the scan's backward is one more (plain) scan per layer
    assert calls["attention_fwd"] == 2 * n_attn
    assert calls["scan_fwd"] == 3 * n_scan
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
    assert fa_ops.flash_attention.launches == 0
    assert ls_ops.linear_scan.launches == 0


def _ref_curve(rcfg, ref, params, batches, lr):
    opt = RefAdamW(learning_rate=ref_warmup_cosine(*lr))
    state = opt.init(params)
    step = ref_step.make_train_step(ref, opt)
    out = []
    for batch in batches:
        params, state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append({k: float(v) for k, v in metrics.items()})
    return out


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "h2o_danube_1_8b"])
def test_five_train_steps_follow_the_references_loss_curve(arch):
    rcfg, ref, params, model = _carried(arch, seed=3)
    data = RefDataset(rcfg.vocab_size, S, B, seed=1)
    batches = [{k: np.asarray(v) for k, v in data.batch_at(i).items()}
               for i in range(5)]
    lr = (3e-3, 2, 5)
    want = _ref_curve(rcfg, ref, params, batches, lr)
    opt = AdamW(learning_rate=warmup_cosine(*lr))
    state = opt.init(model)
    step = make_train_step(model, opt)
    got = []
    for batch in batches:
        state, metrics = step(state, _port_batch(batch))
        got.append({k: float(v) for k, v in metrics.items()})
    assert state.count == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"loss", "nll", "aux", "tokens",
                                    "grad_norm", "lr"}
        for key in ("loss", "nll", "grad_norm", "lr"):
            assert g[key] == pytest.approx(w[key], rel=CURVE_TOL), (i, key)
        assert g["tokens"] == w["tokens"]
    assert got[-1]["loss"] < got[0]["loss"]


def test_gemma_7b_step_at_head_dim_256_matches_the_reference(rng):
    """Gemma-7B's head dim (256; ``reduced()`` gives 16), float32: the
    attention takes the log-sum-exp route, as f32_3xtf32 does on the card
    (the forward hands ``ref.attention_lse``'s log-sum-exp to
    ``ref.attention_grad_lse``); the first step's loss and every gradient
    against ``jax.value_and_grad`` of the reference's loss (1e-5 / 1e-4 of
    each leaf's largest |gradient|), then two ``make_train_step`` steps
    against the reference's within 1e-3."""
    rcfg, ref, params, model = _carried("gemma_7b", seed=4, head_dim=256)
    assert model.cfg.head_dim == rcfg.head_dim == 256
    assert fa_ops.bwd_route(torch.float32, 256) == "f32_3xtf32"
    batch = _batch(rng, rcfg.vocab_size)

    def loss_fn(p):
        return ref.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                        remat=False)

    (want_loss, _), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    calls = []
    plain = fa_ref.attention_grad_lse

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    fa_ref.attention_grad_lse = counting
    try:
        loss, _, grads = _port_loss_and_grads(model, batch)
    finally:
        fa_ref.attention_grad_lse = plain
    assert calls and len(calls) == rcfg.n_layers
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_TOL)
    theirs = weights.leaves(weights.port_tree(_np(want_grads)))
    assert set(theirs) == set(grads)
    for name, want in theirs.items():
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(grads[name].numpy() - want).max())
        assert err <= GRAD_TOL * scale, name
    model.zero_grad(set_to_none=True)
    data = RefDataset(rcfg.vocab_size, S, B, seed=2)
    batches = [{k: np.asarray(v) for k, v in data.batch_at(i).items()}
               for i in range(2)]
    lr = (3e-3, 1, 5)
    want = _ref_curve(rcfg, ref, params, batches, lr)
    opt = AdamW(learning_rate=warmup_cosine(*lr))
    state = opt.init(model)
    step = make_train_step(model, opt)
    for batch, w in zip(batches, want):
        state, metrics = step(state, _port_batch(batch))
        for key in ("loss", "nll", "grad_norm", "lr"):
            assert float(metrics[key]) == pytest.approx(w[key],
                                                        rel=CURVE_TOL), key


def test_train_step_options(rng):
    cfg = configs.get("gemma_7b").reduced()
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(6))
    opt = AdamW(learning_rate=1e-3)
    batch = _port_batch(_batch(rng, cfg.vocab_size))
    state = opt.init(model)
    kept = {n: t.clone() for n, t in state.m.items()}
    # donate=False leaves the state it was given as it was
    new, _ = make_train_step(model, opt, donate=False)(state, batch)
    assert state.count == 0 and new.count == 1
    for n in kept:
        assert torch.equal(state.m[n], kept[n]) and not torch.equal(
            new.m[n], kept[n])
    # gradients cast before the update (the reference's A3)
    seen = []

    class Watching(AdamW):
        def update(self, grads, state, params):
            seen.extend(g.dtype for g in grads.values())
            return super().update(grads, state, params)

    w = Watching(learning_rate=1e-3)
    make_train_step(model, w, grad_reduce_dtype="bfloat16")(w.init(model),
                                                            batch)
    assert set(seen) == {torch.bfloat16}
    # eval: the loss without a gradient, as the reference's eval step
    metrics = make_eval_step(model)(batch)
    assert set(metrics) == {"loss", "nll", "aux", "tokens"}
    assert metrics["loss"].grad_fn is None


def test_multi_device_steps_name_their_slice():
    """Where Slice 3 refused them, the multi-device steps run: the manual
    data-parallel step on a rank mesh (a 2-rank tree: 2 copies a leaf,
    the pattern groups stacked as the reference's, and the ring pmean of
    the loss) ends with the single stream's parameters,
    and the policy-taking train and eval steps give the policy-free values
    on a dense model (no layer reads the policy); the policy's step keeps
    the parameters as per-rank shards at rest, so they are compared
    assembled (``spmd.assemble``), bit for bit."""
    from repro_torch.core.spmd import assemble, make_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import make_policy
    from repro_torch.train.step import init_error_state, stacked_leaves

    cfg = configs.get("gemma_7b").reduced()
    data = SyntheticLMDataset(cfg.vocab_size, 16, 4, device="cpu")

    def fresh():
        return LanguageModel(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))

    one, two = fresh(), fresh()
    opt = AdamW(learning_rate=1e-3)
    s1, s2 = opt.init(one), opt.init(two)
    mesh = make_mesh((2,), ("data",), ("cpu",) * 2)
    dp = make_manual_dp_train_step(two, opt, mesh, schedule="tree")
    err = init_error_state(two)
    single = make_train_step(one, opt)
    for s in range(2):
        s1, m = single(s1, data.batch_at(s))
        s2, loss, err = dp(s2, data.batch_at(s), err)
    n_leaves = len(stacked_leaves(dict(two.named_parameters())))
    assert mesh.copies == 2 * (2 * n_leaves + 2 * 2 * 1)
    for (name, a), b in zip(one.named_parameters(), two.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    policy = make_policy(make_host_mesh(2, 2, device="cpu"))
    ev = make_eval_step(one, policy)(data.batch_at(0))
    assert float(ev["loss"]) == float(make_eval_step(one)(
        data.batch_at(0))["loss"])
    a, b = fresh(), fresh()
    _, ma = make_train_step(a, opt)(opt.init(a), data.batch_at(0))
    _, mb = make_train_step(b, opt, policy)(opt.init(b), data.batch_at(0))
    assert float(ma["loss"]) == float(mb["loss"])
    placed = b.placement.params
    for (name, pa), nb in zip(a.named_parameters(), placed):
        assert name == nb
        assert torch.equal(pa, assemble(placed[name])), name


@pytest.mark.parametrize("seed, step", [(0, 0), (0, 7), (3, 2)])
def test_data_pipeline_gives_the_references_batches_bit_for_bit(seed, step):
    kw = dict(vocab_size=512, seq_len=33, global_batch=3, seed=seed,
              enc_len=5, d_model=8, vision_tokens=4)
    want = RefDataset(**kw).batch_at(step)
    got = SyntheticLMDataset(**kw, device="cpu").batch_at(step)
    assert set(got) == set(want) == {"tokens", "labels", "frames", "pixels"}
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].device.type == "cpu"
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_data_pipeline_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLMDataset(16, 4, 1).batch_at(0)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_batch_specs_match_the_references(arch):
    for cfg, rcfg in ((configs.get(arch), ref_configs.get(arch)),
                      (configs.get(arch).reduced(),
                       ref_configs.get(arch).reduced())):
        want = ref_batch_specs(rcfg, 96, 2)
        got = make_batch_specs(cfg, 96, 2)
        assert set(got) == set(want)
        for k, spec in want.items():
            assert got[k].shape == tuple(spec.shape), k
            assert str(got[k].dtype).split(".")[-1] == str(spec.dtype), k
            assert got[k].ndim == spec.ndim


def test_launch_train_runs_on_the_host(tmp_path, capsys):
    log, out = tmp_path / "log.jsonl", tmp_path / "metrics.json"
    assert launch_train.main(["--arch", "recurrentgemma_9b", "--reduced",
                              "--steps", "3", "--cpu", "--log-file",
                              str(log), "--metrics-out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "[train] done"
    steps = [json.loads(line[len("[train] "):]) for line in lines[:-1]]
    assert [s["step"] for s in steps] == [0, 2]
    assert all(np.isfinite(s["loss"]) for s in steps)
    assert [json.loads(x)["step"] for x in log.read_text().splitlines()] == [
        0, 2]
    final = json.loads(out.read_text())["final"]
    assert final == {k: v for k, v in steps[-1].items() if k != "step"}


def test_launch_train_refuses_without_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch_train.main(["--arch", "gemma_7b", "--reduced"]) == 1
    assert "--cpu" in capsys.readouterr().err


@pytest.mark.parametrize("flags, slice_", [
    (["--fake-devices", "4"], "Slice 3"),
])
def test_launch_train_flags_that_wait_for_their_slice(flags, slice_, capsys):
    """The flag Slice 3 refused runs: 4 ranks sharing the host under the
    policy of a (4, 1) mesh (``--grad-sync implicit``), with the one-rank
    run's loss on a dense model (the reference's trainer under the same
    flags: ``tests/test_torch_dp_train.py``).  The gradient norm is held
    to 1e-6: two runs of the same flags on the host differ in its last
    bits."""
    base = ["--arch", "gemma_7b", "--reduced", "--cpu", "--steps", "1"]
    assert launch_train.main([*base, *flags]) == 0
    got = capsys.readouterr().out.splitlines()
    assert launch_train.main(base) == 0
    want = capsys.readouterr().out.splitlines()
    assert got[-1] == want[-1] == "[train] done" and len(got) == len(want)
    g, w = (json.loads(x[0][len("[train] "):]) for x in (got, want))
    assert g.pop("grad_norm") == pytest.approx(w.pop("grad_norm"), rel=1e-6)
    assert g == w
    assert slice_ not in "\n".join(got)


@pytest.mark.parametrize("flags", [
    ["--mesh-model", "2"],
    ["--grad-sync", "tree"],
    ["--grad-sync", "ring"],
    ["--fake-devices", "1"],
])
def test_launch_train_one_device_ignores_the_mesh_flags(flags, capsys):
    """On one device the reference reads neither ``--mesh-model`` nor
    ``--grad-sync`` (``src/repro/launch/train.py:86-100``), and
    ``--fake-devices 1`` leaves one device: the run trains and prints the
    same ``[train]`` lines as without the flags."""
    base = ["--arch", "gemma_7b", "--reduced", "--cpu", "--steps", "1",
            "--batch", "2", "--seq", "32"]
    assert launch_train.main(base) == 0
    want = capsys.readouterr().out
    assert launch_train.main([*base, *flags]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[-1] == "[train] done"
    assert got.startswith("[train] {")
