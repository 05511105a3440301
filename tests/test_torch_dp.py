"""Explicit data parallelism and the collectives the LM code calls, against
the reference on rank meshes.

One subprocess per reference section (``tests/_multidevice_reference.py``
``dp`` and ``collectives``, 8 fake CPU devices, run side by side once for
this module) gives the reference's values; the port runs the same inputs
on 8 CPU ranks that share the host (:mod:`repro_torch.core.spmd`):

* ``make_manual_dp_train_step`` on gemma reduced (8 × 32 tokens, 3 AdamW
  steps, the reference's weights carried in): ``tree`` and ``ring`` on
  (8,), ``hierarchical`` with and without ``compress_outer`` on (2, 4),
  each against the reference's run of the same variant — losses within
  1e-5, parameters within 2e-4 per leaf (the reference's own bound between
  its schedules; the compressed run within 5e-3, its error state within
  one quantisation step per block) — and against the single stream with
  the reference self-test's bounds; every rank's replica bit for bit rank
  0's; every step's copies and bytes equal to the schedule's closed-form
  count (``launch/meter_gradsync.py``); the state resident between steps;
* ``compressed_allreduce`` alone: codes equal, mean and residual within
  1e-6;
* ``all_to_all`` (both directions), ``pmean`` over one axis and two, the
  stacked ``all_gather`` of int8, each with its copy count; an argument
  placed under its spec passing through ``shard_map`` with no copy;
  gradients flowing through ``ppermute``'s copies.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from _multidevice_reference import (DP_STEPS, DP_VARIANTS, collective_inputs,
                                    run)

from repro_torch import configs
from repro_torch.core import spmd
from repro_torch.core.spmd import NamedSharding, P, Sharded, make_mesh
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.meter_gradsync import (expected_copies,
                                              gradient_leaves)
from repro_torch.models import LanguageModel
from repro_torch.optim import AdamW
from repro_torch.optim.compression import (BLOCK, compressed_allreduce,
                                           quantize_int8)
from repro_torch.train import step as step_mod
from repro_torch.train.step import (init_error_state,
                                    make_manual_dp_train_step,
                                    make_train_step, stacked_leaves)

CPU = (torch.device("cpu"),) * 8
EXACT = ("tree", "ring", "hierarchical")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(run, s, d) for s in ("dp", "collectives")]
        out = {}
        for job in jobs:
            out.update(job.result())
    return out


def _model(ref):
    cfg = configs.get("gemma_7b").reduced()
    model = LanguageModel(cfg, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(ref[f"params0/{name}"]))
    return model


def _data(model):
    return SyntheticLMDataset(model.cfg.vocab_size, seq_len=32,
                              global_batch=8, device="cpu")


@pytest.fixture(scope="module")
def single(ref):
    """The port's single stream from the reference's weights."""
    model = _model(ref)
    opt = AdamW(learning_rate=1e-3)
    step = make_train_step(model, opt)
    state, losses = opt.init(model), []
    for s in range(DP_STEPS):
        state, m = step(state, _data(model).batch_at(s))
        losses.append(float(m["loss"]))
    return {n: p.detach().clone() for n, p in model.named_parameters()}, \
        losses


@pytest.fixture(scope="module")
def runs(ref):
    """Every variant through the port: final parameters, losses, error
    state, per-step copies / bytes with their expected counts, whether
    every rank's replica is rank 0's after each step, and whether the
    state stayed the same tensors between steps; for the compressed run,
    rank 0's residual after the first step and its input to each
    compressed all-reduce (a stacked leaf's gradient plus the carried
    residual) in the first step and in the last, by stacked leaf."""
    out = {}
    inputs = []

    def recording(g, axis_name, *, error=None):
        inputs.append(g.shards[0].float() + error.shards[0])
        return compressed_allreduce(g, axis_name, error=error)

    for name, (shape, axes, schedule, compress) in DP_VARIANTS.items():
        model = _model(ref)
        opt = AdamW(learning_rate=1e-3)
        mesh = make_mesh(shape, axes, CPU)
        step = make_manual_dp_train_step(model, opt, mesh, schedule=schedule,
                                         data_axes=axes,
                                         compress_outer=compress)
        state, err = opt.init(model), init_error_state(model)
        want = expected_copies(schedule, compress, dict(zip(axes, shape)),
                               gradient_leaves(model))
        losses, counts, equal, kept = [], [], [], []
        for s in range(DP_STEPS):
            before = (mesh.copies, mesh.bytes_copied)
            held = (None if step.params is None else
                    [t for v in step.params.values() for t in v.shards]
                    + [t for v in state.m.values() for t in v.shards])
            inputs.clear()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(step_mod, "compressed_allreduce", recording)
                state, loss, err = step(state, _data(model).batch_at(s), err)
            if s == 0:
                err1 = {n: spmd.assemble(v) for n, v in err.items()}
                inputs1 = list(inputs)
            counts.append((mesh.copies - before[0],
                           mesh.bytes_copied - before[1]))
            losses.append(float(loss))
            equal.append(all(
                torch.equal(t, v.shards[0])
                for tree in (step.params, state.master, state.m, state.v)
                for v in tree.values() for t in v.shards))
            if held is not None:
                now = ([t for v in step.params.values() for t in v.shards]
                       + [t for v in state.m.values() for t in v.shards])
                kept.append(all(a is b for a, b in zip(held, now)))
        out[name] = dict(
            params={n: p.detach().clone()
                    for n, p in model.named_parameters()},
            placed={n: v.shards[0] for n, v in step.params.items()},
            own=all(v.shards[0] is p for (n, p), v in zip(
                model.named_parameters(), step.params.values())),
            err={n: spmd.assemble(v) for n, v in err.items()},
            stacks=stacked_leaves(list(err)), err_in=inputs, err1=err1,
            err_in1=inputs1,
            losses=losses, counts=counts, want=want, equal=equal, kept=kept)
    return out


@pytest.mark.parametrize("name", EXACT)
def test_exact_schedules_match_the_references_run(name, ref, runs):
    got = runs[name]
    np.testing.assert_allclose(got["losses"], ref[f"{name}/losses"],
                               rtol=0, atol=1e-5)
    for n, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), ref[f"{name}/{n}"],
                                   rtol=2e-4, atol=2e-4, err_msg=n)


def test_compressed_run_matches_the_references_compressed_run(ref, runs):
    got = runs["compressed"]
    # a code may round the other way on gradients that differ by float
    # rounding: the compressed run is held within 5e-3, losses too
    np.testing.assert_allclose(got["losses"], ref["compressed/losses"],
                               rtol=0, atol=5e-3)
    for n, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), ref[f"compressed/{n}"],
                                   rtol=0, atol=5e-3, err_msg=n)
    assert len(got["err_in"]) == len(got["err_in1"]) == len(got["stacks"])

    def blocks(t):
        flat = t.reshape(-1).abs()
        return torch.nn.functional.pad(
            flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)

    def stacked(tree, stack):
        return torch.stack([torch.as_tensor(tree[n]) for n in stack])
    for stack, x, x1 in zip(got["stacks"], got["err_in"], got["err_in1"]):
        e = stacked(got["err"], stack)
        want = stacked({n: ref[f"compressed.err/{n}"] for n in stack}, stack)
        # each block's quantisation step: the largest |g + e| of the
        # (stacked) block a step quantised, over 127
        _, step = quantize_int8(x)
        # the residual is what rounding to the nearest code lost
        assert bool((blocks(e).amax(1) <= step / 2 * (1 + 1e-6)).all()), \
            stack
        # after the first step, from the same weights, the residuals differ
        # by at most one code; later the two runs' gradients part too
        _, step1 = quantize_int8(x1)
        want1 = stacked({n: ref[f"compressed.err1/{n}"] for n in stack},
                        stack)
        gap = blocks(stacked(got["err1"], stack) - want1).amax(1)
        assert bool((gap <= step1 * (1 + 1e-5)).all()), stack
        np.testing.assert_allclose(e.numpy(), want.numpy(), rtol=0,
                                   atol=5e-3, err_msg=str(stack))
        assert float(torch.cat([e.reshape(-1),
                                want.reshape(-1)]).abs().max()) < 1.0


@pytest.mark.parametrize("name", list(DP_VARIANTS))
def test_every_variant_holds_to_the_single_stream(name, single, runs):
    params, _ = single
    rtol, atol = (5e-2, 5e-3) if name == "compressed" else (2e-4, 2e-4)
    for n, p in runs[name]["params"].items():
        np.testing.assert_allclose(p.numpy(), params[n].numpy(), rtol=rtol,
                                   atol=atol, err_msg=n)


def test_the_single_stream_matches_the_references(ref, single):
    params, losses = single
    np.testing.assert_allclose(losses, ref["single/losses"], rtol=0,
                               atol=1e-5)
    for n, p in params.items():
        np.testing.assert_allclose(p.numpy(), ref[f"single/{n}"], rtol=2e-4,
                                   atol=2e-4, err_msg=n)


@pytest.mark.parametrize("name", list(DP_VARIANTS))
def test_ranks_end_every_step_bit_for_bit_equal(name, runs):
    got = runs[name]
    assert got["equal"] == [True] * DP_STEPS
    # the model's own parameters are rank 0's replica
    assert got["own"]
    for n, p in got["params"].items():
        assert torch.equal(p, got["placed"][n]), n


@pytest.mark.parametrize("name", list(DP_VARIANTS))
def test_each_steps_copies_are_the_schedules_count(name, runs):
    got = runs[name]
    assert got["counts"] == [got["want"]] * DP_STEPS


@pytest.mark.parametrize("name", list(DP_VARIANTS))
def test_replicas_and_state_stay_resident_between_steps(name, runs):
    # the second and third steps take the placed state as it is: the same
    # tensors on every rank, updated in place
    assert runs[name]["kept"] == [True] * (DP_STEPS - 1)


def test_the_schedules_differ_in_their_counts(runs):
    counts = {name: runs[name]["counts"][0] for name in DP_VARIANTS}
    # over all ranks the tree and the ring move the same 2 (n - 1) times a
    # gradient: the tree in whole-tensor copies into and out of a root,
    # the ring in n-th parts spread over every rank
    assert counts["ring"][0] > counts["tree"][0]
    assert counts["ring"][1] == counts["tree"][1]


# ---------------------------------------------------------------------------
# compressed_allreduce and the collectives the model code calls
# ---------------------------------------------------------------------------

def _mesh2():
    return make_mesh((2, 4), ("data", "model"), CPU)


@pytest.mark.parametrize("name, shape, axes, axis", [
    ("c8", (8,), ("i",), "i"), ("c24", (2, 4), ("pod", "data"), "pod")])
def test_compressed_allreduce_matches_the_reference(name, shape, axes, axis,
                                                    ref):
    x = collective_inputs()
    mesh = make_mesh(shape, axes, CPU)
    spec = P(axes)

    def body(v, e):
        v, e = v.map(lambda t: t[0]), e.map(lambda t: t[0])
        mean, res = compressed_allreduce(v, axis, error=e)
        codes = (v + e).map(lambda t: quantize_int8(t)[0])
        return tuple(o.map(lambda t: t[None]) for o in (mean, res, codes))

    before = mesh.copies
    mean, res, codes = spmd.shard_map(
        body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec,) * 3)(
        torch.from_numpy(x["cx"]), torch.from_numpy(x["cerr"]))
    np.testing.assert_array_equal(codes.numpy(), ref[f"{name}.codes"])
    np.testing.assert_allclose(mean.numpy(), ref[f"{name}.mean"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(res.numpy(), ref[f"{name}.res"], rtol=0,
                               atol=1e-6)
    n = mesh.axis_size(axis)
    # codes and scales all-gathered: n (n - 1) copies of each a group
    assert mesh.copies - before == 2 * n * (n - 1) * (8 // n)


def test_compressed_allreduce_moves_int8_codes():
    mesh = make_mesh((2,), ("pod",), CPU[:2])
    x = Sharded(mesh, [torch.ones(512), torch.full((512,), 2.0)])
    sent = []
    copy_to = mesh.copy_to
    mesh.copy_to = lambda t, r: sent.append(t.dtype) or copy_to(t, r)
    with spmd.in_mesh(mesh):
        mean, res = compressed_allreduce(x, "pod")
    assert sorted(set(sent), key=str) == [torch.float32, torch.int8]
    assert sent.count(torch.int8) == 2
    assert all(torch.equal(m, torch.full((512,), 1.5)) for m in mean.shards)
    assert all(float(r.abs().max()) == 0 for r in res.shards)


@pytest.mark.parametrize("key, split, concat", [("a2a", 0, 1),
                                                ("a2a_back", 1, 0)])
def test_all_to_all_matches_the_reference(key, split, concat, ref):
    mesh = _mesh2()
    both = ("data", "model")

    def body(v):
        y = spmd.all_to_all(v.map(lambda t: t[0]), "model", split, concat)
        return y.map(lambda t: t[None])

    got = spmd.shard_map(body, mesh=mesh, in_specs=P(both),
                         out_specs=P(both))(
        torch.from_numpy(collective_inputs()["a2a"]))
    np.testing.assert_array_equal(got.numpy(), ref[key])
    # n - 1 rounds of n copies in each of the 2 groups; no copy of a
    # rank's own block
    assert mesh.copies == 3 * 4 * 2


@pytest.mark.parametrize("key, axes", [("mean_model", "model"),
                                       ("mean_both", ("data", "model"))])
def test_pmean_matches_the_reference(key, axes, ref):
    mesh = _mesh2()
    both = ("data", "model")
    got = spmd.shard_map(lambda v: spmd.pmean(v, axes), mesh=mesh,
                         in_specs=P(both), out_specs=P(both))(
        torch.from_numpy(collective_inputs()["mean"]))
    np.testing.assert_allclose(got.numpy(), ref[key], rtol=0, atol=1e-6)
    n = mesh.axis_size(axes)
    assert mesh.copies == 2 * n * (n - 1) * (8 // n)


def test_stacked_all_gather_matches_the_reference(ref):
    mesh = _mesh2()
    both = ("data", "model")
    got = spmd.shard_map(
        lambda v: spmd.all_gather(v, "data").map(lambda t: t[None]),
        mesh=mesh, in_specs=P(both), out_specs=P(both))(
        torch.from_numpy(collective_inputs()["gather"]))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref["gather"])
    assert mesh.copies == 2 * 1 * 4


def test_a_placed_argument_passes_through_shard_map():
    mesh = _mesh2()
    x = torch.arange(32.0).reshape(8, 4)
    placed = NamedSharding(mesh, P(("data", "model"))).place(x)
    assert placed.sharding == NamedSharding(mesh, P(("data", "model")))
    assert placed.global_shape == (8, 4)
    seen = []
    fn = spmd.shard_map(lambda v: seen.append(v) or v, mesh=mesh,
                        in_specs=P(("data", "model")),
                        out_specs=P(("data", "model")))
    out = fn(placed)
    assert seen[0] is placed and mesh.copies == 0
    assert all(a is b for a, b in zip(seen[0].shards, placed.shards))
    assert torch.equal(out, x) and torch.equal(spmd.assemble(placed), x)
    # placing it again by the same sharding returns it as it is
    assert NamedSharding(mesh, P(("data", "model"))).place(placed) is placed
    # under another spec the value is assembled and split anew
    other = spmd.shard_map(lambda v: v, mesh=mesh, in_specs=P(),
                           out_specs=P())(placed)
    assert torch.equal(other, x)


def test_gradients_flow_through_ppermute_copies():
    mesh = make_mesh((4,), ("i",), CPU[:4])
    x = torch.arange(4.0, requires_grad=True)
    y = spmd.shard_map(
        lambda v: spmd.psum(v.map(lambda t: t * t), "i"), mesh=mesh,
        in_specs=P("i"), out_specs=P())(x)
    y.sum().backward()
    # the sum of squares reaches rank 0 through copies: d/dx = 2x
    assert torch.equal(x.grad, 2 * x.detach())
    assert mesh.copies == 2 * 4 * 3
