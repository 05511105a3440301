"""Meter the gradient-sync schedules' collective traffic.

    python -m repro_torch.launch.meter_gradsync [--device cpu]

Runs one step of the explicit data-parallel trainer
(:func:`repro_torch.train.step.make_manual_dp_train_step`) on a (2, 4)
``("pod", "data")`` rank mesh (8 ranks sharing the card; ``--device cpu``:
the host) for each schedule, gemma reduced with a batch of 8 × 64 tokens,
and prints one JSON line per schedule with the reference's keys
(``schedule``, ``params``, ``grad_fp32_bytes``, ``collectives``).

The reference parses its bytes from the compiled step's HLO.  The port's
come from the mesh's counters over the step: ``collectives.ppermute``
holds the copies and bytes per rank.  Beside them stand
:func:`expected_copies` (the port's schedules counted in closed form:
``copies_expected`` / ``bytes_expected``, per rank) and
:func:`wire_model` (the reference's per-device wire bytes of the
collectives it emits for the same schedule, priced as its
``parse_collective_bytes`` prices them, by
:func:`repro_torch.launch.dryrun.wire_bytes`: ``reference_wire_model``).  Both count the loss's ``pmean`` besides the
gradients.  Exits non-zero when a measured count differs from
:func:`expected_copies`.

Beside them stand the closed forms of the policy path with its
parameters at rest (:mod:`repro_torch.sharding.placement`):
:func:`fsdp_expected_copies` (a train step: each leaf gathered whole once
a pass, twice for a pattern group's under remat, and split once into the
ranks' gradient shards), :func:`serving_expected_copies` (a prefill or a
decode step: one gather a leaf) and :func:`moe_expected_splits` (the
blocks a mixture of experts' ``shard_map`` cuts a call: the expert
weights' among them unless they rest on the expert axis).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

SCHEDULES = (("tree", False), ("ring", False), ("hierarchical", False),
             ("hierarchical", True))


def _ring(n: int, nbytes: int) -> tuple:
    """Copies and bytes of one ring all-reduce (reduce-scatter and
    all-gather, ``n - 1`` rounds each) of ``nbytes`` in one group."""
    return 2 * n * (n - 1), 2 * (n - 1) * nbytes


def _gather(n: int, nbytes: int) -> tuple:
    """Copies and bytes of one ring all-gather of ``nbytes`` a rank."""
    return n * (n - 1), n * (n - 1) * nbytes


def gradient_leaves(model) -> list:
    """``(shape, element size)`` of every leaf the manual DP step
    synchronises: the reference's, the pattern groups stacked
    (:func:`repro_torch.train.step.stacked_leaves`)."""
    from repro_torch.train.step import stacked_leaves

    params = dict(model.named_parameters())
    out = []
    for stack in stacked_leaves(params):
        p = params[stack[0]]
        shape = tuple(p.shape) if len(stack) == 1 else (len(stack),
                                                        *p.shape)
        out.append((shape, p.element_size()))
    return out


def expected_copies(schedule: str, compress: bool, axes: dict, leaves,
                    loss_bytes: int = 4) -> tuple:
    """``(copies, bytes)`` of one manual-DP step over all ranks, in closed
    form: ``axes`` is ``{data axis: size}`` outermost first (the mesh's
    only axes), ``leaves`` the gradients' ``(shape, element size)``
    (:func:`gradient_leaves`).  The
    loss's ``pmean`` is a ring all-reduce of one float32 over every rank
    (one element: ``loss_bytes`` move in each round)."""
    names = list(axes)
    size = math.prod(axes.values())
    copies = nbytes = 0

    def add(groups, cb):
        nonlocal copies, nbytes
        copies += groups * cb[0]
        nbytes += groups * cb[1]

    for shape, item in leaves:
        b = math.prod(shape) * item
        if compress and len(names) > 1:
            o, i = axes[names[0]], axes[names[-1]]
            add(size // i, _ring(i, b))                # pmean over inner
            nb = -(-math.prod(shape) // 256)
            add(size // o, _gather(o, nb * 256))       # int8 codes
            add(size // o, _gather(o, nb * 4))         # float32 scales
        elif schedule == "tree":
            for ax in names:
                n = axes[ax]
                add(size // n, (2 * (n - 1), 2 * (n - 1) * b))
        elif schedule == "ring" or len(names) == 1:
            add(1, _ring(size, b))
        elif schedule == "hierarchical":
            o, i = axes[names[0]], axes[names[-1]]
            if not any(d % i == 0 for d in shape):
                add(1, _ring(size, b))
                continue
            add(o, (i * (i - 1), (i - 1) * b))          # reduce-scatter
            add(i, _ring(o, b // i))                     # across pods
            add(o, (i * (i - 1), (i - 1) * b))          # all-gather
        else:
            raise ValueError(f"unknown schedule {schedule!r}")
    add(1, (2 * size * (size - 1), 2 * (size - 1) * loss_bytes))
    return copies, nbytes


def _placed(model, shardings) -> list:
    """``(name, elements, element size, distinct blocks, global shape,
    sharding)`` of every leaf placed by ``shardings``."""
    from repro_torch.core.spmd import block_ranks

    params = _named_shapes(model)
    out = []
    for name, (shape, item) in params.items():
        sh = shardings[name]
        out.append((name, math.prod(shape), item,
                    len(block_ranks(sh.mesh, sh.spec)), shape, sh))
    return out


def _named_shapes(model) -> dict:
    """``{name: (shape, element size)}`` of a model's parameters (a placed
    model's placeholders carry both)."""
    return {n: (tuple(p.shape), p.element_size())
            for n, p in model.named_parameters()}


def _moe_layers(model) -> int:
    """The blocks with a mixture of experts."""
    return sum(1 for m in model.modules() if "moe" in m._modules)


def _moe_recomputed(model) -> tuple:
    """``(blocks, balance-loss means)`` the remat recompute runs: every
    mixture of experts of a pattern group, but the balance loss's mean
    not in the group's last one, since no later op of the group saves a
    tensor for the backward (``torch.utils.checkpoint`` stops its
    recompute there)."""
    blocks = means = 0
    for stack in (model, getattr(model, "enc", None)):
        for group in getattr(stack, "groups", ()) if stack is not None \
                else ():
            m = sum(1 for blk in group.values() if "moe" in blk._modules)
            blocks += m
            means += max(m - 1, 0)
    return blocks, means


def _relabels(policy, sh, shape) -> bool:
    """Whether a leaf at rest by ``sh`` has the blocks of the expert
    parallel in-spec (the expert dim on the model axis)."""
    from repro_torch.core.spmd import NamedSharding, P
    from repro_torch.sharding.placement import same_blocks

    target = NamedSharding(sh.mesh, P(policy.model_axis,
                                      *([None] * (len(shape) - 1))))
    return same_blocks(sh, target, shape)


def _taken(policy, ep: bool, name, numel, item, blocks, shape, sh) -> tuple:
    """``(copies, bytes)`` of one pass taking a leaf at rest: gathered
    whole (one copy a distinct block, its bytes once), or, for expert
    weights under expert parallelism (``ep``), taken on the in-spec: no
    copy where their blocks are the spec's, else a gather and a copy of
    ``E / n`` experts to every rank."""
    if not (ep and "experts" in name.split(".")):
        return blocks, numel * item
    if _relabels(policy, sh, shape):
        return 0, 0
    size = policy.mesh.size
    return blocks + size, numel * item + size * (numel // policy.model_size
                                                 ) * item


def _moe_collectives(model, policy, tokens: int, *, decode: bool) -> tuple:
    """``(all_to_all copies, bytes, pmean copies, bytes)`` of one mixture
    of experts under ``policy`` (``tokens``: the batch's B · S): the two
    ``all_to_all`` of expert parallelism (``n (n - 1)`` blocks of ``(E /
    n, C, d)`` in each model group) and the ring ``pmean`` of the balance
    loss (one float32 over every rank)."""
    from repro_torch.models.moe import _capacity, uses_ep

    if policy is None or policy.model_axis is None or not _moe_layers(model):
        return 0, 0, 0, 0
    cfg = model.cfg
    size, n = policy.mesh.size, policy.model_size
    a2a = a2a_bytes = 0
    if uses_ep(cfg, policy):
        t_loc = tokens
        if policy.batch_sharded:
            t_loc //= policy.dp_size
        if policy.seq_sharded and not decode:
            t_loc //= n
        c = t_loc if decode else _capacity(t_loc, cfg)
        block = cfg.n_experts // n * c * cfg.d_model * (
            2 if cfg.dtype == "bfloat16" else 4)
        a2a = 2 * (size // n) * n * (n - 1)
        a2a_bytes = a2a * block
    return a2a, a2a_bytes, 2 * size * (size - 1), 2 * (size - 1) * 4


def fsdp_expected_copies(model, policy, *, tokens: int, remat: bool = True,
                         grad_itemsize=None, shardings=None) -> tuple:
    """``(copies, bytes)`` of one train step on a model placed at rest by
    ``shardings`` (default ``policy.tree_param_shardings(model)``), over
    all ranks, in closed form.

    A leaf is gathered whole once a pass (one copy a distinct block, its
    bytes once): once in the forward, and again in the recompute for a
    pattern group's under ``remat``.  Its gradient is split once, a copy
    to every rank of its block in ``grad_itemsize`` (default the leaf's).
    Expert weights under expert parallelism are taken on the in-spec
    instead: no copy where their blocks are those of the spec, else a
    gather and a copy to every rank; their backward sums every rank's
    block into the whole gradient (one copy a rank) before the split.
    The mixture-of-experts collectives of each pass
    (:func:`_moe_collectives`, :func:`_moe_recomputed`) come on top.
    """
    from repro_torch.models.moe import uses_ep

    size = policy.mesh.size
    shardings = shardings or policy.tree_param_shardings(model)
    ep = uses_ep(model.cfg, policy)
    copies = nbytes = 0
    for leaf in _placed(model, shardings):
        name, numel, item, blocks = leaf[:4]
        passes = 2 if remat and "groups" in name.split(".") else 1
        c, b = _taken(policy, ep, *leaf)
        copies += passes * c
        nbytes += passes * b
        if ep and "experts" in name.split("."):
            # every rank's block gradient summed into the whole gradient
            copies += size
            nbytes += size * (numel // policy.model_size) * item
        copies += size
        nbytes += size * (numel // blocks) * (grad_itemsize or item)
    a2a, a2a_b, mean, mean_b = _moe_collectives(model, policy, tokens,
                                                decode=False)
    layers = _moe_layers(model)
    copies += layers * (a2a + mean)
    nbytes += layers * (a2a_b + mean_b)
    if remat:
        blocks, means = _moe_recomputed(model)
        copies += blocks * a2a + means * mean
        nbytes += blocks * a2a_b + means * mean_b
    return copies, nbytes


def serving_expected_copies(model, policy, *, tokens: int, decode: bool,
                            shardings=None) -> tuple:
    """``(copies, bytes)`` of one prefill (``decode``: one decode step,
    ``tokens`` = B) on a model placed at rest by ``shardings`` (default
    ``policy.tree_param_shardings(model)``): every leaf gathered whole
    once, expert weights under expert parallelism taken on the in-spec
    (:func:`fsdp_expected_copies`), and the mixture-of-experts
    collectives."""
    from repro_torch.models.moe import uses_ep

    shardings = shardings or policy.tree_param_shardings(model)
    ep = uses_ep(model.cfg, policy)
    copies = nbytes = 0
    for leaf in _placed(model, shardings):
        c, b = _taken(policy, ep, *leaf)
        copies += c
        nbytes += b
    a2a, a2a_b, mean, mean_b = _moe_collectives(model, policy, tokens,
                                                decode=decode)
    layers = _moe_layers(model)
    return (copies + layers * (a2a + mean),
            nbytes + layers * (a2a_b + mean_b))


def moe_expected_splits(model, policy, *, batch: int, seq: int,
                        at_rest: bool) -> tuple:
    """``(splits, bytes)`` a ``shard_map`` of the mixture-of-experts
    layers cuts in one pass of a ``(batch, seq)`` input under ``policy``
    (``Mesh.splits`` / ``bytes_split``): each layer's router (replicated
    on every rank), its input's blocks, and, unless the experts rest on
    the expert axis (``at_rest``), the three expert weights' blocks
    (``E / n`` experts a rank under expert parallelism, all of them
    replicated otherwise)."""
    from repro_torch.models.moe import uses_ep

    if policy is None or policy.model_axis is None or not _moe_layers(model):
        return 0, 0
    cfg = model.cfg
    size, n = policy.mesh.size, policy.model_size
    item = 2 if cfg.dtype == "bfloat16" else 4
    b_loc = batch // policy.dp_size if policy.batch_sharded else batch
    s_loc = seq // n if policy.seq_sharded else seq
    splits = 2 * size
    nbytes = size * (cfg.d_model * cfg.n_experts * 4
                     + b_loc * s_loc * cfg.d_model * item)
    if not at_rest:
        per = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * item
        splits += 3 * size
        nbytes += size * (per // n if uses_ep(cfg, policy) else per)
    layers = _moe_layers(model)
    return layers * splits, layers * nbytes


def wire_model(schedule: str, compress: bool, axes: dict, leaves,
               loss_bytes: int = 4) -> dict:
    """The reference's per-device wire bytes for the same step, by kind,
    from the collectives its step emits (``lax.ppermute`` rounds for the
    tree, ``psum`` / ``psum_scatter`` / ``all_gather`` otherwise), each
    priced as ``parse_collective_bytes`` prices it
    (:func:`repro_torch.launch.dryrun.wire_bytes` of its output and
    group)."""
    from repro_torch.launch.dryrun import wire_bytes

    names = list(axes)
    size = math.prod(axes.values())
    out = {"all-reduce": 0.0, "reduce-scatter": 0.0, "all-gather": 0.0,
           "collective-permute": 0.0}

    def add(kind, o, g):
        out[kind] += wire_bytes(kind, o, g)

    for shape, item in leaves:
        b = math.prod(shape) * item
        if compress and len(names) > 1:
            o, i = axes[names[0]], axes[names[-1]]
            add("all-reduce", b, i)
            nb = -(-math.prod(shape) // 256)
            add("all-gather", o * nb * 256, o)
            add("all-gather", o * nb * 4, o)
        elif schedule == "tree":
            for ax in names:
                rounds = math.ceil(math.log2(axes[ax])) if axes[ax] > 1 else 0
                for _ in range(2 * rounds):
                    add("collective-permute", b, 2)
        elif schedule == "ring" or len(names) == 1:
            add("all-reduce", b, size)
        else:
            o, i = axes[names[0]], axes[names[-1]]
            if not any(d % i == 0 for d in shape):
                add("all-reduce", b, size)
                continue
            add("reduce-scatter", b / i, i)
            add("all-reduce", b / i, o)
            add("all-gather", b, i)
    add("all-reduce", loss_bytes, size)
    out["total_bytes"] = sum(out.values())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="the device every rank shares (cuda, cpu)")
    args = parser.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.core.spmd import make_mesh
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW
    from repro_torch.train.step import (init_error_state,
                                        make_manual_dp_train_step)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no GPU (torch.cuda.is_available() is false); pass "
                     "--device cpu to run on the host")
    cfg = configs.get("gemma_7b").reduced()
    data = SyntheticLMDataset(cfg.vocab_size, seq_len=64, global_batch=8,
                              device=device)
    opt = AdamW(learning_rate=1e-3)
    axes = {"pod": 2, "data": 4}
    batch = data.batch_at(0)
    ok = True
    for schedule, compress in SCHEDULES:
        mesh = make_mesh(tuple(axes.values()), tuple(axes), (device,) * 8)
        model = LanguageModel(cfg, device=device).init(
            torch.Generator(device=device).manual_seed(0))
        leaves = gradient_leaves(model)
        step = make_manual_dp_train_step(
            model, opt, mesh, schedule=schedule, data_axes=tuple(axes),
            compress_outer=compress)
        step(opt.init(model), batch, init_error_state(model))
        copies, nbytes = expected_copies(schedule, compress, axes, leaves)
        ok &= (mesh.copies, mesh.bytes_copied) == (copies, nbytes)
        print(json.dumps({
            "schedule": schedule + ("+int8" if compress else ""),
            "params": model.param_count(),
            "grad_fp32_bytes": 4 * model.param_count(),
            "collectives": {
                "ppermute": {"bytes": mesh.bytes_copied / mesh.size,
                             "count": mesh.copies / mesh.size},
                "copies_expected": copies / mesh.size,
                "bytes_expected": nbytes / mesh.size,
                "reference_wire_model": wire_model(schedule, compress, axes,
                                                   leaves),
            },
        }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
