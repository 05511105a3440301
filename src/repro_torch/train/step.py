"""Training step factories — ``repro/train/step.py`` in PyTorch.

:func:`make_train_step` is the reference's loss → grad → AdamW step.  The
model holds its parameters (an ``nn.Module``), as the serving steps'
models do, so the step is ``step(opt_state, batch) -> (opt_state,
metrics)``: it takes the gradient of ``model.loss`` with autograd (through
the attention backward kernel and the scan kernel on the card) and updates
the parameters and the optimizer state in place, where the reference
donates both to XLA (ROADMAP Queue 3).  Under a sharding policy the step
places what the reference's ``jit_with`` pins at rest: the parameters,
the float32 masters and both moments as per-rank shards by
``policy.tree_param_shardings`` (flat FSDP over ``("data", "model")``,
expert weights on the model axis; :mod:`repro_torch.sharding.placement`),
the count replicated.  Each layer group's weights are gathered whole just
before the group runs (again in the backward's recompute under remat),
the gradients reach the shards through the gather's backward (cast to
``grad_reduce_dtype``, then split: the reduce-scatter of the reference's
§Perf A1), and AdamW updates each rank's shards in place.  Activations
stay whole on the mesh's first device: the ranks share one card, where a
sequence or batch split would only cut every op into per-rank launches.
The loss runs inside ``use_policy``, so its mixture-of-experts layers run
per rank on the policy's mesh.

:func:`make_manual_dp_train_step` is the reference's explicit data
parallelism (the paper's idea on an LM): parameters replicated on every
rank of a mesh, the batch split over ``data_axes``, each rank's gradient
synchronised with a chosen collective schedule (the paper's binary tree,
the ring, or the pod-aware hierarchical one), or int8-compressed with
error feedback across the outermost axis (:func:`init_error_state`).
It synchronises the reference's leaves: a layer's tensor joins the other
pattern groups' tensor of the same path, stacked in group order
(:func:`stacked_leaves`), so each collective, each schedule's choice of
dimension and each int8 block is the reference's.
"""

from __future__ import annotations

import re

import torch

from repro_torch.core import lowering, spmd
from repro_torch.core.spmd import NamedSharding, P, Sharded
from repro_torch.optim.adamw import OptState, named
from repro_torch.optim.compression import compressed_allreduce
from repro_torch.sharding.constraints import use_policy
from repro_torch.sharding.placement import (check_placement, place_model,
                                            placement_of)


def _dtype(dtype) -> torch.dtype | None:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def make_train_step(model, optimizer, policy=None, *, n_loss_chunks: int = 8,
                    remat: bool = True, donate: bool = True,
                    grad_reduce_dtype=None):
    """Returns ``step(opt_state, batch) -> (opt_state, metrics)`` for
    ``model`` (whose parameters it sets to take a gradient) and
    ``optimizer`` (:class:`repro_torch.optim.AdamW`).

    ``metrics`` are the loss's (``nll``, ``aux``, ``tokens``) with
    ``loss``, ``grad_norm`` and ``lr``.  The parameters are updated in
    place; with ``donate=True`` (the reference's default) so is
    ``opt_state``, and with ``donate=False`` the step updates a copy and
    leaves the state it was given as it was.  ``grad_reduce_dtype`` casts
    the gradients before the update, as the reference does (its A3:
    ``"bfloat16"``).

    Under a sharding ``policy`` an unplaced model is placed at rest now
    (:func:`repro_torch.sharding.placement.place_model`; one placed
    otherwise already raises, it is never placed again behind the
    caller's back), the loss runs inside ``use_policy(policy)``, and the
    step places ``opt_state``'s masters and moments by the parameters'
    shardings (a state placed so already, as :meth:`AdamW.init` of the
    placed model gives it and the step returns it, is kept as it is).  A
    model placed already is trained on its shards with or without a
    policy.  Each leaf's gradient norm is taken on its whole gradient
    before the split, so the global norm, and with it every update, has
    the policy-free step's bits on a dense model.  The step raises if the
    model was placed or unplaced after it was built.
    """
    model.requires_grad_(True)
    reduce_dtype = _dtype(grad_reduce_dtype)
    if policy is not None:
        place_model(model, policy)
    placement = placement_of(model)
    if placement is not None:
        return _placed_train_step(model, optimizer, policy, placement,
                                  n_loss_chunks=n_loss_chunks, remat=remat,
                                  donate=donate, reduce_dtype=reduce_dtype)
    params = dict(model.named_parameters())

    def step(opt_state, batch):
        check_placement(model, None)
        for p in params.values():
            p.grad = None
        with use_policy(policy):
            loss, metrics = model.loss(batch, n_chunks=n_loss_chunks,
                                       remat=remat)
        loss.backward()
        grads = {}
        for name, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            grads[name] = g if reduce_dtype is None else g.to(reduce_dtype)
        if not donate:
            opt_state = type(opt_state)(
                *({n: t.clone() for n, t in tree.items()}
                  for tree in opt_state[:3]), opt_state.count)
        _, opt_state, opt_metrics = optimizer.update(grads, opt_state,
                                                     params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), **opt_metrics)
        return opt_state, metrics

    return step


def _placed_train_step(model, optimizer, policy, placement, *, n_loss_chunks,
                       remat, donate, reduce_dtype):
    """:func:`make_train_step` on a placed model: the gradients reach the
    shards through the gathers' backward, and AdamW runs rank by rank on
    each rank's shards with the global norm of the whole gradients."""
    placement.requires_grad_(True)
    placement.grad_dtype = reduce_dtype
    mesh = placement.mesh
    params = placement.params

    def placed(tree, copy: bool) -> dict:
        out = {n: placement.shardings[n].place(t) for n, t in tree.items()}
        if copy:
            out = {n: Sharded(mesh, [t.clone() for t in v.shards], v.spec)
                   for n, v in out.items()}
        return out

    def step(opt_state, batch):
        check_placement(model, placement)
        master, m, v = (placed(tree, not donate) for tree in opt_state[:3])
        placement.zero_grad()
        with use_policy(policy):
            loss, metrics = model.loss(batch, n_chunks=n_loss_chunks,
                                       remat=remat)
        loss.backward()
        gnorm = torch.linalg.vector_norm(torch.stack(placement.grad_norms()))
        for r in range(mesh.size):
            own = {n: value.shards[r] for n, value in params.items()}
            grads = {n: t.grad if t.grad is not None else torch.zeros_like(t)
                     for n, t in own.items()}
            _, _, opt_metrics = optimizer.update(
                grads, OptState({n: t.shards[r] for n, t in master.items()},
                                {n: t.shards[r] for n, t in m.items()},
                                {n: t.shards[r] for n, t in v.items()},
                                opt_state.count), own, grad_norm=gnorm)
            del grads
        placement.zero_grad()
        metrics = {k: val.detach() for k, val in metrics.items()}
        metrics.update(loss=loss.detach(), **opt_metrics)
        return OptState(master, m, v, opt_state.count + 1), metrics

    return step


def make_eval_step(model, policy=None, *, n_loss_chunks: int = 8):
    """Returns ``step(batch) -> metrics``: the loss without remat and
    without a gradient (inside ``use_policy(policy)``; a placed model
    gathers each group's weights as it runs, as the train step's forward
    does).  The reference's eval step pins no placement, and neither does
    this one."""

    @torch.no_grad()
    def step(batch):
        with use_policy(policy):
            loss, metrics = model.loss(batch, n_chunks=n_loss_chunks,
                                       remat=False)
        return dict(metrics, loss=loss)

    return step


class _Loss(torch.nn.Module):
    """``model.loss`` as a module's forward, for
    ``torch.func.functional_call`` over a rank's replica tensors."""

    def __init__(self, model, n_chunks: int):
        super().__init__()
        self.model = model
        self.n_chunks = n_chunks

    def forward(self, batch):
        return self.model.loss(batch, n_chunks=self.n_chunks, remat=False)


_GROUP = re.compile(r"^(.*?)groups\.(\d+)\.(.*)$")


def stacked_leaves(names) -> list:
    """The reference's parameter leaves as lists of the port's names: a
    name under ``groups.<g>.`` joins the other groups' name of the same
    path, in group order (the reference stacks the pattern groups on a
    leading axis); any other name stands alone."""
    out: dict = {}
    for n in names:
        m = _GROUP.match(n)
        key = (m.group(1), m.group(3)) if m else n
        out.setdefault(key, []).append((int(m.group(2)) if m else -1, n))
    return [[n for _, n in sorted(v)] for v in out.values()]


def _stack(tensors: list) -> torch.Tensor:
    return tensors[0] if len(tensors) == 1 else torch.stack(tensors)


def _place_replicas(model, mesh) -> dict:
    """``{name: Sharded}``, the model's parameters replicated (spec
    ``P()``) on every rank: rank 0's are the model's own tensors where the
    mesh's first device is the model's, every other rank's a copy on its
    device.  Each takes a gradient."""
    out = {}
    first = mesh.rank_devices[0]
    for name, p in model.named_parameters():
        shards = []
        for r, dev in enumerate(mesh.rank_devices):
            if r == 0 and p.device == first:
                t = p
            else:
                t = torch.empty(p.shape, dtype=p.dtype, device=dev)
                with torch.no_grad():
                    t.copy_(p)
            shards.append(t.requires_grad_(True))
        out[name] = Sharded(mesh, shards, P())
    return out


def make_manual_dp_train_step(model, optimizer, mesh, *,
                              schedule: str = "tree",
                              data_axes: tuple = ("data",),
                              compress_outer: bool = False,
                              n_loss_chunks: int = 4):
    """Explicit-DP step over ``mesh`` (a :class:`repro_torch.core.spmd.Mesh`
    whose ranks may share a device): parameters replicated, the batch
    split on ``data_axes``, gradients synced with ``schedule`` (``tree``,
    ``ring``, ``hierarchical``: :func:`repro_torch.core.lowering.
    sync_gradients`).  With ``compress_outer`` and two or more data axes,
    the gradients are averaged over the innermost axis and then all-reduced
    int8-compressed with error feedback over the outermost one.

    Returns ``step(opt_state, batch, err) -> (opt_state, loss, err)``: the
    reference's ``(params, opt_state, batch, err)`` step with the
    parameters held by the model.  On the first call the step places the
    model's parameters on every rank (rank 0 keeps the model's own
    tensors), and ``opt_state`` (``optimizer.init(model)``) and ``err``
    (:func:`init_error_state`) are placed on every rank
    (:class:`~repro_torch.core.spmd.NamedSharding` ``P()``); the step
    returns them placed, and handed back they are placed already, so each
    rank's replica, moments and residual stay on its device between steps
    and are updated in place.  ``loss`` is the mean over the ranks (rank
    0's value, a tensor on the mesh's first device); ``step.params`` holds
    the placed parameters.  Every rank runs the loss without remat, its
    backward, and the optimizer's update on the synced gradients; every
    schedule leaves the same bits on every rank.
    """
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    stacks = stacked_leaves(names)
    loss_mod = _Loss(model, n_loss_chunks)
    whole = NamedSharding(mesh, P())
    compress = compress_outer and len(data_axes) > 1

    def unstack(stack, value: Sharded) -> dict:
        """A stacked leaf's value per layer name, placed ``P()``."""
        if len(stack) == 1:
            return {stack[0]: Sharded(mesh, value.shards, P())}
        return {n: Sharded(mesh, [t[g] for t in value.shards], P())
                for g, n in enumerate(stack)}

    def body(p, os_, b, e, count):
        ranks = range(mesh.size)
        losses, grads = [], [[] for _ in stacks]
        for r in ranks:
            mine = {f"model.{n}": p[n].shards[r] for n in names}
            loss, _ = torch.func.functional_call(
                loss_mod, mine, ({k: v.shards[r] for k, v in b.items()},))
            loss.backward()
            for i, stack in enumerate(stacks):
                own = [p[n].shards[r] for n in stack]
                grads[i].append(_stack([t.grad if t.grad is not None
                                        else torch.zeros_like(t)
                                        for t in own]))
                for t in own:
                    t.grad = None
            losses.append(loss.detach())
        grads = {i: Sharded(mesh, g) for i, g in enumerate(grads)}
        synced, new_err = {}, {}
        if compress:
            inner = data_axes[-1]
            for i, stack in enumerate(stacks):
                g = spmd.pmean(grads[i], inner)
                err = Sharded(mesh, [_stack([e[n].shards[r] for n in stack])
                                     for r in ranks])
                mean, res = compressed_allreduce(g, data_axes[0], error=err)
                synced.update(unstack(stack, mean))
                new_err.update(unstack(stack, res))
        else:
            grads = lowering.sync_gradients(grads, schedule, data_axes)
            for i, stack in enumerate(stacks):
                synced.update(unstack(stack, grads[i]))
            new_err = e
        grads = synced
        loss = spmd.pmean(Sharded(mesh, losses), data_axes)
        master, m, v = os_
        for r in ranks:
            optimizer.update(
                {n: grads[n].shards[r] for n in names},
                OptState({n: master[n].shards[r] for n in names},
                         {n: m[n].shards[r] for n in names},
                         {n: v[n].shards[r] for n in names}, count),
                {n: p[n].shards[r] for n in names})
        return (master, m, v), loss.shards[0], new_err

    def step(opt_state, batch, err):
        if step.params is None:
            step.params = _place_replicas(model, mesh)
        os_ = tuple({n: whole.place(t) for n, t in tree.items()}
                    for tree in opt_state[:3])
        b = {k: NamedSharding(mesh, P(tuple(data_axes),
                                      *([None] * (x.ndim - 1)))).place(x)
             for k, x in batch.items()}
        e = {n: whole.place(t) for n, t in err.items()}
        with spmd.in_mesh(mesh):
            (master, m, v), loss, err = body(step.params, os_, b, e,
                                             opt_state.count)
        return OptState(master, m, v, opt_state.count + 1), loss, err

    step.params = None
    return step


def init_error_state(params) -> dict:
    """Zero float32 error-feedback residuals, one per parameter (a module
    or ``{name: tensor}``), on each parameter's device."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named(params).items()}
