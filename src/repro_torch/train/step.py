"""Training step factories — ``repro/train/step.py`` for ``policy=None``.

:func:`make_train_step` is the reference's loss → grad → AdamW step on one
device.  The model holds its parameters (an ``nn.Module``), as the serving
steps' models do, so the step is ``step(opt_state, batch) -> (opt_state,
metrics)``: it takes the gradient of ``model.loss`` with autograd (through
the attention backward kernel and the scan kernel on the card) and updates
the parameters and the optimizer state in place, where the reference
donates both to XLA (ROADMAP Queue 3).

The reference's other step family, :func:`make_manual_dp_train_step`
(explicit data parallelism over a device mesh, with its error-feedback
state ``init_error_state``), is a collective schedule: it raises
:class:`ValueError` until the multi-device slice.
"""

from __future__ import annotations

import torch

from repro_torch.sharding.constraints import _refuse, use_policy


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
    ``"bfloat16"``).  A sharding ``policy`` raises :class:`ValueError`
    until the multi-device slice.
    """
    _refuse(policy)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    reduce_dtype = _dtype(grad_reduce_dtype)

    def step(opt_state, batch):
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


def make_eval_step(model, policy=None, *, n_loss_chunks: int = 8):
    """Returns ``step(batch) -> metrics``: the loss without remat and
    without a gradient."""
    _refuse(policy)

    @torch.no_grad()
    def step(batch):
        with use_policy(policy):
            loss, metrics = model.loss(batch, n_chunks=n_loss_chunks,
                                       remat=False)
        return dict(metrics, loss=loss)

    return step


def make_manual_dp_train_step(model, optimizer, mesh, **kwargs):
    """The reference's explicit data-parallel step: a collective schedule
    over a device mesh, which the port does not run yet."""
    raise ValueError(
        "make_manual_dp_train_step synchronises gradients across a device "
        "mesh (tree / ring / hierarchical schedules, int8 compression): it "
        "comes with Slice 3 (multi-device, ROADMAP Queue 1)")

