"""Serving step factories: prefill (full sequence, cache-building) and
single-token decode — ``repro/train/serve.py`` in PyTorch.

The model holds its parameters (an ``nn.Module``), so the steps take no
``params`` argument: ``make_prefill_step(model, policy, s_max=...)(tokens,
frames=None, pixels=None)`` (the encoder's frames of an encoder-decoder,
the image patches of a vision model) and ``make_decode_step(model,
policy)(states, token, pos)``.  Under a sharding policy each step runs
inside ``use_policy``, so the mixture-of-experts layers run per rank on
the policy's mesh, and the model's parameters rest as per-rank shards by
``policy.tree_param_shardings``, as the reference's ``lower_prefill`` /
``lower_decode`` pin them (:mod:`repro_torch.sharding.placement`):
flat FSDP, or under ``params_tp`` the decode weights TP-sharded over the
model axis (``ShardingPolicy._tp_spec``).  The activations stay whole, so
each group's weights are gathered whole as the group runs, TP shards
included: where the reference's column- and row-parallel products move
no weight bytes, the port moves each group's weights once a step.  A
model rests by one placement: a step under a policy that would place it
otherwise raises when it is built (the caller unplaces it first), and a
step without a policy runs the model as it rests.

:func:`state_spec` / :func:`tree_state_shardings` are the reference's
decode-state layout (batch over the data axes, the KV cache's sequence
over the model axis): the specs a caller places states by
(:class:`repro_torch.core.spmd.NamedSharding`, the checkpoint manager's
``restore(shardings=)``); the steps themselves keep the states whole on
the mesh's first device, as they keep the activations.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.spmd import NamedSharding, P
from repro_torch.sharding.constraints import use_policy
from repro_torch.sharding.placement import check_placement, place_model


def state_spec(policy, path_keys: tuple, shape: tuple) -> P:
    """Sharding spec for one decode-state leaf, the reference's rule:
    ``path_keys`` is the leaf's path (``groups`` in it marks the
    reference's stacked groups, whose leading dimension stays whole; the
    port's per-group leaves are given the stacked shape by
    :func:`tree_state_shardings`).  With no policy every dimension is
    whole."""
    if policy is None:
        return P(*([None] * len(shape)))
    dp = policy.dp_axes if policy.batch_sharded else None
    m = policy.model_axis
    n_model = policy.model_size
    stacked = "groups" in path_keys
    o = 1 if stacked else 0
    spec: list[Any] = [None] * len(shape)
    if (dp is not None and len(shape) > o
            and shape[o] % max(policy.dp_size, 1) == 0):
        spec[o] = dp
    if m is None or n_model <= 1:
        return P(*spec)
    last = path_keys[-1] if path_keys else ""
    if len(shape) - o == 4 and last in ("k", "v"):
        if policy.params_tp and shape[o + 1] % n_model == 0:
            spec[o + 1] = m              # TP serving: heads with their
            return P(*spec)              # head-sharded projections
        if shape[o + 2] % n_model == 0:
            spec[o + 2] = m              # sequence dim of the KV cache
        return P(*spec)
    # generic: largest trailing dim divisible by the model axis
    cands = [d for d in range(o + 1, len(shape)) if shape[d] % n_model == 0
             and shape[d] >= n_model]
    if cands:
        spec[max(cands, key=lambda d: shape[d])] = m
    return P(*spec)


def tree_state_shardings(policy, states):
    """The port's decode states (``{"groups": [per-group states] or None,
    "tail": [...]}``) mapped to :class:`NamedSharding` leaves.  A leaf of
    group ``g`` is decided on the shape the reference stacks the groups
    to, and loses the leading entry."""
    n_groups = len(states.get("groups") or ())

    def walk(tree, keys, stacked):
        if isinstance(tree, dict):
            return {k: walk(v, keys + (k,), stacked) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, keys + (i,), stacked)
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        shape = tuple(tree.shape)
        if stacked:
            spec = P(*state_spec(policy, keys, (n_groups,) + shape)[1:])
        else:
            spec = state_spec(policy, keys, shape)
        return NamedSharding(policy.mesh, spec)

    out = {}
    for key, sub in states.items():
        if key == "groups" and sub is not None:
            # the reference's path has no group index
            out[key] = [walk(g, ("groups",), True) for g in sub]
        else:
            out[key] = walk(sub, (key,), False)
    return out


def _placed_by(model, policy):
    """The placement a step under ``policy`` runs on (``None`` without a
    policy): an unplaced model is placed by it now, one placed otherwise
    raises (:func:`repro_torch.sharding.placement.place_model`)."""
    return None if policy is None else place_model(model, policy)


def make_prefill_step(model, policy=None, *, s_max: int):
    """The prefill under ``policy``, on the model placed at rest by it
    (:func:`_placed_by`; the step raises if the model is placed again
    later).  Without a policy the model runs as it rests: a placed
    model's groups are gathered whole at use."""
    placement = _placed_by(model, policy)

    def step(tokens, frames=None, pixels=None):
        if policy is not None:
            check_placement(model, placement)
        with use_policy(policy):
            return model.prefill(tokens, s_max=s_max, frames=frames,
                                 pixels=pixels)
    return step


def make_decode_step(model, policy=None):
    """A decode step under ``policy``, placed as :func:`make_prefill_step`
    places; without a policy the model runs as it rests."""
    placement = _placed_by(model, policy)

    def step(states, token, pos):
        if policy is not None:
            check_placement(model, placement)
        with use_policy(policy):
            return model.decode_step(states, token, pos)
    return step
