"""Carry the reference's parameters and decode states into the port.

The reference keeps parameters and states as nested dicts and lists of
arrays, with the pattern groups stacked: every leaf under ``groups`` (and
under an encoder's ``enc.groups``) has a leading axis of the number of
groups.  The port keeps one tensor per layer (``groups.<g>.b<i>...``).
Every subtree is carried the same way: the experts of a mixture
(``moe.experts``, stacked over experts, not groups), the xLSTM blocks'
leaves, and in the states the ``{"self", "cross"}`` pairs of an
encoder-decoder and the xLSTM states (mLSTM ``C, n, m, conv``, sLSTM
``c, n, h, m``).  :func:`port_tree` unstacks the groups;
:func:`carry_params` copies a tree of arrays into a
:class:`~repro_torch.models.model.LanguageModel` by name, and
:func:`carry_states` makes the port's decode states of a reference state
tree.  Leaves are NumPy arrays (or anything ``np.asarray`` takes, such as
a jax array); a bfloat16 leaf (``ml_dtypes.bfloat16``) is carried bit for
bit through a ``uint16`` view (:func:`repro_torch.compat.to_torch`), never
through float32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.compat import to_torch


def leaves(tree: Any, prefix: str = "") -> dict:
    """``{dotted path: leaf}`` of a tree of dicts and lists (``None``
    subtrees have no leaves)."""
    out = {}
    if isinstance(tree, dict):
        for key, sub in tree.items():
            out.update(leaves(sub, f"{prefix}{key}."))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            out.update(leaves(sub, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def port_tree(tree: dict) -> dict:
    """The reference's tree with its stacked ``groups`` split into a list
    of per-group trees (leading axis ``g`` -> list index ``g``), the
    encoder's (``enc.groups``) too."""
    out = dict(tree)
    groups = tree.get("groups")
    if groups is not None:
        n = np.shape(next(iter(leaves(groups).values())))[0]
        out["groups"] = [_map(lambda leaf, g=g: np.asarray(leaf)[g], groups)
                         for g in range(n)]
    if isinstance(tree.get("enc"), dict):
        out["enc"] = port_tree(tree["enc"])
    return out


@torch.no_grad()
def carry_params(model: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Copy the reference's parameter tree ``params`` into ``model``: every
    leaf into the parameter of the same path, which must have its shape
    and dtype; a leaf without a parameter, or a parameter without a leaf,
    raises :class:`ValueError`.  Returns ``model``."""
    theirs = leaves(port_tree(params))
    ours = dict(model.named_parameters())
    if set(theirs) != set(ours):
        raise ValueError(
            f"parameter trees differ: only in the reference "
            f"{sorted(set(theirs) - set(ours))}, only in the port "
            f"{sorted(set(ours) - set(theirs))}")
    for name, leaf in theirs.items():
        param = ours[name]
        t = to_torch(np.asarray(leaf), param.device)
        if t.shape != param.shape or t.dtype != param.dtype:
            raise ValueError(f"{name}: reference {tuple(t.shape)} {t.dtype}, "
                             f"port {tuple(param.shape)} {param.dtype}")
        param.copy_(t)
    return model


def carry_states(states: dict, device) -> dict:
    """The port's decode states (groups as a list) holding the values of
    the reference's state tree ``states``, on ``device`` (copies: decode
    writes its caches in place)."""
    return _map(lambda leaf: to_torch(np.array(leaf), device),
                port_tree(states))
