"""Activation-sharding hooks of the reference (``repro/sharding/
constraints.py``) for one device: with no policy active every hook is the
identity, as the reference's are.

Model code tags activations with semantic names (``"residual"``,
``"kv_gathered"``, ``"ffn_hidden"``) and calls these hooks; the port runs
the LM stack (serving and training) on one card, so the only policy is
``None``.  A sharding policy (``repro/sharding/policy.py``, the LM
stack's last module, which the mixture of experts' expert-parallel path
needs) comes with the multi-device slice: asking for one raises
:class:`ValueError` until then.
"""

from __future__ import annotations

import contextlib


def _refuse(policy) -> None:
    if policy is not None:
        raise ValueError(
            f"sharding policy {policy!r}: the port runs the LM stack on one "
            f"device with policy=None; sharding policies "
            f"(repro/sharding/policy.py, and with them the mixture of "
            f"experts' expert-parallel path) come with Slice 3 "
            f"(multi-device, ROADMAP Queue 1)")


def current_policy():
    """The active policy: always ``None`` in the port."""
    return None


@contextlib.contextmanager
def use_policy(policy):
    """Activate ``policy`` for the block; only ``None`` is accepted."""
    _refuse(policy)
    yield policy


def shard_act(x, tag: str):
    """Identity: no policy is active."""
    return x


def shard_param_slice(tree):
    """Identity: no policy is active."""
    return tree
