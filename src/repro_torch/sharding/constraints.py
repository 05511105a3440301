"""Activation-sharding hooks — ``repro/sharding/constraints.py``: Bind's
scope-guard idea at the mesh level.

Model code never mentions a mesh; it tags activations with semantic names
(``"residual"``, ``"kv_gathered"``, ``"ffn_hidden"``).  A
:class:`~repro_torch.sharding.policy.ShardingPolicy` is made active for a
block with :func:`use_policy` (thread-local, as the reference's), and the
layers that act on it explicitly read it with :func:`current_policy`: the
mixture of experts runs its ``shard_map`` over the policy's mesh.

In the reference each tag resolves to ``with_sharding_constraint`` under a
policy, which tells the partitioner where a value lies and never changes
it.  The port has no partitioner.  What rests as per-rank shards under a
policy is the parameters and the AdamW state
(:mod:`repro_torch.sharding.placement`, placed by the policy's train,
prefill and decode steps, each group's weights gathered whole as it
runs); the activations and the decode states stay whole on the mesh's
first device, since the ranks share one card and a split would only cut
every op into per-rank launches.  So :func:`shard_act` and
:func:`shard_param_slice` return their argument with or without a policy.
"""

from __future__ import annotations

import contextlib
import threading

_TLS = threading.local()


def current_policy():
    """The policy :func:`use_policy` made active on this thread, or
    ``None``."""
    return getattr(_TLS, "policy", None)


@contextlib.contextmanager
def use_policy(policy):
    """Make ``policy`` (or ``None``) the active one for the block."""
    prev = current_policy()
    _TLS.policy = policy
    try:
        yield policy
    finally:
        _TLS.policy = prev


def shard_act(x, tag: str):
    """``x``: a sharding constraint places a value and never changes it."""
    return x


def shard_param_slice(tree):
    """``tree``: as :func:`shard_act`, for a layer's parameters."""
    return tree
