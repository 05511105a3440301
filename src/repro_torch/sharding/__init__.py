"""Sharding hooks for ``policy=None`` (one device); see :mod:`.constraints`."""

from .constraints import current_policy, shard_act, shard_param_slice, use_policy

__all__ = ["current_policy", "shard_act", "shard_param_slice", "use_policy"]
