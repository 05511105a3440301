"""Sharding policies and the activation hooks that read them."""

from .constraints import current_policy, shard_act, shard_param_slice, use_policy
from .policy import ShardingPolicy, make_policy

__all__ = ["ShardingPolicy", "current_policy", "make_policy", "shard_act",
           "shard_param_slice", "use_policy"]
