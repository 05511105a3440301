"""Sharding policies, the activation hooks that read them, and the
parameters' placement at rest under a policy."""

from .constraints import current_policy, shard_act, shard_param_slice, use_policy
from .placement import Placement, place_model, placement_of, unplace
from .policy import ShardingPolicy, make_policy

__all__ = ["Placement", "ShardingPolicy", "current_policy", "make_policy",
           "place_model", "placement_of", "shard_act", "shard_param_slice",
           "unplace", "use_policy"]
