"""Sharding rules on DTensor: the port of ``repro.sharding``."""
from .rules import (ShardingRules, Spec, constrain, dp_world,  # noqa: F401
                    make_rules, sharding_scope)
