"""Sharding rules of the port: logical axes -> mesh axes for every param,
cache, optimizer, batch and walker-batch leaf (``rules``)."""
from repro_torch.sharding.rules import (
    PROFILES,
    batch_specs,
    cache_specs,
    fleet_specs,
    named_shardings,
    opt_state_specs,
    param_specs,
    resolve_walker_axis,
    spec_for_leaf,
    walker_batch_specs,
)

__all__ = [
    "PROFILES",
    "spec_for_leaf",
    "param_specs",
    "batch_specs",
    "cache_specs",
    "opt_state_specs",
    "named_shardings",
    "resolve_walker_axis",
    "walker_batch_specs",
    "fleet_specs",
]
