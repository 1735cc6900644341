"""Sharded parameter server: partitioned weight store + per-shard gating.

See ``plan.py`` for the shard plan format, ``server.py`` for the
threaded runtime and ``simulator.py`` for the virtual-time instrument.
"""

from repro_torch.ps.sharded.plan import (LeafSlice, Shard, ShardPlan,
                                         WireLayout, build_shard_plan)
from repro_torch.ps.sharded.server import ShardedParameterServer
from repro_torch.ps.sharded.simulator import (ShardedPSSimulator,
                                              hot_shard_service,
                                              run_sharded_policy)

__all__ = [
    "LeafSlice", "Shard", "ShardPlan", "WireLayout", "build_shard_plan",
    "ShardedParameterServer",
    "ShardedPSSimulator", "run_sharded_policy", "hot_shard_service",
]
