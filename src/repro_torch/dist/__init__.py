"""repro_torch.dist — the device mesh the distributed stencil executor
runs over, and the LM's sharding rules over a ``DeviceMesh`` (the port of
``repro.dist``)."""

from .sharding import (Mesh, ShardingRules, activation_context,
                       batch_sharding, cache_specs, make_auto_mesh,
                       named_shardings, param_specs, placements,
                       shard_activation)

__all__ = ["Mesh", "ShardingRules", "activation_context", "batch_sharding",
           "cache_specs", "make_auto_mesh", "named_shardings", "param_specs",
           "placements", "shard_activation"]
