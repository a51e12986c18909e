"""repro_torch.dist — the device mesh the distributed stencil executor
runs over, and the LM's sharding rules over a ``DeviceMesh`` (the port of
``repro.dist``), with the placement of live tensors by them: the port's
``NamedSharding`` and ``device_put`` (``place``, ``place_params``,
``place_batch``)."""

from .sharding import (Mesh, NamedSharding, ShardingRules,
                       activation_context, batch_sharding, cache_specs,
                       make_auto_mesh, named_shardings, param_specs, place,
                       place_batch, place_params, placements,
                       shard_activation)

__all__ = ["Mesh", "NamedSharding", "ShardingRules", "activation_context",
           "batch_sharding", "cache_specs", "make_auto_mesh",
           "named_shardings", "param_specs", "place", "place_batch",
           "place_params", "placements", "shard_activation"]
