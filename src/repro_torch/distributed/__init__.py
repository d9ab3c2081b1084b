"""Distribution: logical-axis sharding rules, meshes of torch devices,
sharded tile execution and the training loop's fault tolerance (the port
of ``src/repro/distributed``)."""
from .sharding import (RULES, constrain, current_mesh, named_sharding,
                       resolve_spec, tree_shardings, use_mesh)

__all__ = ["RULES", "constrain", "current_mesh", "named_sharding",
           "resolve_spec", "tree_shardings", "use_mesh"]
