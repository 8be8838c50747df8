from .mesh import (Mesh, all_reduce_sum, batch_mesh, get_mesh,
                   local_device_count, mesh_from_env, shard_batch,
                   sharded_batch, shutdown, unshard, world_size_from_env)

__all__ = [
    "Mesh", "all_reduce_sum", "batch_mesh", "get_mesh", "local_device_count",
    "mesh_from_env", "shard_batch", "sharded_batch", "shutdown", "unshard",
    "world_size_from_env",
]
