from .mesh import Mesh, make_mesh, sharded_sampling_plan, shard_batch

__all__ = ["Mesh", "make_mesh", "sharded_sampling_plan", "shard_batch"]
