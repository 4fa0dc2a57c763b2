"""Distribution layer: meshes of ranks, sharding rules, the process group,
and the tensor-parallel kernel wrappers."""

from .distributed import (all_gather, all_reduce, broadcast_from_primary,
                          global_batch, init_distributed, is_primary,
                          make_hybrid_mesh, process_chunk, replicate, sync)
from .mesh import (Mesh, kv_state_shardings, make_mesh, param_shardings,
                   shard_kv_state, shard_params)

__all__ = ["Mesh", "all_gather", "all_reduce", "broadcast_from_primary",
           "global_batch", "init_distributed", "is_primary",
           "kv_state_shardings", "make_hybrid_mesh", "make_mesh",
           "param_shardings", "process_chunk", "replicate",
           "shard_kv_state", "shard_params", "sync"]
