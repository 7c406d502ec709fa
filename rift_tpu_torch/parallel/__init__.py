from .mesh import make_mesh, replicate, shard_batch
from .multihost import (
    global_mesh,
    host_local_batch,
    init_distributed,
    replicate_global,
)

__all__ = [
    "make_mesh", "shard_batch", "replicate",
    "init_distributed", "global_mesh", "host_local_batch",
    "replicate_global",
]
