"""Process groups, device meshes and sharding helpers (``torch.distributed``)."""

from semanticlens_tpu_torch.core.mesh import (
    ShardedRows,
    backend_reachable,
    data_mesh,
    data_model_mesh,
    enable_compilation_cache,
    init_distributed,
    replicate,
    shard_batch,
    shard_concept_db,
)

__all__ = ["ShardedRows", "backend_reachable", "data_mesh", "data_model_mesh", "enable_compilation_cache",
           "init_distributed", "replicate", "shard_batch", "shard_concept_db"]
