"""Parallel layouts on torch.distributed: device mesh, sharding rules,
distributed metrics, multi-process runtime (port of `tpu_deer/parallel/`).
Sequence (ring attention), pipeline (GPipe) and expert parallelism
(`shard_moe_params`) are not ported yet."""

from tpu_deer_torch.parallel.dist_metrics import global_ccc_stats, psum_tree
from tpu_deer_torch.parallel.mesh import (
    MeshConfig,
    batch_sharding,
    create_mesh,
    fsdp_sharding_rules,
    param_sharding_rules,
    replicated_sharding,
    shard_batch,
    shard_params,
)
from tpu_deer_torch.parallel.runtime import (
    DistributedRuntime,
    RuntimeConfig,
    initialize_runtime,
    shutdown_runtime,
)
