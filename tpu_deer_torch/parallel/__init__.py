"""Parallel layouts on torch.distributed: device mesh, sharding rules,
distributed metrics, multi-process runtime, ring-attention sequence
parallelism, the GPipe pipeline and expert-parallel MoE placement (port of
`tpu_deer/parallel/`)."""

from tpu_deer_torch.parallel.dist_metrics import global_ccc_stats, psum_tree
from tpu_deer_torch.parallel.mesh import (
    MeshConfig,
    batch_sharding,
    create_mesh,
    expert_parallel,
    fsdp_sharding_rules,
    param_sharding_rules,
    replicated_sharding,
    shard_batch,
    shard_moe_params,
    shard_params,
)
from tpu_deer_torch.parallel.pipeline import pipeline_apply, pipeline_sharded
from tpu_deer_torch.parallel.runtime import (
    DistributedRuntime,
    RuntimeConfig,
    initialize_runtime,
    shutdown_runtime,
)
from tpu_deer_torch.parallel.sequence import ring_attention, ring_attention_sharded
