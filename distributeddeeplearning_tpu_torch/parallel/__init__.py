"""Parallelism for the port: the process mesh, process-group start-up,
collectives, the partition-rule layout table, batch layout and the
explicit gradient comms.  Data parallelism trains (ROADMAP A5); a tensor
axis serves (``serve.engine.tensor_parallel_engine``).  One process drives
one device, as under Horovod; the communicator is a ``torch.distributed``
process group (NCCL on the card, gloo on the CPU)."""

from distributeddeeplearning_tpu_torch.parallel import comms
from distributeddeeplearning_tpu_torch.parallel.distributed import (
    DistributedContext,
    initialize,
    is_primary,
    process_count,
    process_index,
    shutdown,
)
from distributeddeeplearning_tpu_torch.parallel.mesh import (
    MeshSpec,
    create_mesh,
    data_parallel_size,
    local_device_count,
    require_data_only,
    tensor_parallel_size,
    world_size,
)
from distributeddeeplearning_tpu_torch.parallel.sharding import (
    LAYOUT_RULES,
    layout_rules_provenance,
    match_partition_rules,
    replicate_params,
    shard_batch,
    shard_params,
    spec_for,
)

__all__ = [
    "comms",
    "MeshSpec",
    "create_mesh",
    "data_parallel_size",
    "local_device_count",
    "require_data_only",
    "tensor_parallel_size",
    "world_size",
    "LAYOUT_RULES",
    "layout_rules_provenance",
    "match_partition_rules",
    "replicate_params",
    "shard_batch",
    "shard_params",
    "spec_for",
    "DistributedContext",
    "initialize",
    "is_primary",
    "process_count",
    "process_index",
    "shutdown",
]
