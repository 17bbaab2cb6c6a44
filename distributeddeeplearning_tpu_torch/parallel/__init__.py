"""Data parallelism for the port: the process mesh, process-group
start-up, collectives, batch layout and the explicit gradient comms
(ROADMAP A5).  One process drives one device, as under Horovod; the
communicator is a ``torch.distributed`` process group (NCCL on the card,
gloo on the CPU)."""

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
    world_size,
)
from distributeddeeplearning_tpu_torch.parallel.sharding import (
    replicate_params,
    shard_batch,
)

__all__ = [
    "comms",
    "MeshSpec",
    "create_mesh",
    "data_parallel_size",
    "local_device_count",
    "world_size",
    "replicate_params",
    "shard_batch",
    "DistributedContext",
    "initialize",
    "is_primary",
    "process_count",
    "process_index",
    "shutdown",
]
