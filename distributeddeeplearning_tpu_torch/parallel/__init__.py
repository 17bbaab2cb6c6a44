"""Parallelism for the port: the process mesh, process-group start-up,
collectives, the partition-rule layout table, batch layout and the
explicit gradient comms, and the logical-axis rules of training.  Data,
fsdp (ZeRO-3) and tensor (Megatron) parallelism train; a tensor axis also
serves (``serve.engine.tensor_parallel_engine``).  One process drives
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
    require_ported,
    tensor_parallel_size,
    world_size,
)
from distributeddeeplearning_tpu_torch.parallel.sharding import (
    LAYOUT_RULES,
    RULES_DP,
    RULES_EP,
    RULES_FSDP,
    RULES_TP,
    ParamLayout,
    layout_rules_provenance,
    logical_to_spec,
    match_partition_rules,
    param_shardings,
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
    "require_ported",
    "tensor_parallel_size",
    "world_size",
    "LAYOUT_RULES",
    "RULES_DP",
    "RULES_EP",
    "RULES_FSDP",
    "RULES_TP",
    "ParamLayout",
    "layout_rules_provenance",
    "logical_to_spec",
    "match_partition_rules",
    "param_shardings",
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
