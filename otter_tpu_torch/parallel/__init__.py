"""The parallel layer (counterpart of `otter_tpu/parallel/`): process
bootstrap (`distributed.py`), the ("data", "fsdp", "seq", "tensor") mesh
(`mesh.py`), the partition rules and their application (`sharding.py`),
the dtype policy (`precision.py`) and differentiable collectives
(`collectives.py`)."""

from otter_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    TENSOR_AXIS,
    batch_sharding,
    create_mesh,
    local_mesh_for_testing,
    shard_batch,
)
