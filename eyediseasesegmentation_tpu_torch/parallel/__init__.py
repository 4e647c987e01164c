"""Multi-GPU execution (torch port of ``eyediseasesegmentation_tpu/parallel``):
the process-group mesh and its collectives (``mesh``), the H-sharded
primitives (``spatial``) and the H-sharded flagship forward
(``spatial_model``, imported by name: it builds on the model zoo)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    replicate,
    local_device_count,
    pad_to_batch_multiple,
    spawn,
)
from .spatial import (
    halo_exchange,
    conv3x3_spatial,
    pool2x_spatial,
    upsample2x_spatial,
    spatial_predict,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "local_device_count",
    "pad_to_batch_multiple",
    "spawn",
    "halo_exchange",
    "conv3x3_spatial",
    "pool2x_spatial",
    "upsample2x_spatial",
    "spatial_predict",
]
