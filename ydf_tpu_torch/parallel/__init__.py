"""Training on several devices (counterpart of ydf_tpu/parallel)."""

from ydf_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEATURE_AXIS,
    Mesh,
    init_distributed,
    make_mesh,
    shard_batch,
    shard_batch_and_features,
)

__all__ = [
    "DATA_AXIS",
    "FEATURE_AXIS",
    "Mesh",
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "shard_batch_and_features",
]
