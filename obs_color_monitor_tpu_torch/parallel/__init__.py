"""Device-mesh scaling over torch.distributed: batch data-parallel and
row-sharded analysis with an all-reduce merge of the counts (counterpart
of ``obs_color_monitor_tpu/parallel``)."""

from .mesh import (
    BATCH_AXIS,
    SPATIAL_AXIS,
    batch_analyze,
    make_mesh,
    mesh_device,
    shard_batch,
    shard_rows,
    spatial_analyze,
    spatial_pipeline,
)

__all__ = [
    "BATCH_AXIS",
    "SPATIAL_AXIS",
    "batch_analyze",
    "make_mesh",
    "mesh_device",
    "shard_batch",
    "shard_rows",
    "spatial_analyze",
    "spatial_pipeline",
]
