"""The sharded path (port of deepflow_tpu/parallel): the (host, chip)
mesh, per-shard pipelines with the cross-shard sketch merges, and the
shard-group topology."""

from .mesh import make_mesh
from .sharded import ShardedPipeline, SketchPlanes
from .topology import MeshTopology, key_shard_group

__all__ = [
    "make_mesh",
    "ShardedPipeline",
    "SketchPlanes",
    "MeshTopology",
    "key_shard_group",
]
