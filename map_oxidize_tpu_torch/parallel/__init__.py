"""The sharded engines on a mesh of device slots: the mesh and its
collectives, the hash-bucket exchange, the sharded reduce engine (the JAX
package's ``parallel/__init__.py``), with the sharded collect and k-means
in :mod:`.collect` and :mod:`.kmeans`, and the multi-process drivers over
a process group in :mod:`.distributed` and :mod:`.dataflow`."""

from map_oxidize_tpu_torch.parallel.engine import (
    ShardedReduceEngine,
    ShuffleOverflowError,
)
from map_oxidize_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, make_mesh
from map_oxidize_tpu_torch.parallel.shuffle import bucket_of, build_sharded_ops

__all__ = [
    "SHARD_AXIS",
    "Mesh",
    "ShardedReduceEngine",
    "ShuffleOverflowError",
    "bucket_of",
    "build_sharded_ops",
    "make_mesh",
]
