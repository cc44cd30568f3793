from lux_tpu_torch.parallel.mesh import (
    PARTS_AXIS,
    DistMesh,
    LocalMesh,
    make_mesh,
)
from lux_tpu_torch.parallel.multihost import initialize, make_global_mesh
from lux_tpu_torch.parallel.shard import ShardedGraph

__all__ = ["make_mesh", "LocalMesh", "DistMesh", "PARTS_AXIS",
           "ShardedGraph", "initialize", "make_global_mesh"]
