from lux_tpu_torch.parallel.mesh import PARTS_AXIS, LocalMesh, make_mesh
from lux_tpu_torch.parallel.shard import ShardedGraph

__all__ = ["make_mesh", "LocalMesh", "PARTS_AXIS", "ShardedGraph"]
