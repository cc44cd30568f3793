from lux_tpu_torch.graph.graph import Csr, Graph
from lux_tpu_torch.graph.format import (
    convert_edge_list,
    detect_layout,
    read_lux,
    read_lux_mmap,
    write_lux,
)
from lux_tpu_torch.graph.partition import edge_balanced_bounds, PartitionInfo
from lux_tpu_torch.graph.delta import DeltaGraph, EdgeEdits
from lux_tpu_torch.graph.snapshot import Snapshot, SnapshotStore
from lux_tpu_torch.graph.wal import (RecoveryResult, Wal, WalCorruptError,
                                     replay)
from lux_tpu_torch.graph import generate

__all__ = [
    "Csr",
    "Graph",
    "DeltaGraph",
    "EdgeEdits",
    "Snapshot",
    "SnapshotStore",
    "Wal",
    "WalCorruptError",
    "RecoveryResult",
    "replay",
    "read_lux",
    "read_lux_mmap",
    "write_lux",
    "convert_edge_list",
    "detect_layout",
    "edge_balanced_bounds",
    "PartitionInfo",
    "generate",
]
