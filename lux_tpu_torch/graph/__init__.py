from lux_tpu_torch.graph.graph import Csr, Graph
from lux_tpu_torch.graph.format import (
    convert_edge_list,
    detect_layout,
    read_lux,
    read_lux_mmap,
    write_lux,
)
from lux_tpu_torch.graph import generate

__all__ = [
    "Csr",
    "Graph",
    "read_lux",
    "read_lux_mmap",
    "write_lux",
    "convert_edge_list",
    "detect_layout",
    "generate",
]
