from lux_tpu_torch.models.colfilter import CollaborativeFiltering
from lux_tpu_torch.models.components import ConnectedComponents
from lux_tpu_torch.models.pagerank import PageRank
from lux_tpu_torch.models.sssp import SSSP

__all__ = ["CollaborativeFiltering", "ConnectedComponents", "PageRank",
           "SSSP"]
