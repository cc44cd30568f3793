from lux_tpu_torch.models.pagerank import PageRank

__all__ = ["PageRank"]
