"""PageRank (pull model), the counterpart of ``lux_tpu/models/pagerank.py``.

Semantics match the reference exactly (pagerank/pagerank_gpu.cu:49-102 and
:239-245 for init; pagerank/app.h:24 for ALPHA):

- stored vertex value is the rank **pre-divided by out-degree**, so the
  gather side adds plain ``old[src]`` per in-edge;
- update:  ``r = (1-ALPHA)/nv + ALPHA * Σ_in old[src]``, then
  ``r /= out_degree`` unless the out-degree is zero;
- init:    ``(1/nv) / out_degree`` (plain ``1/nv`` for sinks).

ALPHA = 0.15 multiplies the *neighbor sum*, the reference's orientation.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.engine.program import EdgeCtx, PullProgram, VertexCtx
from lux_tpu_torch.utils.host import host_threads, run_parts

ALPHA = 0.15  # pagerank/app.h:24


class PageRank(PullProgram):
    name = "pagerank"
    combiner = "sum"
    value_dtype = torch.float32
    identity_contrib = True  # gather side is plain old[src] (pre-divided)
    edge_op = "copy"         # K8 in the flat PullExecutor

    def init_values(self, graph) -> np.ndarray:
        rank = np.float32(1.0) / np.float32(graph.nv)
        deg = graph.out_degrees
        safe = np.maximum(deg, 1).astype(np.float32)
        return np.where(deg == 0, rank, rank / safe).astype(np.float32)

    def edge_contrib(self, edge: EdgeCtx) -> torch.Tensor:
        return edge.src_vals

    def apply(self, old_vals, acc, ctx: VertexCtx):
        init_rank = (1.0 - ALPHA) / ctx.nv
        r = init_rank + ALPHA * acc
        deg = ctx.out_degrees.to(r.dtype)
        return torch.where(ctx.out_degrees == 0, r, r / deg)


def true_ranks(stored: np.ndarray, out_degrees: np.ndarray) -> np.ndarray:
    """Undo the pre-division: the actual PageRank mass per vertex."""
    return np.where(out_degrees == 0, stored, stored * out_degrees)


def reference_pagerank(graph, num_iters: int) -> np.ndarray:
    """Host numpy oracle in f64 (same stored-pre-divided convention).

    ``np.bincount`` with weights gives the same f64 per-destination sums
    as ``np.add.at`` (both add in edge order) and stays fast at R-MAT
    scale 22. The destinations are cut into ranges of about equal edge
    counts, one bincount each on the host's threads: each destination's
    edges are added in the same order, so the sums are the same."""
    deg = graph.out_degrees.astype(np.float64)
    rank = np.full(graph.nv, 1.0 / graph.nv, dtype=np.float64)
    vals = np.where(deg == 0, rank, rank / np.maximum(deg, 1))
    dst = graph.col_dst
    rp = graph.row_ptr
    cuts = np.searchsorted(rp, np.linspace(0, graph.ne, host_threads() + 1))
    cuts[0], cuts[-1] = 0, graph.nv
    ranges = [(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
    acc = np.zeros(graph.nv, dtype=np.float64)

    def part(vr):
        v0, v1 = vr
        e0, e1 = int(rp[v0]), int(rp[v1])
        acc[v0:v1] = np.bincount(dst[e0:e1] - v0,
                                 weights=vals[graph.col_src[e0:e1]],
                                 minlength=v1 - v0)

    for _ in range(num_iters):
        run_parts(part, ranges)
        r = (1.0 - ALPHA) / graph.nv + ALPHA * acc
        vals = np.where(deg == 0, r, r / np.maximum(deg, 1))
    return vals.astype(np.float32)


def main(argv=None):
    """CLI:

        python -m lux_tpu_torch.models.pagerank -file g.lux -ni 10 [-check]
    """
    from lux_tpu_torch.models.cli import run_pull_app

    return run_pull_app(
        PageRank(),
        argv,
        oracle=lambda g, ni: reference_pagerank(g, ni),
    )


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
