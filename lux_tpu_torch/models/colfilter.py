"""Collaborative filtering (pull model), the counterpart of
``lux_tpu/models/colfilter.py``.

SGD matrix factorization on a weighted bipartite graph. Reference
semantics (col_filter/colfilter_gpu.cu:32-104, app.h:25-28): a latent
vector in R^K (K = 20) per vertex, initialized to sqrt(1/K)
(colfilter_gpu.cu:260-263); one iteration updates every vertex from its
in-edges (ratings):

    err_e  = weight_e - <vec[src_e], vec[dst_e]>
    acc_v  = sum over the in-edges of err_e * vec[src_e]
    vec'_v = vec_v + GAMMA * (acc_v - LAMBDA * vec_v)

On the card ``PullExecutor`` computes ``acc`` with kernel K9
(``edge_op = "cf_sgd"``, ``csrc/pull_sum.cu``); ``apply`` is plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.engine.program import EdgeCtx, PullProgram, VertexCtx

K = 20            # col_filter/app.h:27
LAMBDA = 0.001    # col_filter/app.h:25
GAMMA = 0.00000035  # col_filter/app.h:26
# Edges per window of the oracle and of rmse: (window, K) float64 arrays
# stay near 0.7 GB however large the graph.
WINDOW = 1 << 22


class CollaborativeFiltering(PullProgram):
    name = "colfilter"
    combiner = "sum"
    value_dtype = torch.float32
    value_shape = (K,)
    needs_weights = True
    servable = False   # training workload: CLI/bench only, not a query app
    edge_op = "cf_sgd"

    def init_values(self, graph) -> np.ndarray:
        value = np.sqrt(1.0 / K).astype(np.float32)
        return np.full((graph.nv, K), value, dtype=np.float32)

    def edge_contrib(self, edge: EdgeCtx) -> torch.Tensor:
        dot = (edge.src_vals * edge.dst_vals).sum(-1)          # (ne,)
        err = edge.weights.to(torch.float32) - dot
        return err[:, None] * edge.src_vals                    # (ne, K)

    def apply(self, old_vals, acc, ctx: VertexCtx):
        return old_vals + GAMMA * (acc - LAMBDA * old_vals)


def _windows(ne: int, window: int):
    return ((lo, min(lo + window, ne)) for lo in range(0, ne, window))


def reference_colfilter(graph, num_iters: int, window: int = WINDOW,
                        device=None) -> np.ndarray:
    """Float64 oracle: ``lux_tpu``'s ``reference_colfilter`` over edge
    windows of ``window`` edges, so it stays usable at 10^8 edges.

    On the host it sums each window per destination with one
    ``np.bincount`` per column, in edge order as ``np.add.at`` does: with
    a single window the result equals ``lux_tpu``'s bit for bit. With
    ``device`` the same float64 loop runs in torch on that device
    (``index_add_``)."""
    assert graph.weights is not None
    if device is not None:
        return _reference_torch(graph, num_iters, window,
                                torch.device(device))
    nv = graph.nv
    vec = np.full((nv, K), np.sqrt(1.0 / K), dtype=np.float64)
    dst_all, src_all = graph.col_dst, graph.col_src
    for _ in range(num_iters):
        acc = np.zeros_like(vec)
        for lo, hi in _windows(graph.ne, window):
            dst, sv = dst_all[lo:hi], vec[src_all[lo:hi]]
            w = graph.weights[lo:hi].astype(np.float64)
            err = w - np.sum(sv * vec[dst], axis=-1)
            contrib = err[:, None] * sv
            for k in range(K):
                acc[:, k] += np.bincount(dst, weights=contrib[:, k],
                                         minlength=nv)
        vec = vec + GAMMA * (acc - LAMBDA * vec)
    return vec.astype(np.float32)


def _reference_torch(graph, num_iters, window, dev) -> np.ndarray:
    vec = torch.full((graph.nv, K), float(np.sqrt(1.0 / K)),
                     dtype=torch.float64, device=dev)
    src_all = torch.from_numpy(graph.col_src).to(dev)
    dst_all = torch.from_numpy(graph.col_dst).to(dev)
    w_all = torch.from_numpy(graph.weights).to(dev)
    for _ in range(num_iters):
        acc = torch.zeros_like(vec)
        for lo, hi in _windows(graph.ne, window):
            dst = dst_all[lo:hi].long()
            sv = vec[src_all[lo:hi].long()]
            err = w_all[lo:hi].double() - (sv * vec[dst]).sum(-1)
            acc.index_add_(0, dst, err[:, None] * sv)
        vec = vec + GAMMA * (acc - LAMBDA * vec)
    return vec.float().cpu().numpy()


def rmse(graph, vec, window: int = WINDOW, device=None) -> float:
    """Root-mean-square rating error, the quantity CF training reduces,
    in float64 over edge windows (on ``device`` when given)."""
    dev = torch.device("cpu" if device is None else device)
    v = torch.as_tensor(np.asarray(vec)).to(dev, torch.float64)
    src_all = torch.from_numpy(graph.col_src).to(dev)
    dst_all = torch.from_numpy(graph.col_dst).to(dev)
    w_all = torch.from_numpy(graph.weights).to(dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for lo, hi in _windows(graph.ne, window):
        dot = (v[src_all[lo:hi].long()] * v[dst_all[lo:hi].long()]).sum(-1)
        total += ((w_all[lo:hi].double() - dot) ** 2).sum()
    return float(torch.sqrt(total / max(graph.ne, 1)))


def main(argv=None):
    """CLI:

        python -m lux_tpu_torch.models.colfilter -file g.lux -ni 10
    """
    from lux_tpu_torch.models.cli import run_pull_app

    return run_pull_app(
        CollaborativeFiltering(),
        argv,
        oracle=lambda g, ni: reference_colfilter(g, ni),
    )


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
