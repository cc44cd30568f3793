"""Port parity: the R-MAT generator's threaded draws and the packed
stable sort of ``Graph.from_edges``, byte for byte against lux_tpu's
generator.

``rmat`` draws each chunk of a batch's edges on its own thread from a
copy of the stream jumped to its draws, keeps pass 1's batches for pass
2 up to ``RMAT_KEEP_EDGES`` edges, and sorts them with
``stable_argsort``; ``tests/test_torch_graph.py``'s graphs fit in one
chunk and one batch, so here the chunk, the batch and the keep limit are
small enough that every path splits.
"""

import numpy as np
import pytest

from lux_tpu.graph import generate as jgen
from lux_tpu_torch.graph import generate as tgen


def _same(a, b):
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("chunk", [1000, 4096])
def test_rmat_chunks_and_batches_match_lux_tpu(chunk, keep, weighted,
                                               monkeypatch):
    monkeypatch.setattr(tgen, "RMAT_CHUNK", chunk)
    if not keep:
        monkeypatch.setattr(tgen, "RMAT_KEEP_EDGES", 0)
    kw = dict(seed=11, weighted=weighted, batch=3000)
    got, want = tgen.rmat(10, 8, **kw), jgen.rmat(10, 8, **kw)
    _same(got.row_ptr, want.row_ptr)
    _same(got.col_src, want.col_src)
    if weighted:
        _same(got.weights, want.weights)


def test_rmat_edges_stream_matches_lux_tpu(monkeypatch):
    monkeypatch.setattr(tgen, "RMAT_CHUNK", 777)
    got = list(tgen.rmat_edges(9, 5000, seed=3, batch=2048))
    want = list(jgen.rmat_edges(9, 5000, seed=3, batch=2048))
    assert len(got) == len(want) == 3
    for (gs, gd), (ws, wd) in zip(got, want):
        _same(gs, ws)
        _same(gd, wd)


@pytest.mark.parametrize("weighted", [False, True])
def test_from_edges_matches_lux_tpu(weighted):
    rng = np.random.default_rng(5)
    src = rng.integers(0, 3000, 40000)
    dst = rng.integers(0, 3000, 40000)
    w = rng.integers(1, 100, 40000, dtype=np.int32) if weighted else None
    got = tgen.Graph.from_edges(src, dst, nv=3000, weights=w)
    want = jgen.Graph.from_edges(src, dst, nv=3000, weights=w)
    _same(got.row_ptr, want.row_ptr)
    _same(got.col_src, want.col_src)
    if weighted:
        _same(got.weights, want.weights)
