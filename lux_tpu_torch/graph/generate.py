"""Synthetic graph generators (for tests and benchmarks).

The reference ships no generator — its benchmark graphs (Hollywood, Twitter,
RMAT27, ... README.md:79-86) are downloaded. We generate R-MAT graphs of the
same family locally for benchmarking, plus tiny deterministic graphs for
unit tests.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from lux_tpu_torch.graph.graph import Graph, stable_argsort
from lux_tpu_torch.utils.host import run_parts

# Edges of one thread's share of a batch: small enough that its arrays
# stay in the core's cache across the bit levels.
RMAT_CHUNK = 1 << 18
# Up to this many edges, rmat() keeps pass 1's batches for pass 2 (8
# bytes an edge) instead of drawing them again.
RMAT_KEEP_EDGES = 1 << 28


def rmat_edges(
    scale: int,
    ne: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    batch: int = 1 << 24,
):
    """Yield (src, dst) int64 batches of an R-MAT graph with 2**scale
    vertices. Vectorized one bit-level at a time; streamed in batches so
    RMAT27-sized generation stays within memory.

    Bit level k of a batch of n edges takes draws k * n .. k * n + n - 1
    of the batch's share of one ``default_rng(seed)`` stream (one 64-bit
    draw a double), as ``lux_tpu``'s generator draws them level by
    level. Each chunk of edges jumps a copy of the stream to its draws
    (``PCG64.advance``), so the chunks run on the host's threads and the
    edges are the same, byte for byte."""
    base = np.random.PCG64(seed).state
    drawn = 0
    remaining = ne
    while remaining > 0:
        n = min(batch, remaining)
        src = np.empty(n, dtype=np.int64)
        dst = np.empty(n, dtype=np.int64)

        def chunk(lo: int, n=n, src=src, dst=dst, drawn=drawn) -> None:
            hi = min(lo + RMAT_CHUNK, n)
            s = np.zeros(hi - lo, dtype=np.int64)
            d = np.zeros(hi - lo, dtype=np.int64)
            bg = np.random.PCG64()
            gen = np.random.Generator(bg)
            for k in range(scale):
                bg.state = base
                bg.advance(drawn + k * n + lo)
                u = gen.random(hi - lo)
                # Quadrant probs: (0,0)=a, (0,1)=b, (1,0)=c, (1,1)=d.
                src_bit = u >= a + b
                dst_bit = ((u >= a) & (u < a + b)) | (u >= a + b + c)
                s = (s << 1) | src_bit
                d = (d << 1) | dst_bit
            src[lo:hi] = s
            dst[lo:hi] = d

        run_parts(chunk, list(range(0, n, RMAT_CHUNK)))
        yield src, dst
        drawn += scale * n
        remaining -= n


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    weighted: bool = False,
    max_weight: int = 100,
    batch: int = 1 << 24,
) -> Graph:
    """R-MAT graph with ``nv = 2**scale`` vertices and ``nv * edge_factor``
    edges (Graph500 parameters by default; RMAT27 ⇒ scale=27, ef=16).

    Builds the CSC out-of-core-style: two generation passes over identical
    batches (first: in-degree histogram → row_ptr; second: counting-sort
    placement), so peak memory is the output arrays plus one batch — never
    the full int64 edge list. This is the "out-of-core graph build for
    RMAT27" requirement of SURVEY.md §7(e).
    """
    nv = 1 << scale
    ne = nv * edge_factor

    def batches():
        return rmat_edges(scale, ne, a=a, b=b, c=c, seed=seed, batch=batch)

    # Pass 1: in-degree histogram. A graph of up to RMAT_KEEP_EDGES edges
    # keeps its batches (int32 ids) for pass 2 instead of drawing them
    # again.
    keep = ne <= RMAT_KEEP_EDGES and scale < 32
    kept = []
    in_deg = np.zeros(nv, dtype=np.int64)
    for s, d in batches():
        in_deg += np.bincount(d, minlength=nv)
        if keep:
            kept.append((s.astype(np.int32), d.astype(np.int32)))
    row_ptr = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(in_deg, out=row_ptr[1:])

    # Pass 2: the same batches again, each counting-sorted into place.
    col_src = np.empty(ne, dtype=np.int32)
    w_out = np.empty(ne, dtype=np.int32) if weighted else None
    wrng = np.random.default_rng(seed + 1) if weighted else None
    cursor = row_ptr[:-1].copy()  # next free slot per destination
    # Kept batches are sorted side by side; drawn ones one at a time.
    orders = (run_parts(lambda sd: stable_argsort(sd[1]), kept)
              if keep else None)
    for i, (s, d) in enumerate(kept if keep else batches()):
        order = orders[i] if keep else stable_argsort(d)
        d_sorted = d[order].astype(np.int64)
        s_sorted = s[order]
        # rank of each edge within its (batch-local) destination group:
        # its index less its group's first index
        counts = np.bincount(d_sorted, minlength=nv)
        first = np.cumsum(counts) - counts
        pos = (cursor - first)[d_sorted] + np.arange(len(d_sorted))
        col_src[pos] = s_sorted.astype(np.int32)
        if weighted:
            batch_w = wrng.integers(
                1, max_weight + 1, size=len(order), dtype=np.int32
            )
            w_out[pos] = batch_w[order]
        cursor += counts
    return Graph(nv=nv, ne=ne, row_ptr=row_ptr, col_src=col_src, weights=w_out)


def gnp(nv: int, ne: int, seed: int = 0, weighted: bool = False) -> Graph:
    """Uniform random multigraph with exactly ``ne`` directed edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, size=ne, dtype=np.int64)
    dst = rng.integers(0, nv, size=ne, dtype=np.int64)
    w = rng.integers(1, 101, size=ne, dtype=np.int32) if weighted else None
    return Graph.from_edges(src, dst, nv=nv, weights=w)


def undirected(g: Graph) -> Graph:
    """Symmetrize: add the reverse of every edge (needed for CC, whose label
    propagation follows directed edges only — reference components use
    symmetric inputs)."""
    dst = g.col_dst
    src = g.col_src
    both_src = np.concatenate([src, dst]).astype(np.int64)
    both_dst = np.concatenate([dst, src]).astype(np.int64)
    w = None
    if g.weights is not None:
        w = np.concatenate([g.weights, g.weights])
    return Graph.from_edges(both_src, both_dst, nv=g.nv, weights=w)


def small_world(
    nv: int,
    k: int = 16,
    p_rewire: float = 0.05,
    seed: int = 0,
) -> Graph:
    """Watts-Strogatz-style ring lattice: vertex v points at its next
    ``k`` ring neighbors, with a ``p_rewire`` fraction of source
    endpoints rewired uniformly at random (destinations keep their ring
    position so the graph stays dst-major).

    The locality-rich synthetic stand-in for the reference's web/social
    benchmark graphs (Hollywood-2009, Indochina-2004 — README.md:79-86),
    whose strong community structure is what GPU L2 caches (and this
    framework's strip tiles) exploit; R-MAT's Kronecker tail has no such
    structure, making it the adversarial case instead. Generated
    dst-major, so building the CSC needs no sort."""
    rng = np.random.default_rng(seed)
    ne = nv * k
    # dst-major enumeration: dst v receives from v-1 ... v-k (mod nv).
    dst = np.repeat(np.arange(nv, dtype=np.int64), k)
    src = dst - np.tile(np.arange(1, k + 1, dtype=np.int64), nv)
    src %= nv
    m = rng.random(ne) < p_rewire
    src[m] = rng.integers(0, nv, size=int(m.sum()), dtype=np.int64)
    row_ptr = np.arange(nv + 1, dtype=np.int64) * k
    return Graph(
        nv=nv, ne=ne, row_ptr=row_ptr, col_src=src.astype(np.int32),
        weights=None,
    )


def halo(
    blocks: int,
    span: int,
    hubs: int = 16,
    seed: int = 0,
    weighted: bool = False,
) -> Graph:
    """Halo-exchange locality graph: ``blocks`` contiguous ranges of
    ``span`` vertices, a forward chain inside each range, and exactly
    ``hubs`` cross-range source rows read by every other range — the
    stencil/halo communication pattern where each partition's remote
    reads are a small fixed set of boundary rows.

    Per-range edge totals are identical, so an edge-balanced contiguous
    P-way partition with ``P == blocks`` recovers the ranges to within a
    few boundary rows, and every part reads the same ``hubs`` mid-range
    rows from every other part (mid-range placement keeps hub ownership
    immune to the small boundary drift of the strictly-exceeds split
    rule): the best case for the compacted exchange — per-pair needs are
    uniform, so the fixed all_to_all capacity carries no padding
    waste."""
    if span // 2 + (blocks - 1) * hubs > span:
        raise ValueError(
            f"span {span} too small for {(blocks - 1) * hubs} distinct "
            "mid-range cross destinations"
        )
    mid = span // 2
    src = []
    dst = []
    for b in range(blocks):
        base = b * span
        # Forward chain keeps every range internally connected with
        # purely local edges (the compute the overlap path hides).
        chain = np.arange(span - 1, dtype=np.int64) + base
        src.append(chain)
        dst.append(chain + 1)
    for q in range(blocks):
        for p in range(blocks):
            if p == q:
                continue
            # Sender p's ``hubs`` mid-range rows land on distinct
            # receiver rows (one slot group per sender), so in-degrees
            # stay even and the per-pair needed-rows count is exactly
            # ``hubs`` plus the adjacent chain-boundary row.
            t = (p - q - 1) % blocks
            j = np.arange(hubs, dtype=np.int64)
            src.append(p * span + mid + j)
            dst.append(q * span + mid + t * hubs + j)
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    w = None
    if weighted:
        rng = np.random.default_rng(seed)
        w = rng.integers(1, 101, size=src.size, dtype=np.int32)
    return Graph.from_edges(src, dst, nv=blocks * span, weights=w)


def bipartite_ratings(
    n_users: int,
    n_items: int,
    n_ratings: int,
    seed: int = 0,
    max_weight: int = 5,
) -> Graph:
    """Weighted bipartite ratings graph with edges in both directions
    (users 0..n_users-1, items n_users..n_users+n_items-1) — the
    NetFlix-shaped CF workload (480K users x 17.8K movies x 100M
    ratings, README.md:85). Item popularity is quadratically skewed
    (a bounded inverse-transform — popular items get ~sqrt-density
    weight, a milder skew than a true Zipf tail) so hub items exist
    without the distribution degenerating; total directed edges =
    2 * n_ratings."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, size=n_ratings, dtype=np.int64)
    # Quadratic inverse-transform of uniforms → denser low item ids.
    z = rng.random(n_ratings)
    items = (n_items * z ** 2.0).astype(np.int64).clip(0, n_items - 1)
    i = items + n_users
    w = rng.integers(1, max_weight + 1, size=n_ratings, dtype=np.int32)
    src = np.concatenate([u, i])
    dst = np.concatenate([i, u])
    ww = np.concatenate([w, w])
    return Graph.from_edges(src, dst, nv=n_users + n_items, weights=ww)


def path_graph(n: int) -> Graph:
    """0 → 1 → ... → n-1 (directed path, both directions NOT added)."""
    src = np.arange(n - 1, dtype=np.int64)
    dst = src + 1
    return Graph.from_edges(src, dst, nv=n)


def star_graph(n: int) -> Graph:
    """Center 0 with out-edges to 1..n-1."""
    src = np.zeros(n - 1, dtype=np.int64)
    dst = np.arange(1, n, dtype=np.int64)
    return Graph.from_edges(src, dst, nv=n)


def cycle_graph(n: int) -> Graph:
    src = np.arange(n, dtype=np.int64)
    dst = (src + 1) % n
    return Graph.from_edges(src, dst, nv=n)
