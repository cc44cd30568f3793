"""Port parity: the sharded tiled engine (tiled PageRank over P parts)
against lux_tpu's.

On the CPU the port's ``ShardedTiledExecutor`` runs the plain versions of
K1 and K2 per part. Each part's K1 reads the cell stream of its own run
of strips, and together they are the single-device stream. These tests
hold its host layout byte-identical to
``lux_tpu``'s ``ShardedTiledExecutor`` (partition, ``block_map``,
``stack_map``, local vertex lists, remote-read counts, the compact plan
and ``exchange_bytes_per_iter``) for P in {1, 2, 4, 8}, and its
PageRank to ``lux_tpu``'s on its 8-device virtual CPU mesh, to the f64
oracle and to the port's single-device ``TiledPullExecutor`` at
``tests/test_tiled.py``'s tolerance (rtol=5e-5, atol=1e-9). Compact
equals full bitwise. The kernels on the card are tested by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from lux_tpu.engine import tiled_sharded as jts
from lux_tpu.graph import generate as jgen
from lux_tpu.models import PageRank as JPageRank
from lux_tpu.ops.tiled_spmv import plan_hybrid as jplan_hybrid
from lux_tpu.parallel.mesh import make_mesh as jmake_mesh
from lux_tpu_torch.engine import tiled_sharded as tts
from lux_tpu_torch.engine.tiled import TiledPullExecutor
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.graph.partition import ExchangePlan
from lux_tpu_torch.models import ConnectedComponents, PageRank
from lux_tpu_torch.models.pagerank import reference_pagerank
from lux_tpu_torch.ops.tiled_spmv import plan_hybrid
from lux_tpu_torch.parallel.mesh import LocalMesh

CPU = "cpu"
PARTS = [1, 2, 4, 8]
TOL = dict(rtol=5e-5, atol=1e-9)          # tests/test_tiled.py
ITERS = 10
# name -> (graph maker over a generate module, levels). The first three
# are tests/test_tiled_sharded.py's levels; "gnp_tiny" has 2 blocks, fewer
# than most part counts; "cycle" and "path" have compact plans that are
# profitable (each part reads a few blocks of each other part).
GRAPHS = {
    "rmat_8_1": (lambda m: m.rmat(10, 8, seed=1), ((8, 1),)),
    "rmat_8_4": (lambda m: m.rmat(10, 8, seed=1), ((8, 4),)),
    "rmat_128_8": (lambda m: m.rmat(10, 8, seed=1), ((128, 8), (8, 2))),
    "gnp": (lambda m: m.gnp(600, 5000, seed=7), ((8, 1),)),
    "gnp_tiny": (lambda m: m.gnp(200, 1000, seed=1), ((8, 1),)),
    "cycle": (lambda m: m.undirected(m.cycle_graph(20000)), ((8, 1),)),
    "path": (lambda m: m.path_graph(20000), ((8, 2),)),
}
_GRAPHS = {}
_RUNS = {}


def _graphs(name):
    if name not in _GRAPHS:
        make = GRAPHS[name][0]
        _GRAPHS[name] = (make(jgen), make(tgen))
    return _GRAPHS[name]


def _spy_plans(monkeypatch, cls):
    """Record every ExchangePlan that ``cls.from_needs`` builds."""
    seen = []
    orig = cls.from_needs

    def spy(*a, **k):
        seen.append(orig(*a, **k))
        return seen[-1]

    monkeypatch.setattr(cls, "from_needs", staticmethod(spy))
    return seen


def _jax_ex(name, parts):
    jg, _ = _graphs(name)
    return jts.ShardedTiledExecutor(
        jg, JPageRank(), mesh=jmake_mesh(parts), levels=GRAPHS[name][1],
        chunk_strips=16, chunk_tail=64)


def _port(name, parts, mode, monkeypatch, **kw):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    _, tg = _graphs(name)
    return tts.ShardedTiledExecutor(tg, PageRank(), num_parts=parts,
                                    levels=GRAPHS[name][1], device=CPU, **kw)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_plan_is_byte_identical(name, parts):
    jg, tg = _graphs(name)
    levels = GRAPHS[name][1]
    jp = jts.partition_plan(jplan_hybrid(jg, levels=levels), parts)
    tp = tts.partition_plan(plan_hybrid(tg, levels=levels), parts)
    _same(tp.owner, jp.owner)
    assert tp.max_nvb == jp.max_nvb and tp.num_parts == parts
    assert len(tp.blocks) == len(jp.blocks) == parts
    for a, b in zip(tp.blocks, jp.blocks):
        _same(a, b)


@pytest.mark.parametrize("mode", ["full", "compact"])
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_layout_and_exchange_plan_match_lux_tpu(name, parts, mode,
                                                monkeypatch):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    jplans = _spy_plans(monkeypatch, jts.ExchangePlan)
    tplans = _spy_plans(monkeypatch, ExchangePlan)
    jx = _jax_ex(name, parts)
    ex = _port(name, parts, mode, monkeypatch)
    assert ex.max_nv == jx.max_nv and ex.part.max_nvb == jx.part.max_nvb
    _same(ex.block_map, jx._replicated["block_map"])
    _same(ex.stack_map, jx._replicated["stack_map"])
    assert len(ex._vidx) == len(jx._vidx) == parts
    for a, b in zip(ex._vidx, jx._vidx):
        _same(a, b)
    _same(ex._remote_read_counts, jx._remote_read_counts)
    assert len(tplans) == len(jplans)
    assert len(tplans) == (1 if mode == "compact" and parts > 1 else 0)
    for tpl, jpl in zip(tplans, jplans):
        _same(tpl.send_units, jpl.send_units)
        _same(tpl.recv_pos, jpl.recv_pos)
        _same(tpl.counts, jpl.counts)
        assert (tpl.capacity, tpl.profitable) == (jpl.capacity,
                                                  jpl.profitable)
    assert ex.exchange_mode == jx.exchange_mode
    assert ex.exchange_bytes_per_iter() == jx._exchange_bytes_per_iter(
        jx.init_values())


def _jax_run(name, parts, mode, monkeypatch):
    key = (name, parts, mode)
    if key not in _RUNS:
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        jx = _jax_ex(name, parts)
        _RUNS[key] = jx.gather_values(jx.run(ITERS))
    return _RUNS[key]


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", ["rmat_8_1", "rmat_8_4", "rmat_128_8",
                                  "gnp", "cycle"])
def test_pagerank_matches_lux_tpu(name, parts, monkeypatch):
    mode = "compact" if name == "cycle" else "full"
    ex = _port(name, parts, mode, monkeypatch)
    got = ex.gather_values(ex.run(ITERS))
    _, tg = _graphs(name)
    assert got.dtype == np.float32 and got.shape == (tg.nv,)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, _jax_run(name, parts, mode, monkeypatch),
                               **TOL)
    np.testing.assert_allclose(got, reference_pagerank(tg, ITERS), **TOL)
    single = TiledPullExecutor(tg, PageRank(), levels=GRAPHS[name][1],
                               device=CPU)
    np.testing.assert_allclose(got, single.run(ITERS).numpy(), **TOL)


def _cells(lev):
    """(global destination row, src, cnt) of a level's cells."""
    n = lev.n_cells
    row = torch.repeat_interleave(torch.arange(lev.nrows),
                                  lev.row_ptr.diff()) + lev.row0
    return row, lev.src[:n], lev.cnt[:n]


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", ["rmat_8_1", "rmat_128_8", "gnp_tiny"])
def test_part_cell_streams_concatenate_to_the_single_device_one(
        name, parts, monkeypatch):
    # The parts' strip runs partition the strips, so their cell streams,
    # concatenated in part order and then stably ordered by row, are the
    # single-device stream: one copy of the cells on the card. Each part's
    # row pointer covers only its band of rows.
    ex = _port(name, parts, "full", monkeypatch)
    whole = tts.DeviceHybrid.build(ex.plan, CPU)
    for k, (lev, want) in enumerate(zip(ex.plan.levels, whole.levels)):
        got = [_cells(p.levels[k]) for p in ex._parts]
        row = torch.cat([g[0] for g in got])
        order = torch.sort(row, stable=True).indices
        for i, w in enumerate(_cells(want)):
            assert torch.equal(torch.cat([g[i] for g in got])[order], w)
        n = lev.rows.shape[0]
        cmax = -(-n // parts)
        for p, part in enumerate(ex._parts):
            pl = part.levels[k]
            i0, i1 = min(p * cmax, n), min((p + 1) * cmax, n)
            if i1 > i0:
                assert pl.row0 == int(lev.rows[i0]) * lev.r
                assert pl.row0 + pl.nrows == (int(lev.rows[i1 - 1]) + 1) \
                    * lev.r
            else:
                assert pl.nrows == 0 and pl.n_cells == 0


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("name", ["rmat_8_1", "rmat_128_8", "gnp_tiny"])
def test_part_tail_streams_match_lux_tpu(name, parts, monkeypatch):
    # Each part's tail on the card is one int32 stream, (sb << 7) | lane
    # of lux_tpu's part tail, padded with zeros to a multiple of 4, under
    # the same local row pointer; its sources lie below src_end.
    monkeypatch.setenv("LUX_EXCHANGE", "full")
    jx = _jax_ex(name, parts)
    ex = _port(name, parts, "full", monkeypatch)
    for p, part in enumerate(ex._parts):
        m = int(part.tail_row_ptr[-1])
        sb = np.asarray(jx.shybrid.tail_sb[p]).reshape(-1)[:m]
        lane = np.asarray(jx.shybrid.tail_lane[p]).reshape(-1)[:m]
        src = part.tail_src.numpy()
        assert src.dtype == np.int32 and src.shape[0] == m + (-m % 4)
        _same(src[:m], (sb.astype(np.int32) << 7) | lane)
        assert not src[m:].any()
        assert part.tail_row_ptr.shape[0] == ex.max_nv + 1
        assert int(src[:m].max(initial=-1)) < part.src_end \
            <= ex.plan.nvb * 128


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("name", ["cycle", "path"])
def test_compact_equals_full_bitwise(name, parts, monkeypatch):
    full = _port(name, parts, "full", monkeypatch)
    compact = _port(name, parts, "compact", monkeypatch)
    assert (full.exchange_mode, compact.exchange_mode) == ("full", "compact")
    assert compact.exchange_bytes_per_iter() < full.exchange_bytes_per_iter()
    assert torch.equal(compact.run(ITERS), full.run(ITERS))


def test_unprofitable_compact_falls_back_with_a_note(monkeypatch, capsys):
    ex = _port("rmat_8_1", 4, "compact", monkeypatch)
    assert ex.exchange_mode == "full" and ex._xplan is None
    err = capsys.readouterr().err
    assert "LUX_EXCHANGE=compact unprofitable" in err
    assert "using the full exchange" in err
    ex1 = _port("rmat_8_1", 1, "compact", monkeypatch)
    assert ex1.exchange_mode == "full"
    assert "one part exchanges nothing" in capsys.readouterr().err


def test_resume_from_half(monkeypatch):
    ex = _port("gnp", 4, "full", monkeypatch)
    full = ex.run(6)
    resumed = ex.run(3, vals=ex.run(3))
    assert torch.equal(resumed, full)
    np.testing.assert_allclose(ex.gather_values(full),
                               reference_pagerank(_graphs("gnp")[1], 6),
                               **TOL)


def test_all_tail_plan(monkeypatch):
    monkeypatch.setenv("LUX_EXCHANGE", "full")
    jg, tg = jgen.rmat(9, 8, seed=5), tgen.rmat(9, 8, seed=5)
    levels = ((8, 10 ** 9),)
    ex = tts.ShardedTiledExecutor(tg, PageRank(), num_parts=8,
                                  levels=levels, device=CPU)
    assert ex.plan.num_strips == 0
    got = ex.gather_values(ex.run(5))
    jx = jts.ShardedTiledExecutor(jg, JPageRank(), mesh=jmake_mesh(8),
                                  levels=levels, chunk_tail=64)
    np.testing.assert_allclose(got, jx.gather_values(jx.run(5)), **TOL)
    np.testing.assert_allclose(got, reference_pagerank(tg, 5), **TOL)


def test_values_round_trip_and_phase_step(monkeypatch):
    ex = _port("gnp", 4, "full", monkeypatch)
    _, tg = _graphs("gnp")
    init = ex.init_values()
    assert tuple(init.shape) == (4, ex.max_nv)
    _same(ex.gather_values(init), PageRank().init_values(tg))
    new, times = ex.phase_step(init)
    assert set(times) == {"exchange", "strips", "tail", "apply"}
    assert torch.equal(new, ex.step(init))
    pads = ~ex.vertex_mask
    assert torch.equal(new[pads], init[pads])
    with pytest.raises(ValueError, match="values must be"):
        ex.step(init[:, :-1])


def test_rejects_non_spmv_programs_and_packing(monkeypatch):
    _, tg = _graphs("gnp")
    with pytest.raises(ValueError, match="identity|source value"):
        tts.ShardedTiledExecutor(tg, ConnectedComponents(), num_parts=2,
                                 device=CPU)
    with pytest.raises(NotImplementedError, match="nibble"):
        _port("gnp", 2, "full", monkeypatch, pack=True)


def test_ranges_to_indices_matches_lux_tpu():
    rng = np.random.default_rng(0)
    lens = rng.integers(0, 5, 50)
    starts = rng.integers(0, 1000, 50)
    _same(tts._ranges_to_indices(starts, lens),
          jts._ranges_to_indices(starts, lens))
    _same(tts._ranges_to_indices(starts, np.zeros(50, np.int64)),
          jts._ranges_to_indices(starts, np.zeros(50, np.int64)))
    assert tts.TAIL_EDGE_COST == jts.TAIL_EDGE_COST


@pytest.mark.parametrize("tail", [(), (3,)])
@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_reduce_scatter_sums_each_block_over_senders(parts, tail):
    n = 5
    rng = np.random.default_rng(parts)
    x = torch.from_numpy(rng.random((parts, parts * n) + tail,
                                    dtype=np.float32))
    got = LocalMesh(parts, CPU).reduce_scatter(x)
    assert tuple(got.shape) == (parts, n) + tail
    for q in range(parts):
        want = x[0, q * n:(q + 1) * n].clone()
        for p in range(1, parts):
            want = want + x[p, q * n:(q + 1) * n]
        assert torch.equal(got[q], want)
    if parts > 1:
        with pytest.raises(ValueError, match="split"):
            LocalMesh(parts, CPU).reduce_scatter(x[:, :-1])


def test_reduce_scatter_refuses_a_wrong_stack():
    with pytest.raises(ValueError, match="stack"):
        LocalMesh(2, CPU).reduce_scatter(torch.zeros(3, 6))
