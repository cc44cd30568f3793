"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor lux_tpu, so it also runs without the suite's
conftest (which sets JAX up), on a machine with or without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lux_tpu_torch.engine import gas
from lux_tpu_torch.engine.pull import PullExecutor
from lux_tpu_torch.engine.push import PushExecutor, PushProgram
from lux_tpu_torch.engine.tiled import TiledPullExecutor
from lux_tpu_torch.graph import generate
from lux_tpu_torch.models import (
    BFS,
    SSSP,
    CollaborativeFiltering,
    ConnectedComponents,
    DeltaSSSP,
    KCore,
    LabelPropagation,
    PageRank,
)
from lux_tpu_torch.models.bfs import reference_bfs
from lux_tpu_torch.models.kcore import reference_kcore
from lux_tpu_torch.models.labelprop import reference_labelprop
from lux_tpu_torch.models.sssp_delta import reference_sssp_delta
from lux_tpu_torch.models.colfilter import reference_colfilter
from lux_tpu_torch.models.components import reference_components
from lux_tpu_torch.models.sssp import reference_sssp
from lux_tpu_torch.ops import _cuda
from lux_tpu_torch.ops import frontier as fq
from lux_tpu_torch.ops import merge_tail_kernel as mtk
from lux_tpu_torch.ops import merge_tail_plan as mtp
from lux_tpu_torch.ops import segment as seg
from lux_tpu_torch.ops import tiled_spmv as ts
from torch_pull_order import ordered_pull_sum

pytestmark = pytest.mark.cuda
RTOL, ATOL = 5e-5, 1e-9
CPU = torch.device("cpu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _operands(nvb, seed):
    rng = np.random.default_rng(seed)
    return (
        (torch.from_numpy(rng.integers(0, 8, (nvb, 128)).astype(np.float32)),
         True),
        (torch.from_numpy(rng.random((nvb, 128), dtype=np.float32) + 0.5),
         False),
    )


def _compare(got, want, exact):
    got = got.cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    if exact:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("levels", [((8, 2),), ((128, 8), (8, 2)),
                                    ((32, 4), (2, 2)), ((8, 10 ** 9),)])
def test_strip_and_tail_kernels_match_plain(dev, levels):
    plan = ts.plan_hybrid(generate.rmat(10, 14, seed=3), levels=levels)
    dh, cpu = ts.DeviceHybrid.build(plan, dev), ts.DeviceHybrid.build(plan, CPU)
    for x, exact in _operands(plan.nvb, 1):
        xd = x.to(dev)
        for ld, lc in zip(dh.levels, cpu.levels):
            _compare(ts.strip_level_spmv(xd, ld), ts.strip_level_spmv(x, lc),
                     exact)
        _compare(ts.tail_sum(xd, dh), ts.tail_sum(x, cpu), exact)


def _tail_operands(lens, seed):
    """A tail stream (padded to a multiple of 4) with rows of ``lens``
    edges over ``4 * len(lens)`` source values."""
    rng = np.random.default_rng(seed)
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    m = int(row_ptr[-1])
    n_x = 4 * len(lens)
    src = np.zeros(m + (-m % 4), np.int32)
    src[:m] = rng.integers(0, n_x, m)
    return torch.from_numpy(src), torch.from_numpy(row_ptr), n_x, rng


@pytest.mark.parametrize("shape", ["skewed", "hub", "empty"])
def test_tail_kernel_matches_plain(dev, shape):
    # Rows of every tier: short rows and empty ones (a thread), rows of
    # 33-2,048 edges (a warp), and a hub row of more than 10^5 edges (the
    # block); bitwise on integral x, with accumulate off and on.
    rng = np.random.default_rng(5)
    if shape == "empty":
        lens = np.zeros(1000, np.int64)
    else:
        lens = rng.integers(0, 9, 5000)
        lens[rng.random(5000) < 0.3] = 0
        lens[7], lens[300], lens[301] = 40, 2048, 2049
        if shape == "hub":
            lens[1234] = 150_000
    src, row_ptr, n_x, rng = _tail_operands(lens, 3)
    rows = len(lens)
    for exact in (True, False):
        x = torch.from_numpy(rng.integers(0, 8, n_x).astype(np.float32)
                             if exact else
                             rng.random(n_x, dtype=np.float32) + 0.5)
        y0 = torch.from_numpy(rng.integers(0, 8, rows).astype(np.float32))
        d = [t.to(dev) for t in (x, src, row_ptr)]
        _compare(ts.lane_select_tail_sums(*d),
                 ts.lane_select_tail_sums(x, src, row_ptr), exact)
        out = y0.to(dev, copy=True)
        got = ts.lane_select_tail_sums(*d, out=out)
        assert got is out
        _compare(got, ts.lane_select_tail_sums(x, src, row_ptr,
                                               out=y0.clone()), exact)


def test_tail_kernel_reads_the_values_flat(dev):
    # The executor hands K2 (and K1) the (nv,) values; the sharded parts
    # the (nvb, 128) table. Both index the same flat values.
    plan = ts.plan_hybrid(generate.rmat(10, 14, seed=3))
    dh = ts.DeviceHybrid.build(plan, dev)
    x = _operands(plan.nvb, 7)[0][0]
    flat = x.reshape(-1)[:plan.nv].contiguous().to(dev)
    _compare(ts.tail_sum(flat, dh), ts.tail_sum(x.to(dev), dh).cpu(), True)
    for lev in dh.levels:
        _compare(ts.strip_level_spmv(flat, lev),
                 ts.strip_level_spmv(x.to(dev), lev).cpu(), True)
    with pytest.raises(ValueError, match="sources"):
        ts.tail_sum(flat[:dh.src_end - 1], dh)


def test_strip_kernel_on_a_legacy_plan(dev):
    # Counts up to 127 in a cell (cap=127), every edge repeated 1-40 times.
    g = generate.rmat(9, 8, seed=2)
    reps = np.random.default_rng(0).integers(1, 41, size=g.ne)
    dst = np.repeat(np.repeat(np.arange(g.nv), np.diff(g.row_ptr)), reps)
    row_ptr = np.zeros(g.nv + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=g.nv), out=row_ptr[1:])
    g = type(g)(nv=g.nv, ne=int(reps.sum()), row_ptr=row_ptr,
                col_src=np.repeat(g.col_src, reps))
    plan = ts.plan_hybrid(g, levels=((8, 1),), cap=127)
    dh, cpu = ts.DeviceHybrid.build(plan, dev), ts.DeviceHybrid.build(plan, CPU)
    assert int(cpu.levels[0].cnt.max()) > 15
    for x, exact in _operands(plan.nvb, 2):
        _compare(ts.strip_level_spmv(x.to(dev), dh.levels[0]),
                 ts.strip_level_spmv(x, cpu.levels[0]), exact)


def test_strip_kernel_bands(dev):
    # Bands of rows, alone and added into a full-height vector (the parts
    # of the sharded engine), and an empty band.
    plan = ts.plan_hybrid(generate.rmat(11, 8, seed=3), levels=((8, 2),))
    lev = plan.levels[0]
    n = lev.rows.shape[0]
    for x, exact in _operands(plan.nvb, 4):
        xd = x.to(dev)
        out_d = torch.full((plan.nvb * 128,), 3.0, device=dev)
        out_c = torch.full((plan.nvb * 128,), 3.0)
        for lo, hi in ((0, n // 4), (n // 4, n), (n, n)):
            bd = ts.build_level(lev, plan.nvb, dev, lo, hi, band=True)
            bc = ts.build_level(lev, plan.nvb, CPU, lo, hi, band=True)
            _compare(ts.strip_level_spmv(xd, bd), ts.strip_level_spmv(x, bc),
                     exact)
            ts.strip_level_spmv(xd, bd, out_d)
            ts.strip_level_spmv(x, bc, out_c)
        _compare(out_d, out_c, exact)


@pytest.mark.parametrize("item", [3, 16, 1024])
def test_strip_kernel_rows_of_many_items(dev, item, monkeypatch):
    # Short items put many items in a row, so K1's second pass takes both
    # its one-thread and its whole-warp path for a row's partials.
    monkeypatch.setattr(ts, "CELL_ITEM", item)
    plan = ts.plan_hybrid(generate.rmat(10, 14, seed=3),
                          levels=((128, 8), (8, 2)))
    dh, cpu = ts.DeviceHybrid.build(plan, dev), ts.DeviceHybrid.build(plan, CPU)
    per_row = cpu.levels[0].items.row_items.diff()
    assert item > 100 or int(per_row.max()) > 4
    for x, exact in _operands(plan.nvb, 3):
        for ld, lc in zip(dh.levels, cpu.levels):
            _compare(ts.strip_level_spmv(x.to(dev), ld),
                     ts.strip_level_spmv(x, lc), exact)


@pytest.mark.parametrize("m", [15000, 0])
def test_grouped_tail_kernels_match_plain(dev, m):
    rng = np.random.default_rng(4)
    sb = rng.integers(0, 48, size=m)
    lane = rng.integers(0, 128, size=m)
    dst = np.sort(rng.integers(0, 700, size=m))
    plan = mtp.plan_grouped_tail(sb, lane, np.searchsorted(dst,
                                                           np.arange(701)))
    gd = mtk.DeviceGroupedTail.build(plan, dev)
    gc = mtk.DeviceGroupedTail.build(plan, CPU)
    x = torch.from_numpy(rng.standard_normal((48, 128)).astype(np.float32))
    xd = x.to(dev)
    for k in range(gd.n_levels + 1):
        x = mtk.level_apply(x, gc.arow[k], gc.brow[k], gc.codes[k])
        xd = mtk.level_apply(xd, gd.arow[k], gd.brow[k], gd.codes[k])
        assert torch.equal(xd.cpu(), x)
    root = torch.from_numpy(
        rng.integers(-40, 40, size=tuple(x.shape)).astype(np.float32))
    _compare(mtk.root_reduce(root.to(dev), gd.nvalid_root, gd.dst_row_ptr),
             mtk.root_reduce(root, gc.nvalid_root, gc.dst_row_ptr), True)
    y0 = torch.from_numpy(rng.integers(0, 8, 700).astype(np.float32))
    out = y0.to(dev, copy=True)
    got = mtk.root_reduce(root.to(dev), gd.nvalid_root, gd.dst_row_ptr, out)
    assert got is out
    _compare(got, mtk.root_reduce(root, gc.nvalid_root, gc.dst_row_ptr,
                                  y0.clone()), True)


def test_segment_sum_without_mask(dev):
    rng = np.random.default_rng(2)
    lens = rng.integers(0, 9, size=300)
    lens[5] = 5000
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    data = torch.from_numpy(rng.random(int(row_ptr[-1]), dtype=np.float32))
    got = seg.segment_sum_by_rowptr(data.to(dev),
                                    torch.from_numpy(row_ptr).to(dev))
    _compare(got, seg.segment_sum_by_rowptr(data, torch.from_numpy(row_ptr)),
             False)


@pytest.mark.parametrize("shape", ["skewed", "hub", "empty"])
@pytest.mark.parametrize("masked", [True, False])
def test_segment_sum_one_launch_matches_plain(dev, shape, masked):
    # K4 in one launch: rows of every tier (empty and short rows a
    # thread, 33-2,048 elements a warp, a row of 150,000 that outgrows
    # any block's stage the whole block), bitwise on integral streams
    # and within the tolerance on floats, written or added into a
    # vector; the (S, 128) stream with its lane mask, or 1-D (of a
    # length not a multiple of 4) without.
    rng = np.random.default_rng(8)
    if shape == "empty":
        lens = np.zeros(1000, np.int64)
    else:
        lens = rng.integers(0, 9, 5000)
        lens[rng.random(5000) < 0.3] = 0
        lens[7], lens[300], lens[301] = 40, 2048, 2049
        if shape == "hub":
            lens[1234] = 150_000
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n = int(row_ptr[-1])
    rows = len(lens)
    nvalid = None
    if masked:
        s = -(-n // 128) + 1
        row_ptr[-1] = s * 128 if shape == "empty" else row_ptr[-1]
        nvalid = torch.from_numpy(rng.integers(0, 129, s).astype(np.int32))
        shp = (s, 128)
    else:
        shp = (n + 3,)
    rpc = torch.from_numpy(row_ptr)
    for exact in (True, False):
        data = torch.from_numpy(
            rng.integers(-8, 8, shp).astype(np.float32) if exact
            else rng.random(shp, dtype=np.float32) + 0.5)
        y0 = torch.from_numpy(rng.integers(0, 8, rows).astype(np.float32))
        d = (data.to(dev), rpc.to(dev),
             None if nvalid is None else nvalid.to(dev))
        _cuda.reset_launches()
        _compare(seg.segment_sum_by_rowptr(*d),
                 seg.segment_sum_by_rowptr(data, rpc, nvalid), exact)
        out = y0.to(dev, copy=True)
        got = seg.segment_sum_by_rowptr(*d, out=out)
        assert got is out
        assert _cuda.LAUNCHES["segment_sum_rowptr"] == 2
        _compare(got, seg.segment_sum_by_rowptr(data, rpc, nvalid,
                                                out=y0.clone()), exact)


@pytest.mark.parametrize("grouped", [False, True])
def test_executor_on_cuda_counts_launches(dev, grouped, monkeypatch):
    if grouped:
        monkeypatch.setenv("LUX_GROUPED_TAIL", "1")
    g = generate.rmat(10, 14, seed=3)
    ex = TiledPullExecutor(g, PageRank())
    assert ex.device.type == "cuda"
    ref = TiledPullExecutor(g, PageRank(), plan=ex.plan, device="cpu")
    _cuda.reset_launches()
    got = ex.run(10)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    np.testing.assert_allclose(got.cpu().numpy(), ref.run(10).numpy(),
                               rtol=RTOL, atol=ATOL)
    assert counts["strip_spmv"] == 10 * len(ex.plan.levels)
    if grouped:
        assert counts["level_apply"] == 10 * (ex.gtail.n_levels + 1)
        assert counts["segment_sum_rowptr"] == 10
        assert counts["tail_gather_sum"] == 0
    else:
        assert counts["tail_gather_sum"] == 10
        assert counts["level_apply"] == counts["segment_sum_rowptr"] == 0


def test_wrappers_check_their_inputs(dev):
    x = torch.zeros((4, 128), device=dev)
    rows = torch.zeros(2, dtype=torch.int64, device=dev)  # must be int32
    codes = torch.zeros((2, 128), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="int32"):
        mtk.level_apply(x, rows, rows, codes)
    with pytest.raises(ValueError, match="contiguous"):
        mtk.level_apply(x.t().contiguous().t(), rows.int(), rows.int(), codes)


# -- push engine kernels (K5-K7): bitwise against their plain versions --


def _push_operands(nv, seed, frac):
    """uint32 values below 2**31 (some at the SSSP infinity nv) as int32
    storage, and a random bool frontier."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, nv, size=nv).astype(np.uint32)
    vals[rng.random(nv) < 0.2] = nv
    fr = rng.random(nv) < frac
    return seg.to_u32_storage(vals), torch.from_numpy(fr)


K5_PAIRS = [("min", "add1"), ("max", "copy"), ("min", "copy"),
            ("max", "add1")]


def _k7_per_part(rows, starts, offss, cols, values, kind, relax_op):
    """K7 over P receivers as P scatters: receiver p's candidates, read
    from the flat values at ``rows``, into row p of a copy of the (P, n)
    values."""
    flat = seg.widen_u32(values).reshape(-1)
    relax = seg.RELAX_OPS[relax_op]
    red = {"min": "amin", "max": "amax"}[kind]
    out = []
    for p in range(starts.shape[0]):
        slot, edge = fq.queue_edges(rows, starts[p], offss[p])
        out.append(seg.widen_u32(values[p]).scatter_reduce(
            0, cols[p][edge].long(), relax(flat[rows.long()[slot]]),
            reduce=red, include_self=True))
    return seg.narrow_u32(torch.stack(out))


def _queue_graph(seed):
    """A CSR of 200,000 vertices for the queue expansion: vertex 0 a hub
    of 150,000 out-edges, vertices 1-20,000 one edge each, 20,001-80,000
    none (so a chunk's queue range outgrows the stage) and the rest 0-8
    edges; with int32 weights."""
    rng = np.random.default_rng(seed)
    nv = 200_000
    deg = rng.integers(0, 9, nv)
    deg[0] = 150_000
    deg[1:20_001] = 1
    deg[20_001:80_001] = 0
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    col = rng.integers(0, nv, int(rp[-1])).astype(np.int32)
    w = rng.integers(1, 100, int(rp[-1])).astype(np.int32)
    return nv, torch.from_numpy(rp), torch.from_numpy(col), \
        torch.from_numpy(w)


QUEUES = ["hub", "one-edge", "outgrows", "empty", "random"]


def _queue_frontier(nv, which, rng):
    fr = np.zeros(nv, bool)
    if which == "hub":
        fr[0] = True
    elif which == "one-edge":
        fr[1:20_001] = True
    elif which == "outgrows":
        fr[10_000:100_000] = True
    elif which == "random":
        fr = rng.random(nv) < 0.3
    return torch.from_numpy(fr)


@pytest.mark.parametrize("which", QUEUES)
def test_queue_fold_shapes_match_plain(dev, which):
    # K7's four pairs and K11's five ops on queues of one hub of 150,000
    # out-edges, 20,000 one-edge vertices, a range of 60,000 vertices
    # without out-edges inside one chunk, no vertex, and 30% of the
    # vertices: bitwise against the plain versions, one launch a call
    # (none for the empty queue).
    nv, rp, col, w = _queue_graph(3)
    rng = np.random.default_rng(4)
    fr = _queue_frontier(nv, which, rng)
    cnt = int(fr.sum())
    q, start, _, offs = fq.frontier_queue(fr.to(dev), rp.to(dev), cnt)
    total = int(offs[-1])
    qc, sc, oc = q.cpu(), start.cpu(), offs.cpu()
    cold, wd = col.to(dev), w.to(dev)
    vals, _ = _push_operands(nv, 5, 0.0)
    vd = vals.to(dev)
    for kind, relax_op in K5_PAIRS:
        _cuda.reset_launches()
        got = fq.queue_relax_scatter(q, start, offs, cold, vd, kind,
                                     relax_op, total)
        assert _cuda.LAUNCHES["queue_relax_scatter"] == int(total > 0)
        assert torch.equal(got.cpu(), fq.queue_relax_scatter(
            qc, sc, oc, col, vals, kind, relax_op, total))
    for kind, gather_op in seg.GAS_KERNEL_OPS:
        gv, _ = _gas_operands(nv, gather_op, 0.0, 1, seed=6)
        _cuda.reset_launches()
        got = fq.gas_push_acc(q, start, offs, cold, gv.to(dev), kind,
                              gather_op, total, weights=wd)
        assert _cuda.LAUNCHES["gas_push_acc"] == int(total > 0)
        want = fq.gas_push_acc(qc, sc, oc, col, gv, kind, gather_op, total,
                               weights=w)
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_queue_fold_over_receivers_matches_per_part(dev, parts,
                                                    monkeypatch):
    # The sharded sparse step's K7: one launch over the P receivers at
    # every sparse iteration of sharded SSSP and CC, bitwise against P
    # scatters of the plain fold.
    from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor

    monkeypatch.setenv("LUX_EXCHANGE", "full")
    g = generate.rmat(12, 10, seed=1)
    for prog, kw, graph in ((SSSP(), {"start": 0}, g),
                            (ConnectedComponents(), {},
                             generate.undirected(g))):
        ex = ShardedPushExecutor(graph, prog, num_parts=parts, queue_frac=4,
                                 edge_budget_frac=2)
        ex.run(**kw)
        sparse = [i for i, b in enumerate(ex.branch_log) if b[0] > 0]
        assert sparse
        for at in sparse:
            st, _ = ex.run(max_iters=at, **kw)
            stats = ex._frontier_stats(st)
            rows, ids = ex._sparse_load(st, stats)
            start = ex.push_row_ptr[:, ids]
            offs = torch.nn.functional.pad(
                (ex.push_row_ptr[:, ids + 1] - start).cumsum(1), (1, 0))
            assert int(offs[:, -1].sum()) == stats[1]
            got = fq.queue_relax_scatter(
                rows, start, offs, ex.push_dst_local, st.values,
                prog.combiner, prog.relax_op, stats[1])
            want = _k7_per_part(*(x.cpu() for x in (
                rows, start, offs, ex.push_dst_local, st.values)),
                prog.combiner, prog.relax_op)
            assert torch.equal(got.cpu(), want)


def _k5_forms(vals, fr, dev):
    """K5's two input forms on the card: (values, bool frontier) and the
    packed table."""
    return ((vals.to(dev), fr.to(dev)),
            (seg.pack_words(vals, fr).to(dev), None))


@pytest.mark.parametrize("kind,relax_op", K5_PAIRS)
@pytest.mark.parametrize("frac", [0.3, 0.0, 1.0])
def test_segment_minmax_relax_matches_plain(dev, kind, relax_op, frac):
    g = generate.rmat(12, 12, seed=5)
    row_ptr = torch.from_numpy(g.row_ptr)
    col_src = torch.from_numpy(g.col_src)
    tasks = seg.push_row_tasks(g.row_ptr, dev)
    vals, fr = _push_operands(g.nv, 3, frac)
    want = seg.segment_minmax_relax(row_ptr, col_src, vals, fr, kind,
                                    relax_op)
    for table, front in _k5_forms(vals, fr, dev):
        call = lambda: seg.segment_minmax_relax(
            row_ptr.to(dev), col_src.to(dev), table, front, kind, relax_op,
            tasks)
        _cuda.reset_launches()
        got = call()
        assert _cuda.LAUNCHES["segment_minmax_relax"] == 1
        assert torch.equal(got.cpu(), want)
        assert torch.equal(call(), got)   # two calls, bitwise


@pytest.mark.parametrize("kind,relax_op", K5_PAIRS)
def test_segment_minmax_relax_hub_empty_rows_and_a_part(dev, kind,
                                                        relax_op):
    # Rows of every tier (empty, a lane, a warp, two hubs above
    # HUB_EDGES) over a table of more rows than row_ptr, read through a
    # col_src view 4 bytes past a 16-byte boundary, as a part reads its
    # slice of src_pidx.
    rng = np.random.default_rng(8)
    lens = rng.choice([0, 0, 1, 5, 31, 33, 700], 3000)
    lens[[17, 2900]] = [seg.HUB_EDGES + 3, 3 * seg.HUB_EDGES]
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]))
    n_tab, ne = 5000, int(lens.sum())
    store = torch.from_numpy(rng.integers(0, n_tab, ne + 5, dtype=np.int32))
    col_src = store.to(dev)[1:ne + 1]
    assert col_src.data_ptr() % 16 == 4
    tasks = seg.push_row_tasks(row_ptr.numpy(), dev)
    assert tasks.n_hub == 2
    for frac in (0.0, 0.3, 1.0):
        vals, fr = _push_operands(n_tab, 11, frac)
        want = seg.segment_minmax_relax(row_ptr, store[1:ne + 1], vals, fr,
                                        kind, relax_op)
        ident = -1 if kind == "min" else 0
        assert torch.all(want[torch.from_numpy(lens == 0)] == ident)
        for table, front in _k5_forms(vals, fr, dev):
            got = seg.segment_minmax_relax(row_ptr.to(dev), col_src, table,
                                           front, kind, relax_op, tasks)
            assert torch.equal(got.cpu(), want)


def test_segment_minmax_relax_checks_its_inputs(dev):
    g = generate.rmat(8, 8, seed=2)
    row_ptr = torch.from_numpy(g.row_ptr).to(dev)
    col_src = torch.from_numpy(g.col_src).to(dev)
    vals, fr = _push_operands(g.nv, 1, 0.5)
    vals, fr = vals.to(dev), fr.to(dev)
    with pytest.raises(ValueError, match="RowTasks"):
        seg.segment_minmax_relax(row_ptr, col_src, vals, fr, "min", "add1")
    other = seg.RowTasks.build(g.row_ptr[:-1], dev)
    with pytest.raises(ValueError, match="tasks cover"):
        seg.segment_minmax_relax(row_ptr, col_src, vals, fr, "min", "add1",
                                 other)
    tasks = seg.RowTasks.build(g.row_ptr, dev)
    with pytest.raises(ValueError, match="at least"):
        seg.segment_minmax_relax(row_ptr, col_src, vals[:-1], fr[:-1],
                                 "min", "add1", tasks)
    with pytest.raises(NotImplementedError):
        seg.segment_minmax_relax(row_ptr, col_src, vals, fr, "min", "decay",
                                 tasks)


@pytest.mark.parametrize("nv,frac", [(4096 * 3 + 5, 0.02), (1000, 1.0),
                                     (70000, 0.0005)])
def test_frontier_queue_and_scatter_match_plain(dev, nv, frac):
    g = generate.gnp(nv, nv * 6, seed=7)
    csr = g.csr()
    rp = torch.from_numpy(csr.row_ptr)
    col_dst = torch.from_numpy(csr.col_dst)
    vals, fr = _push_operands(nv, 9, frac)
    cnt = int(fr.sum())
    want_q = fq.frontier_queue(fr, rp, cnt)
    got_q = fq.frontier_queue(fr.to(dev), rp.to(dev), cnt)
    for got, want in zip(got_q, want_q):
        assert torch.equal(got.cpu(), want)
    total = int(want_q[3][-1])
    q, start, _, offs = got_q
    for kind, relax_op in (("min", "add1"), ("max", "copy")):
        want = fq.queue_relax_scatter(*want_q[:2], want_q[3], col_dst, vals,
                                      kind, relax_op, total)
        got = fq.queue_relax_scatter(q, start, offs, col_dst.to(dev),
                                     vals.to(dev), kind, relax_op, total)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("frac", [0.0, "one", 0.01, 0.5, 1.0])
@pytest.mark.parametrize("nv", [4096 * 7, 4096 * 300 + 77])
def test_frontier_queue_one_launch_matches_plain(dev, nv, frac):
    # Bitwise on empty, one-vertex, 1%, half and full frontiers, with nv a
    # multiple of a 32-flag word or not; repeated calls reuse one scratch
    # (its grid barrier resets itself, nothing is zeroed), and each call is
    # one launch.
    g = generate.gnp(nv, nv * 4, seed=11)
    rp = torch.from_numpy(g.csr().row_ptr)
    rng = np.random.default_rng(nv)
    if frac == "one":
        fr = np.zeros(nv, bool)
        fr[nv - 3] = True
    else:
        fr = rng.random(nv) < frac
    fr = torch.from_numpy(fr)
    cnt = int(fr.sum())
    want = fq.frontier_queue(fr, rp, cnt)
    rpd, frd = rp.to(dev), fr.to(dev)
    for _ in range(3):
        _cuda.reset_launches()
        got = fq.frontier_queue(frd, rpd, cnt)
        assert _cuda.LAUNCHES["frontier_queue"] == (1 if cnt else 0)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    # Smaller and larger frontiers in turn on the same stream.
    small = frd[:5000]
    for _ in range(2):
        for f, r in ((small, rpd[:5001]), (frd, rpd)):
            c = int(f.sum())
            for a, b in zip(fq.frontier_queue(f, r, c),
                            fq.frontier_queue(f.cpu(), r.cpu(), c)):
                assert torch.equal(a.cpu(), b)


def test_frontier_queue_on_a_part_row_pointer(dev, monkeypatch):
    # K6 as the sharded push engine calls it: one part's frontier row of
    # the (P, max_nv) state over the shared _queue_row_ptr.
    from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor

    monkeypatch.setenv("LUX_EXCHANGE", "full")
    g = generate.rmat(12, 10, seed=1)
    ex = ShardedPushExecutor(g, SSSP(), num_parts=4)
    st, _ = ex.run(max_iters=2, start=0)
    rp = ex._queue_row_ptr
    n = st.frontier.shape[1]
    assert rp.shape[0] == n + 1
    rng = np.random.default_rng(1)
    for p in range(4):
        for fr in (st.frontier[p],
                   torch.from_numpy(rng.random(n) < 0.3).to(dev)):
            cnt = int(fr.sum())
            for a, b in zip(fq.frontier_queue(fr, rp, cnt),
                            fq.frontier_queue(fr.cpu(), rp.cpu(), cnt)):
                assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("which", ["last", "sparse"])
def test_frontier_queue_at_two_to_the_28(dev, which):
    # nv = 2^28: a block's span outgrows its window of shared memory, so
    # its warps walk their runs a window at a time and read them twice.
    nv = 1 << 28
    rp = torch.arange(nv + 1, dtype=torch.int64, device=dev) * 3
    if which == "last":
        fr = torch.zeros(nv, dtype=torch.bool, device=dev)
        fr[-1] = True
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(28)
        fr = torch.rand(nv, generator=gen, device=dev) < 1e-4
    cnt = int(fr.sum())
    _cuda.reset_launches()
    got = fq.frontier_queue(fr, rp, cnt)
    assert _cuda.LAUNCHES["frontier_queue"] == 1
    for a, b in zip(got, fq.frontier_queue_plain(fr, rp)):
        assert torch.equal(a, b)


def test_frontier_queue_on_two_streams_at_once(dev):
    # Two threads, each on its own stream, call K6, K7 and K11 at once:
    # each stream has its own scratch, whose grid barrier the three
    # cooperative launches share in turn, and the launch shapes are
    # cached per device without a lock.
    import threading

    nv = 4096 * 300 + 77
    csr = generate.gnp(nv, nv * 4, seed=11).csr()
    rp, col = torch.from_numpy(csr.row_ptr), torch.from_numpy(csr.col_dst)
    rng = np.random.default_rng(2)
    frs = [torch.from_numpy(rng.random(nv) < f) for f in (0.01, 0.3)]
    vals, _ = _push_operands(nv, 3, 0.0)
    gv, _ = _gas_operands(nv, "one", 0.0, 1, seed=3)

    cnts = [int(f.sum()) for f in frs]
    totals = [int(torch.where(f, rp.diff(), 0).sum()) for f in frs]

    def calls(i, f, r, c, v, g):
        q, start, deg, offs = fq.frontier_queue(f, r, cnts[i])
        return (q, start, deg, offs,
                fq.queue_relax_scatter(q, start, offs, c, v, "min", "add1",
                                       totals[i]),
                fq.gas_push_acc(q, start, offs, c, g, "sum", "one",
                                totals[i]))

    wants = [calls(i, f, rp, col, vals, gv) for i, f in enumerate(frs)]
    rpd, cold, vd, gvd = rp.to(dev), col.to(dev), vals.to(dev), gv.to(dev)
    results, errors = [None, None], []

    def work(i):
        try:
            stream = torch.cuda.Stream(device=dev)
            with torch.cuda.stream(stream):
                f = frs[i].to(dev)
                outs = [calls(i, f, rpd, cold, vd, gvd) for _ in range(20)]
            stream.synchronize()
            results[i] = outs
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for outs, want in zip(results, wants):
        for got in outs:
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("app", ["sssp", "cc"])
@pytest.mark.parametrize("blocked", [True, False])
def test_push_executor_on_cuda_counts_launches(dev, app, blocked):
    g = generate.rmat(12, 10, seed=1)
    if app == "sssp":
        prog, kw, ref = SSSP(), {"start": 0}, reference_sssp(g, 0)
    else:
        g = generate.undirected(g)
        prog, kw, ref = ConnectedComponents(), {}, reference_components(g)
    ex = PushExecutor(g, prog, blocked_dense=blocked)
    assert ex.device.type == "cuda"
    cpu = PushExecutor(g, prog, device="cpu", blocked_dense=blocked)
    _cuda.reset_launches()
    state, iters = ex.run(**kw)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    cstate, citers = cpu.run(**kw)
    np.testing.assert_array_equal(ex.values(state), ref)
    np.testing.assert_array_equal(ex.values(state), cpu.values(cstate))
    assert (iters, ex.sparse_iters) == (citers, cpu.sparse_iters)
    dense = sum(1 for b, _, _ in ex.branch_log if b == 0)
    assert counts["segment_minmax_relax"] == dense
    assert counts["frontier_queue"] == iters - dense
    assert counts["queue_relax_scatter"] == sum(
        1 for b, _, e in ex.branch_log if b > 0 and e > 0)


def test_push_program_without_relax_op_raises_on_cuda(dev):
    class Plain(SSSP):
        relax_op = None

    g = generate.gnp(300, 2000, seed=2)
    with pytest.raises(NotImplementedError):
        PushExecutor(g, Plain(), sparse=False).run(start=0)
    assert issubclass(Plain, PushProgram)


# -- flat pull kernels (K8, K9) ---------------------------------------------

CF_TOL = dict(rtol=1e-4, atol=1e-7)


def _pull_operands(width, exact, nv=500, seed=6):
    """A CSC graph with empty rows and hub rows many items long, its int32
    weights, and (nv, width) values ((nv,) for width 1): 0/1 (exact sums)
    or floats near CF's initial value."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 12, size=nv)
    lens[::7] = 0
    lens[3], lens[400] = 5000, 300
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    ne = int(row_ptr[-1])
    col_src = rng.integers(0, nv, size=ne).astype(np.int32)
    w = rng.integers(1, 6, size=ne).astype(np.int32)
    shape = (nv,) if width == 1 else (nv, width)
    if exact:
        vals = rng.integers(0, 2, size=shape).astype(np.float32)
    else:
        vals = (rng.random(shape, dtype=np.float32) * np.float32(0.2)
                + np.float32(0.12))
    return tuple(torch.from_numpy(a) for a in (row_ptr, col_src, w, vals))


# The kernels' own thresholds, and ones that cut the rows of
# _pull_operands into blocks, warps and lanes otherwise.
PULL_SCHEDULES = [None, (64, 200), (8, 16)]


def _pull_call(op, d, tasks, row_base=0):
    """K8 or K9 on the device operands d = (row_ptr, col_src, w, vals)."""
    if op == "copy":
        return seg.gather_segment_sum(d[3], d[0], d[1], tasks)
    return seg.cf_edge_sum(d[3], d[0], d[1], d[2], tasks, row_base)


def _ordered(op, row_ptr, col_src, w, vals, tasks, row_base=0):
    """The kernel's summation order on the CPU (tests/torch_pull_order.py)."""
    hubs = tasks.tasks[:tasks.n_hub, 0].cpu().numpy()
    return ordered_pull_sum(vals, row_ptr.numpy(), col_src, hubs,
                            weights=None if op == "copy" else w,
                            row_base=row_base)


@pytest.mark.parametrize("op,width", [("copy", 1), ("cf_sgd", 20)])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("thresholds", PULL_SCHEDULES)
def test_pull_kernels_match_plain(dev, op, width, exact, thresholds):
    # Bitwise on small integers, within the tolerances on floats; and
    # bitwise on both against the kernel's order emulated on the CPU.
    # The rows are empty, a lane's, a warp's and a hub block's.
    row_ptr, col_src, w, vals = _pull_operands(width, exact)
    if op == "copy":
        want = seg.gather_segment_sum(vals, row_ptr, col_src)
        tol = dict(rtol=RTOL, atol=ATOL)
    else:
        want = seg.cf_edge_sum(vals, row_ptr, col_src, w)
        tol = CF_TOL
    d = [t.to(dev) for t in (row_ptr, col_src, w, vals)]
    tasks = (seg.pull_row_tasks(row_ptr.numpy(), op, dev)
             if thresholds is None else
             seg.RowTasks.build(row_ptr.numpy(), dev, *thresholds))
    assert tasks.n_hub >= 1
    _cuda.reset_launches()
    got = _pull_call(op, d, tasks)
    assert _cuda.LAUNCHES[("gather_segment_sum" if op == "copy"
                           else "cf_edge_sum")] == 1
    got = got.cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    if exact:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    assert torch.equal(got, _ordered(op, row_ptr, col_src, w, vals, tasks))


@pytest.mark.parametrize("op,width", [("copy", 1), ("cf_sgd", 20)])
def test_pull_kernels_are_deterministic(dev, op, width):
    # No atomics: two calls are bitwise equal, on an R-MAT's skewed rows
    # as on a ratings graph's hub items.
    g = (generate.rmat(12, 16, seed=4) if op == "copy"
         else generate.bipartite_ratings(2000, 60, 60000, seed=4))
    rng = np.random.default_rng(9)
    shape = (g.nv,) if width == 1 else (g.nv, width)
    vals = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    w = None if g.weights is None else torch.from_numpy(g.weights).to(dev)
    d = (torch.from_numpy(g.row_ptr).to(dev),
         torch.from_numpy(g.col_src).to(dev), w, vals)
    tasks = seg.pull_row_tasks(g.row_ptr, op, dev)
    first = _pull_call(op, d, tasks)
    assert torch.equal(_pull_call(op, d, tasks), first)


def test_pull_wrappers_check_their_inputs(dev):
    row_ptr, col_src, w, vals = (t.to(dev) for t in _pull_operands(20, True))
    tasks = seg.pull_row_tasks(row_ptr.cpu().numpy(), "cf_sgd", dev)
    # K8 is compiled for scalar values, K9 for K = 20 only.
    with pytest.raises(NotImplementedError):
        seg.gather_segment_sum(vals, row_ptr, col_src, tasks)
    with pytest.raises(NotImplementedError):
        seg.cf_edge_sum(vals[:, :4].contiguous(), row_ptr, col_src, w, tasks)
    with pytest.raises(ValueError, match="int32"):
        seg.cf_edge_sum(vals, row_ptr, col_src, w.long(), tasks)
    with pytest.raises(ValueError, match="RowTasks"):
        seg.cf_edge_sum(vals, row_ptr, col_src, w)
    with pytest.raises(ValueError, match="RowTasks"):
        seg.gather_segment_sum(vals[:, 0].contiguous(), row_ptr, col_src)
    with pytest.raises(ValueError, match="K-vectors"):
        seg.cf_edge_sum(vals[:, 0].contiguous(), row_ptr, col_src, w, tasks)
    other = seg.pull_row_tasks(row_ptr.cpu().numpy()[:-1], "cf_sgd", dev)
    with pytest.raises(ValueError, match="tasks cover"):
        seg.cf_edge_sum(vals, row_ptr, col_src, w, other)
    with pytest.raises(ValueError, match="must hold rows"):
        seg.cf_edge_sum(vals, row_ptr, col_src, w, tasks, row_base=1)


@pytest.mark.parametrize("app", ["cf", "pagerank"])
@pytest.mark.parametrize("edge_chunk", [0, 256])
def test_pull_executor_on_cuda_counts_launches(dev, app, edge_chunk):
    if app == "cf":
        g = generate.bipartite_ratings(300, 40, 6000, seed=2)
        prog, kernel, tol = CollaborativeFiltering(), "cf_edge_sum", CF_TOL
    else:
        g = generate.rmat(10, 8, seed=3)
        prog, kernel = PageRank(), "gather_segment_sum"
        tol = dict(rtol=RTOL, atol=ATOL)
    ex = PullExecutor(g, prog, edge_chunk=edge_chunk)
    assert ex.device.type == "cuda" and ex.edge_chunk == edge_chunk
    cpu = PullExecutor(g, prog, device="cpu", edge_chunk=edge_chunk)
    _cuda.reset_launches()
    got = ex.run(5)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    np.testing.assert_allclose(got.cpu().numpy(), cpu.run(5).numpy(), **tol)
    if app == "cf":
        np.testing.assert_allclose(got.cpu().numpy(),
                                   reference_colfilter(g, 5), **tol)
    assert counts == {**dict.fromkeys(counts, 0), kernel: 5}


def test_pull_program_without_edge_op_raises_on_cuda(dev):
    class Plain(CollaborativeFiltering):
        edge_op = None

    class Other(CollaborativeFiltering):
        # Inherits edge_op="cf_sgd" but computes another edge function.
        def edge_contrib(self, edge):
            return edge.src_vals

    g = generate.bipartite_ratings(50, 20, 400, seed=1)
    for prog in (Plain(), Other()):
        with pytest.raises(NotImplementedError):
            PullExecutor(g, prog).run(1)


# -- GAS kernels (K10, K11): bitwise against their plain versions -----------


def _gas_operands(nv, gather_op, frac, k, seed):
    """GAS storage for ``gather_op``: (nv,) or (nv, k) uint32 values over
    the whole range (wrapping under add1, hops 0 under decay) as int32
    words, or f32 distances with some +inf; a random bool frontier."""
    rng = np.random.default_rng(seed)
    shape = (nv,) if k == 1 else (nv, k)
    if gather_op == "add_w":
        vals = rng.integers(0, 10**6, size=shape).astype(np.float32)
        vals[rng.random(shape) < 0.2] = np.inf
        t = torch.from_numpy(vals)
    else:
        vals = rng.integers(0, 2**32, size=shape,
                            dtype=np.uint64).astype(np.uint32)
        vals[rng.random(shape) < 0.1] = np.uint32(0xFFFFFFFF)
        t = seg.to_u32_storage(vals)
    return t, torch.from_numpy(rng.random(shape) < frac)


def _gas_csc(seed):
    """A CSC with rows of every K10 tier: short and empty rows (a lane),
    rows of 33-2,048 edges (the warp), a row alone above 1,024 and hub
    rows above HUB_EDGES edges (a block)."""
    rng = np.random.default_rng(seed)
    nv = 3000
    lens = rng.integers(0, 20, nv)
    lens[rng.random(nv) < 0.2] = 0
    lens[[5, 6, 7]] = [33, 500, 1500]
    lens[[100, 2999]] = [9000, 20000]
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    w = rng.integers(1, 100, int(row_ptr[-1])).astype(np.int32)
    return nv, row_ptr, w, rng


@pytest.mark.parametrize("kind,gather_op", seg.GAS_KERNEL_OPS)
@pytest.mark.parametrize("k", [1, 3, 8, 9])
def test_gas_pull_acc_matches_plain(dev, kind, gather_op, k):
    # Frontier densities from empty to full, on one table and on a split
    # table (three times the rows, col_src a view that is not 16-byte
    # aligned); bitwise.
    nv, row_ptr, w, rng = _gas_csc(k)
    ne = int(row_ptr[-1])
    tasks = seg.RowTasks.build(row_ptr, dev)
    assert tasks.n_hub == 2
    rp = torch.from_numpy(row_ptr)
    wt = torch.from_numpy(w)
    for split in (False, True):
        n_tab = 3 * nv if split else nv
        buf = torch.from_numpy(rng.integers(0, n_tab, ne + 1)
                               .astype(np.int32))
        col_src = buf[1:] if split else buf[:ne]
        for frac in (0.0, 1e-4, 0.06, 0.5, 1.0):
            vals, fr = _gas_operands(n_tab, gather_op, frac, k,
                                     seed=int(frac * 1e4) + k)
            want = seg.gas_pull_acc(rp, col_src, vals, fr, kind, gather_op,
                                    weights=wt)
            got = seg.gas_pull_acc(rp.to(dev), col_src.to(dev) if not split
                                   else buf.to(dev)[1:], vals.to(dev),
                                   fr.to(dev), kind, gather_op, tasks,
                                   weights=wt.to(dev))
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.cpu(), want), (split, frac)


@pytest.mark.parametrize("k", [1, 3, 8, 9])
def test_frontier_bits_match_plain(dev, k):
    rng = np.random.default_rng(k)
    for n in (1, 31, 1000, 4097):
        shape = (n,) if k == 1 else (n, k)
        fr = torch.from_numpy(rng.random(shape) < 0.4)
        got = seg.frontier_bits(fr.to(dev))
        assert torch.equal(got.cpu(), seg.frontier_bits_plain(fr))


def test_gas_pull_acc_on_an_rmat(dev):
    # The item lengths of the old schedule no longer matter: one RowTasks
    # per graph, on an R-MAT's skewed rows.
    g = generate.rmat(11, 12, seed=5, weighted=True)
    tasks = seg.RowTasks.build(g.row_ptr, dev)
    row_ptr = torch.from_numpy(g.row_ptr)
    col_src = torch.from_numpy(g.col_src)
    w = torch.from_numpy(g.weights)
    for kind, gather_op in seg.GAS_KERNEL_OPS:
        vals, fr = _gas_operands(g.nv, gather_op, 0.3, 1, seed=1)
        want = seg.gas_pull_acc(row_ptr, col_src, vals, fr, kind, gather_op,
                                weights=w)
        _cuda.reset_launches()
        got = seg.gas_pull_acc(row_ptr.to(dev), col_src.to(dev),
                               vals.to(dev), fr.to(dev), kind, gather_op,
                               tasks, weights=w.to(dev))
        assert _cuda.LAUNCHES["gas_pull_acc"] == 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind,gather_op", seg.GAS_KERNEL_OPS)
@pytest.mark.parametrize("nv,frac", [(4096 * 3 + 5, 0.02), (1000, 1.0),
                                     (5000, 0.0)])
def test_gas_push_acc_matches_plain(dev, kind, gather_op, nv, frac):
    g = generate.gnp(nv, nv * 6, seed=7, weighted=True)
    csr = g.csr()
    rp = torch.from_numpy(csr.row_ptr)
    col_dst = torch.from_numpy(csr.col_dst)
    cw = torch.from_numpy(csr.weights)
    vals, fr = _gas_operands(nv, gather_op, frac, 1, seed=nv)
    cnt = int(fr.sum())
    q, start, _, offs = fq.frontier_queue(fr.to(dev), rp.to(dev), cnt)
    total = int(offs[-1])
    want = fq.gas_push_acc(q.cpu(), start.cpu(), offs.cpu(), col_dst, vals,
                           kind, gather_op, total, weights=cw)
    got = fq.gas_push_acc(q, start, offs, col_dst.to(dev), vals.to(dev),
                          kind, gather_op, total, weights=cw.to(dev))
    assert got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("which", ["first", "cap"])
@pytest.mark.parametrize("kind,gather_op", [("min", "add1"),
                                            ("min", "add_w"),
                                            ("sum", "one")])
def test_gas_push_acc_over_receivers_matches_plain(dev, kind, gather_op,
                                                   which, parts):
    # The sharded GAS push branch's K11: one launch over the P receiving
    # parts' push CSRs, from the flat (P, max_nv) values, on a first
    # frontier (vertex 0) and at the per-part queue cap; bitwise against
    # the plain version and against P one-receiver launches.
    from lux_tpu_torch.engine.push import _sparse_budgets
    from lux_tpu_torch.parallel.shard import ShardedGraph

    g = generate.rmat(12, 10, seed=1, weighted=True)
    sg = ShardedGraph.build(g, parts)
    prp, pdst, pw = (torch.from_numpy(a) for a in sg.build_push_csr())
    prp = prp.long()
    n = sg.max_nv
    rng = np.random.default_rng(parts)
    fr = np.zeros((parts, n), bool)
    if which == "first":
        fr[0, 0] = True
    else:
        cap = _sparse_budgets(n, sg.max_ne, 16, 8)[0]
        for p in range(parts):
            nv_p = int(sg.local_nv[p])
            fr[p, rng.choice(nv_p, min(nv_p, cap), replace=False)] = True
    part, local = np.nonzero(fr)
    rows = torch.from_numpy((part * n + local).astype(np.int32))
    ids = torch.from_numpy(local + sg.row_left[part])
    start = prp[:, ids]
    offs = torch.nn.functional.pad((prp[:, ids + 1] - start).cumsum(1),
                                   (1, 0))
    total = int(offs[:, -1].sum())
    vals, _ = _gas_operands(parts * n, gather_op, 0.0, 1, seed=parts)
    vals = vals.reshape(parts, n)
    want = fq.gas_push_acc(rows, start, offs, pdst, vals, kind, gather_op,
                           total, weights=pw)
    on = [x.to(dev) for x in (rows, start, offs, pdst, vals, pw)]
    _cuda.reset_launches()
    got = fq.gas_push_acc(*on[:5], kind, gather_op, total, weights=on[5])
    assert _cuda.LAUNCHES["gas_push_acc"] == 1
    assert got.shape == (parts, n) and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)
    for p in range(parts):
        # One receiver: its local destinations index the first n words of
        # an accumulator of the flat values' shape.
        one = fq.gas_push_acc(on[0], on[1][p].contiguous(),
                              on[2][p].contiguous(), on[3][p].contiguous(),
                              on[4].reshape(-1), kind, gather_op,
                              int(offs[p, -1]), weights=on[5][p].contiguous())
        assert torch.equal(one[:n].cpu(), want[p])


def test_gas_wrappers_check_their_inputs(dev):
    g = generate.rmat(8, 8, seed=1, weighted=True)
    rp = torch.from_numpy(g.row_ptr).to(dev)
    cs = torch.from_numpy(g.col_src).to(dev)
    tasks = seg.RowTasks.build(g.row_ptr, dev)
    vals, fr = _gas_operands(g.nv, "add1", 0.5, 1, seed=1)
    vals, fr = vals.to(dev), fr.to(dev)
    with pytest.raises(NotImplementedError):
        seg.gas_pull_acc(rp, cs, vals, fr, "min", "decay", tasks)
    with pytest.raises(ValueError, match="float32"):
        seg.gas_pull_acc(rp, cs, vals, fr, "min", "add_w", tasks,
                         weights=torch.from_numpy(g.weights).to(dev))
    with pytest.raises(ValueError, match="RowTasks"):
        seg.gas_pull_acc(rp, cs, vals, fr, "min", "add1")
    with pytest.raises(ValueError, match="shape"):
        seg.gas_pull_acc(rp, cs, vals, fr[:-1], "min", "add1", tasks)
    f32 = torch.zeros(g.nv, device=dev)
    with pytest.raises(ValueError, match="weights"):
        seg.gas_pull_acc(rp, cs, f32, fr, "min", "add_w", tasks)


def _gas_app(app):
    g = generate.rmat(12, 10, seed=1, weighted=True)
    gu = generate.undirected(g)
    if app == "bfs":
        return g, BFS(), {"start": 0}, reference_bfs(g, 0)[0]
    if app == "sssp_delta":
        return gu, DeltaSSSP(), {"start": 0}, reference_sssp_delta(gu, 0)
    if app == "labelprop":
        return g, LabelPropagation(), {}, reference_labelprop(g)
    return gu, KCore(4), {}, reference_kcore(gu, 4)


@pytest.mark.parametrize("mode", gas.GAS_MODES)
@pytest.mark.parametrize("app", ["bfs", "sssp_delta", "labelprop", "kcore"])
def test_gas_executor_on_cuda_counts_launches(dev, app, mode):
    g, prog, kw, ref = _gas_app(app)
    ex = gas.AdaptiveExecutor(g, prog, mode=mode)
    assert ex.device.type == "cuda"
    cpu = gas.AdaptiveExecutor(g, prog, device="cpu", mode=mode)
    _cuda.reset_launches()
    state, iters = ex.run(**kw)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    cstate, citers = cpu.run(**kw)
    np.testing.assert_array_equal(ex.values(state), ref)
    np.testing.assert_array_equal(ex.values(state), cpu.values(cstate))
    assert (iters, ex.push_iters, ex.direction_switches) == (
        citers, cpu.push_iters, cpu.direction_switches)
    log = ex.direction_log
    assert counts["gas_pull_acc"] == sum(1 for d, _, _ in log if d == 0)
    assert counts["frontier_queue"] == sum(
        1 for d, c, _ in log if d == 1 and c > 0)
    assert counts["gas_push_acc"] == sum(
        1 for d, c, e in log if d == 1 and c > 0 and e > 0)
    assert counts == {**dict.fromkeys(counts, 0),
                      **{n: counts[n] for n in ("gas_pull_acc",
                                                "frontier_queue",
                                                "gas_push_acc")}}


def test_multi_source_gas_on_cuda(dev):
    g = generate.undirected(generate.rmat(11, 8, seed=2, weighted=True))
    roots = list(range(0, 90, 10))
    for prog in (BFS(), DeltaSSSP()):
        mx = gas.MultiSourceGasExecutor(g, prog, k=len(roots))
        _cuda.reset_launches()
        st, iters = mx.run(roots)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["gas_pull_acc"] == iters
        ex = gas.AdaptiveExecutor(g, prog)
        for j, r in enumerate(roots):
            single, _ = ex.run(start=r)
            np.testing.assert_array_equal(mx.values_for(st, j),
                                          ex.values(single))
        _cuda.reset_launches()
        mx.warmup(start=roots[0])
        assert _cuda.LAUNCHES["gas_pull_acc"] == 1
        assert mx.pull_iters == iters


def test_gas_pagerank_adapter_on_cuda(dev):
    g = generate.rmat(10, 8, seed=3)
    ex = gas.AdaptiveExecutor(g, gas.as_gas(PageRank()))
    _cuda.reset_launches()
    st, iters = ex.run(max_iters=10)
    torch.cuda.synchronize()
    assert iters == 10 and _cuda.LAUNCHES["gather_segment_sum"] == 10
    cpu = PullExecutor(g, PageRank(), device="cpu")
    np.testing.assert_allclose(ex.values(st), cpu.run(10).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_gas_program_the_kernels_do_not_cover_raises_on_cuda(dev):
    class Apart(BFS):
        def gather(self, src_vals, weights):
            return src_vals

    g = generate.gnp(300, 2000, seed=2)
    with pytest.raises(NotImplementedError):
        gas.AdaptiveExecutor(g, Apart())
    with pytest.raises(NotImplementedError):
        gas.MultiSourceGasExecutor(g, Apart(), k=2)


# -- the sharded pull engine (K8, K9 per part) -------------------------------


@pytest.mark.parametrize("op,width", [("copy", 1), ("cf_sgd", 20)])
@pytest.mark.parametrize("exact", [True, False])
def test_pull_kernels_on_a_part_of_a_flat_table(dev, op, width, exact):
    # The destination rows of the part lie at row_base in a table of
    # several parts' rows; the sources anywhere in it. Its col_src is a
    # view that starts at an odd word (not 16-byte aligned), as a part's
    # view of the stacked src_pidx may. Bitwise against the kernel's
    # order, and against the plain version on small integers.
    row_ptr, col_src, w, vals = _pull_operands(width, exact)
    nv = row_ptr.shape[0] - 1
    rng = np.random.default_rng(8)
    table = torch.cat([vals, vals.flip(0), vals * 0.5])
    buf = torch.from_numpy(
        rng.integers(0, 3 * nv, size=col_src.shape[0] + 1).astype(np.int32))
    col_src = buf[1:]
    tasks = seg.pull_row_tasks(row_ptr.numpy(), op, dev)
    d_buf = buf.to(dev)
    d = (row_ptr.to(dev), d_buf[1:], w.to(dev), table.to(dev))
    assert d[1].data_ptr() % 16
    for base in (0, nv, 2 * nv):
        if op == "copy":
            want = seg.gather_segment_sum(table, row_ptr, col_src)
            tol = dict(rtol=RTOL, atol=ATOL)
        else:
            want = seg.cf_edge_sum(table, row_ptr, col_src, w, row_base=base)
            tol = CF_TOL
        got = _pull_call(op, d, tasks, base).cpu()
        assert got.shape == want.shape == (nv,) + tuple(vals.shape[1:])
        if exact:
            assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
        assert torch.equal(got, _ordered(op, row_ptr, col_src, w, table,
                                         tasks, base))


def test_cf_edge_sum_on_compact_tables(dev):
    # Each part's K9 launch on its receiver table of the compact exchange
    # (its own span written from its shard, the rows its edges read from
    # the others) equals its launch on the full flat table bitwise.
    from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
    from lux_tpu_torch.parallel.mesh import CompactExchange

    g = generate.bipartite_ratings(400, 30, 8000, seed=3)
    ex = ShardedPullExecutor(g, CollaborativeFiltering(), num_parts=3)
    xch = CompactExchange(ex.sg.exchange_plan(), ex.mesh, ex.sg.max_nv)
    vals = ex.init_values()
    full, tables = ex.mesh.all_gather(vals), xch.tables(vals)
    for q, part in enumerate(ex._parts):
        args = (part.row_ptr, part.col_src, part.weights, part.tasks,
                part.row_base)
        assert torch.equal(seg.cf_edge_sum(tables[q], *args),
                           seg.cf_edge_sum(full, *args))


@pytest.mark.parametrize("parts", [1, 3, 4])
@pytest.mark.parametrize("app", ["pagerank", "cf"])
def test_sharded_pull_on_cuda(dev, monkeypatch, app, parts):
    from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor

    if app == "cf":
        g = generate.bipartite_ratings(300, 40, 6000, seed=2)
        prog, kernel, tol, iters = (CollaborativeFiltering(), "cf_edge_sum",
                                    CF_TOL, 5)
    else:
        g = generate.rmat(11, 8, seed=3)
        prog, kernel = PageRank(), "gather_segment_sum"
        tol, iters = dict(rtol=RTOL, atol=ATOL), 10
    single = PullExecutor(g, prog).run(iters)
    outs = {}
    for mode in ("full", "compact"):
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        ex = ShardedPullExecutor(g, prog, num_parts=parts)
        cpu = ShardedPullExecutor(g, prog, num_parts=parts, device="cpu")
        assert ex.exchange_mode == cpu.exchange_mode
        _cuda.reset_launches()
        out = ex.run(iters)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        assert counts == {**dict.fromkeys(counts, 0), kernel: parts * iters}
        got = ex.gather_values(out)
        np.testing.assert_allclose(got, cpu.gather_values(cpu.run(iters)),
                                   **tol)
        # Each row summed in the order the single-device kernel takes.
        np.testing.assert_array_equal(got, single.cpu().numpy())
        outs[mode] = out
    assert torch.equal(outs["compact"], outs["full"])


# -- the multi-source and sharded push engines (K5-K7, K10 per part) ---------


def test_split_table_wrappers_match_plain(dev):
    # K7 over P receivers in one launch: each reads the flat (P * n)
    # table at q and combines into its own row of a copy of it; K10
    # reads a table of more rows than its row_ptr's, which sizes the
    # output.
    g = generate.gnp(5000, 30000, seed=7)
    csr = g.csr()
    rp, col_dst = torch.from_numpy(csr.row_ptr), torch.from_numpy(csr.col_dst)
    vals, fr = _push_operands(3 * g.nv, 4, 0.0)
    fr[g.nv:2 * g.nv] = torch.rand(g.nv) < 0.05
    q, start, _, offs = fq.frontier_queue(fr[g.nv:2 * g.nv], rp,
                                          int(fr[g.nv:2 * g.nv].sum()))
    rows = q + g.nv
    table = vals.reshape(3, g.nv)
    starts, offss = torch.stack([start] * 3), torch.stack([offs] * 3)
    cols = torch.stack([col_dst, g.nv - 1 - col_dst, col_dst.flip(0)])
    total = 3 * int(offs[-1])
    for kind, relax_op in (("min", "add1"), ("max", "copy")):
        want = _k7_per_part(rows, starts, offss, cols, table, kind, relax_op)
        _cuda.reset_launches()
        got = fq.queue_relax_scatter(*(x.to(dev) for x in (
            rows, starts, offss, cols, table)), kind, relax_op, total)
        assert _cuda.LAUNCHES["queue_relax_scatter"] == 1
        assert torch.equal(got.cpu(), want)
    gk = generate.rmat(11, 12, seed=5)
    lanes, front = _gas_operands(3 * gk.nv, "add1", 0.3, 8, seed=2)
    col_src = torch.from_numpy(
        np.random.default_rng(3).integers(0, 3 * gk.nv, gk.ne)
        .astype(np.int32))
    row_ptr = torch.from_numpy(gk.row_ptr)
    tasks = seg.RowTasks.build(gk.row_ptr, dev)
    for kind, op in (("min", "add1"), ("max", "copy")):
        want = seg.gas_pull_acc(row_ptr, col_src, lanes, front, kind, op)
        got = seg.gas_pull_acc(row_ptr.to(dev), col_src.to(dev),
                               lanes.to(dev), front.to(dev), kind, op, tasks)
        assert got.shape == want.shape == (gk.nv, 8)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("app", ["sssp", "cc"])
def test_multi_source_push_on_cuda(dev, app):
    from lux_tpu_torch.engine.push import MultiSourcePushExecutor

    g = generate.rmat(12, 10, seed=1)
    if app == "cc":
        g = generate.undirected(g)
    prog = SSSP() if app == "sssp" else ConnectedComponents()
    roots = [0, 3, 11, 40, 77, 100, 512, 4000]
    mx = MultiSourcePushExecutor(g, prog, k=len(roots))
    _cuda.reset_launches()
    st, iters = mx.run(roots)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES == {**dict.fromkeys(_cuda.LAUNCHES, 0),
                              "gas_pull_acc": iters}
    single = PushExecutor(g, prog)
    longest = 0
    for j, r in enumerate(roots):
        s, n = single.run(start=r)
        longest = max(longest, n)
        np.testing.assert_array_equal(mx.values_for(st, j), single.values(s))
    assert iters == longest and mx.sparse_iters == 0


@pytest.mark.parametrize("parts", [1, 3, 4])
@pytest.mark.parametrize("app", ["sssp", "cc"])
def test_sharded_push_on_cuda(dev, monkeypatch, app, parts):
    from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor

    g = generate.rmat(12, 10, seed=1)
    if app == "sssp":
        prog, kw, ref = SSSP(), {"start": 0}, reference_sssp(g, 0)
    else:
        g = generate.undirected(g)
        prog, kw, ref = ConnectedComponents(), {}, reference_components(g)
    single = PushExecutor(g, prog)
    sstate, siters = single.run(**kw)
    outs = {}
    for mode, blocked in (("full", True), ("full", False),
                          ("compact", None)):
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        ex = ShardedPushExecutor(g, prog, num_parts=parts, queue_frac=4,
                                 edge_budget_frac=2, blocked_dense=blocked)
        cpu = ShardedPushExecutor(g, prog, num_parts=parts, device="cpu",
                                  queue_frac=4, edge_budget_frac=2,
                                  blocked_dense=blocked)
        _cuda.reset_launches()
        state, iters = ex.run(**kw)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        cstate, citers = cpu.run(**kw)
        got = ex.gather_values(state)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, cpu.gather_values(cstate))
        np.testing.assert_array_equal(got, single.values(sstate))
        assert (iters, ex.sparse_iters) == (citers, cpu.sparse_iters)
        assert iters == siters and 0 < ex.sparse_iters < iters
        with_edges = sum(1 for p in ex._parts if p.col_src.numel())
        dense = iters - ex.sparse_iters
        assert counts == {
            **dict.fromkeys(counts, 0),
            "segment_minmax_relax": with_edges * dense,
            "frontier_queue": sum(k6 for k6, _ in ex.queue_log),
            "queue_relax_scatter": sum(k7 for _, k7 in ex.queue_log)}
        outs[mode, blocked] = state.values
    assert torch.equal(outs["compact", None], outs["full", False])
    assert torch.equal(outs["full", True], outs["full", False])


@pytest.mark.parametrize("parts", [1, 4])
def test_sharded_multi_source_push_on_cuda(dev, monkeypatch, parts):
    from lux_tpu_torch.engine.push import MultiSourcePushExecutor
    from lux_tpu_torch.engine.push_sharded import (
        ShardedMultiSourcePushExecutor,
    )

    g = generate.rmat(12, 10, seed=1)
    roots = [0, 3, 11, 40, 77]
    want, witers = MultiSourcePushExecutor(g, SSSP(), k=8).run(roots)
    for mode in ("full", "compact"):
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        ex = ShardedMultiSourcePushExecutor(g, SSSP(), 8, num_parts=parts)
        _cuda.reset_launches()
        st, iters = ex.run(roots)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES == {**dict.fromkeys(_cuda.LAUNCHES, 0),
                                  "gas_pull_acc": parts * iters}
        assert iters == witers
        np.testing.assert_array_equal(ex.gather_values(st),
                                      seg.u32_to_numpy(want.values))


# -- the sharded tiled engine (K1, K2 per part) and the gather probes ---------


@pytest.mark.parametrize("levels", [((8, 2),), ((128, 8), (8, 2)),
                                    ((8, 10 ** 9),)])
@pytest.mark.parametrize("parts", [1, 3, 4])
def test_sharded_tiled_on_cuda(dev, monkeypatch, parts, levels):
    from lux_tpu_torch.engine.tiled_sharded import ShardedTiledExecutor

    g = generate.rmat(11, 8, seed=3)
    plan = ts.plan_hybrid(g, levels=levels)
    single = TiledPullExecutor(g, PageRank(), plan=plan).run(10)
    monkeypatch.setenv("LUX_EXCHANGE", "full")
    ex = ShardedTiledExecutor(g, PageRank(), num_parts=parts, plan=plan)
    cpu = ShardedTiledExecutor(g, PageRank(), num_parts=parts, plan=plan,
                               device="cpu")
    _cuda.reset_launches()
    out = ex.run(10)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    k1 = sum(1 for p in ex._parts for lev in p.levels if lev.items.n_items)
    k2 = len(ex._parts)   # K2 launches for every part with rows
    assert counts == {**dict.fromkeys(counts, 0), "strip_spmv": 10 * k1,
                      "tail_gather_sum": 10 * k2}
    got = ex.gather_values(out)
    np.testing.assert_allclose(got, cpu.gather_values(cpu.run(10)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, single.cpu().numpy(), rtol=RTOL,
                               atol=ATOL)
    new, times = ex.phase_step(out)
    assert set(times) == {"exchange", "strips", "tail", "apply"}
    assert torch.equal(new, ex.step(out))


@pytest.mark.parametrize("parts", [2, 4])
def test_sharded_tiled_compact_equals_full_on_cuda(dev, monkeypatch, parts):
    from lux_tpu_torch.engine.tiled_sharded import ShardedTiledExecutor

    g = generate.undirected(generate.cycle_graph(20000))
    outs = {}
    for mode in ("full", "compact"):
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        ex = ShardedTiledExecutor(g, PageRank(), num_parts=parts,
                                  levels=((8, 1),))
        assert ex.exchange_mode == mode
        outs[mode] = ex.run(10)
    assert torch.equal(outs["compact"], outs["full"])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8])
@pytest.mark.parametrize("axis,rows", [(1, 4096), (0, 8), (0, 512)])
def test_block_take_matches_plain(dev, axis, rows, dtype):
    from lux_tpu_torch.probes import gather as pg

    rng = np.random.default_rng(axis + rows)
    x = torch.from_numpy(rng.standard_normal((2 * rows, 128),
                                             dtype=np.float32))
    hi = rows if axis == 0 else 128
    idx = torch.from_numpy(rng.integers(0, min(hi, 128), x.shape)
                           .astype(np.int32)).to(dtype)
    _cuda.reset_launches()
    got = pg.block_take(x.to(dev), idx.to(dev), axis, rows)
    strip = axis == 0 and pg.strip_plan(rows, 128, dtype) is not None
    assert _cuda.LAUNCHES[pg.take_kernel(axis, dtype, strip)] == 1
    assert torch.equal(got.cpu(), pg.block_take_plain(x, idx, axis, rows))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8])
@pytest.mark.parametrize("S,blocks", [(512, 3), (4096, 2), (8192, 2)])
def test_block_take_strip_matches_plain(dev, S, blocks, dtype):
    """P2's axis-0 gather over large blocks: bitwise the plain version
    with indices at 0 and at the top of their range (S - 1; 127 for
    int8), through the planned kernel (the strip kernel for int32, the
    row kernel for int8), through every strip plan that fits, and with a
    misaligned x view, which the row kernel takes."""
    from lux_tpu_torch.probes import gather as pg

    rng = np.random.default_rng(S + blocks)
    rows = blocks * S
    x = torch.from_numpy(rng.standard_normal((rows, 128), dtype=np.float32))
    hi = min(S, 128) if dtype == torch.int8 else S
    draw = rng.integers(0, hi, (rows, 128))
    draw[0, :] = hi - 1
    draw[1, :] = 0
    draw[S - 1, ::2] = hi - 1
    draw[-1, 1::2] = 0
    idx = torch.from_numpy(draw.astype(np.int32)).to(dtype)
    xd, idd = x.to(dev), idx.to(dev)
    want = pg.block_take_plain(x, idx, 0, S)
    plan = pg.strip_plan(S, 128, dtype)
    assert (plan is None) == (dtype == torch.int8)
    _cuda.reset_launches()
    assert torch.equal(pg.block_take(xd, idd, 0, S).cpu(), want)
    assert _cuda.LAUNCHES[pg.take_kernel(0, dtype, plan is not None)] == 1
    assert sum(_cuda.LAUNCHES.values()) == 1
    if dtype == torch.int32:
        for w in pg.STRIP_WIDTHS:
            for r in (S, min(S, pg.STRIP_ROWS), S // 2, 1):
                if r * w * 4 > pg.STRIP_SMEM_MAX:
                    continue
                out = torch.empty_like(xd)
                pg.take_strip(xd, idd, S, w, r, out)
                assert torch.equal(out.cpu(), want), (w, r)
    # x one float past a 16-byte boundary: the row kernel takes it.
    flat = torch.empty(rows * 128 + 1, device=dev)
    xm = flat[1:].view(rows, 128)
    xm.copy_(xd)
    _cuda.reset_launches()
    assert torch.equal(pg.block_take(xm, idd, 0, S).cpu(), want)
    assert _cuda.LAUNCHES[pg.take_kernel(0, dtype)] == 1


@pytest.mark.parametrize("r", [1, 7, 13, 1001, 20003])
def test_merge4_edge_cases_match_plain(dev, r):
    # Rows not a multiple of a stage's 8 and more stages than the grid
    # holds at once; selectors outside [0, 4) give +0, and so do -0.0
    # candidates; lanes out of range are clamped into the row.
    from lux_tpu_torch.probes import gather as pg

    rng = np.random.default_rng(r)
    cand = rng.standard_normal((r, 4, 128), dtype=np.float32)
    cand[rng.random(cand.shape) < 0.2] = -0.0
    cand = torch.from_numpy(cand)
    lane = torch.from_numpy(rng.integers(0, 128, (r, 128), dtype=np.int32))
    sel = torch.from_numpy(rng.integers(-3, 7, (r, 128), dtype=np.int32))
    _cuda.reset_launches()
    got = pg.merge4(cand.to(dev), lane.to(dev), sel.to(dev)).cpu()
    assert _cuda.LAUNCHES["merge4"] == 1
    want = pg.merge4_plain(cand, lane, sel)
    assert torch.equal(got, want)
    assert not torch.signbit(got[got == 0]).any()
    assert torch.equal(got[(sel < 0) | (sel > 3)],
                       torch.zeros(int(((sel < 0) | (sel > 3)).sum())))
    wild = torch.from_numpy(rng.integers(-500, 500, (r, 128),
                                         dtype=np.int32))
    got = pg.merge4(cand.to(dev), wild.to(dev), sel.to(dev)).cpu()
    assert torch.equal(got, pg.merge4_plain(cand, wild.clamp(0, 127), sel))


def test_merge4_and_merge_level_match_plain(dev):
    from lux_tpu_torch.probes import gather as pg

    rng = np.random.default_rng(6)
    r = 1000
    cand = torch.from_numpy(rng.standard_normal((r, 4, 128),
                                                dtype=np.float32))
    lane = torch.from_numpy(rng.integers(0, 128, (r, 128), dtype=np.int32))
    sel = torch.from_numpy(rng.integers(-1, 5, (r, 128), dtype=np.int32))
    got = pg.merge4(cand.to(dev), lane.to(dev), sel.to(dev))
    assert torch.equal(got.cpu(), pg.merge4_plain(cand, lane, sel))
    g = 300
    stream = torch.from_numpy(rng.standard_normal((8 * g + 8, 128),
                                                  dtype=np.float32))
    aoff = torch.from_numpy(rng.integers(0, g, g).astype(np.int32))
    boff = torch.from_numpy(rng.integers(0, g, g).astype(np.int32))
    idx = torch.from_numpy(rng.integers(-128, 128, (16 * g, 128))
                           .astype(np.int8))
    _cuda.reset_launches()
    got = pg.merge_level(stream.to(dev), aoff.to(dev), boff.to(dev),
                         idx.to(dev))
    assert _cuda.LAUNCHES["level_apply"] == 1
    assert torch.equal(got.cpu(), pg.merge_level_plain(stream, aoff, boff,
                                                       idx))


# -- the app CLIs: main(argv) on the card against the same argv on the CPU ----

CLI_APPS = {
    # app -> (graph file, argv beyond -file, tolerance or None for bitwise)
    "pagerank": ("g.lux", ["-ni", "10", "-check"], (5e-5, 1e-9)),
    "colfilter": ("r.lux", ["-ni", "5", "-check"], (1e-4, 1e-7)),
    "sssp": ("g.lux", ["-start", "0", "-check"], None),
    "components": ("u.lux", ["-check"], None),
    "bfs": ("g.lux", ["-start", "0", "-check"], None),
    "sssp_delta": ("w.lux", ["-start", "0", "-check"], None),
}


@pytest.fixture(scope="module")
def cli_graphs(tmp_path_factory):
    from lux_tpu_torch.graph import write_lux

    d = tmp_path_factory.mktemp("cuda_cli")
    gw = generate.rmat(10, 16, seed=42, weighted=True)
    g = generate.rmat(10, 16, seed=42)
    write_lux(str(d / "g.lux"), g)
    write_lux(str(d / "w.lux"), gw)
    write_lux(str(d / "u.lux"), generate.undirected(g))
    write_lux(str(d / "r.lux"),
              generate.bipartite_ratings(800, 200, 8000, seed=11))
    return d


def _cli_run(app, argv, capsys):
    import importlib

    main = importlib.import_module(f"lux_tpu_torch.models.{app}").main
    capsys.readouterr()
    rc = main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("app", sorted(CLI_APPS))
def test_cli_on_cuda_equals_cpu(dev, cli_graphs, tmp_path, monkeypatch,
                                capsys, app):
    name, extra, tol = CLI_APPS[app]
    argv = ["-file", cli_graphs / name, *extra]
    saved = {}
    for where in ("cpu", "cuda"):
        if where == "cpu":
            monkeypatch.setenv("LUX_PLATFORM", "cpu")
        else:
            monkeypatch.delenv("LUX_PLATFORM", raising=False)
        ck = tmp_path / f"{where}.npz"
        rc, out, err = _cli_run(app, [*argv, "-save", ck], capsys)
        assert rc == 0 and "[PASS]" in out, out + err
        assert f"torch device: {where}" in err
        saved[where] = (np.load(ck), [ln for ln in out.splitlines()
                                      if ln.startswith("iterations")])
    (cpu, it_cpu), (card, it_card) = saved["cpu"], saved["cuda"]
    assert it_card == it_cpu
    assert card["values"].dtype == cpu["values"].dtype
    if tol is None:
        np.testing.assert_array_equal(card["values"], cpu["values"])
    else:
        np.testing.assert_allclose(card["values"], cpu["values"],
                                   rtol=tol[0], atol=tol[1])
    for key in set(cpu.files) - {"values"}:
        np.testing.assert_array_equal(card[key], cpu[key])


def _edited(g, seed, symmetric=False):
    """A 1% batch of random inserts and deletes of existing edges (both
    directions of each when ``symmetric``), the edited graph, and the
    (removed, inserted) arrays of the incremental path."""
    from lux_tpu_torch.graph import DeltaGraph, EdgeEdits
    from lux_tpu_torch.graph.delta import removed_edges

    rng = np.random.default_rng(seed)
    n = g.ne // 100
    ins_s = rng.integers(0, g.nv, n // 2)
    ins_d = rng.integers(0, g.nv, n // 2)
    e = rng.choice(g.ne, n - n // 2, replace=False)
    del_s, del_d = g.col_src[e].astype(np.int64), g.col_dst[e].astype(np.int64)
    if symmetric:
        ins_s, ins_d = np.r_[ins_s, ins_d], np.r_[ins_d, ins_s]
        del_s, del_d = np.r_[del_s, del_d], np.r_[del_d, del_s]
    ed = EdgeEdits(ins_src=ins_s, ins_dst=ins_d, ins_w=None,
                   del_src=del_s, del_dst=del_d)
    new = DeltaGraph.fresh(g).stack(ed).merged()
    return new, removed_edges(g, ed.del_src, ed.del_dst), (ed.ins_src,
                                                           ed.ins_dst)


@pytest.mark.parametrize("app", ["sssp", "cc"])
def test_incremental_push_on_cuda(dev, app):
    """Warm SSSP and CC on a 1% batch at scale 10: the card's values,
    iterations and info equal the CPU's, and the launches the branch
    log says (K5 dense, K6 and K7 sparse)."""
    from lux_tpu_torch.engine.incremental import IncrementalExecutor

    g = generate.rmat(10, 16, seed=42)
    if app == "cc":
        g = generate.undirected(g)
    prog, kw = (SSSP(), {"start": 0}) if app == "sssp" else (
        ConnectedComponents(), {})
    old_st, _ = PushExecutor(g, prog, device="cpu").run(**kw)
    old = seg.u32_to_numpy(old_st.values)
    new, removed, inserted = _edited(g, 17, symmetric=app == "cc")
    got = {}
    for where in ("cpu", "cuda"):
        inc = IncrementalExecutor(new, prog, device=where)
        _cuda.reset_launches()
        st, iters, info = inc.run(old, removed=removed, inserted=inserted,
                                  **kw)
        if where == "cuda":
            torch.cuda.synchronize()
            log = inc.push.branch_log
            assert _cuda.LAUNCHES == {
                **dict.fromkeys(_cuda.LAUNCHES, 0),
                "segment_minmax_relax": sum(1 for b, _, _ in log if b == 0),
                "frontier_queue": sum(1 for b, c, _ in log if b and c),
                "queue_relax_scatter": sum(1 for b, c, e in log
                                           if b and c and e)}
        got[where] = (inc.push.values(st), iters, info)
    np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
    assert got["cuda"][1:] == got["cpu"][1:]
    ref = (reference_sssp(new, 0) if app == "sssp"
           else reference_components(new))
    np.testing.assert_array_equal(got["cuda"][0], ref)


def test_incremental_multi_source_on_cuda(dev):
    from lux_tpu_torch.engine.incremental import IncrementalExecutor

    g = generate.rmat(10, 16, seed=42)
    roots = [0, 3, 11, 40, 77, 100, 512]
    single = PushExecutor(g, SSSP(), device="cpu")
    cols = [single.values(single.run(start=r)[0]) for r in roots]
    new, removed, inserted = _edited(g, 18)
    got = {}
    for where in ("cpu", "cuda"):
        inc = IncrementalExecutor(new, SSSP(), k=8, device=where)
        _cuda.reset_launches()
        st, iters, info = inc.run_multi(roots, cols, removed=removed,
                                        inserted=inserted)
        if where == "cuda":
            torch.cuda.synchronize()
            assert _cuda.LAUNCHES == {**dict.fromkeys(_cuda.LAUNCHES, 0),
                                      "gas_pull_acc": iters}
        got[where] = (seg.u32_to_numpy(st.values), iters, info)
    np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
    assert got["cuda"][1:] == got["cpu"][1:]
    for j, r in enumerate(roots):
        np.testing.assert_array_equal(got["cuda"][0][:, j],
                                      reference_sssp(new, r))


def test_incremental_pagerank_on_cuda(dev):
    """Warm PageRank (K8) at scale 10: the card's ranks within
    rtol=5e-5, atol=1e-9 of the CPU's plain run, equal iterations."""
    from lux_tpu_torch.engine.incremental import incremental_pagerank

    g = generate.rmat(10, 16, seed=42)
    old = PullExecutor(g, PageRank(), device="cpu").run(20)
    new, _, _ = _edited(g, 19)
    got = {}
    for where in ("cpu", "cuda"):
        _cuda.reset_launches()
        got[where] = incremental_pagerank(
            PullExecutor(new, PageRank(), device=where), old,
            g.out_degrees, 20, tol=1e-7)
        if where == "cuda":
            torch.cuda.synchronize()
            assert _cuda.LAUNCHES["gather_segment_sum"] == got[where][1]
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0], rtol=RTOL,
                               atol=ATOL)
    assert got["cuda"][1] == got["cpu"][1]


# -- serving on the card --------------------------------------------------

SERVE_ROOTS = (0, 3, 77, 300)


def _serve_cfg(**kw):
    from lux_tpu_torch.serve import ServeConfig

    kw.setdefault("max_batch", 4)
    kw.setdefault("window_s", 0.25)
    kw.setdefault("pagerank_iters", 10)
    return ServeConfig(**kw)


@pytest.fixture(scope="module")
def served_cuda():
    """A warm session on the card over the weighted R-MAT 10 (in memory,
    so PageRank takes the flat K8 path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from lux_tpu_torch.serve import Session

    g = generate.rmat(10, 16, seed=42, weighted=True)
    with Session(g, _serve_cfg(), device="cuda") as s:
        yield g, s


def _direct_rooted(g, prog, roots, lane_roots, dev):
    """Each of ``roots`` alone on the single-source executor, and
    ``lane_roots`` together as the lanes of a 4-wide multi-source one:
    (values, iterations) of each."""
    from lux_tpu_torch.engine.gas import (AdaptiveExecutor,
                                          MultiSourceGasExecutor)
    from lux_tpu_torch.engine.push import MultiSourcePushExecutor

    push = isinstance(prog, SSSP)
    one = (PushExecutor(g, prog, device=dev) if push
           else AdaptiveExecutor(g, prog, device=dev))
    singles = []
    for r in roots:
        st, it = one.run(start=r)
        singles.append((one.values(st), int(it)))
    multi = (MultiSourcePushExecutor(g, prog, k=4, device=dev) if push
             else MultiSourceGasExecutor(g, prog, k=4, device=dev))
    st, it = multi.run(list(lane_roots))
    return singles, [(multi.values_for(st, j), int(it))
                     for j in range(len(lane_roots))]


def test_session_on_cuda_equals_executors(served_cuda):
    """Every served app equals its executor run directly on the card,
    bitwise (PageRank too: the same K8 in the same order); no engine is
    built and nothing compiles after warmup."""
    from lux_tpu_torch.engine.gas import AdaptiveExecutor
    from lux_tpu_torch.models.cli import final_values

    g, s = served_cuda
    dev = torch.device("cuda")
    assert s.APPS == ("sssp", "components", "pagerank", "bfs", "kcore",
                      "labelprop", "sssp_delta")
    misses = s.pool.stats()["misses"]
    for app, prog in (("sssp", SSSP()), ("bfs", BFS()),
                      ("sssp_delta", DeltaSSSP())):
        singles, lanes = _direct_rooted(g, prog, SERVE_ROOTS[:2],
                                        SERVE_ROOTS[2:], dev)
        for r, (want, it) in zip(SERVE_ROOTS[:2], singles):
            got = s.query(app, start=r, timeout=120)
            assert got["iters"] == it
            np.testing.assert_array_equal(got["values"], want)
        futs = [s.submit(app, start=r) for r in SERVE_ROOTS[2:]]
        for f, (want, it) in zip(futs, lanes):
            got = f.result(120)
            assert got["iters"] == it
            np.testing.assert_array_equal(got["values"], want)
    fix = (("components", {}, PushExecutor(g, ConnectedComponents(),
                                            device=dev)),
           ("labelprop", {}, AdaptiveExecutor(g, LabelPropagation(),
                                              device=dev)),
           ("kcore", {}, AdaptiveExecutor(g, KCore(k=2), device=dev)))
    for app, kw, ex in fix:
        st, it = ex.run()
        got = s.query(app, timeout=120, **kw)
        assert got["iters"] == int(it)
        np.testing.assert_array_equal(got["values"], ex.values(st))
    ex = PullExecutor(g, PageRank(), device=dev)
    got = s.query("pagerank", ni=10, timeout=120)
    np.testing.assert_array_equal(got["values"], final_values(ex, ex.run(10)))
    st = s.pool.stats()
    assert st["misses"] == misses and st["recompiles"] == 0
    s.pool.sentinel.assert_zero_recompiles()
    assert s.statusz()["memory"]["device_peak_bytes"] > 0


def test_session_tiled_pagerank_from_a_file_on_cuda(dev, tmp_path):
    """A session on a .lux path serves PageRank through the CLI's tiled
    engine and its cached plan (K1, K2), equal to that engine run
    directly."""
    from lux_tpu_torch.engine.tiled import get_cached_plan
    from lux_tpu_torch.graph import write_lux
    from lux_tpu_torch.models.cli import final_values
    from lux_tpu_torch.serve import Session

    g = generate.rmat(10, 16, seed=42)
    path = tmp_path / "g.lux"
    write_lux(str(path), g)
    with Session(str(path), _serve_cfg(), device="cuda") as s:
        plan_path = str(path) + ".plan_8x2_8192.luxplan"
        ex = TiledPullExecutor(g, PageRank(), device=dev,
                               plan=get_cached_plan(g, plan_path))
        _cuda.reset_launches()
        got = s.query("pagerank", ni=10, timeout=120)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["strip_spmv"] > 0
        assert _cuda.LAUNCHES["tail_gather_sum"] > 0
        np.testing.assert_array_equal(got["values"],
                                      final_values(ex, ex.run(10)))


def test_swap_under_eight_client_threads_on_cuda(dev):
    """Queries from 8 client threads during an ``apply_edits`` swap: an
    answer is version N's while N serves and N+1's once the flip
    happened, bitwise; a thread never sees N after N+1; nothing is built
    or compiled on the serving path."""
    import threading

    from lux_tpu_torch.graph import DeltaGraph, EdgeEdits
    from lux_tpu_torch.serve import Session

    g = generate.rmat(10, 16, seed=44)
    rng = np.random.default_rng(17)
    n = g.ne // 100
    e = rng.choice(g.ne, n - n // 2, replace=False)
    ed = EdgeEdits(ins_src=rng.integers(0, g.nv, n // 2),
                   ins_dst=rng.integers(0, g.nv, n // 2), ins_w=None,
                   del_src=g.col_src[e].astype(np.int64),
                   del_dst=g.col_dst[e].astype(np.int64))
    new = DeltaGraph.fresh(g).stack(ed).merged()
    roots = list(range(64))
    want = {0: {r: reference_sssp(g, r) for r in roots},
            1: {r: reference_sssp(new, r) for r in roots}}
    with Session(g, _serve_cfg(window_s=0.005), device="cuda") as s:
        s.query("sssp", start=0, timeout=120)
        errors, stop = [], threading.Event()

        def client(t):
            seen, i = 0, t
            while not stop.is_set():
                r = roots[i % len(roots)]
                v0 = s.version
                try:
                    got = s.query("sssp", start=r, timeout=120)["values"]
                except Exception as exc:
                    errors.append(repr(exc))
                    return
                v1 = s.version
                match = [v for v in (0, 1)
                         if np.array_equal(got, want[v][r])]
                if (not match or (v1 == 0 and 0 not in match)
                        or (v0 == 1 and 1 not in match)
                        or max(match) < seen):
                    errors.append((t, r, v0, v1, match, seen))
                    return
                seen = max(seen, min(match))
                i += 8

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        summary = s.apply_edits(ed)
        for r in (5, 6, 7, 8):
            np.testing.assert_array_equal(
                s.query("sssp", start=r, timeout=120)["values"], want[1][r])
        stop.set()
        for t in threads:
            t.join(120)
        assert not errors, errors[:3]
        assert summary["version"] == 1 and s.version == 1
        assert s.pool.stats()["recompiles"] == 0
        s.pool.sentinel.assert_zero_recompiles()


def test_profile_capture_while_the_batcher_serves_on_cuda(
        served_cuda, tmp_path, monkeypatch):
    """``profile_capture(3)`` on one thread while another's queries run
    through the batcher: the capture holds device kernels and every
    answer stays bitwise right."""
    import threading

    g, s = served_cuda
    monkeypatch.setenv("LUX_PROF_DIR", str(tmp_path))
    errors, done = [], threading.Event()

    def client():
        r = 500
        while not done.is_set():
            got = s.query("sssp", start=r, timeout=120)["values"]
            if not np.array_equal(got, reference_sssp(g, r)):
                errors.append(r)
            r += 1

    t = threading.Thread(target=client)
    t.start()
    try:
        rep = s.profile_capture(3)
    finally:
        done.set()
        t.join(120)
    assert not errors, errors
    assert rep["schema"] == "profile.v1" and rep["devices"]
    assert rep["steps"]["captured"] == 3
    assert s.pool.stats()["recompiles"] == 0


# -- the auto-tuner (tune/) on the card ---------------------------------------


@pytest.mark.parametrize("kind", ["gas", "gas_sharded"])
def test_tune_real_probes_on_cuda(dev, kind):
    """tune() with real probes on the card: candidate 0 is the defaults,
    the winner the last rung's argmin, 0 tuneck findings, the key names
    the card; the winner's executor answers bitwise the default's. Which
    candidate wins is not asserted (scores are timings)."""
    from lux_tpu_torch.analysis import tuneck
    from lux_tpu_torch.engine.gas_sharded import ShardedAdaptiveExecutor
    from lux_tpu_torch.tune import space, tune
    from lux_tpu_torch.utils import flags

    g = generate.rmat(10, 16, seed=42)
    build_kw = ({"num_parts": 4, "device": dev} if kind == "gas_sharded"
                else {"device": dev})
    art = tune(g, BFS(), kind, program_name="bfs", graph_fingerprint="ab" * 20,
               mesh_shape="4" if kind == "gas_sharded" else "1",
               init_kw={"start": 0}, build_kw=build_kw)
    assert art["key"]["device_kind"] == torch.cuda.get_device_name()
    rows = art["score_table"]
    assert rows[0]["config"] == space.default_candidate(kind)
    last = max(r["rung"] for r in rows)
    best = min((r for r in rows if r["rung"] == last),
               key=lambda r: (r["score"], r["candidate_index"]))
    assert best["config"] == art["config"]
    assert tuneck.verify_artifact(art).findings == []
    make = ((lambda: ShardedAdaptiveExecutor(g, BFS(), **build_kw))
            if kind == "gas_sharded"
            else (lambda: gas.AdaptiveExecutor(g, BFS(), device=dev)))
    with flags.overrides(art["config"]):
        tuned = make()
    default = make()
    if "LUX_EXCHANGE" in art["config"]:
        assert tuned.exchange_mode == art["config"]["LUX_EXCHANGE"]
    outs = []
    for ex in (tuned, default):
        st, it = ex.run(start=0)
        outs.append((ex.gather_values(st) if kind == "gas_sharded"
                     else ex.values(st), it))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][0], reference_bfs(g, 0)[0])
    assert outs[0][1] == outs[1][1]


def test_tuned_session_on_cuda(dev, tmp_path, monkeypatch):
    """A session on the card armed with a store: BFS built under the
    artifact's thresholds, bitwise the default config's answers, the
    other apps counted fallbacks, no build after warmup."""
    import math

    from lux_tpu_torch.obs import report
    from lux_tpu_torch.serve import Session
    from lux_tpu_torch.tune import tune, tune_cache
    from lux_tpu_torch.utils.checkpoint import fingerprint_hex

    g = generate.rmat(10, 16, seed=42)
    art = tune(g, BFS(), "gas", program_name="bfs",
               graph_fingerprint=fingerprint_hex(g), mesh_shape="1",
               device_kind=report.device_profile()["device_kind"],
               measure=lambda c, i, r: 2.0 - float(c["LUX_GAS_DENSITY_HI"])
               - float(c["LUX_GAS_DENSITY_LO"]))
    monkeypatch.setenv("LUX_TUNE_DIR", str(tmp_path))
    tune_cache().clear()
    tune_cache().put(art)
    try:
        with Session(g, _serve_cfg(), device="cuda") as s:
            assert s.tuned_for("bfs")["id"] == art["id"]
            ex = s._gas_single("bfs")
            assert ex.hi_count == math.ceil(0.9 * g.nv)
            misses = s.pool.stats()["misses"]
            got = [s.query("bfs", start=r, timeout=120) for r in SERVE_ROOTS]
            assert s.pool.stats()["misses"] == misses
            assert set(s.statusz()["tune"]["fallbacks"]) \
                == set(s.APPS) - {"bfs"}
    finally:
        tune_cache().clear()
    default = gas.AdaptiveExecutor(g, BFS(), device=dev)
    for r, out in zip(SERVE_ROOTS, got):
        st, it = default.run(start=r)
        np.testing.assert_array_equal(out["values"], default.values(st))
        assert out["iters"] == int(it)


def test_program_contracts_with_hooks_on_the_card(dev):
    """The program-contract tier with the hooks on the card derives the
    committed gascap.v1 artifact, each seeded fixture fires exactly its
    rule, and the incremental gate's verdicts are the CPU's."""
    import os

    from lux_tpu_torch.analysis import gasck
    from lux_tpu_torch.engine.program import ProgramContractError

    report, art = gasck.prove_registry(device=dev)
    assert report.ok and len(report.results) == 8
    committed = gasck.load_capmap(os.path.join(
        os.path.dirname(gasck.__file__), gasck.CAP_FILENAME))
    assert art["id"] == committed["id"]
    fixtures = os.path.join(os.path.dirname(__file__), "torch_gas_fixtures")
    for name in sorted(os.listdir(fixtures)):
        if not name.startswith("lux60"):
            continue
        rep = gasck.verify_fixture_paths([os.path.join(fixtures, name)],
                                         device=dev)
        assert sorted({f.rule for f in rep.findings}) == \
            [name[:3].upper() + name[3:6]], name

    class Quiet(SSSP):
        incremental_ok = False

    class Claimant(ConnectedComponents):
        name = "claimant"

        def relax(self, src_vals, weights):
            return (src_vals + 1) & seg.U32_MASK

    gasck.require_incremental(Quiet(), dev)
    with pytest.raises(ProgramContractError, match="not inflationary"):
        gasck.require_incremental(Claimant(), dev)


def test_host_transfer_guard_on_the_card(dev):
    """Each device->host form of a CUDA tensor raises under the guard and
    none does inside allow(); the tiled executor's steps (K1, K2) pass
    under it; the push executor's step raises at its counter read."""
    from lux_tpu_torch.analysis.sentinel import (HostTransferError,
                                                 HostTransferGuard)

    t = torch.arange(6, dtype=torch.float32, device=dev)
    host = torch.zeros(6)
    forms = {
        "item": lambda: t.sum().item(),
        "float": lambda: float(t.sum()),
        "int": lambda: int(t[1]),
        "bool": lambda: bool(t[1]),
        "cpu": lambda: t.cpu(),
        "to_cpu": lambda: t.to("cpu"),
        "tolist": lambda: t.tolist(),
        "numpy_force": lambda: t.numpy(force=True),
        "copy_": lambda: host.copy_(t),
        "synchronize": lambda: torch.cuda.synchronize(),
        "event": lambda: torch.cuda.Event().synchronize(),
        "stream": lambda: torch.cuda.current_stream().synchronize(),
    }
    with HostTransferGuard("card") as guard:
        for name, form in forms.items():
            with pytest.raises(HostTransferError):
                form()
            with guard.allow():
                form()
        u = t * 2 + 1          # device work stays legal
    assert u.sum().item() == 2 * 15 + 6
    g = generate.rmat(10, 8, seed=3)
    ex = TiledPullExecutor(g, PageRank())
    want = ex.run(10)
    v = ex.init_values()
    with HostTransferGuard("tiled") as guard:
        for _ in range(10):
            v = ex.step(v)
        with guard.allow():
            torch.cuda.synchronize()
    torch.testing.assert_close(v, want, rtol=0, atol=0)
    push = PushExecutor(g, SSSP())
    state = push.init_state(start=0)
    with HostTransferGuard("push"):
        with pytest.raises(HostTransferError):
            push.step(state)


def test_grouped_plan_artifact_on_the_card(dev, tmp_path):
    """A grouped-tail plan saved, verified (0 findings), reloaded by mmap
    and uploaded gives the executor's grouped tail bitwise; a flipped
    code fails with LUX203."""
    import os

    from lux_tpu_torch.analysis import planck

    g = generate.rmat(12, 16, seed=1)
    plan = ts.plan_hybrid(g, levels=((8, 10 ** 9),))
    gp = mtp.plan_grouped_tail(plan.tail_sb, plan.tail_lane,
                               plan.tail_row_ptr)
    path = str(tmp_path / "gplan")
    mtp.save_grouped_plan(path, gp)
    assert planck.verify_plan_dirs([path]).ok
    back = mtp.load_grouped_plan(path, mmap=True)
    x = torch.rand((plan.nvb, 128), device=dev)
    a = mtk.grouped_tail_sums(x, mtk.DeviceGroupedTail.build(gp, dev))
    b = mtk.grouped_tail_sums(x, mtk.DeviceGroupedTail.build(back, dev))
    assert torch.equal(a, b)
    codes = np.load(os.path.join(path, "codes.npy"))
    r0 = int(gp.level_ptr[1])
    codes[int(np.argmax(gp.nvalid[:r0] > 0)), 0] = -5
    np.save(os.path.join(path, "codes.npy"), codes)
    assert {f.rule for f in planck.verify_plan_dirs([path]).findings} == \
        {"LUX203"}


def test_registry_exchange_plans_on_the_card(dev):
    """luxlint --exchange's registry mode with the executors on the card:
    every compact plan verifies clean."""
    from lux_tpu_torch.analysis import ir

    report = ir.run_exchange_matrix(device=dev)
    assert report.ok, report.format_human()
    assert len(report.results) >= 20


def test_trace_tiers_on_cuda_equal_cpu(dev):
    # Every registry target's step traced on the card: 0 findings of the
    # IR and exchange rules, and the same kernel and collective nodes,
    # in sequence and shape, as its trace on the CPU.
    from lux_tpu_torch.analysis import ir, trace

    rules = ir.all_ir_rules() + ir.exchange_ir_rules()
    cpu = {t.name: t for t in ir.registry_targets(device=CPU)}
    card = ir.registry_targets(device=dev)
    assert len(card) == len(cpu) == 59
    for t in card:
        kept = []
        res = ir.check_target(t, rules, kept)
        assert not res.error and not res.findings, (t.name, res.error,
                                                    res.findings)
        assert trace.kernel_sequence(kept[0]) == trace.kernel_sequence(
            ir.trace_target(cpu[t.name])), t.name


def test_traced_steps_on_cuda_leave_executors_unchanged(dev):
    from lux_tpu_torch.analysis import ir

    g = generate.rmat(10, 8, seed=5)
    for kind, prog, kw in (("tiled", PageRank(), {}),
                           ("push", SSSP(), {"start": 0}),
                           ("gas", BFS(), {"start": 0}),
                           ("gas_sharded", BFS(), {"start": 0})):
        extra = {"num_parts": 4} if kind.endswith("sharded") else {}
        ex = ir.build_executor(kind, g, prog, device=dev, **extra)
        first = ex.run(3) if kind == "tiled" else ex.run(max_iters=4, **kw)[0]
        res = ir.check_target(ir.target_from_spec(
            kind, ex.trace_step(**kw)), ir.all_ir_rules())
        assert not res.findings and not res.error, (kind, res)
        again = ex.run(3) if kind == "tiled" else ex.run(max_iters=4,
                                                         **kw)[0]
        a = first if kind == "tiled" else first.values
        b = again if kind == "tiled" else again.values
        assert torch.equal(a, b), kind


def test_memory_tier_on_the_card_matches_the_committed_artifact(dev):
    # luxlint --memory's registry with the executors on the card: the
    # card's artifact, derived from its own traces, holds against the
    # committed one (LUX706 within LUX_MEM_MODEL_TOL, LUX701 coverage)
    # and fits the card at the bench scale (LUX703).
    from lux_tpu_torch.analysis import memck

    report, art = memck.prove_registry(device=dev)
    assert report.ok, report.format_human()
    assert not any(r.error for r in report.results)
    committed = memck.load_memcap(memck.memcap_path())
    assert set(art["targets"]) == set(committed["targets"])
    assert memck._capacity_bytes() == torch.cuda.get_device_properties(
        0).total_memory
