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
    _compare(mtk.root_reduce(root.to(dev), gd.nvalid_root, gd.dst_row_ptr,
                             gd.dst_items),
             mtk.root_reduce(root, gc.nvalid_root, gc.dst_row_ptr), True)


def test_segment_sum_without_mask(dev):
    rng = np.random.default_rng(2)
    lens = rng.integers(0, 9, size=300)
    lens[5] = 5000
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    data = torch.from_numpy(rng.random(int(row_ptr[-1]), dtype=np.float32))
    items = seg.SegmentItems.build(row_ptr, seg.SEG_ITEM, dev)
    got = seg.segment_sum_by_rowptr(data.to(dev),
                                    torch.from_numpy(row_ptr).to(dev), items)
    _compare(got, seg.segment_sum_by_rowptr(data, torch.from_numpy(row_ptr)),
             False)


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


@pytest.mark.parametrize("kind,relax_op", [("min", "add1"), ("max", "copy"),
                                           ("min", "copy"), ("max", "add1")])
@pytest.mark.parametrize("frac", [0.3, 0.0])
def test_segment_minmax_relax_matches_plain(dev, kind, relax_op, frac):
    g = generate.rmat(12, 12, seed=5)
    row_ptr = torch.from_numpy(g.row_ptr)
    col_src = torch.from_numpy(g.col_src)
    items = seg.SegmentItems.build(g.row_ptr, seg.SEG_ITEM, dev)
    vals, fr = _push_operands(g.nv, 3, frac)
    want = seg.segment_minmax_relax(row_ptr, col_src, vals, fr, kind,
                                    relax_op)
    packed = seg.pack_words(vals, fr)
    for table, front in ((vals, fr), (packed, None)):
        got = seg.segment_minmax_relax(
            row_ptr.to(dev), col_src.to(dev), table.to(dev),
            None if front is None else front.to(dev), kind, relax_op, items)
        assert torch.equal(got.cpu(), want)


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


@pytest.mark.parametrize("op,width", [("copy", 1), ("cf_sgd", 20)])
@pytest.mark.parametrize("exact", [True, False])
def test_pull_kernels_match_plain(dev, op, width, exact):
    row_ptr, col_src, w, vals = _pull_operands(width, exact)
    if op == "copy":
        want = seg.gather_segment_sum(vals, row_ptr, col_src)
        tol = dict(rtol=RTOL, atol=ATOL)
    else:
        want = seg.cf_edge_sum(vals, row_ptr, col_src, w)
        tol = CF_TOL
    d = [t.to(dev) for t in (row_ptr, col_src, w, vals)]
    # The kernel's own item length, and one that cuts every row into
    # many short items: the sums do not depend on it.
    for item_len in (seg.pull_item_len(op), 7):
        items = seg.SegmentItems.build(row_ptr.numpy(), item_len, dev)
        if op == "copy":
            got = seg.gather_segment_sum(d[3], d[0], d[1], items)
        else:
            got = seg.cf_edge_sum(d[3], d[0], d[1], d[2], items)
        got = got.cpu()
        assert got.dtype == torch.float32 and got.shape == want.shape
        if exact:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


def test_pull_wrappers_check_their_inputs(dev):
    row_ptr, col_src, w, vals = (t.to(dev) for t in _pull_operands(20, True))
    items = seg.SegmentItems.build(row_ptr.cpu().numpy(), seg.WARP_ITEM, dev)
    # K8 is compiled for scalar values, K9 for K = 20 only.
    with pytest.raises(NotImplementedError):
        seg.gather_segment_sum(vals, row_ptr, col_src, items)
    with pytest.raises(NotImplementedError):
        seg.cf_edge_sum(vals[:, :4].contiguous(), row_ptr, col_src, w, items)
    with pytest.raises(ValueError, match="int32"):
        seg.cf_edge_sum(vals, row_ptr, col_src, w.long(), items)
    with pytest.raises(ValueError, match="SegmentItems"):
        seg.cf_edge_sum(vals, row_ptr, col_src, w)
    with pytest.raises(ValueError, match="K-vectors"):
        seg.cf_edge_sum(vals[:, 0].contiguous(), row_ptr, col_src, w, items)


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


@pytest.mark.parametrize("kind,gather_op", seg.GAS_KERNEL_OPS)
@pytest.mark.parametrize("k", [1, 3, 8, 9])
@pytest.mark.parametrize("frac", [0.3, 0.0])
def test_gas_pull_acc_matches_plain(dev, kind, gather_op, k, frac):
    g = generate.rmat(11, 12, seed=5, weighted=True)
    row_ptr = torch.from_numpy(g.row_ptr)
    col_src = torch.from_numpy(g.col_src)
    w = torch.from_numpy(g.weights)
    vals, fr = _gas_operands(g.nv, gather_op, frac, k, seed=k)
    want = seg.gas_pull_acc(row_ptr, col_src, vals, fr, kind, gather_op,
                            weights=w)
    # The kernel's item length, and one that cuts rows into short items.
    for item_len in (seg.SEG_ITEM, 5):
        items = seg.SegmentItems.build(g.row_ptr, item_len, dev)
        got = seg.gas_pull_acc(row_ptr.to(dev), col_src.to(dev),
                               vals.to(dev), fr.to(dev), kind, gather_op,
                               items, weights=w.to(dev))
        assert got.dtype == want.dtype and got.shape == want.shape
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


def test_gas_wrappers_check_their_inputs(dev):
    g = generate.rmat(8, 8, seed=1, weighted=True)
    rp = torch.from_numpy(g.row_ptr).to(dev)
    cs = torch.from_numpy(g.col_src).to(dev)
    items = seg.SegmentItems.build(g.row_ptr, seg.SEG_ITEM, dev)
    vals, fr = _gas_operands(g.nv, "add1", 0.5, 1, seed=1)
    vals, fr = vals.to(dev), fr.to(dev)
    with pytest.raises(NotImplementedError):
        seg.gas_pull_acc(rp, cs, vals, fr, "min", "decay", items)
    with pytest.raises(ValueError, match="float32"):
        seg.gas_pull_acc(rp, cs, vals, fr, "min", "add_w", items,
                         weights=torch.from_numpy(g.weights).to(dev))
    with pytest.raises(ValueError, match="SegmentItems"):
        seg.gas_pull_acc(rp, cs, vals, fr, "min", "add1")
    with pytest.raises(ValueError, match="shape"):
        seg.gas_pull_acc(rp, cs, vals, fr[:-1], "min", "add1", items)
    f32 = torch.zeros(g.nv, device=dev)
    with pytest.raises(ValueError, match="weights"):
        seg.gas_pull_acc(rp, cs, f32, fr, "min", "add_w", items)


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
def test_pull_kernels_on_a_part_of_a_flat_table(dev, op, width):
    # The destination rows of the part lie at row_base in a table of
    # several parts' rows; the sources anywhere in it.
    row_ptr, col_src, w, vals = _pull_operands(width, False)
    nv = row_ptr.shape[0] - 1
    rng = np.random.default_rng(8)
    table = torch.cat([vals, vals.flip(0), vals * 0.5])
    col_src = torch.from_numpy(
        rng.integers(0, 3 * nv, size=col_src.shape[0]).astype(np.int32))
    for base in (0, nv, 2 * nv):
        items = seg.SegmentItems.build(row_ptr.numpy(),
                                       seg.pull_item_len(op), dev, base)
        d = [t.to(dev) for t in (table, row_ptr, col_src, w)]
        if op == "copy":
            want = seg.gather_segment_sum(table, row_ptr, col_src)
            got = seg.gather_segment_sum(d[0], d[1], d[2], items)
            tol = dict(rtol=RTOL, atol=ATOL)
        else:
            want = seg.cf_edge_sum(table, row_ptr, col_src, w, row_base=base)
            got = seg.cf_edge_sum(d[0], d[1], d[2], d[3], items, base)
            tol = CF_TOL
        assert got.shape == want.shape == (nv,) + tuple(vals.shape[1:])
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **tol)
        if op == "cf_sgd":
            other = nv if base == 0 else 0
            with pytest.raises(ValueError, match="row_base"):
                seg.cf_edge_sum(d[0], d[1], d[2], d[3], items, other)


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
        # The same items in the same order as the single-device kernel.
        np.testing.assert_array_equal(got, single.cpu().numpy())
        outs[mode] = out
    assert torch.equal(outs["compact"], outs["full"])


# -- the multi-source and sharded push engines (K5-K7, K10 per part) ---------


def test_split_table_wrappers_match_plain(dev):
    # K7 reads a flat table of several parts' rows at q and combines into
    # one part's row of its own; K10 reads a table of more rows than its
    # row_ptr's, which sizes the output.
    g = generate.gnp(5000, 30000, seed=7)
    csr = g.csr()
    rp, col_dst = torch.from_numpy(csr.row_ptr), torch.from_numpy(csr.col_dst)
    vals, fr = _push_operands(3 * g.nv, 4, 0.0)
    fr[g.nv:2 * g.nv] = torch.rand(g.nv) < 0.05
    q, start, _, offs = fq.frontier_queue(fr[g.nv:2 * g.nv], rp,
                                          int(fr[g.nv:2 * g.nv].sum()))
    q = q + g.nv
    total = int(offs[-1])
    for kind, relax_op in (("min", "add1"), ("max", "copy")):
        out = vals[:g.nv].clone()
        want = fq.queue_relax_scatter(q, start, offs, col_dst, vals, kind,
                                      relax_op, total, out=out.clone())
        d_out = out.to(dev)
        got = fq.queue_relax_scatter(q.to(dev), start.to(dev), offs.to(dev),
                                     col_dst.to(dev), vals.to(dev), kind,
                                     relax_op, total, out=d_out)
        assert got is d_out and torch.equal(got.cpu(), want)
    d_vals = vals.to(dev)
    with pytest.raises(ValueError, match="share memory"):
        fq.queue_relax_scatter(q.to(dev), start.to(dev), offs.to(dev),
                               col_dst.to(dev), d_vals, "min", "add1", total,
                               out=d_vals[:g.nv])
    gk = generate.rmat(11, 12, seed=5)
    lanes, front = _gas_operands(3 * gk.nv, "add1", 0.3, 8, seed=2)
    col_src = torch.from_numpy(
        np.random.default_rng(3).integers(0, 3 * gk.nv, gk.ne)
        .astype(np.int32))
    row_ptr = torch.from_numpy(gk.row_ptr)
    items = seg.SegmentItems.build(gk.row_ptr, seg.SEG_ITEM, dev)
    for kind, op in (("min", "add1"), ("max", "copy")):
        want = seg.gas_pull_acc(row_ptr, col_src, lanes, front, kind, op)
        got = seg.gas_pull_acc(row_ptr.to(dev), col_src.to(dev),
                               lanes.to(dev), front.to(dev), kind, op, items)
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
    k2 = sum(1 for p in ex._parts if p.tail_items.n_items)
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
    assert _cuda.LAUNCHES[pg.take_kernel(axis, dtype)] == 1
    assert torch.equal(got.cpu(), pg.block_take_plain(x, idx, axis, rows))


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
