"""Port parity: the partition, the sharded layout and the exchange plan.

``lux_tpu_torch.graph.partition`` and ``lux_tpu_torch.parallel.shard``
are copies of ``lux_tpu``'s host numpy. These tests hold every array
they build byte-identical to ``lux_tpu``'s (same dtype, shape and
bytes) on an R-MAT, a skewed graph with empty parts and a bipartite
ratings graph, for P in {1, 2, 4, 8}; ``resolve_exchange``'s outcomes
and log notes to ``lux_tpu``'s; and the port's compact exchange table to
its full one, bitwise, on every row an edge reads. The parts axis
(``LocalMesh``) is held to explicit loops.
"""

import logging

import numpy as np
import pytest
import torch

from lux_tpu.graph import generate as jgen
from lux_tpu.graph import partition as jpart
from lux_tpu.parallel import shard as jshard
from lux_tpu.utils import flags as jflags
from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.graph import partition as tpart
from lux_tpu_torch.models import CollaborativeFiltering, PageRank
from lux_tpu_torch.parallel import mesh as tmesh
from lux_tpu_torch.parallel import shard as tshard
from lux_tpu_torch.utils import flags as tflags

PARTS = [1, 2, 4, 8]
# name -> graph maker over a generate module
GRAPHS = {
    "rmat": lambda m: m.rmat(10, 8, seed=3, weighted=True),
    # Nearly every edge goes into vertex 0: later parts are empty.
    "star": lambda m: m.undirected(m.star_graph(40)),
    "ratings": lambda m: m.bipartite_ratings(200, 30, 3000, seed=1),
    "world": lambda m: m.small_world(400, 6, 0.1, seed=1),
}
_CACHE = {}

SG_ARRAYS = ("src_pidx", "src_global", "dst_local", "edge_mask", "weights",
             "local_row_ptr", "out_degrees", "in_degrees", "vertex_mask",
             "local_nv", "row_left")
PLAN_ARRAYS = ("counts", "send_units", "recv_pos")
PLAN_SCALARS = ("num_parts", "max_units", "unit_rows", "capacity",
                "profitable", "exchanged_units_per_iter")


def _graphs(name):
    if name not in _CACHE:
        _CACHE[name] = (GRAPHS[name](jgen), GRAPHS[name](tgen))
    return _CACHE[name]


def assert_same_array(got, want, what):
    if want is None:
        assert got is None, what
        return
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def assert_same_plan(got, want):
    for name in PLAN_SCALARS:
        assert getattr(got, name) == getattr(want, name), name
    for name in PLAN_ARRAYS:
        assert_same_array(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_sharded_graph_and_plan_are_byte_identical(gname, parts):
    jg, tg = _graphs(gname)
    assert tpart.edge_balanced_bounds(tg.row_ptr, parts) == \
        jpart.edge_balanced_bounds(jg.row_ptr, parts)
    info, jinfo = (tpart.PartitionInfo.build(tg.row_ptr, parts),
                   jpart.PartitionInfo.build(jg.row_ptr, parts))
    assert (info.num_parts, info.bounds, info.edge_bounds,
            info.frontier_slots) == (jinfo.num_parts, jinfo.bounds,
                                     jinfo.edge_bounds, jinfo.frontier_slots)
    assert (info.max_part_nv, info.max_part_ne) == (jinfo.max_part_nv,
                                                    jinfo.max_part_ne)

    sg, jsg = (tshard.ShardedGraph.build(tg, parts),
               jshard.ShardedGraph.build(jg, parts))
    assert (sg.num_parts, sg.max_nv, sg.max_ne) == (jsg.num_parts,
                                                    jsg.max_nv, jsg.max_ne)
    assert sg.info.bounds == jsg.info.bounds
    for name in SG_ARRAYS:
        assert_same_array(getattr(sg, name), getattr(jsg, name), name)
    assert_same_array(sg.remote_read_counts(), jsg.remote_read_counts(),
                      "remote_read_counts")
    assert_same_plan(sg.exchange_plan(), jsg.exchange_plan())
    for got, want in zip(sg.build_push_csr(), jsg.build_push_csr()):
        assert_same_array(got, want, "build_push_csr")
    plan = sg.exchange_plan()
    for frac in (0.25, 1.0):
        assert plan.frontier_capacity(frac) == \
            jsg.exchange_plan().frontier_capacity(frac)
    for row_bytes in (4, 80):
        assert plan.exchange_bytes_per_iter(row_bytes) == \
            jsg.exchange_plan().exchange_bytes_per_iter(row_bytes)

    # Pad edges lie past the last real row, so no row's range holds one.
    n_e = sg.local_row_ptr[:, -1]
    assert np.array_equal(n_e, sg.edge_mask.sum(axis=1))
    for p in range(parts):
        assert np.all(sg.dst_local[p, n_e[p]:] == sg.max_nv)

    vals = np.random.default_rng(0).random((tg.nv, 3), dtype=np.float32)
    assert_same_array(sg.to_padded(vals), jsg.to_padded(vals), "to_padded")
    np.testing.assert_array_equal(sg.from_padded(sg.to_padded(vals)), vals)


@pytest.mark.parametrize("gname", ["rmat", "star"])
def test_explicit_capacity_and_released_arrays_match_lux_tpu(gname):
    jg, tg = _graphs(gname)
    sg, jsg = tshard.ShardedGraph.build(tg, 4), jshard.ShardedGraph.build(
        jg, 4)
    cap = sg.exchange_plan().capacity
    assert_same_plan(sg.exchange_plan(capacity=cap + 8),
                     jsg.exchange_plan(capacity=cap + 8))
    required = int((sg.remote_read_counts()
                    - np.diag(np.diag(sg.remote_read_counts()))).max())
    if required > 1:
        with pytest.raises(ValueError, match="refusing to truncate"):
            sg.exchange_plan(capacity=required - 1)
        with pytest.raises(ValueError, match="refusing to truncate"):
            jsg.exchange_plan(capacity=required - 1)
    # Released before any plan: no plan and no counts, in both packages.
    fresh, jfresh = tshard.ShardedGraph.build(tg, 4), \
        jshard.ShardedGraph.build(jg, 4)
    fresh.release_edge_arrays()
    jfresh.release_edge_arrays()
    assert fresh.exchange_plan() is None and jfresh.exchange_plan() is None
    assert fresh.remote_read_counts() is None
    # Released after: the cached plan stays.
    sg.release_edge_arrays()
    assert sg.exchange_plan() is not None
    assert sg.src_pidx is None and sg.weights is None


def _resolve(module, sg, frontier_ok=False):
    records = []

    class _Log:
        def info(self, msg, *args):
            records.append(msg % args)

    mode, plan = module.resolve_exchange(sg, _Log(), frontier_ok=frontier_ok)
    return mode, plan, records


@pytest.mark.parametrize("case,gname,parts,flag,frontier_ok,want", [
    ("full", "rmat", 4, "full", False, "full"),
    ("compact", "rmat", 4, "compact", False, "compact"),
    ("compact at P=1", "rmat", 1, "compact", False, "full"),
    ("unprofitable", "ratings", 4, "compact", False, "full"),
    ("frontier without activity", "rmat", 4, "frontier", False, "compact"),
    ("frontier", "rmat", 4, "frontier", True, "frontier"),
    ("released", "rmat", 4, "compact", False, "full"),
])
def test_resolve_exchange_matches_lux_tpu(monkeypatch, case, gname, parts,
                                          flag, frontier_ok, want):
    monkeypatch.setenv("LUX_EXCHANGE", flag)
    jg, tg = _graphs(gname)
    sg, jsg = tshard.ShardedGraph.build(tg, parts), \
        jshard.ShardedGraph.build(jg, parts)
    if case == "released":
        sg.release_edge_arrays()
        jsg.release_edge_arrays()
    mode, plan, notes = _resolve(tshard, sg, frontier_ok)
    jmode, jplan, jnotes = _resolve(jshard, jsg, frontier_ok)
    assert mode == jmode == want
    # Every downgrade is logged; a mode kept as asked logs nothing. The
    # port also notes the one lux_tpu makes silently, at P = 1.
    assert len(notes) == (want != flag)
    if parts > 1:
        assert notes == jnotes
    if jplan is None:
        assert plan is None
    else:
        assert_same_plan(plan, jplan)


def test_unprofitable_plan_is_the_one_lux_tpu_refuses():
    _, tg = _graphs("ratings")
    plan = tshard.ShardedGraph.build(tg, 4).exchange_plan()
    assert not plan.profitable and plan.capacity >= plan.max_units


def test_exchange_mode_flag(monkeypatch):
    mine, theirs = tflags._flag("LUX_EXCHANGE"), jflags._flag("LUX_EXCHANGE")
    assert (mine.default, mine.doc, mine.kind) == (
        theirs.default, theirs.doc, theirs.kind)
    monkeypatch.delenv("LUX_EXCHANGE", raising=False)
    assert tshard.exchange_mode() == jshard.exchange_mode() == "full"
    monkeypatch.setenv("LUX_EXCHANGE", " Compact ")
    assert tshard.exchange_mode() == "compact"
    monkeypatch.setenv("LUX_EXCHANGE", "ring")
    with pytest.raises(ValueError, match="LUX_EXCHANGE"):
        tshard.exchange_mode()


def test_executor_logs_its_downgrade(monkeypatch):
    monkeypatch.setenv("LUX_EXCHANGE", "compact")
    _, tg = _graphs("ratings")
    seen = []
    handler = logging.Handler()
    handler.emit = seen.append
    logger = logging.getLogger("lux_tpu_torch")
    logger.addHandler(handler)
    try:
        ex = ShardedPullExecutor(tg, CollaborativeFiltering(), num_parts=4,
                                 device="cpu")
    finally:
        logger.removeHandler(handler)
    assert ex.exchange_mode == "full"
    assert [r.name for r in seen] == ["lux_tpu_torch.engine"]
    assert "falling back to full" in seen[0].getMessage()


# -- the exchange ---------------------------------------------------------


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("gname,width", [("rmat", 1), ("world", 1),
                                         ("rmat", 5)])
def test_compact_table_equals_full_on_every_row_read(monkeypatch, gname,
                                                     width, parts):
    _, tg = _graphs(gname)
    tables = {}
    for mode in ("full", "compact"):
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        ex = ShardedPullExecutor(tg, PageRank(), num_parts=parts,
                                 device="cpu")
        assert ex.exchange_mode == mode
        shape = (parts, ex.sg.max_nv) + ((width,) if width > 1 else ())
        vals = torch.from_numpy(np.random.default_rng(parts).random(
            shape, dtype=np.float32))
        flat = ex._exchange(vals)
        tables[mode] = [ex._table(flat, q) for q in range(parts)]
    sg, n = ex.sg, ex.sg.max_nv
    full_ptr = tables["full"][0].data_ptr()
    for q in range(parts):
        # Full: every part reads one view of the stacked values.
        assert tables["full"][q].data_ptr() == full_ptr
        read = np.unique(np.concatenate([
            sg.src_pidx[q][sg.edge_mask[q]],
            q * n + np.arange(n)]))              # its own destinations
        idx = torch.from_numpy(read)
        got, want = tables["compact"][q][idx], tables["full"][q][idx]
        assert torch.equal(got, want)
        # Rows no edge of q reads and no own row: zero, as in lux_tpu.
        unread = np.setdiff1d(np.arange(parts * n), read)
        assert torch.count_nonzero(
            tables["compact"][q][torch.from_numpy(unread)]) == 0


def test_local_mesh_collectives():
    m = tmesh.LocalMesh(3, "cpu")
    x = torch.arange(3 * 6 * 2, dtype=torch.float32).reshape(3, 6, 2)
    flat = m.all_gather(x)
    assert flat.shape == (18, 2) and flat.data_ptr() == x.data_ptr()
    got = m.all_to_all(x)
    for q in range(3):
        for p in range(3):
            assert torch.equal(got[q, 2 * p:2 * p + 2], x[p, 2 * q:2 * q + 2])
    with pytest.raises(ValueError, match="split"):
        m.all_to_all(x[:, :5])
    with pytest.raises(ValueError, match=r"\(3, n"):
        m.all_gather(x[:2])
    with pytest.raises(ValueError, match="num_parts"):
        tmesh.LocalMesh(0, "cpu")
    assert tmesh.make_mesh(device="cpu").num_parts == 1
    assert tmesh.make_mesh(5, "cpu") == tmesh.LocalMesh(5, torch.device(
        "cpu"))
