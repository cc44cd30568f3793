"""Port parity: incremental recompute (``engine/incremental.py``).

On the same old values and edit batches the port's ``invalidate`` masks,
warm states, ``info`` dicts, values and iteration counts must equal
``lux_tpu``'s bitwise for SSSP (unit and weighted graphs), CC (directed,
and symmetric against the oracle) and the multi-source lanes (padding
included); incremental PageRank within rtol=5e-5, atol=1e-9 of
``lux_tpu``'s with equal iteration counts. The warm runs are also held
against from-scratch runs of both packages and the host oracles, as
tests/test_incremental.py holds ``lux_tpu``'s. On the CPU the push
executors run the kernels' plain versions (K5-K7, K10, K8); the card
runs are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from lux_tpu.engine import incremental as jinc
from lux_tpu.engine.pull import PullExecutor as JPull
from lux_tpu.engine.push import PushExecutor as JPush
from lux_tpu.graph import DeltaGraph as JDelta
from lux_tpu.graph import EdgeEdits as JEdits
from lux_tpu.graph import generate as jgen
from lux_tpu.graph.delta import removed_edges as jremoved
from lux_tpu.models.bfs import BFS as JBFS
from lux_tpu.models.components import ConnectedComponents as JCC
from lux_tpu.models.pagerank import PageRank as JPageRank
from lux_tpu.models.sssp import SSSP as JSSSP
from lux_tpu.models.sssp_delta import DeltaSSSP as JDeltaSSSP
from lux_tpu_torch.engine import incremental as tinc
from lux_tpu_torch.engine.incremental import (IncrementalExecutor,
                                              incremental_pagerank,
                                              invalidate)
from lux_tpu_torch.engine.program import ProgramContractError
from lux_tpu_torch.engine.pull import PullExecutor
from lux_tpu_torch.engine.push import PushExecutor
from lux_tpu_torch.graph import DeltaGraph, EdgeEdits, generate
from lux_tpu_torch.graph.delta import removed_edges
from lux_tpu_torch.models import (BFS, SSSP, ConnectedComponents, DeltaSSSP,
                                  PageRank)
from lux_tpu_torch.models.components import reference_components
from lux_tpu_torch.models.pagerank import reference_pagerank, true_ranks
from lux_tpu_torch.models.sssp import reference_sssp
from lux_tpu_torch.ops.segment import u32_to_numpy
from lux_tpu_torch.utils import faults

CPU = torch.device("cpu")
PROGRAMS = {"sssp": (JSSSP, SSSP), "cc": (JCC, ConnectedComponents)}


def _case(make, seed, n_ins, n_del, weighted=False, symmetric=False):
    """Both packages' base and edited graphs (checked equal) and the
    (removed, inserted) arrays each package's incremental path takes."""
    g, jg = make(generate), make(jgen)
    rng = np.random.default_rng(seed)
    ins = [(int(rng.integers(g.nv)), int(rng.integers(g.nv)))
           + ((int(rng.integers(1, 9)),) if weighted else ())
           for _ in range(n_ins)]
    dels = []
    if n_del:
        eidx = rng.choice(g.ne, size=min(n_del, g.ne), replace=False)
        dels = [(int(g.col_src[e]), int(g.col_dst[e])) for e in eidx]
    if symmetric:
        ins = [p for (u, v) in ins for p in ((u, v), (v, u))]
        dels = [p for (u, v) in dels for p in ((u, v), (v, u))]
    out = []
    for graph, edits_cls, delta_cls, rem in (
            (g, EdgeEdits, DeltaGraph, removed_edges),
            (jg, JEdits, JDelta, jremoved)):
        ed = edits_cls.from_lists(insert=ins, delete=dels)
        new = delta_cls.fresh(graph).stack(ed).merged()
        out.append((graph, new, rem(graph, ed.del_src, ed.del_dst),
                    (ed.ins_src, ed.ins_dst)))
    np.testing.assert_array_equal(out[0][1].row_ptr, out[1][1].row_ptr)
    np.testing.assert_array_equal(out[0][1].col_src, out[1][1].col_src)
    return out


def _rmat(m):
    return m.rmat(8, 8, seed=21)


def _old(jg, jprog, **kw):
    st, _ = JPush(jg, jprog).run(**kw)
    return np.asarray(st.values)


def _check_parity(app, port, theirs, old, **kw):
    """Warm column, info, values and iterations equal to lux_tpu's; the
    values equal to both packages' from-scratch runs."""
    jcls, tcls = PROGRAMS[app]
    g, new, removed, inserted = port
    jg, jnew, jremd, jins = theirs
    got_col = tinc._warm_column(tcls(), new, old, removed, inserted, **kw)
    want_col = jinc._warm_column(jcls(), jnew, old, jremd, jins, **kw)
    for x, y in zip(got_col[:2], want_col[:2]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert got_col[2] == want_col[2]
    inc = IncrementalExecutor(new, tcls(), device=CPU)
    st, iters, info = inc.run(old, removed=removed, inserted=inserted, **kw)
    jst, jiters, jinfo = jinc.IncrementalExecutor(jnew, jcls()).run(
        old, removed=jremd, inserted=jins, **kw)
    got = inc.push.values(st)
    np.testing.assert_array_equal(got, np.asarray(jst.values))
    assert (iters, info) == (jiters, jinfo)
    full, _ = PushExecutor(new, tcls(), device=CPU).run(**kw)
    np.testing.assert_array_equal(got, u32_to_numpy(full.values))
    return got, iters, info


@pytest.mark.parametrize("seed,n_ins,n_del", [
    (1, 20, 0),    # insert-only
    (2, 0, 20),    # delete-only
    (3, 15, 15),   # mixed
    (4, 0, 0),     # empty batch: warm state already at fixpoint
])
def test_sssp_equals_lux_tpu(seed, n_ins, n_del):
    port, theirs = _case(_rmat, seed, n_ins, n_del)
    old = _old(theirs[0], JSSSP(), start=3)
    got, iters, info = _check_parity("sssp", port, theirs, old, start=3)
    np.testing.assert_array_equal(got, reference_sssp(port[1], 3))
    assert info["touched_frac"] <= 1.0
    if n_ins == n_del == 0:
        assert info["reset"] == 0 and iters <= 1


def test_sssp_weighted_equals_lux_tpu():
    port, theirs = _case(lambda m: m.gnp(400, 3000, seed=31, weighted=True),
                         31, 15, 15, weighted=True)
    assert port[1].weights is not None
    old = _old(theirs[0], JSSSP(), start=0)
    _check_parity("sssp", port, theirs, old, start=0)


@pytest.mark.parametrize("seed,n_ins,n_del", [(5, 25, 0), (6, 0, 25),
                                              (7, 12, 12)])
def test_components_directed_equals_lux_tpu(seed, n_ins, n_del):
    port, theirs = _case(_rmat, seed, n_ins, n_del)
    old = _old(theirs[0], JCC())
    _check_parity("cc", port, theirs, old)


def test_components_symmetric_equals_oracle():
    port, theirs = _case(
        lambda m: m.undirected(m.gnp(200, 350, seed=205)), 205, 8, 8,
        symmetric=True)
    old = _old(theirs[0], JCC())
    got, _, _ = _check_parity("cc", port, theirs, old)
    np.testing.assert_array_equal(got, reference_components(port[1]))


def test_invalidate_masks_equal_lux_tpu():
    """Removing every edge resets every reachable non-root vertex, in
    both packages; a non-supporting edge resets nothing."""
    g, jg = generate.gnp(300, 1200, seed=41), jgen.gnp(300, 1200, seed=41)
    old = _old(jg, JSSSP(), start=0)
    init = SSSP().init_values(g, start=0)
    src, dst = g.col_src.astype(np.int64), g.col_dst.astype(np.int64)
    got = invalidate(SSSP(), g, old, init, src, dst, g.weights)
    want = jinc.invalidate(JSSSP(), jg, old, init, src, dst, jg.weights)
    np.testing.assert_array_equal(got, want)
    assert (got == (old != init)).all()
    e = int(np.flatnonzero(old[g.col_src] + 1 != old[g.col_dst])[0])
    assert not invalidate(SSSP(), g, old, init, src[e:e + 1],
                          dst[e:e + 1], None).any()


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("app", ["sssp", "cc"])
def test_invalidation_split_over_threads_equals_lux_tpu(app, threads,
                                                        monkeypatch):
    """With every level split into runs of a few edges over ``threads``
    threads, the reset mask, warm values and frontier still equal
    ``lux_tpu``'s."""
    from lux_tpu_torch.utils import host

    monkeypatch.setattr(host, "PARALLEL_MIN", 64)
    make = _rmat if app == "sssp" else (
        lambda m: m.undirected(m.rmat(8, 8, seed=21)))
    port, theirs = _case(make, 13, 30, 30, symmetric=app == "cc")
    jcls, tcls = PROGRAMS[app]
    kw = {"start": 3} if app == "sssp" else {}
    old = _old(theirs[0], jcls(), **kw)
    got = tinc._warm_column(tcls(), port[1], old, port[2], port[3],
                            threads=threads, **kw)
    want = jinc._warm_column(jcls(), theirs[1], old, theirs[2], theirs[3],
                             **kw)
    assert got[2] == want[2] > 0
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(x, y)


def _multi_case(roots, seed, n):
    port, theirs = _case(_rmat, seed, n, n)
    cols = [_old(theirs[0], JSSSP(), start=r) for r in roots]
    return port, theirs, cols


def test_multi_source_lanes_equal_lux_tpu():
    roots = [0, 9, 44, 200]
    port, theirs, cols = _multi_case(roots, 8, 10)
    _, new, removed, inserted = port
    inc = IncrementalExecutor(new, SSSP(), k=len(roots), device=CPU)
    st, iters, info = inc.run_multi(roots, cols, removed=removed,
                                    inserted=inserted)
    jx = jinc.IncrementalExecutor(theirs[1], JSSSP(), k=len(roots))
    jst, jiters, jinfo = jx.run_multi(roots, cols, removed=theirs[2],
                                      inserted=theirs[3])
    assert (iters, info) == (jiters, jinfo)
    assert 0.0 <= info["touched_frac"] <= 1.0
    for j, r in enumerate(roots):
        lane = inc.multi.values_for(st, j)
        np.testing.assert_array_equal(lane, jx.multi.values_for(jst, j))
        full, _ = inc.push.run(start=r)
        np.testing.assert_array_equal(lane, inc.push.values(full))


def test_multi_source_pads_short_batches():
    port, theirs, cols = _multi_case([7], 9, 5)
    _, new, removed, inserted = port
    inc = IncrementalExecutor(new, SSSP(), k=4, device=CPU)
    st, iters, info = inc.run_multi([7], cols, removed=removed,
                                    inserted=inserted)
    jx = jinc.IncrementalExecutor(theirs[1], JSSSP(), k=4)
    jst, jiters, jinfo = jx.run_multi([7], cols, removed=theirs[2],
                                      inserted=theirs[3])
    assert (iters, info) == (jiters, jinfo)
    want = jx.multi.values_for(jst, 0)
    for j in range(4):
        np.testing.assert_array_equal(inc.multi.values_for(st, j), want)
    with pytest.raises(ValueError, match="one old-value column"):
        inc.run_multi([1, 2], cols)
    with pytest.raises(ValueError, match="need 1..4 roots"):
        inc.run_multi([0] * 5, cols * 5)
    with pytest.raises(ValueError, match="no MultiSourcePushExecutor"):
        IncrementalExecutor(new, SSSP(), device=CPU).run_multi([1], cols)


def test_fewer_iterations_and_compaction_round_trip():
    """A 1% batch converges in fewer iterations than from scratch, in
    both packages alike; warm-starting off a compacted snapshot's graph
    gives the same values."""
    g = _rmat(generate)
    n = max(1, g.ne // 100)
    port, theirs = _case(_rmat, 10, n, n)
    old = _old(theirs[0], JSSSP(), start=3)
    _, full_iters = PushExecutor(port[1], SSSP(), device=CPU).run(start=3)
    got, iters, info = _check_parity("sssp", port, theirs, old, start=3)
    assert iters < full_iters and info["touched_frac"] < 1.0
    compacted = DeltaGraph.fresh(port[1]).merged()
    st, _, _ = IncrementalExecutor(compacted, SSSP(), device=CPU).run(
        old, removed=port[2], inserted=port[3], start=3)
    np.testing.assert_array_equal(u32_to_numpy(st.values), got)


def test_incremental_pagerank_equals_lux_tpu():
    """Within rtol=5e-5, atol=1e-9 of lux_tpu's warm run, with the same
    iteration count, and within lux_tpu's rtol=1e-3, atol=1e-6 of the
    from-scratch oracle."""
    ni = 50
    port, theirs = _case(_rmat, 12, 10, 10)
    g, new = port[0], port[1]
    jg, jnew = theirs[0], theirs[1]
    old = np.asarray(JPull(jg, JPageRank()).run(ni))
    mine_old = PullExecutor(g, PageRank(), device=CPU).run(ni)
    np.testing.assert_allclose(mine_old.numpy(), old, rtol=5e-5, atol=1e-9)
    stored, iters = incremental_pagerank(
        PullExecutor(new, PageRank(), device=CPU), old, g.out_degrees, ni,
        tol=1e-7)
    jstored, jiters = jinc.incremental_pagerank(
        JPull(jnew, JPageRank()), old, jg.out_degrees, ni, tol=1e-7)
    assert stored.dtype == np.float32 and stored.shape == (g.nv,)
    np.testing.assert_allclose(stored, np.asarray(jstored), rtol=5e-5,
                               atol=1e-9)
    assert iters == jiters < ni
    want = true_ranks(reference_pagerank(new, ni), new.out_degrees)
    np.testing.assert_allclose(true_ranks(stored, new.out_degrees), want,
                               rtol=1e-3, atol=1e-6)
    # From the port's own tensor too, and no iteration at ni = 0.
    again, _ = incremental_pagerank(
        PullExecutor(new, PageRank(), device=CPU), mine_old, g.out_degrees,
        0)
    assert again.shape == (g.nv,)


def test_incremental_pagerank_warm_vector_equals_lux_tpu():
    """At ``ni = 0`` the entry point returns the warm vector it starts
    from: the old true ranks re-divided by the new out-degrees, bitwise
    ``lux_tpu``'s, and not the old stored vector where a degree moved."""
    port, theirs = _case(_rmat, 12, 10, 10)
    g, new, jg, jnew = port[0], port[1], theirs[0], theirs[1]
    old = np.asarray(JPull(jg, JPageRank()).run(5))
    warm, iters = incremental_pagerank(
        PullExecutor(new, PageRank(), device=CPU), old, g.out_degrees, 0)
    jwarm, jiters = jinc.incremental_pagerank(
        JPull(jnew, JPageRank()), old, jg.out_degrees, 0)
    assert iters == jiters == 0
    assert warm.dtype == np.float32
    np.testing.assert_array_equal(warm, np.asarray(jwarm))
    # Between degrees 0 and 1 the stored rank is the true rank.
    moved = (g.out_degrees != new.out_degrees) & (
        np.maximum(g.out_degrees, new.out_degrees) > 1)
    assert moved.any() and np.all(warm[moved] != old[moved])


class _PageRankWithRelax(PageRank):
    def relax(self, src_vals, weights):
        return src_vals


class _JPageRankWithRelax(JPageRank):
    def relax(self, src_vals, weights):
        return src_vals


@pytest.mark.parametrize("name,mine,theirs,why", [
    ("bfs", BFS, JBFS, "relax"),
    ("sssp_delta", DeltaSSSP, JDeltaSSSP, "relax"),
    ("pagerank", PageRank, JPageRank, "relax"),
    ("pagerank_relax", _PageRankWithRelax, _JPageRankWithRelax,
     "frontier-less"),
])
def test_gate_refuses_as_lux_tpu(name, mine, theirs, why):
    from lux_tpu.analysis.gasck import ProgramContractError as JError

    g = generate.rmat(6, 4, seed=1)
    with pytest.raises(ProgramContractError, match="LUX604") as e:
        IncrementalExecutor(g, mine(), device=CPU)
    assert why in str(e.value) and "A16" in str(e.value)
    with pytest.raises(JError, match="LUX604") as je:
        jinc.IncrementalExecutor(jgen.rmat(6, 4, seed=1), theirs())
    assert why in str(je.value)
    assert isinstance(e.value, TypeError)


def test_gate_refuses_an_undeclared_program():
    """Until the LUX604 proof is ported the declaration decides: an SSSP
    that does not declare ``incremental_ok`` is refused by the port,
    which ``lux_tpu``'s proof would accept."""

    class Undeclared(SSSP):
        incremental_ok = False

    g = generate.rmat(6, 4, seed=1)
    with pytest.raises(ProgramContractError, match="incremental_ok"):
        IncrementalExecutor(g, Undeclared(), device=CPU)


def test_refusals_of_bad_inputs():
    """The nv mismatch in both packages; no card and no device named is
    a refusal, not a CPU run; the executor's fault point fires."""
    g, jg = _rmat(generate), _rmat(jgen)
    short = np.zeros(g.nv - 1, dtype=np.uint32)
    with pytest.raises(ValueError, match="snapshots never change nv"):
        IncrementalExecutor(g, SSSP(), device=CPU).run(short, start=0)
    with pytest.raises(ValueError, match="snapshots never change nv"):
        jinc.IncrementalExecutor(jg, JSSSP()).run(short, start=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IncrementalExecutor(g, SSSP())
    inc = IncrementalExecutor(g, SSSP(), device=CPU)
    old = _old(jg, JSSSP(), start=0)
    with faults.injected("serve.engine.execute:raise:1.0:1"):
        with pytest.raises(faults.FaultInjected):
            inc.run(old, start=0)
    inc.warmup(start=0)
    st, iters, info = inc.run(old, start=0)
    assert info == {"reset": 0, "frontier": 0, "touched_frac": 0.0}
    np.testing.assert_array_equal(u32_to_numpy(st.values), old)
