"""The 13 executors that record a run, built in both packages on one
graph, for tests/test_torch_obs.py and tests/test_torch_engobs.py.

``CASES[name](pkg)`` builds ``pkg``'s (``"jax"`` or ``"torch"``)
executor on R-MAT 9 (edge factor 8, seed 5), warms it up, and returns a
zero-argument run, which returns (host values, iterations): PageRank
``run(10)``, the push and GAS programs to their fixpoint in chunks of
``CHUNK`` iterations (SSSP and BFS from vertex 0, or from ``ROOTS`` over
``K`` lanes; the incremental runs warm from SSSP on the graph less 20
edges).
"""

import numpy as np
import torch

from lux_tpu import models as jmodels
from lux_tpu import obs as jobs
from lux_tpu.engine import gas as jgas
from lux_tpu.engine import gas_sharded as jgs
from lux_tpu.engine import incremental as jinc
from lux_tpu.engine import pull as jpull
from lux_tpu.engine import pull_sharded as jps
from lux_tpu.engine import push as jpush
from lux_tpu.engine import tiled as jtiled
from lux_tpu.engine import tiled_sharded as jts
from lux_tpu.graph import generate as jgen
from lux_tpu.graph.graph import Graph as JGraph
from lux_tpu.obs import engobs as jengobs
from lux_tpu.ops.tiled_spmv import plan_hybrid as jplan
from lux_tpu_torch import models as tmodels
from lux_tpu_torch.engine import gas as tgas
from lux_tpu_torch.engine import gas_sharded as tgs
from lux_tpu_torch.engine import incremental as tinc
from lux_tpu_torch.engine import pull as tpull
from lux_tpu_torch.engine import pull_sharded as tps
from lux_tpu_torch.engine import push as tpush
from lux_tpu_torch.engine import push_sharded as tpsh
from lux_tpu_torch.engine import tiled as ttiled
from lux_tpu_torch.engine import tiled_sharded as tts
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.graph.graph import Graph as TGraph
from lux_tpu_torch.ops.segment import u32_to_numpy
from lux_tpu_torch.ops.tiled_spmv import plan_hybrid as tplan

CPU = "cpu"
P = 4
K = 4
CHUNK = 2
ROOTS = [0, 3, 7]
PULL_FAMILY = ("tiled", "pull", "pull_sharded", "tiled_sharded")
_GRAPHS = {}


def graphs():
    """(lux_tpu's, the port's) R-MAT 9 graph, checked equal."""
    if not _GRAPHS:
        jg = jgen.rmat(9, 8, seed=5)
        tg = tgen.rmat(9, 8, seed=5)
        np.testing.assert_array_equal(jg.col_src, tg.col_src)
        _GRAPHS["g"] = (jg, tg)
    return _GRAPHS["g"]


def _pagerank(pkg):
    return (jmodels if pkg == "jax" else tmodels).get_program("pagerank")


def _sssp(pkg):
    return (jmodels if pkg == "jax" else tmodels).get_program("sssp")


def _bfs(pkg):
    return (jmodels if pkg == "jax" else tmodels).get_program("bfs")


def _host(pkg, values) -> np.ndarray:
    """Host values: lux_tpu's array, or the port's tensor (uint32 from
    its int32 storage)."""
    if pkg == "jax":
        return np.asarray(values)
    return u32_to_numpy(values) if values.dtype == torch.int32 \
        else values.detach().cpu().numpy()


def _pull_run(pkg, ex, sharded=False):
    def run():
        out = ex.run(10)
        return (ex.gather_values(out) if sharded else _host(pkg, out)), 10
    return run


def _fix_run(pkg, ex, sharded=False, **kw):
    """A fixpoint run: (host values, iterations)."""
    def run():
        st, iters = ex.run(**kw)
        vals = ex.gather_values(st) if sharded else _host(pkg, st.values)
        return vals, iters
    return run


def _case_tiled(pkg):
    jg, tg = graphs()
    if pkg == "jax":
        ex = jtiled.TiledPullExecutor(jg, _pagerank(pkg), plan=jplan(jg))
    else:
        ex = ttiled.TiledPullExecutor(tg, _pagerank(pkg), plan=tplan(tg),
                                      device=CPU)
    ex.warmup()
    return _pull_run(pkg, ex)


def _case_pull(pkg):
    jg, tg = graphs()
    ex = (jpull.PullExecutor(jg, _pagerank(pkg)) if pkg == "jax" else
          tpull.PullExecutor(tg, _pagerank(pkg), device=CPU))
    ex.warmup()
    return _pull_run(pkg, ex)


def _case_push(pkg):
    jg, tg = graphs()
    ex = (jpush.PushExecutor(jg, _sssp(pkg)) if pkg == "jax" else
          tpush.PushExecutor(tg, _sssp(pkg), device=CPU))
    ex.warmup(start=0)
    return _fix_run(pkg, ex, chunk=CHUNK, start=0)


def _case_push_multi(pkg):
    jg, tg = graphs()
    ex = (jpush.MultiSourcePushExecutor(jg, _sssp(pkg), K) if pkg == "jax"
          else tpush.MultiSourcePushExecutor(tg, _sssp(pkg), K,
                                             device=CPU))
    ex.warmup(chunk=CHUNK)
    return _fix_run(pkg, ex, starts=ROOTS, chunk=CHUNK)


def _case_gas(pkg):
    jg, tg = graphs()
    ex = (jgas.AdaptiveExecutor(jg, _bfs(pkg)) if pkg == "jax" else
          tgas.AdaptiveExecutor(tg, _bfs(pkg), device=CPU))
    ex.warmup(start=0)
    return _fix_run(pkg, ex, chunk=CHUNK, start=0)


def _case_gas_multi(pkg):
    jg, tg = graphs()
    ex = (jgas.MultiSourceGasExecutor(jg, _bfs(pkg), K) if pkg == "jax"
          else tgas.MultiSourceGasExecutor(tg, _bfs(pkg), K, device=CPU))
    ex.warmup(chunk=CHUNK)
    return _fix_run(pkg, ex, starts=ROOTS, chunk=CHUNK)


def _case_pull_sharded(pkg):
    jg, tg = graphs()
    ex = (jps.ShardedPullExecutor(jg, _pagerank(pkg), num_parts=P)
          if pkg == "jax" else
          tps.ShardedPullExecutor(tg, _pagerank(pkg), num_parts=P,
                                  device=CPU))
    ex.warmup()
    return _pull_run(pkg, ex, sharded=True)


def _case_tiled_sharded(pkg):
    jg, tg = graphs()
    if pkg == "jax":
        ex = jts.ShardedTiledExecutor(jg, _pagerank(pkg), num_parts=P,
                                      plan=jplan(jg))
    else:
        ex = tts.ShardedTiledExecutor(tg, _pagerank(pkg), num_parts=P,
                                      plan=tplan(tg), device=CPU)
    ex.warmup()
    return _pull_run(pkg, ex, sharded=True)


def _case_push_sharded(pkg):
    jg, tg = graphs()
    ex = (jpush.ShardedPushExecutor(jg, _sssp(pkg), num_parts=P)
          if pkg == "jax" else
          tpsh.ShardedPushExecutor(tg, _sssp(pkg), num_parts=P, device=CPU))
    ex.warmup(start=0)
    return _fix_run(pkg, ex, sharded=True, chunk=CHUNK, start=0)


def _case_push_multi_sharded(pkg):
    jg, tg = graphs()
    ex = (jpush.ShardedMultiSourcePushExecutor(jg, _sssp(pkg), K,
                                               num_parts=P)
          if pkg == "jax" else
          tpsh.ShardedMultiSourcePushExecutor(tg, _sssp(pkg), K,
                                              num_parts=P, device=CPU))
    ex.warmup(chunk=CHUNK)
    return _fix_run(pkg, ex, sharded=True, starts=ROOTS, chunk=CHUNK)


def jax_gas_sharded_run(ex, state, chunk):
    """lux_tpu's ShardedAdaptiveExecutor.run() recorder, driven over
    ``phase_step`` (its ``run()`` of a frontier program fails under its
    JAX): the set-up of its run()
    (``lux_tpu/engine/gas_sharded.py:623-646``) and one flush per chunk of
    its fixpoint (``:926-963``). Returns (values, iterations)."""
    g = ex.graph
    rec = jobs.recorder_for("gas_sharded", g, ex.program)
    rec.start()
    rec.record_compile(jobs.consume_compile_seconds(ex))
    packed = ex._xplan is not None
    rec.set_exchange_bytes(ex.exchange_bytes_per_iter(), parts=ex.num_parts)
    if packed:
        rec.set_overlap(True)
    useful = jengobs.useful_exchange(
        ex.sg, ex._row_bytes(),
        exchanged_rows=(ex._xplan.exchanged_units_per_iter
                        if packed else None))
    if useful is not None:
        rec.set_useful_bytes(useful["useful_bytes_per_iter"],
                             useful["ratio"])
    rec.set_hbm_bytes(jengobs.hbm_bytes_per_iter(g.nv, g.ne))
    sizes, dirs, total = [], [], 0
    while True:
        state, cnt, info = ex.phase_step(state)
        total += 1
        sizes.append(cnt)
        dirs.append(int(info["branch"].startswith("push")))
        if total % chunk == 0:
            rec.flush(total, frontier_sizes=sizes, directions=dirs)
            sizes, dirs = [], []
        if cnt == 0:
            break
    rec.flush(total, frontier_sizes=sizes, directions=dirs)
    rec.finish()
    return ex.gather_values(state), total


def _case_gas_sharded(pkg):
    jg, tg = graphs()
    if pkg == "jax":
        ex = jgs.ShardedAdaptiveExecutor(jg, _bfs(pkg), num_parts=P,
                                         mode="adaptive")
        ex.warmup_phases(ex.init_state(start=0))
        return lambda: jax_gas_sharded_run(ex, ex.init_state(start=0),
                                           CHUNK)
    ex = tgs.ShardedAdaptiveExecutor(tg, _bfs(pkg), num_parts=P,
                                     mode="adaptive", device=CPU)
    ex.warmup(start=0)
    return _fix_run(pkg, ex, sharded=True, chunk=CHUNK, start=0)


def _case_gas_multi_sharded(pkg):
    jg, tg = graphs()
    ex = (jgs.ShardedMultiSourceGasExecutor(jg, _bfs(pkg), K, num_parts=P)
          if pkg == "jax" else
          tgs.ShardedMultiSourceGasExecutor(tg, _bfs(pkg), K, num_parts=P,
                                            device=CPU))
    ex.warmup(chunk=CHUNK)
    return _fix_run(pkg, ex, sharded=True, starts=ROOTS, chunk=CHUNK)


def _inc_graphs(pkg):
    """``pkg``'s graph less 20 seeded edges, those edges as the
    ``removed`` batch, and lux_tpu's SSSP from 0 on the whole graph."""
    jg, tg = graphs()
    rng = np.random.default_rng(7)
    eidx = np.sort(rng.choice(tg.ne, size=20, replace=False))
    keep = np.ones(tg.ne, bool)
    keep[eidx] = False
    cls = JGraph if pkg == "jax" else TGraph
    new = cls.from_edges(tg.col_src[keep], tg.col_dst[keep], tg.nv)
    removed = (tg.col_src[eidx].astype(np.int32),
               tg.col_dst[eidx].astype(np.int32), None)
    old, _ = jpush.PushExecutor(jg, _sssp("jax")).run(start=0)
    return new, removed, np.asarray(old.values)


def _case_incremental(pkg):
    new, removed, old = _inc_graphs(pkg)
    if pkg == "jax":
        inc = jinc.IncrementalExecutor(new, _sssp(pkg))
    else:
        inc = tinc.IncrementalExecutor(new, _sssp(pkg), device=CPU)
    inc.warmup(chunk=CHUNK, start=0)

    def run():
        st, iters, _ = inc.run(old, removed=removed, chunk=CHUNK, start=0)
        return _host(pkg, st.values), iters
    return run


def _case_incremental_multi(pkg):
    new, removed, old = _inc_graphs(pkg)
    if pkg == "jax":
        inc = jinc.IncrementalExecutor(new, _sssp(pkg), k=K)
    else:
        inc = tinc.IncrementalExecutor(new, _sssp(pkg), k=K, device=CPU)
    inc.multi.warmup(chunk=CHUNK)
    cols = [old] * len(ROOTS)

    def run():
        st, iters, _ = inc.run_multi(ROOTS, cols, removed=removed,
                                     chunk=CHUNK)
        return _host(pkg, st.values), iters
    return run


CASES = {
    "tiled": _case_tiled,
    "pull": _case_pull,
    "push": _case_push,
    "push_multi": _case_push_multi,
    "gas": _case_gas,
    "gas_multi": _case_gas_multi,
    "pull_sharded": _case_pull_sharded,
    "tiled_sharded": _case_tiled_sharded,
    "push_sharded": _case_push_sharded,
    "push_multi_sharded": _case_push_multi_sharded,
    "gas_sharded": _case_gas_sharded,
    "gas_multi_sharded": _case_gas_multi_sharded,
    "incremental": _case_incremental,
    "incremental_multi": _case_incremental_multi,
}
