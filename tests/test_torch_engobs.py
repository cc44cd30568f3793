"""Port parity: the engine observatory (``obs/engobs.py``) and the cost
of telemetry on the executors.

- Under ``LUX_ENGOBS=1`` the sharded pull, tiled, push, multi-source
  push and GAS executors run phase-fenced in both packages; the records'
  iterations, branches, frontiers and densities must be equal, each
  iteration split into exchange and compute seconds, and the port's
  values equal its plain run's bitwise (``lux_tpu``'s GAS ``run()``
  works when phase-fenced: it goes through ``phase_step``, not the
  chunked loop that fails under its JAX).
- ``useful_exchange`` and ``hbm_bytes_per_iter`` equal ``lux_tpu``'s on
  the same partition, in the full and compact modes.
- Off costs nothing: with every knob unset the pull family's ``run()``
  calls no ``torch.cuda.synchronize``, ``Tensor.item`` or
  ``Tensor.cpu``, and every executor's run makes the same host reads on
  and off (the push and GAS runs: their per-iteration counter reads);
  on, the pull family waits for the card once per flush window.
- Telemetry never changes a result: each of the 13 executors gives the
  same values bitwise, the same iterations and the same ledgers with
  telemetry on and off.

R-MAT 9 from both packages (``tests/torch_obs_cases.py``), P = 4.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch
from torch_obs_cases import CASES, CHUNK, CPU, P, PULL_FAMILY, graphs

from lux_tpu import models as jmodels
from lux_tpu import obs as jobs
from lux_tpu.engine import gas_sharded as jgs
from lux_tpu.engine import pull_sharded as jps
from lux_tpu.obs import engobs as jengobs
from lux_tpu.parallel.shard import ShardedGraph as JSharded
from lux_tpu_torch import models as tmodels
from lux_tpu_torch import obs as tobs
from lux_tpu_torch.engine import gas as tgas
from lux_tpu_torch.engine import gas_sharded as tgs
from lux_tpu_torch.engine import pull_sharded as tps
from lux_tpu_torch.engine import push as tpush
from lux_tpu_torch.engine import push_sharded as tpsh
from lux_tpu_torch.engine import telemetry
from lux_tpu_torch.obs import engobs as tengobs
from lux_tpu_torch.parallel.shard import ShardedGraph as TSharded

OBS = {"jax": jobs, "torch": tobs}
KNOBS = ("LUX_METRICS", "LUX_TRACE", "LUX_ENGOBS", "LUX_FLIGHT_DIR",
         "LUX_LEDGER_DIR", "LUX_PROF_DIR")
PHASED = ("pull_sharded", "tiled_sharded", "push_sharded",
          "push_multi_sharded", "gas_sharded")


@pytest.fixture
def knobs_unset(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    for mod in OBS.values():
        mod.reconfigure()
    yield monkeypatch
    for mod in OBS.values():
        mod.reconfigure()


def _recorded(pkg, tmp_path, run):
    """(run(), the run's last lux.run_telemetry.v1 record) with
    LUX_METRICS set to ``pkg``'s file."""
    path = tmp_path / f"{pkg}.jsonl"
    os.environ["LUX_METRICS"] = str(path)
    try:
        out = run()
    finally:
        del os.environ["LUX_METRICS"]
    return out, json.loads(path.read_text().splitlines()[-1])


@pytest.mark.parametrize("case", PHASED)
def test_phased_run_equals_lux_tpus(knobs_unset, tmp_path, case):
    knobs_unset.setenv("LUX_ENGOBS", "1")
    if case == "gas_sharded":
        # lux_tpu's GAS run() when phase-fenced (see the docstring).
        jg, _ = graphs()
        jex = jgs.ShardedAdaptiveExecutor(jg, jmodels.get_program("bfs"),
                                          num_parts=P, mode="adaptive")

        def jrun():
            st, it = jex.run(start=0)
            return jex.gather_values(st), it
    else:
        jrun = CASES[case]("jax")
    trun = CASES[case]("torch")
    (jvals, jiters), jrec = _recorded("jax", tmp_path, jrun)
    (tvals, titers), trec = _recorded("torch", tmp_path, trun)
    assert titers == jiters == trec["num_iters"] == jrec["num_iters"]
    keys = ("iter", "branch", "frontier", "frontier_density", "crossover",
            "flush_span")
    assert [{k: it.get(k) for k in keys} for it in trec["iterations"]] == \
        [{k: it.get(k) for k in keys} for it in jrec["iterations"]]
    for key in ("exchange_bytes_per_iter", "useful_bytes_per_iter",
                "hbm_bytes_per_iter", "parts", "crossovers"):
        assert trec.get(key) == jrec.get(key), key
    for it in trec["iterations"]:
        assert it["exchange_s"] >= 0 and it["compute_s"] > 0
        assert 0.0 <= it["exchange_frac"] <= 1.0
    assert set(trec["phases"]) == set(jrec["phases"])
    assert trec["compile_s"] > 0       # the phases' first run
    # Phase-fenced values equal the plain run's bitwise.
    knobs_unset.delenv("LUX_ENGOBS")
    plain_vals, plain_iters = trun()
    np.testing.assert_array_equal(tvals, plain_vals)
    assert plain_iters == titers
    if case in PULL_FAMILY:
        np.testing.assert_allclose(tvals, jvals, rtol=5e-5, atol=1e-9)
    else:
        np.testing.assert_array_equal(tvals, jvals)
    assert tengobs.latest()


@pytest.mark.parametrize("mode", ["full", "compact"])
def test_useful_exchange_equals_lux_tpus(knobs_unset, mode):
    knobs_unset.setenv("LUX_EXCHANGE", mode)
    jg, tg = graphs()
    jsg, tsg = JSharded.build(jg, P), TSharded.build(tg, P)
    jex = jps.ShardedPullExecutor(jg, jmodels.get_program("pagerank"),
                                  num_parts=P, sg=jsg)
    tex = tps.ShardedPullExecutor(tg, tmodels.get_program("pagerank"),
                                  num_parts=P, sg=tsg, device=CPU)
    assert (tex._xplan is None) == (jex._xplan is None)
    rows = (None if tex._xplan is None
            else tex._xplan.exchanged_units_per_iter)
    for row_bytes in (4, 5, 80):
        assert tengobs.useful_exchange(tsg, row_bytes, rows) == \
            jengobs.useful_exchange(jsg, row_bytes, rows)
    got = tengobs.useful_exchange(tsg, 4)
    assert 0.0 < got["ratio"] <= 1.0
    assert got["exchanged_rows"] == P * (P - 1) * tsg.max_nv
    for nv, ne, vb, k in ((512, 4096, 4, 1), (10, 7, 8, 20), (0, 0, 4, 0)):
        assert tengobs.hbm_bytes_per_iter(nv, ne, vb, k) == \
            jengobs.hbm_bytes_per_iter(nv, ne, vb, k)


def test_latest_table():
    tengobs.reset()
    assert tengobs.latest() == {}
    tengobs.note("gas", num_iters=3)
    tengobs.note("gas", direction_push=1)
    got = tengobs.latest()
    assert got == {"gas": {"num_iters": 3, "direction_push": 1}}
    got["gas"]["num_iters"] = 9            # a copy
    assert tengobs.latest()["gas"]["num_iters"] == 3
    tengobs.reset()
    assert tengobs.latest() == {}


def test_split_sums_the_phases():
    times = {"loadTime": 1.0, "compTime": 2.0, "updateTime": 0.5,
             "branch": "dense", "exchange": 0.25}
    assert tengobs._split(times) == jengobs._split(times) == (1.25, 2.5)


# -- the cost of telemetry ---------------------------------------------------


class _Counts:
    """Counts host synchronisations and device-to-host reads."""

    NAMES = ("item", "cpu", "tolist")

    def __init__(self, monkeypatch):
        self.n = collections.Counter()
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._wrap(name, orig))
        monkeypatch.setattr(torch.cuda, "synchronize",
                            self._wrap("synchronize", lambda *a, **k: None))
        orig_sync = telemetry.sync
        monkeypatch.setattr(telemetry, "sync",
                            self._wrap("window", orig_sync))

    def _wrap(self, name, fn):
        def counted(*a, **k):
            self.n[name] += 1
            return fn(*a, **k)
        return counted

    def take(self) -> dict:
        out = dict(self.n)
        self.n.clear()
        return out

    def syncs(self) -> dict:
        """``take()`` less ``tolist``: on the CPU the plain version of K8
        reads each edge window's row bounds with it; the kernel on the
        card reads nothing."""
        out = self.take()
        out.pop("tolist", None)
        return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_off_adds_no_sync_and_on_no_read(knobs_unset, tmp_path, case):
    run = CASES[case]("torch")
    counts = _Counts(knobs_unset)
    assert tobs.recorder_for("x", graphs()[1]) is tobs.NULL_RECORDER
    # The runs' own host work (building the initial state, the values'
    # copy to the host) is the same on and off; what run() adds is what
    # telemetry adds.
    off_vals, off_iters = run()
    off = counts.take()
    knobs_unset.setenv("LUX_METRICS", str(tmp_path / "m.jsonl"))
    on_vals, on_iters = run()
    on = counts.take()
    np.testing.assert_array_equal(on_vals, off_vals)
    assert on_iters == off_iters
    windows = on.pop("window", 0)
    assert "window" not in off and "synchronize" not in off
    assert on == off
    if case in PULL_FAMILY:
        assert windows == 2           # run(10), flush_every=8
    else:
        assert windows == 0           # the counter reads already wait


@pytest.mark.parametrize("flush_every,windows", [(8, 2), (0, 1), (3, 4),
                                                 (1, 10)])
def test_on_waits_once_per_window(knobs_unset, tmp_path, flush_every,
                                  windows):
    _, tg = graphs()
    ex = tps.ShardedPullExecutor(tg, tmodels.get_program("pagerank"), num_parts=P, device=CPU)
    vals = ex.init_values()
    counts = _Counts(knobs_unset)
    ex.run(10, vals=vals, flush_every=flush_every)
    assert counts.syncs() == {}
    knobs_unset.setenv("LUX_METRICS", str(tmp_path / "m.jsonl"))
    ex.run(10, vals=vals, flush_every=flush_every)
    assert counts.syncs() == {"window": windows}
    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert max(it["flush_span"] for it in rec["iterations"]) == windows


def test_pull_family_run_reads_nothing_from_the_card(knobs_unset):
    """The pull family's run() alone, values staying on the device: no
    read, no wait, with every knob unset."""
    _, tg = graphs()
    ex = tps.ShardedPullExecutor(tg, tmodels.get_program("pagerank"), num_parts=P, device=CPU)
    vals = ex.init_values()
    counts = _Counts(knobs_unset)
    ex.run(10, vals=vals)
    assert counts.syncs() == {}


def test_push_reads_once_per_iteration(knobs_unset, tmp_path):
    _, tg = graphs()
    ex = tpush.PushExecutor(tg, tmodels.get_program("sssp"), device=CPU)
    st = ex.init_state(start=0)
    counts = _Counts(knobs_unset)
    _, iters = ex.run(state=st, chunk=CHUNK)
    # One counter read before the loop and one after each iteration.
    assert counts.take() == {"tolist": iters + 1}
    knobs_unset.setenv("LUX_TRACE", str(tmp_path / "t.jsonl"))
    tobs.reconfigure()
    ex.run(state=st, chunk=CHUNK)
    assert counts.take() == {"tolist": iters + 1}


@pytest.mark.parametrize("case", ["push", "gas", "gas_sharded",
                                  "push_sharded"])
def test_ledgers_unchanged_by_telemetry(knobs_unset, tmp_path, case):
    """The branch and direction ledgers of a run are the same on and
    off."""
    _, tg = graphs()
    ex = {
        "push": lambda: tpush.PushExecutor(
            tg, tmodels.get_program("sssp"), device=CPU),
        "gas": lambda: tgas.AdaptiveExecutor(
            tg, tmodels.get_program("bfs"), device=CPU),
        "gas_sharded": lambda: tgs.ShardedAdaptiveExecutor(
            tg, tmodels.get_program("bfs"), num_parts=P, mode="adaptive",
            device=CPU),
        "push_sharded": lambda: tpsh.ShardedPushExecutor(
            tg, tmodels.get_program("sssp"), num_parts=P, device=CPU),
    }[case]()
    ex.run(start=0, chunk=CHUNK)
    log = getattr(ex, "branch_log", None) or ex.direction_log
    queue = list(getattr(ex, "queue_log", []))
    knobs_unset.setenv("LUX_METRICS", str(tmp_path / "m.jsonl"))
    ex.run(start=0, chunk=CHUNK)
    assert (getattr(ex, "branch_log", None) or ex.direction_log) == log
    assert list(getattr(ex, "queue_log", [])) == queue
    assert len(log) >= 2
