"""Successive-halving search over the declared knob space, the
counterpart of ``lux_tpu/tune/search.py``: the same rungs, subsample,
tie-breaks and records, so one injected ``measure`` gives one artifact
in both packages.

Budget discipline is the point: a flat sweep at useful iteration counts
costs |space| x iters probes, but most losers are obvious after a short
burst. Rung 0 probes every candidate for ``LUX_TUNE_PROBE_ITERS``
iterations; each later rung keeps the top ``ceil(n / LUX_TUNE_ETA)``
by score and doubles the iteration budget, so total probe work stays
~seconds per workload while the final comparison between surviving
candidates is the best-measured one.

Everything is deterministic under ``LUX_TUNE_SEED``: the candidate
list enumerates in fixed order, oversized spaces subsample with a
seeded RNG (the all-defaults candidate always survives — the score
table must always contain the tuned-vs-default delta), and ties break
on candidate index. Same seed + same graph -> identical winner and
identical score table, which tests/test_torch_tune.py holds as a
contract.

``measure`` is injectable for tests: any callable
``(candidate, iters, rung) -> float | ProbeResult`` replaces the real
probe runner, so search logic is testable with a synthetic cost model
and no timing noise.
"""

from __future__ import annotations

import math
import random
import time
from typing import Callable, Dict, List, Optional

from lux_tpu_torch.obs import ledger
from lux_tpu_torch.tune import artifact, probe, space
from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.logging import get_logger

__all__ = ["tune"]

log = get_logger("tune")


def _subsample(candidates: List[Dict[str, str]], cap: int,
               seed: int) -> List[Dict[str, str]]:
    """Seeded subsample preserving enumeration order; candidate 0 (the
    all-defaults assignment) always survives."""
    if len(candidates) <= cap:
        return list(candidates)
    rng = random.Random(seed)
    picked = sorted(rng.sample(range(1, len(candidates)),
                               max(0, cap - 1)))
    return [candidates[0]] + [candidates[i] for i in picked]


def _coerce(result, candidate: Dict[str, str],
            iters: int) -> probe.ProbeResult:
    """Normalize an injected measure()'s return to a ProbeResult."""
    if isinstance(result, probe.ProbeResult):
        return result
    return probe.ProbeResult(dict(candidate), float(result), int(iters),
                             None, {})


def tune(graph, program, engine_kind: str, *,
         program_name: str,
         graph_fingerprint: str,
         mesh_shape: str = "1",
         device_kind: Optional[str] = None,
         init_kw: Optional[dict] = None,
         candidates: Optional[List[Dict[str, str]]] = None,
         measure: Optional[Callable] = None,
         created_at: Optional[float] = None,
         build_kw: Optional[dict] = None) -> dict:
    """Search the knob space for one workload; returns the finished
    ``tuneconf.v1`` artifact dict (not yet persisted — callers decide
    the sink, e.g. :class:`lux_tpu_torch.tune.cache.TuneCache`).

    Every probe and the final selection append run-ledger records, which
    carry the flag snapshots tuned-vs-default deltas are read from.
    ``device_kind`` defaults to the card's name
    (:func:`lux_tpu_torch.obs.report.device_profile`); ``build_kw`` goes
    to every real probe's executor build (:func:`probe.run_probe`).
    """
    if device_kind is None:
        from lux_tpu_torch.obs import report
        device_kind = report.device_profile()["device_kind"]
    key = artifact.make_key(graph_fingerprint, program_name, engine_kind,
                            mesh_shape, device_kind)

    seed = flags.get_int("LUX_TUNE_SEED")
    rungs = max(1, flags.get_int("LUX_TUNE_RUNGS"))
    eta = max(2, flags.get_int("LUX_TUNE_ETA"))
    probe_iters = max(1, flags.get_int("LUX_TUNE_PROBE_ITERS"))
    cap = max(2, flags.get_int("LUX_TUNE_MAX_CANDIDATES"))

    if candidates is None:
        # Footprint-pruned: candidates the memcap.v1 admission formula
        # would refuse at serving time never burn probe wall-clock.
        parts = 1
        try:
            # mesh_shape is the "x"-joined mesh label ("8", "2x4").
            for dim in str(mesh_shape).split("x"):
                parts *= max(1, int(dim))
        except (TypeError, ValueError):
            parts = 1
        candidates = space.knob_space(
            engine_kind, program_name=program_name,
            nv=int(getattr(graph, "nv", 0) or 0),
            ne=int(getattr(graph, "ne", 0) or 0), parts=parts)
    candidates = _subsample(candidates, cap, seed)

    t0 = time.perf_counter()
    score_table: List[dict] = []
    # survivors: (candidate_index, candidate); scored[i] is the latest
    # (score, index) pair for survivor list ordering.
    survivors = list(enumerate(candidates))
    iters = probe_iters
    best: Optional[probe.ProbeResult] = None
    best_idx = 0
    for rung in range(rungs):
        scored = []
        for idx, cand in survivors:
            if measure is not None:
                res = _coerce(measure(cand, iters, rung), cand, iters)
            else:
                res = probe.run_probe(
                    graph, program, engine_kind, cand, iters,
                    init_kw=init_kw, program_name=program_name,
                    graph_fingerprint=graph_fingerprint,
                    mesh_shape=mesh_shape, rung=rung, build_kw=build_kw)
            scored.append((res.score, idx, cand, res))
            score_table.append({
                "candidate_index": idx,
                "rung": rung,
                "iters": res.iters,
                "config": dict(cand),
                "score": res.score,
                "probe_record_id": res.record_id,
                "detail": res.detail,
            })
        # Stable ordering: score first, enumeration index breaks ties,
        # so two runs under one seed always pick the same survivors.
        scored.sort(key=lambda t: (t[0], t[1]))
        best = scored[0][3]
        best_idx = scored[0][1]
        keep = max(1, math.ceil(len(scored) / eta))
        survivors = [(idx, cand) for _, idx, cand, _ in scored[:keep]]
        log.info("tune rung %d: %d candidates @ %d iters, best score "
                 "%.3gs/iter (candidate %d)", rung, len(scored), iters,
                 scored[0][0], best_idx)
        if len(survivors) == 1 and rung + 1 < rungs:
            # Nothing left to halve; later rungs would re-measure the
            # lone survivor for no decision value.
            break
        iters *= 2

    assert best is not None
    elapsed = time.perf_counter() - t0
    default_rows = [r for r in score_table if r["candidate_index"] == 0]
    select_id = ledger.record_run(
        "tune_select",
        {
            "score": best.score,
            "default_score": default_rows[-1]["score"] if default_rows
            else best.score,
            "probes": len(score_table),
            "candidates": len(candidates),
            "search_s": elapsed,
        },
        graph_fingerprint=graph_fingerprint,
        program=program_name,
        engine_kind=engine_kind,
        mesh_shape=mesh_shape,
        tune={"winner": dict(best.candidate),
              "winner_index": best_idx,
              "device_kind": device_kind},
    )
    art = artifact.build(
        key, best.candidate, best.score, score_table,
        graph_meta={"nv": int(graph.nv), "ne": int(graph.ne)},
        tuner={
            "seed": seed, "rungs": rungs, "eta": eta,
            "probe_iters": probe_iters, "candidates": len(candidates),
            "penalty": flags.get_float("LUX_TUNE_PENALTY"),
            "search_s": elapsed,
            "winner_index": best_idx,
        },
        select_record_id=select_id,
        created_at=created_at,
    )
    log.info("tune selected candidate %d for %s: %s (score %.3gs/iter, "
             "%d probes, %.1fs)", best_idx, art["key_string"],
             best.candidate or "defaults", best.score, len(score_table),
             elapsed)
    return art
