"""Declared knob space for the profile-guided auto-tuner, the
counterpart of ``lux_tpu/tune/space.py``: the same managed flags, axes,
pruning and order, so both packages enumerate equal candidate lists.

The tuner may only turn knobs that are (a) declared in the flag
registry, (b) captured at executor build time (so applying a winner at
serving warmup never recompiles per query), and (c) bitwise-neutral for
integral-valued programs — direction schedules, exchange packing, and
tail plans all prove bitwise parity in their own tests. That set is
:data:`TUNER_MANAGED`; luxlint's LUX502 rejects any artifact that
configures a flag outside it.

Candidates are complete assignments (every managed flag applicable to
the engine kind gets an explicit value, defaults included) so a
persisted ``tuneconf.v1`` is self-describing. Enumeration is
deterministic: axes in fixed order, default value first on each axis,
itertools.product, then constraint pruning — the same engine kind always
yields the same candidate list in the same order, which is what makes
the search reproducible under one seed.

Layout/partition choice is not a flag axis: layout is part of the tune
*key* (`engine_kind`), so each layout with a plan-cache entry tunes
separately.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from lux_tpu_torch.utils import flags

__all__ = ["TUNER_MANAGED", "knob_space", "default_candidate",
           "is_sharded", "is_gas", "is_tiled"]

# Every flag the tuner is allowed to set. lux_doctor --tuned and
# luxlint LUX502 both key off this set.
TUNER_MANAGED = frozenset({
    "LUX_EXCHANGE",
    "LUX_EXCHANGE_FRONTIER_FRAC",
    "LUX_GAS_DENSITY_HI",
    "LUX_GAS_DENSITY_LO",
    "LUX_GROUPED_TAIL",
})

_GAS_KINDS = frozenset({"gas", "gas_multi", "gas_sharded",
                        "gas_multi_sharded"})
_TILED_KINDS = frozenset({"tiled", "tiled_sharded"})


def is_sharded(engine_kind: str) -> bool:
    return engine_kind.endswith("sharded")


def is_gas(engine_kind: str) -> bool:
    return engine_kind in _GAS_KINDS


def is_tiled(engine_kind: str) -> bool:
    return engine_kind in _TILED_KINDS


def _sdef(name: str) -> str:
    """Declared default as the string an env var would carry."""
    d = flags.default(name)
    return "" if d is None else str(d)


def _axes(engine_kind: str) -> List:
    """``[(flag, [values...])]`` applicable to the kind; default value
    first on every axis."""
    axes = []
    if is_sharded(engine_kind):
        modes = ["full", "compact"]
        if is_gas(engine_kind):
            # Frontier exchange is the sharded-GAS path; other sharded
            # executors silently run it as compact, which would probe
            # duplicates.
            modes.append("frontier")
        axes.append(("LUX_EXCHANGE", modes))
        axes.append(("LUX_EXCHANGE_FRONTIER_FRAC",
                     [_sdef("LUX_EXCHANGE_FRONTIER_FRAC"),
                      "0.125", "0.5"]))
    if is_gas(engine_kind):
        axes.append(("LUX_GAS_DENSITY_HI",
                     [_sdef("LUX_GAS_DENSITY_HI"), "0.25", "0.9"]))
        axes.append(("LUX_GAS_DENSITY_LO",
                     [_sdef("LUX_GAS_DENSITY_LO"), "0.05"]))
    if is_tiled(engine_kind):
        axes.append(("LUX_GROUPED_TAIL",
                     [_sdef("LUX_GROUPED_TAIL"), "1"]))
    return axes


def _admissible(cand: Dict[str, str]) -> bool:
    """Constraint pruning: frontier fraction only varies when the
    exchange actually runs frontier mode; hysteresis must keep lo < hi
    (equal thresholds would flap every iteration)."""
    if "LUX_EXCHANGE_FRONTIER_FRAC" in cand \
            and cand.get("LUX_EXCHANGE") != "frontier" \
            and cand["LUX_EXCHANGE_FRONTIER_FRAC"] \
            != _sdef("LUX_EXCHANGE_FRONTIER_FRAC"):
        return False
    if "LUX_GAS_DENSITY_HI" in cand:
        if float(cand["LUX_GAS_DENSITY_LO"]) \
                >= float(cand["LUX_GAS_DENSITY_HI"]):
            return False
    return True


def default_candidate(engine_kind: str) -> Dict[str, str]:
    """The all-defaults assignment over the kind's applicable knobs —
    always candidate 0, so a tuned-vs-default delta is in every score
    table."""
    return {flag: values[0] for flag, values in _axes(engine_kind)}


def knob_space(engine_kind: str, *, program_name: Optional[str] = None,
               nv: Optional[int] = None, ne: Optional[int] = None,
               parts: int = 1, k: int = 1) -> List[Dict[str, str]]:
    """Deterministic candidate list for one engine kind. Candidate 0 is
    :func:`default_candidate`; kinds with no applicable knobs get just
    that one (the tuner then records an honest "nothing to tune").

    When the caller supplies the probe context (``program_name`` +
    graph dims), candidates whose memcap.v1-predicted footprint does
    not fit the HBM budget are pruned *before* probing — a candidate
    that would be refused admission at serving time is wasted probe
    wall-clock. Candidate 0 is never pruned (the default config is the
    comparison baseline and the honest fallback)."""
    axes = _axes(engine_kind)
    if not axes:
        return [{}]
    names = [a[0] for a in axes]
    out = []
    for combo in itertools.product(*(a[1] for a in axes)):
        cand = dict(zip(names, combo))
        if _admissible(cand) and cand not in out:
            out.append(cand)
    if program_name and nv and ne:
        out = [out[0]] + [c for c in out[1:]
                          if _fits_budget(c, engine_kind, program_name,
                                          nv, ne, parts, k)]
    return out


def _fits_budget(cand: Dict[str, str], engine_kind: str,
                 program_name: str, nv: int, ne: int,
                 parts: int, k: int) -> bool:
    """True unless the candidate's predicted per-device footprint
    (under its own LUX_EXCHANGE mode) provably exceeds the HBM budget.
    Unknown footprint or no budget means fits — pruning only ever removes
    candidates admission would certainly refuse."""
    try:
        from lux_tpu_torch.analysis import memck

        budget = memck.hbm_budget_bytes()
        if budget is None:
            return True
        mode = cand.get("LUX_EXCHANGE", "")
        pred = memck.predicted_engine_bytes(
            program_name, engine_kind, mode, nv, ne, parts, k=k)
        return pred is None or pred <= budget
    # luxlint: disable=LUX007 -- advisory pruning: a broken predictor keeps the full space
    except Exception:
        return True
