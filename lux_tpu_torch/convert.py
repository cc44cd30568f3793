"""Carry plans and vertex values across from the JAX package.

A plan travels as a dict of numpy arrays, so neither package imports the
other: :func:`plan_to_numpy` / :func:`grouped_plan_to_numpy` read any
object with the plan's attributes (a ``lux_tpu`` plan or this package's),
and :func:`plan_from_numpy` / :func:`grouped_plan_from_numpy` build this
package's plans from the dict. With :func:`vals_from_numpy` a caller can
run the port on exactly the plan and vertex values ``lux_tpu`` computed,
with :func:`push_state_from_numpy` it can finish a push fixpoint from a
state ``lux_tpu`` reached, and with :func:`gas_state_from_numpy` a GAS
fixpoint.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from lux_tpu_torch.engine.gas import GasState
from lux_tpu_torch.engine.push import PushState
from lux_tpu_torch.ops.merge_tail_plan import PLAN_ARRAYS, GroupedTailPlan
from lux_tpu_torch.ops.segment import to_u32_storage, u32_to_numpy
from lux_tpu_torch.ops.tiled_spmv import HybridPlan, StripLevel

_HYBRID_ARRAYS = (
    "order", "rank", "tail_sb", "tail_lane", "tail_row_ptr",
    "out_degrees", "in_degrees",
)


def plan_to_numpy(plan) -> Dict[str, np.ndarray]:
    """Flat dict of a hybrid plan: the arrays, ``lev{i}_{strips,rows,cols}``
    per level, and the scalars as 0-d arrays (``levels_spec`` as an
    (L, 2) array, absent when unknown)."""
    d = {name: np.asarray(getattr(plan, name)) for name in _HYBRID_ARRAYS}
    d["nv"] = np.asarray(plan.nv)
    d["nvb"] = np.asarray(plan.nvb)
    d["cap"] = np.asarray(plan.cap)
    d["budget_bytes"] = np.asarray(plan.budget_bytes)
    d["level_r"] = np.asarray([lev.r for lev in plan.levels], np.int64)
    if plan.levels_spec is not None:
        d["levels_spec"] = np.asarray(plan.levels_spec, np.int64).reshape(-1, 2)
    for i, lev in enumerate(plan.levels):
        d[f"lev{i}_strips"] = np.asarray(lev.strips)
        d[f"lev{i}_rows"] = np.asarray(lev.rows)
        d[f"lev{i}_cols"] = np.asarray(lev.cols)
    return d


def plan_from_numpy(d: Dict[str, np.ndarray]) -> HybridPlan:
    """This package's :class:`HybridPlan` from :func:`plan_to_numpy`'s dict."""
    levels = tuple(
        StripLevel(
            r=int(r),
            strips=np.asarray(d[f"lev{i}_strips"], np.int8),
            rows=np.asarray(d[f"lev{i}_rows"], np.int32),
            cols=np.asarray(d[f"lev{i}_cols"], np.int32),
        )
        for i, r in enumerate(np.asarray(d["level_r"]).tolist())
    )
    spec = d.get("levels_spec")
    return HybridPlan(
        nv=int(d["nv"]), nvb=int(d["nvb"]), levels=levels,
        cap=int(d["cap"]),
        levels_spec=(None if spec is None
                     else tuple((int(r), int(t)) for r, t in spec)),
        budget_bytes=int(d["budget_bytes"]),
        **{name: np.asarray(d[name]) for name in _HYBRID_ARRAYS},
    )


def grouped_plan_to_numpy(plan) -> Dict[str, np.ndarray]:
    """Flat dict of a grouped-tail plan: its planes plus ``n_edges`` and
    ``n_levels`` as 0-d arrays."""
    d = {name: np.asarray(getattr(plan, name)) for name in PLAN_ARRAYS}
    d["n_edges"] = np.asarray(plan.n_edges)
    d["n_levels"] = np.asarray(plan.n_levels)
    return d


def grouped_plan_from_numpy(d: Dict[str, np.ndarray]) -> GroupedTailPlan:
    """This package's :class:`GroupedTailPlan` from
    :func:`grouped_plan_to_numpy`'s dict."""
    return GroupedTailPlan(
        n_edges=int(d["n_edges"]), n_levels=int(d["n_levels"]),
        **{name: np.asarray(d[name]) for name in PLAN_ARRAYS},
    )


def vals_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """(nv, *value_shape) vertex values (e.g. a CF state ``lux_tpu``
    computed) as an f32 tensor on ``device``."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def push_state_from_numpy(values_u32: np.ndarray, frontier_bool: np.ndarray,
                          device) -> PushState:
    """A :class:`PushState` on ``device`` from uint32 values and a bool
    frontier (e.g. ``lux_tpu``'s state after some iterations)."""
    fr = np.array(frontier_bool, dtype=bool)
    return PushState(to_u32_storage(values_u32, device),
                     torch.from_numpy(fr).to(device))


def push_state_to_numpy(state: PushState) -> Tuple[np.ndarray, np.ndarray]:
    """(uint32 values, bool frontier) of a :class:`PushState`."""
    return u32_to_numpy(state.values), state.frontier.cpu().numpy()


def gas_state_from_numpy(values: np.ndarray, frontier_bool: np.ndarray,
                         direction, device) -> GasState:
    """A :class:`GasState` on ``device`` from ``lux_tpu``'s state arrays:
    uint32 values (stored as int32 words of the same bits) or float32,
    of shape (nv,) or (nv, K); a bool frontier of the same shape; and the
    previous iteration's direction (0 pull, 1 push)."""
    vals = np.asarray(values)
    if vals.dtype == np.uint32:
        t = to_u32_storage(vals, device)
    elif vals.dtype == np.float32:
        t = torch.from_numpy(vals.copy()).to(device)
    else:
        raise ValueError(f"GAS values are uint32 or float32, not {vals.dtype}")
    fr = np.array(frontier_bool, dtype=bool)
    return GasState(t, torch.from_numpy(fr).to(device), int(direction))


def gas_state_to_numpy(state: GasState) -> Tuple[np.ndarray, np.ndarray, int]:
    """(values as uint32 or float32, bool frontier, direction) of a
    :class:`GasState`."""
    v = state.values
    vals = (u32_to_numpy(v) if v.dtype == torch.int32
            else v.detach().cpu().numpy())
    return vals, state.frontier.cpu().numpy(), int(state.direction)
