"""Vertex-program abstraction (the counterpart of ``lux_tpu/engine/program.py``).

An application is a :class:`PullProgram`: three functions on tensors —

    contrib_e = edge_contrib(src_val_e, dst_val_e, weight_e)   # per edge
    acc_v     = combine(contrib_e for e into v)                # segment reduce
    new_v     = apply(old_v, acc_v, ctx)                       # per vertex

Host-side initial values are numpy; everything the hooks see on the
device is a ``torch.Tensor``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


class ProgramContractError(TypeError):
    """An engine was asked to run a program whose contract does not
    license it; the message names the failed rule. ``lux_tpu`` raises its
    own from the machine-checked algebra of ``analysis/gasck.py``; the
    port raises this one from the program's declarations until that lint
    is ported (ROADMAP A16)."""


@dataclasses.dataclass(frozen=True)
class VertexCtx:
    """Per-vertex context available to ``apply``."""

    nv: int                        # global vertex count
    out_degrees: torch.Tensor      # (nv,) out-degree per vertex
    in_degrees: torch.Tensor       # (nv,)


@dataclasses.dataclass(frozen=True)
class EdgeCtx:
    """Per-edge context for ``edge_contrib``; every field is (ne, ...)."""

    src_vals: torch.Tensor
    dst_vals: torch.Tensor
    weights: Optional[torch.Tensor]


class PullProgram:
    """Base class for gather-apply (pull) vertex programs."""

    name: str = "pull"
    combiner: str = "sum"             # 'sum' | 'min' | 'max'
    value_dtype = torch.float32
    value_shape: Tuple[int, ...] = ()  # trailing per-vertex dims, e.g. (K,)
    needs_weights: bool = False
    servable: bool = True              # a query app (lux_tpu's serving)
    # True iff edge_contrib(e) == e.src_vals (an SpMV-shaped iteration);
    # unlocks the tiled hybrid executor (engine/tiled.py).
    identity_contrib: bool = False
    # The edge function by the name the CUDA pull kernels know it
    # (ops/segment.py::PULL_EDGE_OPS: "copy" is K8, "cf_sgd" K9). The class
    # that sets it must also define edge_contrib. A program without one
    # runs its plain edge_contrib on the CPU and raises
    # NotImplementedError in PullExecutor on the card.
    edge_op: Optional[str] = None

    def init_values(self, graph) -> np.ndarray:
        """Host-side initial vertex values, shape (nv, *value_shape)."""
        raise NotImplementedError

    def edge_contrib(self, edge: EdgeCtx) -> torch.Tensor:
        """Per-edge contribution toward the destination's accumulator."""
        raise NotImplementedError

    def apply(self, old_vals: torch.Tensor, acc: torch.Tensor,
              ctx: VertexCtx) -> torch.Tensor:
        """Combine accumulator with the old value into the new value."""
        raise NotImplementedError
