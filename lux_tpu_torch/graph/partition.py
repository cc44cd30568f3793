"""Edge-balanced contiguous vertex partitioning and the needed-rows
exchange plan.

A copy of ``lux_tpu/graph/partition.py`` (host numpy, without its
exchange-plan artifact writer, which feeds ``lux_tpu``'s lint tiers).
Tests hold every array byte-identical to the reference's.

The partitioner reproduces the reference's greedy sweep exactly
(core/pull_model.inl:108-131, same code in push_model.inl:378-413): walk
vertices in order accumulating in-degree; when the running count
*exceeds* ``ceil(ne / num_parts)``, close the current part at this vertex
(inclusive) and reset the counter. The sweep is implemented with
``np.searchsorted`` per part instead of a Python loop.

Two deliberate divergences from the reference, as in ``lux_tpu``:
- the reference ``assert``s that the sweep yields exactly ``num_parts``
  parts (pull_model.inl:130); here empty trailing parts pad the list, so
  any graph runs on any number of parts;
- the reference leaves trailing zero-in-degree vertices uncovered
  (pull_model.inl:124-128); here the last non-empty part extends to
  ``nv - 1`` so every vertex owns a slot in the value arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# Frontier-queue sizing for the push model (push_model.inl:390-412,
# sssp/app.h:19): sparse capacity per part, plus slack for corner cases.
SPARSE_THRESHOLD = 16
FRONTIER_SLACK_SLOTS = 100


def edge_balanced_bounds(
    row_ptr: np.ndarray, num_parts: int
) -> List[Tuple[int, int]]:
    """Return ``num_parts`` inclusive (left, right) vertex ranges.

    Empty parts are encoded as (left, left-1) with zero vertices.
    """
    nv = row_ptr.shape[0] - 1
    ne = int(row_ptr[-1])
    edge_cap = (ne + num_parts - 1) // num_parts if num_parts > 0 else ne
    ends = row_ptr[1:]  # cumulative edge count through vertex v (inclusive)
    bounds: List[Tuple[int, int]] = []
    left = 0
    base = 0  # edges consumed by closed parts
    while left < nv and len(bounds) < num_parts:
        # Smallest v >= left with ends[v] - base > edge_cap  (i.e. the
        # running count strictly exceeds the cap — the reference closes the
        # part *at* that vertex, pull_model.inl:117-123).
        v = int(np.searchsorted(ends, base + edge_cap, side="right"))
        if v >= nv or len(bounds) == num_parts - 1:
            v = nv - 1  # remainder part (pull_model.inl:124-128)
        bounds.append((left, v))
        base = int(ends[v])
        left = v + 1
    while len(bounds) < num_parts:
        bounds.append((left, left - 1))  # empty padding part
    return bounds


@dataclasses.dataclass
class PartitionInfo:
    """Partition metadata mirroring the reference Graph's per-part state
    (rowLeft/rowRight/fqLeft/fqRight, core/graph.h:80-87)."""

    num_parts: int
    bounds: List[Tuple[int, int]]         # inclusive vertex ranges
    edge_bounds: List[Tuple[int, int]]    # half-open [colLeft, colRight)
    frontier_slots: List[int]             # sparse queue capacity per part

    @staticmethod
    def build(row_ptr: np.ndarray, num_parts: int) -> "PartitionInfo":
        bounds = edge_balanced_bounds(row_ptr, num_parts)
        edge_bounds = [
            (int(row_ptr[l]), int(row_ptr[r + 1])) if r >= l
            else (int(row_ptr[l]),) * 2   # empty part: l <= nv is in range
            for (l, r) in bounds
        ]
        slots = [
            (max(r - l, 0)) // SPARSE_THRESHOLD + FRONTIER_SLACK_SLOTS
            for (l, r) in bounds
        ]
        return PartitionInfo(
            num_parts=num_parts,
            bounds=bounds,
            edge_bounds=edge_bounds,
            frontier_slots=slots,
        )

    @property
    def max_part_nv(self) -> int:
        return max((r - l + 1) for (l, r) in self.bounds) if self.bounds else 0

    @property
    def max_part_ne(self) -> int:
        return max((e - s) for (s, e) in self.edge_bounds) if self.edge_bounds else 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(eq=False)
class ExchangePlan:
    """Precomputed needed-rows exchange tables for the sharded engines.

    The full exchange all-gathers every part's whole ``max_units``-row
    shard to every other part; the remote-read index proves most of
    those rows are never gathered by the receiver. This plan turns the
    exchange into a fixed-capacity ``all_to_all`` of packed rows: per
    (sender p → receiver q) pair, ``send_units[p]`` lists exactly the
    local row ids of p that q's real edges read, padded to one static
    ``capacity`` so shapes never change across iterations, and
    ``recv_pos[q]`` scatters the received
    rows into q's flat ``(P * max_units,)`` view at the positions the
    unchanged compute bodies index. ``unit_rows`` generalizes the unit:
    1 for row-granular plans (ShardedGraph), BLOCK for the tiled
    executor's 128-row block granularity.

    Sentinels: a pad entry of ``send_units`` is ``max_units`` (senders
    clip the gather; the row's payload is garbage) and the matching
    ``recv_pos`` entry is ``P * max_units`` (receivers scatter it into a
    trash row sliced off before compute), so pad traffic can never leak
    into results.
    """

    num_parts: int
    max_units: int          # per-part padded unit count (max_nv / max_nvb)
    unit_rows: int          # value rows per unit (1, or BLOCK for tiled)
    capacity: int           # static per-(sender, receiver) unit capacity
    counts: np.ndarray      # (P, P) int64: units part q reads of part p
    send_units: np.ndarray  # (P, P*capacity) int32 sender gather lists
    recv_pos: np.ndarray    # (P, P*capacity) int32 receiver scatter slots

    @property
    def exchanged_units_per_iter(self) -> int:
        """Units moved per iteration over the whole mesh (capacity
        figure — what actually crosses the interconnect)."""
        p = self.num_parts
        return p * (p - 1) * self.capacity

    def exchange_bytes_per_iter(self, row_bytes: int) -> int:
        """Interconnect bytes per iteration for ``row_bytes`` per value
        row — the packed-capacity figure."""
        return self.exchanged_units_per_iter * self.unit_rows * int(row_bytes)

    @property
    def profitable(self) -> bool:
        """Whether the packed exchange moves strictly fewer rows per
        pair than the full all-gather; executors fall back to the full
        path (with a log note) when this is False."""
        return self.capacity < self.max_units

    def frontier_capacity(self, frac: float = 0.25, multiple: int = 8) -> int:
        """Static per-(sender, receiver) row budget for the
        frontier-aware exchange (``LUX_EXCHANGE=frontier``).

        The frontier exchange sends only the subset of a pair's static
        ``send_units`` whose source vertex is active this iteration,
        compacted into this many slots (sentinel-padded, so shapes
        never depend on runtime frontier density). It is derived from the static ``capacity``
        rather than from any runtime measurement: ``frac`` of the
        densest pair's padded budget, rounded up to ``multiple`` and
        clamped to ``capacity`` (a frontier can never need more rows
        than the static plan already covers). Iterations whose
        per-pair active-row count exceeds this budget self-downgrade to
        the static compact send — the plan never truncates."""
        if not 0.0 < frac <= 1.0:
            raise ValueError(
                f"frontier capacity fraction must be in (0, 1] (got {frac})"
            )
        cap = _round_up(
            max(1, int(np.ceil(self.capacity * float(frac)))), multiple
        )
        return min(self.capacity, cap)

    @staticmethod
    def from_needs(
        needs,
        max_units: int,
        num_parts: int,
        unit_rows: int = 1,
        multiple: int = 8,
        capacity: Optional[int] = None,
    ) -> "ExchangePlan":
        """Build from per-(receiver, sender) needed-unit lists.

        ``needs[q][p]`` is an ascending int array of the LOCAL unit ids
        of part p that part q reads (``needs[q][q]`` counts toward the
        diagonal of ``counts`` but is never exchanged — own rows stay local).
        ``capacity`` pins the static per-pair pad width; when the needed
        rows of any pair exceed it, the build fails loudly (truncation
        would corrupt results downstream)."""
        P = num_parts
        counts = np.zeros((P, P), dtype=np.int64)
        for q in range(P):
            for p in range(P):
                counts[q, p] = len(needs[q][p])
        off_diag = counts - np.diag(np.diag(counts))
        required = int(off_diag.max()) if P > 1 else 0
        cap = _round_up(max(required, 1), multiple)
        if capacity is not None:
            capacity = int(capacity)
            if capacity < required:
                raise ValueError(
                    f"exchange capacity {capacity} cannot hold the "
                    f"{required} needed units of the densest "
                    "(sender, receiver) pair — refusing to truncate "
                    "the exchange"
                )
            cap = max(capacity, 1)
        send = np.full((P, P, cap), max_units, dtype=np.int32)
        recv = np.full((P, P, cap), P * max_units, dtype=np.int32)
        for q in range(P):
            for p in range(P):
                if p == q:
                    continue
                rows = np.asarray(needs[q][p], dtype=np.int64)
                n = rows.shape[0]
                if n:
                    send[p, q, :n] = rows.astype(np.int32)
                    recv[q, p, :n] = (p * max_units + rows).astype(np.int32)
        return ExchangePlan(
            num_parts=P,
            max_units=max_units,
            unit_rows=int(unit_rows),
            capacity=cap,
            counts=counts,
            send_units=send.reshape(P, P * cap),
            recv_pos=recv.reshape(P, P * cap),
        )

    @staticmethod
    def from_src_pidx(
        src_pidx: np.ndarray,
        edge_mask: np.ndarray,
        max_nv: int,
        num_parts: int,
        multiple: int = 8,
        capacity: Optional[int] = None,
    ) -> "ExchangePlan":
        """Row-granular plan from the stacked flat-index edge arrays —
        the same ``src_pidx``/``edge_mask`` data that feeds
        ``ShardedGraph.remote_read_counts``, so the plan's ``counts``
        matrix is identical to the remote-read index."""
        P = num_parts
        needs = [[np.zeros(0, np.int64)] * P for _ in range(P)]
        for q in range(P):
            rows = np.unique(src_pidx[q][edge_mask[q]]).astype(np.int64)
            owners = rows // max_nv
            for p in range(P):
                needs[q][p] = rows[owners == p] - p * max_nv
        return ExchangePlan.from_needs(
            needs, max_nv, P, unit_rows=1, multiple=multiple,
            capacity=capacity,
        )
