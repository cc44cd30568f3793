"""Sharded hybrid pull executor: int8 strips and the lane-select tail over
P parts, on one device.

The counterpart of ``lux_tpu/engine/tiled_sharded.py``, which runs one
part per device of a ``shard_map`` mesh. Here the parts are the leading
axis of stacked ``(P, max_nv)`` values on one
:class:`~lux_tpu_torch.parallel.mesh.LocalMesh`, and the two layouts of
the hybrid plan are distributed separately, as there:

- **Tail edges** are owner-computes over a non-contiguous destination
  partition: :func:`partition_plan` snake-deals the 128-vertex blocks to
  parts by descending tail cost, which balances both the block counts
  (every padded array is ``max_nvb`` blocks) and the tail bytes. A
  part's tail edges are the concatenation of its owned blocks' CSC
  ranges, with a local row pointer of ``max_nv + 1`` entries; K2
  (``csrc/segment_sum.cu``) runs once per part.
- **Strips** are cut by strip index into P equal contiguous runs of
  each level's sorted strip list. Each level's strips are uploaded once
  and each part's run is a view of them. Each part runs K1
  (``csrc/strip_spmv.cu``) once per level over a full-height row
  pointer, into a partial sum over the whole vertex space. The partials
  are rearranged into owner-stacked block layout (``stack_map``; pad
  slots read a zero row) and the mesh's ``reduce_scatter`` hands every
  part the sum of its own blocks.
- **The exchange** builds each part's ``(nvb, 128)`` gather operand.
  Full mode: the mesh's ``all_gather`` of the ``(P, max_nvb, 128)``
  stack (a view on one device), reordered by ``block_map``; all parts
  share it. Compact mode (``LUX_EXCHANGE=compact``, a profitable
  block-granular :class:`~lux_tpu_torch.graph.partition.ExchangePlan`):
  :class:`~lux_tpu_torch.parallel.mesh.CompactExchange` over the stack
  with blocks as its rows, then ``block_map`` per receiver. Blocks a
  part does not read stay zero there; no strip or tail edge of that part
  reads them, so compact equals full bitwise.

Parts meet only in the mesh's three collectives: ``all_gather``,
``all_to_all`` (inside the compact exchange) and ``reduce_scatter``.
New values are written for owned destinations only, and pad vertices
are frozen by ``vertex_mask``.

Not ported, by design: the Z-stream boundaries, ``crossing_correction``,
``segs``, ``_warn_big_table`` and the ``chunk_strips``/``chunk_tail``
knobs. They are the TPU's layout and change no result; the port's
:class:`~lux_tpu_torch.engine.tiled.TiledPullExecutor` has none of them
either. Also not here: the recorder, engobs, ``prof`` regions,
``trace_step``, the fused runner and ``run``'s ``flush_every``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from lux_tpu_torch.engine.program import PullProgram, VertexCtx
from lux_tpu_torch.engine.tiled import require_spmv_program
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.graph.partition import ExchangePlan
from lux_tpu_torch.ops.segment import SEG_ITEM, SegmentItems
from lux_tpu_torch.ops.tiled_spmv import (
    BLOCK,
    STRIP_ITEM,
    DeviceHybrid,
    DeviceLevel,
    HybridPlan,
    plan_hybrid,
    resolve_pack,
    strips_sum,
    tail_sum,
)
from lux_tpu_torch.parallel.mesh import CompactExchange, LocalMesh, mesh_for
from lux_tpu_torch.parallel.shard import exchange_mode
from lux_tpu_torch.utils.logging import get_logger
from lux_tpu_torch.utils.timing import timed

# ---------------------------------------------------------------------------
# Host-side partitioning of a HybridPlan (a copy of lux_tpu's)
# ---------------------------------------------------------------------------

# Streamed-bytes cost of serving one tail edge: a 512 B row gather of the
# source block, amortized ~4x by destination locality in CSC order. The
# exact constant only shifts the balance point between strip-heavy and
# tail-heavy shards; 512 B keeps hub blocks (strip-dense) and leaf blocks
# (tail-dense) comparably weighted.
TAIL_EDGE_COST = 512


@dataclasses.dataclass(eq=False)
class PlanPartition:
    """Ownership of the plan's destination 128-blocks across P parts.

    Ownership is non-contiguous: on the degree-sorted internal order the
    tail concentrates in the late (leaf) blocks, so a contiguous cut
    trades padding against tail imbalance; snake-dealing blocks by
    descending tail cost balances both."""

    owner: np.ndarray     # (nvb,) int32 owning part per block
    blocks: tuple         # P arrays: owned block ids, ascending
    max_nvb: int          # max blocks owned by any part (= ceil(nvb/P))

    @property
    def num_parts(self) -> int:
        return len(self.blocks)


def partition_plan(plan: HybridPlan, num_parts: int) -> PlanPartition:
    """Snake-deal destination 128-blocks to parts by descending tail-edge
    cost: part counts balance exactly (each part takes every P-th block
    of the cost-sorted order) and tail bytes balance because adjacent
    cost ranks alternate direction each round. Strips are not in this
    cost: they are cut by strip index."""
    nvb = plan.nvb
    tail_per_v = np.diff(plan.tail_row_ptr).astype(np.int64)
    tail_per_blk = np.pad(
        tail_per_v, (0, nvb * BLOCK - plan.nv)
    ).reshape(nvb, BLOCK).sum(axis=1)

    order = np.argsort(-tail_per_blk, kind="stable")
    owner = np.empty(nvb, np.int32)
    ranks = np.arange(nvb, dtype=np.int64)
    rounds, pos = divmod(ranks, num_parts)
    snake = np.where(rounds % 2 == 0, pos, num_parts - 1 - pos)
    owner[order] = snake.astype(np.int32)
    blocks = tuple(
        np.flatnonzero(owner == p).astype(np.int64)
        for p in range(num_parts)
    )
    max_nvb = max(max(b.shape[0] for b in blocks), 1)
    return PlanPartition(owner=owner, blocks=blocks, max_nvb=int(max_nvb))


def _ranges_to_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [starts[i], starts[i]+lens[i]) ranges into one index
    array (vectorized; the tail-edge gather list of a part's owned
    blocks)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    return (
        np.arange(total, dtype=np.int64)
        + np.repeat(starts - offs, lens)
    )


class ShardedTiledExecutor:
    """Strip/lane-select hybrid SpMV over the ``num_parts`` parts of a
    :class:`LocalMesh` (``cuda`` unless ``device`` or ``mesh`` names
    another).

    Same program contract as :class:`TiledPullExecutor` (sum combiner,
    identity contribution); the value contract is the sharded one:
    ``init_values``/``step``/``run`` speak the ``(P, max_nv)`` padded
    degree-sorted layout, and ``gather_values`` converts back to a global
    ``(nv,)`` host array in external vertex order."""

    def __init__(
        self,
        graph: Graph,
        program: PullProgram,
        mesh: Optional[LocalMesh] = None,
        num_parts: Optional[int] = None,
        levels: Sequence[Tuple[int, int]] = ((8, 2),),
        budget_bytes: int = 8 << 30,
        plan: Optional[HybridPlan] = None,
        pack: Optional[bool] = None,
        device=None,
    ):
        require_spmv_program(
            program, "ShardedTiledExecutor", "ShardedPullExecutor")
        self.graph = graph
        self.program = program
        self.mesh = mesh_for(mesh, num_parts, device)
        self.num_parts = self.mesh.num_parts
        self.device = self.mesh.device
        self.plan = plan if plan is not None else plan_hybrid(
            graph, levels=levels, budget_bytes=budget_bytes)
        if resolve_pack(pack, self.plan.cap):
            raise NotImplementedError(
                "nibble-packed strips (pack=True / LUX_PACK_STRIPS=1) are "
                "not ported yet: ROADMAP.md queue A, 'Nibble-packed strips'")
        self.part = partition_plan(self.plan, self.num_parts)
        self._build()

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- host-side shard construction ------------------------------------

    def _build(self) -> None:
        plan, part, put = self.plan, self.part, self._put
        P, max_nvb = self.num_parts, part.max_nvb
        self.max_nv = max_nv = max_nvb * BLOCK
        # Which global source blocks each part's strips and tail gather:
        # the remote-read index and the compact plan's needs.
        read_blocks = [set() for _ in range(P)]

        part_levels: List[List[DeviceLevel]] = [[] for _ in range(P)]
        for lev in plan.levels:
            nrb = plan.nvb * (BLOCK // lev.r)
            n = lev.rows.shape[0]
            cmax = -(-n // P) if n else 0
            strips = put(lev.strips)   # one copy; each part takes a view
            cols = put(lev.cols.astype(np.int32))
            for p in range(P):
                i0, i1 = p * cmax, min((p + 1) * cmax, n)
                k = max(i1 - i0, 0)
                if k:
                    read_blocks[p].update(
                        np.unique(lev.cols[i0:i1]).tolist())
                row_ptr = np.searchsorted(
                    lev.rows[i0:i1], np.arange(nrb + 1, dtype=np.int64)
                ).astype(np.int64)
                part_levels[p].append(DeviceLevel(
                    r=lev.r, strips=strips[i0:i0 + k],
                    cols=cols[i0:i0 + k], row_ptr=put(row_ptr),
                    items=SegmentItems.build(row_ptr, STRIP_ITEM,
                                             self.device)))

        # Each part's local vertex space is the ascending concatenation of
        # its owned blocks' vertices, and its tail edges the matching
        # gather of per-vertex CSC ranges (destination-sorted in the part).
        tail_per_v = np.diff(plan.tail_row_ptr).astype(np.int64)
        self._vidx = []
        deg_out = np.ones((P, max_nv), np.int64)
        deg_in = np.zeros((P, max_nv), np.int64)
        vmask = np.zeros((P, max_nv), bool)
        self._parts: List[DeviceHybrid] = []
        for p in range(P):
            B = part.blocks[p]
            vidx = ((B * BLOCK)[:, None]
                    + np.arange(BLOCK, dtype=np.int64)).ravel()
            vidx = vidx[vidx < plan.nv]
            self._vidx.append(vidx.astype(np.int32))
            nvloc = vidx.shape[0]
            lens = tail_per_v[vidx]
            eidx = _ranges_to_indices(plan.tail_row_ptr[vidx], lens)
            m = eidx.shape[0]
            sb = plan.tail_sb[eidx]
            if m:
                read_blocks[p].update(np.unique(sb).tolist())
            rp = np.full(max_nv + 1, m, np.int64)
            np.cumsum(lens, out=rp[1:nvloc + 1])
            rp[0] = 0
            deg_out[p, :nvloc] = plan.out_degrees[vidx]
            deg_in[p, :nvloc] = plan.in_degrees[vidx]
            vmask[p, :nvloc] = True
            self._parts.append(DeviceHybrid(
                levels=tuple(part_levels[p]),
                tail_sb=put(sb.astype(np.int32)),
                tail_lane=put(plan.tail_lane[eidx].astype(np.int8)),
                tail_row_ptr=put(rp),
                tail_items=SegmentItems.build(rp, SEG_ITEM, self.device),
                nvb=plan.nvb,
            ))

        # (P, P) rows-read matrix in value rows (lux_tpu's engobs ledger).
        counts = np.zeros((P, P), np.int64)
        for p, blocks in enumerate(read_blocks):
            if blocks:
                owners = part.owner[np.fromiter(blocks, np.int64,
                                                len(blocks))]
                counts[p] += np.bincount(
                    owners, minlength=P).astype(np.int64) * BLOCK
        self._remote_read_counts = counts

        # block_map: block b lives at flat row owner[b] * max_nvb + its rank
        # in its owner's ascending block list. stack_map inverts it: the
        # stacked slot p * max_nvb + i is part p's i-th owned block, or the
        # zero row nvb for a pad slot.
        rank_in_owner = np.zeros(plan.nvb, np.int64)
        stack = np.full(P * max_nvb, plan.nvb, np.int32)
        for p in range(P):
            B = part.blocks[p]
            rank_in_owner[B] = np.arange(B.shape[0], dtype=np.int64)
            stack[p * max_nvb:p * max_nvb + B.shape[0]] = B
        self.block_map = (part.owner.astype(np.int64) * max_nvb
                          + rank_in_owner).astype(np.int32)
        self.stack_map = stack
        self._block_map = put(self.block_map.astype(np.int64))
        self._stack_map = put(stack.astype(np.int64))

        # Compact exchange, block-granular: a 128-row block is the finest
        # unit the tiled gather addresses, and multiple=1 because a unit
        # needs no further rounding.
        self._xplan = None
        log = get_logger("engine")
        if exchange_mode() == "compact":
            if P == 1:
                log.info("LUX_EXCHANGE=compact falling back to full: one "
                         "part exchanges nothing")
            else:
                needs = [[np.zeros(0, np.int64)] * P for _ in range(P)]
                for q in range(P):
                    blocks = np.fromiter(read_blocks[q], np.int64,
                                         len(read_blocks[q]))
                    owners_b = part.owner[blocks]
                    ranks = rank_in_owner[blocks]
                    for p in range(P):
                        needs[q][p] = np.sort(ranks[owners_b == p])
                xplan = ExchangePlan.from_needs(
                    needs, max_nvb, P, unit_rows=BLOCK, multiple=1)
                if xplan.profitable:
                    self._xplan = xplan
                else:
                    log.info(
                        "LUX_EXCHANGE=compact unprofitable for this tiled "
                        "plan (capacity %d >= %d blocks/part); using the "
                        "full exchange", xplan.capacity, max_nvb)
        self.exchange_mode = "compact" if self._xplan is not None else "full"
        self._xch = (None if self._xplan is None
                     else CompactExchange(self._xplan, self.mesh, max_nvb))

        self.vertex_mask = put(vmask)
        self._ctx = VertexCtx(nv=self.graph.nv,
                              out_degrees=put(deg_out.astype(np.int32)),
                              in_degrees=put(deg_in.astype(np.int32)))

    # -- one iteration ---------------------------------------------------

    def _exchange(self, vals: torch.Tensor) -> torch.Tensor:
        """The gather operand: one shared (nvb, 128) array (full), or
        (P, nvb, 128), one per receiving part (compact)."""
        stack = vals.view(self.num_parts, self.part.max_nvb, BLOCK)
        if self._xch is None:
            return self.mesh.all_gather(stack).index_select(
                0, self._block_map)
        return self._xch.tables(stack).index_select(1, self._block_map)

    def _x2d(self, ops: torch.Tensor, q: int) -> torch.Tensor:
        return ops if self._xch is None else ops[q]

    def _partials(self, ops: torch.Tensor) -> torch.Tensor:
        """(P, nvb + 1, 128): each part's full-height strip sum, K1 once
        per part and level, and a zero row for stack_map's pad slots."""
        nvb = self.plan.nvb
        buf = torch.empty((self.num_parts, nvb + 1, BLOCK),
                          dtype=torch.float32, device=self.device)
        buf[:, nvb] = 0.0
        for q, part in enumerate(self._parts):
            buf[q, :nvb] = strips_sum(self._x2d(ops, q), part,
                                      nvb * BLOCK).view(nvb, BLOCK)
        return buf

    def _merge(self, partials: torch.Tensor) -> torch.Tensor:
        """(P, max_nv) strip sums: the partials in owner-stacked block
        order, then the mesh's reduce_scatter."""
        stacked = partials.index_select(1, self._stack_map)
        return self.mesh.reduce_scatter(stacked).view(self.num_parts,
                                                      self.max_nv)

    def _strips(self, ops: torch.Tensor) -> torch.Tensor:
        return self._merge(self._partials(ops))

    def _tail(self, ops: torch.Tensor) -> torch.Tensor:
        """(P, max_nv) tail sums over each part's owned destinations: K2
        once per part."""
        return torch.stack([tail_sum(self._x2d(ops, q), part)
                            for q, part in enumerate(self._parts)])

    def _apply(self, vals: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        new = self.program.apply(vals, acc, self._ctx)
        return torch.where(self.vertex_mask, new, vals)   # freeze pads

    def _step(self, vals: torch.Tensor) -> torch.Tensor:
        ops = self._exchange(vals)
        return self._apply(vals, self._strips(ops) + self._tail(ops))

    # -- running -----------------------------------------------------------

    def _values(self, a) -> torch.Tensor:
        """(P, max_nv) f32 values on the device."""
        if isinstance(a, torch.Tensor):
            t = a.to(device=self.device, dtype=torch.float32)
        else:
            t = torch.from_numpy(np.array(a, dtype=np.float32)).to(
                self.device)
        want = (self.num_parts, self.max_nv)
        if tuple(t.shape) != want:
            raise ValueError(f"values must be {want}, got {tuple(t.shape)}")
        return t.contiguous()

    def _to_padded_internal(self, ext_vals) -> torch.Tensor:
        """Global (nv,) host values in external order → the padded
        (P, max_nv) degree-sorted stack on the device."""
        internal = np.asarray(ext_vals)[self.plan.order]
        out = np.zeros((self.num_parts, self.max_nv), np.float32)
        for p, vidx in enumerate(self._vidx):
            out[p, :vidx.shape[0]] = internal[vidx]
        return self._values(out)

    host_to_device = _to_padded_internal

    def init_values(self) -> torch.Tensor:
        return self._to_padded_internal(
            self.program.init_values(self.graph))

    def step(self, vals) -> torch.Tensor:
        """One iteration; (P, max_nv) in and out."""
        return self._step(self._values(vals))

    def phase_step(self, vals):
        """One iteration as separately timed exchange, strips, tail and
        apply phases (CUDA events on the card; the strips phase includes
        the reduce_scatter). Returns (new vals, {phase: seconds})."""
        vals = self._values(vals)
        dev, times = self.device, {}
        ops, times["exchange"] = timed(lambda: self._exchange(vals), dev)
        acc_s, times["strips"] = timed(lambda: self._strips(ops), dev)
        acc_t, times["tail"] = timed(lambda: self._tail(ops), dev)
        new, times["apply"] = timed(
            lambda: self._apply(vals, acc_s + acc_t), dev)
        return new, times

    def warmup(self):
        """One throwaway iteration through the run() path."""
        self.run(1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_iters: int, vals=None) -> torch.Tensor:
        """``num_iters`` iterations from ``vals`` (default: the program's
        initial values). A plain loop of steps on device tensors (no
        host sync inside)."""
        vals = self.init_values() if vals is None else self._values(vals)
        for _ in range(num_iters):
            vals = self._step(vals)
        return vals

    def exchange_bytes_per_iter(self) -> int:
        """Interconnect bytes of one iteration's value exchange, as
        ``lux_tpu`` prices them. Full: the all-gather of the (P, max_nv)
        f32 stack, each part sending its shard to the P-1 others.
        Compact: the packed block all_to_all payload. On one device
        neither crosses an interconnect."""
        if self._xplan is not None:
            return self._xplan.exchange_bytes_per_iter(4)
        p = self.num_parts
        return p * (p - 1) * self.max_nv * 4

    def gather_values(self, vals) -> np.ndarray:
        """Padded (P, max_nv) layout → global (nv,) host array in
        external vertex order."""
        host = self._values(vals).cpu().numpy()
        internal = np.empty(self.plan.nv, host.dtype)
        for p, vidx in enumerate(self._vidx):
            internal[vidx] = host[p, :vidx.shape[0]]
        return internal[self.plan.rank]
