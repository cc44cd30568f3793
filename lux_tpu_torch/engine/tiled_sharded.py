"""Sharded hybrid pull executor: int8 strips and the lane-select tail over
P parts, on one device or over the ranks of a process group.

The counterpart of ``lux_tpu/engine/tiled_sharded.py``, which runs one
part per device of a ``shard_map`` mesh. Here the parts a process holds
are the leading axis of stacked ``(L, max_nv)`` values: all P on one
:class:`~lux_tpu_torch.parallel.mesh.LocalMesh`, or a rank's P / W on a
:class:`~lux_tpu_torch.parallel.mesh.DistMesh` (every rank partitions
the whole plan on the host and builds the cell streams and tails of its
own parts only). The two layouts of the hybrid plan are distributed
separately, as there:

- **Tail edges** are owner-computes over a non-contiguous destination
  partition: :func:`partition_plan` snake-deals the 128-vertex blocks to
  parts by descending tail cost, which balances both the block counts
  (every padded array is ``max_nvb`` blocks) and the tail bytes. A
  part's tail edges are the concatenation of its owned blocks' CSC
  ranges, with a local row pointer of ``max_nv + 1`` entries, held on
  the card as one stream of flat source indices
  (``ops/tiled_spmv.py::tail_stream``); K2 (``csrc/segment_sum.cu``)
  runs once per part and adds into the part's row of the strip sums.
- **Strips** are cut by strip index into P equal contiguous runs of
  each level's sorted strip list. Each part holds the cell stream of its
  own run (``ops/tiled_spmv.py::build_level``), whose row pointer covers
  only the band of destination rows the run reaches; the runs partition
  the strips, so the card holds one copy of the cells. Each part runs K1
  (``csrc/strip_spmv.cu``) once per level, adding its band into a
  zeroed partial sum over the whole vertex space. The partials are
  rearranged into owner-stacked block layout (``stack_map``; pad slots
  read a zero row) and the mesh's ``reduce_scatter`` hands every part
  the sum of its own blocks, added in sender order on every mesh.
- **The exchange** builds each part's ``(nvb, 128)`` gather operand.
  Full mode: the mesh's ``all_gather`` of the ``(L, max_nvb, 128)``
  stack (a view on one device), reordered by ``block_map``; all held
  parts share it. Compact mode (``LUX_EXCHANGE=compact``, a profitable
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
either. Not here either: ``trace_step`` and the fused runner. Telemetry
is ``lux_tpu``'s: ``run`` takes ``flush_every`` and a recorder (the
exchange ledger, useful bytes from the block read counts, the byte
model), runs phase-fenced under ``LUX_ENGOBS=1``, and a step's exchange
and its strips, tail and apply are the ``prof`` regions
``lux.tiled_sharded.exchange`` and ``lux.tiled_sharded.compute``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from lux_tpu_torch.engine.program import PullProgram, VertexCtx
from lux_tpu_torch.engine.telemetry import (
    note_exchange,
    open_run,
    run_steps,
    timed_warmup,
)
from lux_tpu_torch.engine.tiled import require_spmv_program
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.graph.partition import ExchangePlan
from lux_tpu_torch.ops.tiled_spmv import (
    BLOCK,
    DeviceHybrid,
    DeviceLevel,
    HybridPlan,
    build_level,
    plan_hybrid,
    refuse_pack,
    strips_sum,
    tail_stream,
    tail_sum,
)
from lux_tpu_torch.parallel.mesh import (
    AnyMesh,
    CompactExchange,
    mesh_for,
    own_parts,
)
from lux_tpu_torch.obs import engobs, prof
from lux_tpu_torch.parallel.shard import exchange_mode
from lux_tpu_torch.utils.logging import get_logger
from lux_tpu_torch.utils.timing import timed

_EXCHANGE = prof.region("lux.tiled_sharded.exchange")
_COMPUTE = prof.region("lux.tiled_sharded.compute")

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
    :class:`~lux_tpu_torch.parallel.mesh.LocalMesh` or a
    :class:`~lux_tpu_torch.parallel.mesh.DistMesh` (``cuda`` unless
    ``device`` or ``mesh`` names another).

    Same program contract as :class:`TiledPullExecutor` (sum combiner,
    identity contribution); the value contract is the sharded one:
    ``init_values``/``step``/``run`` speak the ``(L, max_nv)`` padded
    degree-sorted layout of the held parts, and ``gather_values``
    converts back to a global ``(nv,)`` host array in external vertex
    order (on every rank)."""

    def __init__(
        self,
        graph: Graph,
        program: PullProgram,
        mesh: Optional[AnyMesh] = None,
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
        self.parts = own_parts(self.mesh)
        self.device = self.mesh.device
        self.plan = plan if plan is not None else plan_hybrid(
            graph, levels=levels, budget_bytes=budget_bytes)
        refuse_pack(pack, self.plan.cap)
        self.part = partition_plan(self.plan, self.num_parts)
        self._build()

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- host-side shard construction ------------------------------------

    def _build(self) -> None:
        plan, part, put, held = self.plan, self.part, self._put, self.parts
        P, max_nvb = self.num_parts, part.max_nvb
        self.max_nv = max_nv = max_nvb * BLOCK
        # Which global source blocks each part's strips and tail gather:
        # the remote-read index and the compact plan's needs, of every
        # part; the card holds the held parts' cells and tails only.
        read_blocks = [set() for _ in range(P)]

        part_levels: List[List[DeviceLevel]] = [[] for _ in held]
        for lev in plan.levels:
            n = lev.rows.shape[0]
            cmax = -(-n // P) if n else 0
            for p in range(P):
                i0 = min(p * cmax, n)
                i1 = max(min((p + 1) * cmax, n), i0)
                if i1 > i0:
                    read_blocks[p].update(
                        np.unique(lev.cols[i0:i1]).tolist())
                if p in held:
                    part_levels[p - held.start].append(build_level(
                        lev, plan.nvb, self.device, i0, i1, band=True))

        # Each part's local vertex space is the ascending concatenation of
        # its owned blocks' vertices, and its tail edges the matching
        # gather of per-vertex CSC ranges (destination-sorted in the part).
        tail_per_v = np.diff(plan.tail_row_ptr).astype(np.int64)
        self._vidx = []
        deg_out = np.ones((len(held), max_nv), np.int64)
        deg_in = np.zeros((len(held), max_nv), np.int64)
        vmask = np.zeros((len(held), max_nv), bool)
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
            if p not in held:
                continue
            j = p - held.start
            rp = np.full(max_nv + 1, m, np.int64)
            np.cumsum(lens, out=rp[1:nvloc + 1])
            rp[0] = 0
            deg_out[j, :nvloc] = plan.out_degrees[vidx]
            deg_in[j, :nvloc] = plan.in_degrees[vidx]
            vmask[j, :nvloc] = True
            lane = plan.tail_lane[eidx]
            self._parts.append(DeviceHybrid(
                levels=tuple(part_levels[j]),
                tail_src=tail_stream(sb, lane, self.device),
                tail_row_ptr=put(rp),
                nvb=plan.nvb,
                src_end=max([(int(sb.max()) << 7) + BLOCK if m else 0]
                            + [lev.src_end for lev in part_levels[j]]),
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
        (L, nvb, 128), one per held receiving part (compact)."""
        stack = vals.view(len(self.parts), self.part.max_nvb, BLOCK)
        if self._xch is None:
            return self.mesh.all_gather(stack).index_select(
                0, self._block_map)
        return self._xch.tables(stack).index_select(1, self._block_map)

    def _x2d(self, ops: torch.Tensor, q: int) -> torch.Tensor:
        return ops if self._xch is None else ops[q]

    def _partials(self, ops: torch.Tensor) -> torch.Tensor:
        """(L, nvb + 1, 128): each held part's full-height strip sum, K1
        once per held part and level adding the part's band into zeros,
        and a zero row for stack_map's pad slots."""
        nvb = self.plan.nvb
        buf = torch.zeros((len(self.parts), nvb + 1, BLOCK),
                          dtype=torch.float32, device=self.device)
        for q, part in enumerate(self._parts):
            strips_sum(self._x2d(ops, q), part, nvb * BLOCK,
                       out=buf[q, :nvb].view(-1))
        return buf

    def _merge(self, partials: torch.Tensor) -> torch.Tensor:
        """(L, max_nv) strip sums of the held parts: the partials in
        owner-stacked block order, then the mesh's reduce_scatter."""
        stacked = partials.index_select(1, self._stack_map)
        return self.mesh.reduce_scatter(stacked).view(len(self.parts),
                                                      self.max_nv)

    def _strips(self, ops: torch.Tensor) -> torch.Tensor:
        return self._merge(self._partials(ops))

    def _tail(self, ops: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        """Adds each held part's tail sums over its owned destinations
        into its row of ``acc`` (L, max_nv), the strips' sums: K2 once
        per held part. Returns ``acc``."""
        for q, part in enumerate(self._parts):
            tail_sum(self._x2d(ops, q), part, out=acc[q])
        return acc

    def _apply(self, vals: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        new = self.program.apply(vals, acc, self._ctx)
        return torch.where(self.vertex_mask, new, vals)   # freeze pads

    def _step(self, vals: torch.Tensor) -> torch.Tensor:
        with _EXCHANGE:
            ops = self._exchange(vals)
        with _COMPUTE:
            return self._apply(vals, self._tail(ops, self._strips(ops)))

    # -- running -----------------------------------------------------------

    def _values(self, a) -> torch.Tensor:
        """(L, max_nv) f32 values of the held parts on the device."""
        if isinstance(a, torch.Tensor):
            t = a.to(device=self.device, dtype=torch.float32)
        else:
            t = torch.from_numpy(np.array(a, dtype=np.float32)).to(
                self.device)
        want = (len(self.parts), self.max_nv)
        if tuple(t.shape) != want:
            raise ValueError(f"values must be {want}, got {tuple(t.shape)}")
        return t.contiguous()

    def _to_padded_internal(self, ext_vals) -> torch.Tensor:
        """Global (nv,) host values in external order → the padded
        (L, max_nv) degree-sorted stack of the held parts on the
        device."""
        internal = np.asarray(ext_vals)[self.plan.order]
        out = np.zeros((len(self.parts), self.max_nv), np.float32)
        for j, p in enumerate(self.parts):
            vidx = self._vidx[p]
            out[j, :vidx.shape[0]] = internal[vidx]
        return self._values(out)

    host_to_device = _to_padded_internal

    def init_values(self) -> torch.Tensor:
        return self._to_padded_internal(
            self.program.init_values(self.graph))

    def step(self, vals) -> torch.Tensor:
        """One iteration; (L, max_nv) in and out."""
        return self._step(self._values(vals))

    def phase_step(self, vals):
        """One iteration as separately timed exchange, strips, tail and
        apply phases (CUDA events on the card; the strips phase includes
        the reduce_scatter, and the tail adds into its result). Returns
        (new vals, {phase: seconds})."""
        vals = self._values(vals)
        dev, times = self.device, {}
        with _EXCHANGE:
            ops, times["exchange"] = timed(lambda: self._exchange(vals),
                                           dev)
        with _COMPUTE:
            acc, times["strips"] = timed(lambda: self._strips(ops), dev)
            acc, times["tail"] = timed(lambda: self._tail(ops, acc), dev)
            new, times["apply"] = timed(lambda: self._apply(vals, acc),
                                        dev)
        return new, times

    def warmup(self):
        """One throwaway step, the one run() loops over; its seconds are
        the next run's compile time."""
        timed_warmup(self, lambda: self._step(self.init_values()))

    def run(self, num_iters: int, vals=None, flush_every: int = 8,
            recorder=None) -> torch.Tensor:
        """``num_iters`` iterations from ``vals`` (default: the program's
        initial values). A plain loop of steps on device tensors; with
        telemetry on, one wait for the card every ``flush_every``
        iterations (0: at the end) closes a recorder window, and
        ``LUX_ENGOBS=1`` runs the iterations phase-fenced."""
        vals = self.init_values() if vals is None else self._values(vals)
        rec = open_run(self, "tiled_sharded", recorder, lambda: (
            engobs.hbm_bytes_per_iter(self.graph.nv, self.graph.ne, 4)))
        note_exchange(rec, self, "all_gather")
        if rec.enabled:
            self._note_useful(rec)
        if engobs.enabled():
            out = engobs.run_pull_phased(self, vals, num_iters, rec)
        else:
            out = run_steps(self._step, vals, num_iters, flush_every, rec,
                            self.device)
        rec.finish()
        return out

    def _note_useful(self, rec) -> None:
        """Useful bytes from the (P, P) block read counts, ``lux_tpu``'s
        ledger of this engine: rows read off-part over rows exchanged."""
        counts = self._remote_read_counts
        p = self.num_parts
        if self._xplan is not None:
            exchanged = (self._xplan.exchanged_units_per_iter
                         * self._xplan.unit_rows)
        else:
            exchanged = p * (p - 1) * self.max_nv
        useful_rows = int(counts.sum() - np.trace(counts))
        if exchanged:
            rec.set_useful_bytes(useful_rows * 4, useful_rows / exchanged)

    def exchange_bytes_per_iter(self) -> int:
        """Interconnect bytes of one iteration's value exchange, as
        ``lux_tpu`` prices them. Full: the all-gather of the (P, max_nv)
        f32 stack, each part sending its shard to the P-1 others.
        Compact: the packed block all_to_all payload. The figure is the
        whole mesh's, on every rank; on one device neither crosses an
        interconnect."""
        if self._xplan is not None:
            return self._xplan.exchange_bytes_per_iter(4)
        p = self.num_parts
        return p * (p - 1) * self.max_nv * 4

    def gather_values(self, vals) -> np.ndarray:
        """Padded (L, max_nv) layout → global (nv,) host array in
        external vertex order, on every rank (a collective over
        ranks)."""
        host = self.mesh.all_gather(self._values(vals)).view(
            self.num_parts, self.max_nv).cpu().numpy()
        internal = np.empty(self.plan.nv, host.dtype)
        for p, vidx in enumerate(self._vidx):
            internal[vidx] = host[p, :vidx.shape[0]]
        return internal[self.plan.rank]
