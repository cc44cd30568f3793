"""Sharded pull executor: the P parts of an edge-balanced partition, on
one device or over the ranks of a process group.

The counterpart of ``ShardedPullExecutor`` in
``lux_tpu/engine/pull_sharded.py``, which runs one part per device of a
``shard_map`` mesh. Here the parts a process holds are the leading axis
of stacked ``(L, max_nv, *value_shape)`` values: all P on one device
(:class:`~lux_tpu_torch.parallel.mesh.LocalMesh`), or a rank's P / W
(:class:`~lux_tpu_torch.parallel.mesh.DistMesh`, where the exchange's
collectives cross ranks). One iteration is three phases:

- **exchange**: the flat ``(P * max_nv, *t)`` table of every part's
  values that the parts' edges gather from (``src_pidx``). Full mode:
  the mesh's ``all_gather``, which on one device is a view of the
  stacked values and across ranks one collective. Compact mode
  (``LUX_EXCHANGE=compact``, a profitable
  :class:`~lux_tpu_torch.graph.partition.ExchangePlan`): one table per
  receiver, of the rows its edges read
  (:class:`~lux_tpu_torch.parallel.mesh.CompactExchange`:
  ``index_select``, ``all_to_all``, ``index_copy_``). The receiver's
  own span of its table is written from its local shard, so a local
  edge reads through the same single gather the value ``lux_tpu``'s
  local-first select gives it. Every row an edge reads equals the full
  table's, so compact equals full bitwise. The exchange is plain torch
  indexing, no hand-written kernel: it is pure data movement, which
  ``index_select`` and ``index_copy_`` already do at the card's rate;
- **comp**: one kernel launch per part, as ``lux_tpu`` runs one device
  per part: K8 ``gather_segment_sum`` (PageRank) or K9 ``cf_edge_sum``
  (CF) over the part's ``local_row_ptr`` and ``src_pidx``, with the
  part's :class:`~lux_tpu_torch.ops.segment.RowTasks`. K9 reads each
  destination's row from the same table as the sources, at ``row_base =
  part * max_nv``, the part's own span. Pad edges lie past
  ``local_row_ptr[max_nv]``, so no row holds one. A row's sum is taken
  in the order one device takes it, so the parts' sums equal the
  single-device run's bitwise;
- **update**: ``program.apply`` over the stacked parts, then pad
  vertices are frozen by ``vertex_mask``.

Routing follows :class:`~lux_tpu_torch.engine.pull.PullExecutor`: on the
card a program that no kernel covers raises ``NotImplementedError``
(:func:`~lux_tpu_torch.engine.pull.check_kernel_covers`), and both
``sum_strategy`` values are the same launch; on the CPU the kernels'
plain versions run, and min/max combiners reduce by ``dst_local``.

Telemetry as ``lux_tpu``'s: ``run`` takes ``flush_every`` and a
recorder (the exchange ledger, useful bytes and the byte model), runs
phase-fenced under ``LUX_ENGOBS=1`` (``obs/engobs.py``), and the
exchange and compute of a step are the ``prof`` regions
``lux.pull_sharded.exchange`` and ``lux.pull_sharded.compute``.

Not ported, by design: ``lux_tpu``'s lane padding (``_kpad``), a TPU
gather layout that changes no result (``exchange_bytes_per_iter`` prices
the real width, as ``lux_tpu`` does); the fused runner (``run`` is a
plain loop of steps on device tensors). ``trace_step`` gives the trace
tiers (``analysis/ir.py``) that step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lux_tpu_torch.engine.program import EdgeCtx, PullProgram, VertexCtx
from lux_tpu_torch.engine.pull import check_kernel_covers
from lux_tpu_torch.engine.sharded import ShardedBase
from lux_tpu_torch.engine.telemetry import (
    note_exchange,
    open_run,
    run_steps,
    timed_warmup,
)
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.obs import engobs, prof
from lux_tpu_torch.ops.segment import (
    SUM_STRATEGIES,
    pull_row_tasks,
    pull_sum,
    segment_reduce,
)
from lux_tpu_torch.parallel.mesh import AnyMesh
from lux_tpu_torch.parallel.shard import ShardedGraph
from lux_tpu_torch.utils.timing import timed

_EXCHANGE = prof.region("lux.pull_sharded.exchange")
_COMPUTE = prof.region("lux.pull_sharded.compute")


class ShardedPullExecutor(ShardedBase):
    """Runs a :class:`PullProgram` over the ``num_parts`` parts of a
    :class:`~lux_tpu_torch.parallel.mesh.LocalMesh` or a
    :class:`~lux_tpu_torch.parallel.mesh.DistMesh` (``cuda`` unless
    ``device`` or ``mesh`` names another). Values are the ``(L, max_nv,
    *value_shape)`` stack of the parts this process holds."""

    def __init__(
        self,
        graph: Graph,
        program: PullProgram,
        mesh: Optional[AnyMesh] = None,
        num_parts: Optional[int] = None,
        sum_strategy: str = "rowptr",
        sg: Optional[ShardedGraph] = None,
        device=None,
    ):
        if sum_strategy not in SUM_STRATEGIES:
            raise ValueError(f"unknown sum strategy {sum_strategy!r}")
        self._setup(graph, program, mesh, num_parts, sg, device)
        self.sum_strategy = sum_strategy
        if self.device.type != "cpu":
            check_kernel_covers(program)
        self.value_shape = tuple(getattr(program, "value_shape", ()) or ())
        width = int(np.prod(self.value_shape)) if self.value_shape else 0
        self._row_bytes = max(width, 1) * getattr(program.value_dtype,
                                                  "itemsize", 4)
        sg = self.sg
        self._build_parts(
            lambda rp, dev: pull_row_tasks(rp, program.edge_op, dev))
        self.dst_local = (self._put_own(sg.dst_local)
                          if program.combiner != "sum" else None)
        self._ctx = VertexCtx(nv=graph.nv,
                              out_degrees=self._put_own(sg.out_degrees),
                              in_degrees=self._put_own(sg.in_degrees))

    # -- one iteration ---------------------------------------------------

    def _edge_fn(self, src, dst, w) -> torch.Tensor:
        return self.program.edge_contrib(
            EdgeCtx(src_vals=src, dst_vals=dst, weights=w))

    def _comp(self, flat: torch.Tensor) -> torch.Tensor:
        """(L, max_nv, *t) accumulators: one kernel launch per held
        part."""
        prog = self.program
        accs = []
        for q, part in enumerate(self._parts):
            table = self._table(flat, q)
            if prog.combiner == "sum":
                accs.append(pull_sum(
                    table, part.row_ptr, part.col_src, part.weights,
                    prog.edge_op, self._edge_fn, part.tasks, 0,
                    self.sum_strategy, part.row_base))
                continue
            # Min/max combiners: the plain scatter (the CPU only; see
            # check_kernel_covers).
            dst = self.dst_local[q, :part.col_src.shape[0]]
            edge = EdgeCtx(src_vals=table[part.col_src.long()],
                           dst_vals=table[dst.long() + part.row_base],
                           weights=part.weights)
            accs.append(segment_reduce(prog.edge_contrib(edge), dst,
                                       self.sg.max_nv, kind=prog.combiner))
        return torch.stack(accs)

    def _update(self, vals: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        new = self.program.apply(vals, acc, self._ctx)
        mask = self.vertex_mask.view(
            tuple(self.vertex_mask.shape) + (1,) * len(self.value_shape))
        return torch.where(mask, new, vals)   # freeze pad vertices

    def _step(self, vals: torch.Tensor) -> torch.Tensor:
        with _EXCHANGE:
            flat = self._exchange(vals)
        with _COMPUTE:
            return self._update(vals, self._comp(flat))

    # -- running -----------------------------------------------------------

    def _values(self, a) -> torch.Tensor:
        """(L, max_nv, *value_shape) f32 values on the device."""
        if isinstance(a, torch.Tensor):
            t = a.to(device=self.device, dtype=torch.float32)
        else:
            t = torch.from_numpy(np.array(a, dtype=np.float32)).to(
                self.device)
        want = (len(self.parts), self.sg.max_nv) + self.value_shape
        if tuple(t.shape) != want:
            raise ValueError(f"values must be {want}, got {tuple(t.shape)}")
        return t.contiguous()

    def init_values(self) -> torch.Tensor:
        return self.host_to_device(self.program.init_values(self.graph))

    def host_to_device(self, host_vals) -> torch.Tensor:
        """Global (nv, *t) host array → the padded (L, max_nv, *t) stack
        of the held parts on the device."""
        return self._values(self._own(self.sg.to_padded(
            np.asarray(host_vals))))

    def step(self, vals) -> torch.Tensor:
        """One iteration; (L, max_nv, *value_shape) in and out."""
        return self._step(self._values(vals))

    def trace_step(self, **init_kw) -> dict:
        """Trace-tier hook (``analysis/ir.py``): the step ``run`` loops
        over, from the program's initial values, with the exchange keys
        LUX404-406 read. ``lux_tpu`` donates the values; this step
        writes new values, so it donates nothing (ROADMAP: memck's
        LUX702)."""
        return {"kind": "pull_sharded", "call": self._step,
                "args": lambda: (self.init_values(),), "donate": (),
                "carry": (0,),
                **self._exchange_spec(np.float32)}

    def phase_step(self, vals):
        """One iteration as separately timed exchange, comp and update
        phases (CUDA events on the card). Returns (new vals, {phase:
        seconds})."""
        vals = self._values(vals)
        dev, times = self.device, {}
        with _EXCHANGE:
            flat, times["exchange"] = timed(lambda: self._exchange(vals),
                                            dev)
        with _COMPUTE:
            acc, times["comp"] = timed(lambda: self._comp(flat), dev)
            new, times["update"] = timed(lambda: self._update(vals, acc),
                                         dev)
        return new, times

    def warmup(self):
        """One throwaway step, the one run() loops over (builds the
        kernels), so timed runs exclude set-up; its seconds are the next
        run's compile time."""
        timed_warmup(self, lambda: self._step(self.init_values()))

    def run(self, num_iters: int, vals=None, flush_every: int = 8,
            recorder=None) -> torch.Tensor:
        """``num_iters`` iterations from ``vals`` (default: the program's
        initial values). A plain loop of steps on device tensors; with
        telemetry on, one wait for the card every ``flush_every``
        iterations (0: at the end) closes a recorder window, and
        ``LUX_ENGOBS=1`` runs the iterations phase-fenced."""
        vals = self.init_values() if vals is None else self._values(vals)
        width = int(np.prod(self.value_shape)) if self.value_shape else 1
        itemsize = self._row_bytes // width
        rec = open_run(self, "pull_sharded", recorder, lambda: (
            engobs.hbm_bytes_per_iter(self.graph.nv, self.graph.ne,
                                      itemsize, width)))
        note_exchange(rec, self, "all_gather", self._row_bytes)
        if engobs.enabled():
            out = engobs.run_pull_phased(self, vals, num_iters, rec)
        else:
            out = run_steps(self._step, vals, num_iters, flush_every, rec,
                            self.device)
        rec.finish()
        return out

    def gather_values(self, vals) -> np.ndarray:
        """Padded device layout → global (nv, *t) host array, on every
        rank (a collective over ranks)."""
        return self.sg.from_padded(
            self._gathered(self._values(vals)).cpu().numpy())
