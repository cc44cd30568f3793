"""Single-device flat pull executor, on the GPU.

The counterpart of ``PullExecutor`` in ``lux_tpu/engine/pull.py``. One
iteration of a pull program runs over the whole CSC graph:

    contrib_e = edge_contrib(vals[src_e], vals[dst_e], w_e)
    acc_v     = combine(contrib_e for the in-edges e of v)
    new_v     = apply(old_v, acc_v, ctx)

Routing is ``lux_tpu``'s, so ``edge_chunk`` equals its value on every
graph: a sum-combiner program whose flat ``(ne, *value_shape)`` f32
contributions would pass ``LUX_EDGE_CHUNK_BYTES`` runs edge-chunked with
windows of ``DEFAULT_EDGE_CHUNK`` edges; a boundary-dense graph grows
the windows, then falls back to flat with a warning, or raises the
"does not compress" error (:func:`_chunk_boundary_plan`).

On the card a step launches one kernel for the program's ``edge_op``
(:func:`lux_tpu_torch.ops.segment.pull_sum`): K8 ``gather_segment_sum``
for ``"copy"`` (PageRank), K9 ``cf_edge_sum`` for ``"cf_sgd"``
(collaborative filtering), over the graph's row schedule
(:func:`~lux_tpu_torch.ops.segment.pull_row_tasks`, built once with the
executor). Neither materialises contributions, so the
flat and chunked steps and both ``sum_strategy`` values are the same
launch there, and a boundary plan that does not compress refuses
nothing: ``edge_chunk`` is still reported as ``lux_tpu`` routes it. A
program that no kernel covers (no known ``edge_op``, an ``edge_contrib``
defined apart from its ``edge_op``, or a min/max combiner) raises
``NotImplementedError`` when the executor is built there. On the CPU
the step runs the plain version with the program's own
``edge_contrib``, one window of ``edge_chunk`` edges at a time when
chunked, so ``(window, K)`` contributions at most exist; there the
routing refuses what ``lux_tpu`` refuses.

Not ported, because they are TPU layouts that change no result:
``_dst_slice_plan`` and ``_src_slice_plan`` (flags ``LUX_DST_SLICE``,
``LUX_SRC_SLICE``) work around a gather cliff of TPU tables above 48 MB,
which the H100 does not have (a 40 MB table sits in its L2); and
``lane_pad_width`` pads K-vectors to the TPU's 128 lanes. Values stay
``(nv, *value_shape)``, unpadded. ``run`` is a plain loop of steps on
device tensors (``lux_tpu``'s fused runner has no counterpart); with
telemetry on it waits for the card once per ``flush_every`` window and
flushes its recorder there. ``trace_step`` gives the trace tiers
(``analysis/ir.py``) that step.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from lux_tpu_torch.engine.program import EdgeCtx, PullProgram, VertexCtx
from lux_tpu_torch.engine.telemetry import (
    NULL_RECORDER,
    open_run,
    run_steps,
    timed_warmup,
)
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.obs import engobs
from lux_tpu_torch.ops.segment import (
    PULL_EDGE_OPS,
    SUM_STRATEGIES,
    pull_row_tasks,
    pull_sum,
    segment_reduce,
)
from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.platform import resolve_device

DEFAULT_EDGE_CHUNK = 1 << 20
# Ceiling for the boundary-dense degrade path (growing windows / flat
# fallback): any single contribution allocation past this is refused in
# favor of the actionable "does not compress" error.
DEGRADE_CAP_BYTES = 4 << 30


def _check_compresses(row_ptr: np.ndarray, ne: int, chunk: int):
    """The verdict of ``lux_tpu``'s edge-chunked plan: (nchunks, the
    chunk of each of the nv+1 row boundaries, boundaries per chunk,
    R = the most in one chunk), or its "does not compress" error."""
    nchunks = max(-(-ne // chunk), 1)
    cidx = np.minimum(row_ptr.astype(np.int64) // chunk, nchunks - 1)
    cnt = np.bincount(cidx, minlength=nchunks)
    r_max = max(int(cnt.max()), 1)
    # The emit table is padded to the most boundary-dense chunk; if that
    # approaches one slot per edge, chunking no longer compresses and the
    # stacked emits would rival the flat (ne, K) array this path avoids.
    if nchunks * r_max >= 2**31 or nchunks * r_max > max(ne, 1):
        raise ValueError(
            f"edge-chunked plan does not compress: {nchunks} chunks x "
            f"{r_max} boundaries/chunk vs {ne} edges — a run of near-empty "
            "rows packs too many boundaries into one chunk; raise the edge "
            "chunk size or reorder vertices"
        )
    return nchunks, cidx, cnt, r_max


def _chunk_boundary_plan(row_ptr: np.ndarray, ne: int, chunk: int):
    """Assign each of the nv+1 row boundaries to the edge chunk it falls
    in. Returns (nchunks, bnd_pos (nchunks, R), gather_idx (nv+1,),
    bnd_chunk (nv+1,)); R is the worst-case boundaries per chunk.

    A copy of ``lux_tpu``'s plan, whose arrays lay out its emits. The
    port's kernels need none of them: the routing takes only the verdict
    (:func:`_check_compresses`)."""
    nchunks, cidx, cnt, r_max = _check_compresses(row_ptr, ne, chunk)
    rp = row_ptr.astype(np.int64)
    lpos = (rp - cidx * chunk).astype(np.int32)          # ∈ [0, C]
    starts = np.zeros(nchunks, np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    rank = np.arange(rp.shape[0], dtype=np.int64) - starts[cidx]
    bnd_pos = np.zeros((nchunks, r_max), np.int32)
    bnd_pos[cidx, rank] = lpos
    gather_idx = (cidx * r_max + rank).astype(np.int32)
    return nchunks, bnd_pos, gather_idx, cidx.astype(np.int32)


def _widths(value_shape):
    """(flat row width, ``lux_tpu``'s chunked row width): the chunked
    width is K rounded up to 128 lanes for a K-vector (its lane padding).
    The port pads nothing; the width only prices the degrade ladder as
    ``lux_tpu`` prices it."""
    vshape = tuple(value_shape or ())
    kreal = int(np.prod(vshape)) if vshape else 0
    kpad = -(-kreal // 128) * 128 if len(vshape) == 1 and kreal % 128 else 0
    return max(kreal, 1), max(kpad or kreal, 1)


def route_edge_chunk(graph: Graph, program: PullProgram,
                     edge_chunk: Optional[int] = None,
                     refuse: bool = True) -> int:
    """``lux_tpu``'s ``PullExecutor.edge_chunk`` for this graph, program
    and request (0 = flat); raises where it raises. With ``refuse``
    False (the card, whose kernels take no windows) a plan that does not
    compress stands as requested, or as the last auto window tried."""
    w_flat, w_eff = _widths(getattr(program, "value_shape", ()))
    if edge_chunk is None:
        limit = flags.get_int("LUX_EDGE_CHUNK_BYTES")
        flat_bytes = graph.ne * w_flat * np.dtype(np.float32).itemsize
        chunk = (DEFAULT_EDGE_CHUNK
                 if program.combiner == "sum" and flat_bytes > limit else 0)
    else:
        chunk = edge_chunk
    if chunk and program.combiner != "sum":
        raise ValueError(
            "edge-chunked execution needs a sum combiner "
            f"({program.name} has {program.combiner!r})"
        )
    if not chunk:
        return 0
    # On the AUTO-selected path a boundary-dense graph must degrade, not
    # fail: growing windows, then the flat engine, while the resulting
    # contribution array stays under DEGRADE_CAP_BYTES. An explicit
    # edge_chunk keeps the hard error.
    while True:
        try:
            _check_compresses(graph.row_ptr, graph.ne, chunk)
            return chunk
        except ValueError:
            if edge_chunk is None:
                nxt = min(chunk * 4, max(graph.ne, 1))
                if chunk < graph.ne and nxt * w_eff * 4 <= DEGRADE_CAP_BYTES:
                    chunk = nxt
                    continue
                if graph.ne * w_flat * 4 <= DEGRADE_CAP_BYTES:
                    warnings.warn(
                        "edge-chunked plan does not compress on this graph "
                        "— degrading to the flat engine "
                        f"({graph.ne * w_flat * 4 >> 20} MB flat "
                        "contributions)"
                    )
                    return 0
            if refuse:
                raise
            return chunk


def _owner(program: PullProgram, name: str):
    """The instance or class whose own attribute ``name`` the program
    uses."""
    if name in vars(program):
        return program
    return next(c for c in type(program).__mro__ if name in vars(c))


def check_kernel_covers(program: PullProgram) -> None:
    """Raise ``NotImplementedError`` unless a CUDA pull kernel computes
    ``program``'s sums: a sum combiner, a known ``edge_op``, and
    ``edge_contrib`` defined where ``edge_op`` is (a subclass that
    overrides only ``edge_contrib`` is not its parent's kernel)."""
    if program.combiner != "sum":
        raise NotImplementedError(
            f"{program.name}: the CUDA pull kernels sum; a "
            f"{program.combiner!r} combiner runs only on the CPU")
    if program.edge_op not in PULL_EDGE_OPS:
        raise NotImplementedError(
            f"{program.name}: the CUDA pull kernels know edge ops "
            f"{PULL_EDGE_OPS}, not {program.edge_op!r}")
    if _owner(program, "edge_op") is not _owner(program, "edge_contrib"):
        raise NotImplementedError(
            f"{program.name}: edge_contrib is defined apart from edge_op "
            f"{program.edge_op!r}, so the kernel may compute another "
            "function; set edge_op where edge_contrib is defined")


class PullExecutor:
    """Executes a pull program on a single device (``cuda`` unless
    ``device`` names another). ``edge_chunk`` forces chunked with the
    given window, ``edge_chunk=0`` forces flat; ``sum_strategy`` is
    ``"rowptr"`` or ``"segment"`` (two TPU formulations of one sum: on
    the CPU, f64 prefix differences or an f32 scatter-add; on the card,
    the same kernel). On the card both change nothing."""

    def __init__(
        self,
        graph: Graph,
        program: PullProgram,
        sum_strategy: str = "rowptr",
        device=None,
        edge_chunk: Optional[int] = None,
    ):
        if program.needs_weights and graph.weights is None:
            raise ValueError(f"{program.name} requires an edge-weighted graph")
        if sum_strategy not in SUM_STRATEGIES:
            raise ValueError(f"unknown sum strategy {sum_strategy!r}")
        self.graph = graph
        self.program = program
        self.sum_strategy = sum_strategy
        self.device = resolve_device(device)
        on_card = self.device.type != "cpu"
        if on_card:
            check_kernel_covers(program)
        self.edge_chunk = route_edge_chunk(graph, program, edge_chunk,
                                           refuse=not on_card)
        self.value_shape = tuple(getattr(program, "value_shape", ()) or ())

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.row_ptr = put(graph.row_ptr.astype(np.int64))
        self.col_src = put(graph.col_src.astype(np.int32))
        self.weights = None if graph.weights is None else put(graph.weights)
        # The kernel's row schedule; the CPU's plain version needs none.
        self.tasks = (pull_row_tasks(graph.row_ptr, program.edge_op,
                                     self.device) if on_card else None)
        self.col_dst = (put(graph.col_dst) if program.combiner != "sum"
                        else None)
        self._ctx = VertexCtx(
            nv=graph.nv,
            out_degrees=put(graph.out_degrees.astype(np.int32)),
            in_degrees=put(graph.in_degrees.astype(np.int32)),
        )

    # -- one iteration ---------------------------------------------------

    def _edge_fn(self, src, dst, w) -> torch.Tensor:
        return self.program.edge_contrib(
            EdgeCtx(src_vals=src, dst_vals=dst, weights=w))

    def _acc(self, vals: torch.Tensor) -> torch.Tensor:
        prog = self.program
        if prog.combiner == "sum":
            return pull_sum(
                vals, self.row_ptr, self.col_src, self.weights, prog.edge_op,
                self._edge_fn, self.tasks, self.edge_chunk,
                self.sum_strategy)
        # Min/max combiners: the plain scatter (the CPU only; see
        # check_kernel_covers).
        edge = EdgeCtx(src_vals=vals[self.col_src.long()],
                       dst_vals=vals[self.col_dst.long()],
                       weights=self.weights)
        return segment_reduce(prog.edge_contrib(edge), self.col_dst,
                              self.graph.nv, kind=prog.combiner)

    def _step(self, vals: torch.Tensor) -> torch.Tensor:
        return self.program.apply(vals, self._acc(vals), self._ctx)

    # -- running -----------------------------------------------------------

    def _values(self, a) -> torch.Tensor:
        """(nv, *value_shape) f32 values on the device."""
        if isinstance(a, torch.Tensor):
            t = a.to(device=self.device, dtype=torch.float32)
        else:
            t = torch.from_numpy(np.array(a, dtype=np.float32)).to(
                self.device)
        want = (self.graph.nv,) + self.value_shape
        if tuple(t.shape) != want:
            raise ValueError(f"values must be {want}, got {tuple(t.shape)}")
        return t.contiguous()

    def init_values(self) -> torch.Tensor:
        return self._values(self.program.init_values(self.graph))

    def step(self, vals) -> torch.Tensor:
        """One iteration; (nv, *value_shape) in and out."""
        return self._step(self._values(vals))

    def trace_step(self, **init_kw) -> dict:
        """Trace-tier hook (``analysis/ir.py``): the step ``run`` loops
        over, from the program's initial values. ``lux_tpu`` donates
        the values (``donate=(0,)``); this step writes new values, so it
        donates nothing (ROADMAP: memck's LUX702)."""
        return {"kind": "pull", "call": self._step,
                "args": lambda: (self.init_values(),), "donate": (),
                "carry": (0,), "sharded": False}

    def warmup(self):
        """One throwaway iteration through the run() path (builds the
        kernels) so timed runs exclude set-up; its seconds are the next
        run's compile time."""
        timed_warmup(self, lambda: self.run(1, recorder=NULL_RECORDER))

    def run(self, num_iters: int, vals=None, flush_every: int = 8,
            recorder=None) -> torch.Tensor:
        """``num_iters`` iterations from ``vals`` (default: the program's
        initial values). A plain loop of steps on device tensors; with
        telemetry on, one wait for the card every ``flush_every``
        iterations (0: at the end) closes a recorder window."""
        vals = self.init_values() if vals is None else self._values(vals)
        width = int(np.prod(self.value_shape)) if self.value_shape else 1
        rec = open_run(self, "pull", recorder, lambda: (
            engobs.hbm_bytes_per_iter(self.graph.nv, self.graph.ne,
                                      k=width)))
        vals = run_steps(self._step, vals, num_iters, flush_every, rec,
                         self.device)
        rec.finish()
        return vals
