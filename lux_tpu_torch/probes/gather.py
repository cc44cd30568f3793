"""The gather kernels of the H100 probes, their plain versions, and the
probes' timer.

The counterparts of the Pallas kernels of ``tools/probe_dgather.py``,
``tools/probe_dgather2.py`` and ``tools/probe_merge_kernel.py`` (P2-P7):

- :func:`block_take` (P2-P5): ``take_along_axis(x, idx, axis)`` within
  each ``(S, L)`` block of an ``(rows, L)`` f32 array, axis 0 or 1, with
  an int32 or int8 index; kernel ``block_take`` in
  ``csrc/probe_gather.cu``, or, along axis 0 over blocks too large for
  L1 (:func:`strip_plan`), kernel ``block_take_strip``, which copies a
  column strip of a block into shared memory once and gathers from
  there. The wrapper chooses from the call's shapes and index type.
- :func:`merge4` (P6): ``out[i, j] = cand[i, s[i, j], l[i, j]]`` as
  ``k_merge``'s masked sum over four candidates; kernel ``merge4`` in the
  same source, which streams each row's 2 KB of candidates through
  shared memory.
- :func:`merge_level` (P7): a 2-candidate merge level whose A and B
  inputs are 8-row windows of one stream at per-block offsets, each row
  repeated twice. That is K3 (``csrc/level_apply.cu``) with the input
  row of output row ``16 g + i`` at ``8 * off[g] + i // 2``; the
  wrapper expands the offsets on the card and launches K3.

Each function runs its plain PyTorch version (``take_along_dim`` over a
view, as the Pallas bodies do) for CPU tensors only; for CUDA tensors it
launches its kernel or raises. All three only move data, so kernel and
plain version agree bitwise. Indices must lie in range, as the probes
draw them.
"""

from __future__ import annotations

import statistics
import time

import torch

from lux_tpu_torch.ops import _cuda
from lux_tpu_torch.ops.merge_tail_kernel import level_apply

_IDX_TYPES = {torch.int32: "int32", torch.int8: "int8"}


def take_kernel(axis: int, dtype: torch.dtype, strip: bool = False) -> str:
    """The launch-count name of one form of the block_take kernel (of
    block_take_strip with ``strip``)."""
    kernel = "block_take_strip" if strip else "block_take"
    return f"{kernel}[axis={axis} {_IDX_TYPES[dtype]}]"


# block_take_strip takes axis-0 int32 gathers over blocks of at least
# STRIP_MIN_ROWS rows. Its strip is the widest of STRIP_WIDTHS floats whose
# S rows fit in STRIP_SMEM bytes of shared memory; where none does, it is
# 8 floats wide with its first STRIP_ROWS rows in shared memory (the widths
# and the budget timed best on the H100 over S from 512 to 8192).
STRIP_MIN_ROWS = 128
STRIP_WIDTHS = (32, 16, 8)
STRIP_SMEM = 128 * 1024
STRIP_ROWS = 6144
STRIP_SMEM_MAX = 227 * 1024   # shared memory a block may use on sm_90


def strip_plan(block_rows: int, width: int, dtype=torch.int32):
    """``(W, R)`` of the strip kernel for an axis-0 gather over
    ``(block_rows, width)`` blocks with a ``dtype`` index: strips of W
    floats with their first R rows in shared memory; or None when the
    row kernel takes the blocks: under STRIP_MIN_ROWS rows they stay in
    L1, and an int8 index reaches only a block's first 128 rows."""
    if dtype != torch.int32 or block_rows < STRIP_MIN_ROWS:
        return None
    for w in STRIP_WIDTHS:
        if width % w == 0 and block_rows * w * 4 <= STRIP_SMEM:
            return w, block_rows
    if width % 8:
        return None
    return 8, min(block_rows, STRIP_ROWS)


def _check_take(x, idx, axis, block_rows):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be a 2-D f32 array, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if idx.shape != x.shape or idx.dtype not in _IDX_TYPES:
        raise ValueError("idx must be int32 or int8 of x's shape")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if axis == 0 and (block_rows < 1 or x.shape[0] % block_rows):
        raise ValueError(f"{x.shape[0]} rows do not split into blocks of "
                         f"{block_rows}")


def block_take_plain(x, idx, axis: int, block_rows: int):
    """``take_along_axis`` within each ``(block_rows, L)`` block."""
    _check_take(x, idx, axis, block_rows)
    if axis == 1:
        return torch.take_along_dim(x, idx.long(), dim=1)
    rows, width = x.shape
    shape = (rows // block_rows, block_rows, width)
    return torch.take_along_dim(x.view(shape), idx.long().view(shape),
                                dim=1).view(rows, width)


def block_take(x, idx, axis: int, block_rows: int):
    """``out = take_along_axis(x, idx, axis)`` within each
    ``(block_rows, L)`` block of ``x`` (rows, L) f32; ``idx`` is int32 or
    int8 of the same shape. ``block_rows`` matters for axis 0 only."""
    if x.device.type == "cpu":
        return block_take_plain(x, idx, axis, block_rows)
    _check_take(x, idx, axis, block_rows)
    dev = x.device
    _cuda.check(x, "x", torch.float32, dev, ndim=2)
    _cuda.check(idx, "idx", idx.dtype, dev, ndim=2)
    if x.shape[1] % 4 or idx.data_ptr() % (4 * idx.element_size()):
        raise ValueError("the kernel takes rows of a multiple of 4 lanes "
                         "and an index aligned to 4 elements")
    out = torch.empty_like(x)
    plan = strip_plan(block_rows, x.shape[1], idx.dtype) if axis == 0 \
        else None
    if plan is not None and x.data_ptr() % 16 == 0:
        take_strip(x, idx, block_rows, *plan, out)
        return out
    _cuda.launch(
        take_kernel(axis, idx.dtype), "lux_block_take",
        _cuda.ptr(x), _cuda.ptr(idx), x.shape[0], x.shape[1],
        block_rows if axis == 0 else 1, axis, idx.element_size(),
        _cuda.ptr(out), _cuda.stream(dev),
    )
    return out


def take_strip(x, idx, block_rows: int, w: int, r: int, out) -> None:
    """Launch block_take_strip into ``out``: strips of ``w`` floats, the
    first ``r`` rows of each in shared memory (``block_take`` plans them
    with :func:`strip_plan`; the probes time other plans through here)."""
    if idx.dtype != torch.int32:
        raise ValueError("block_take_strip takes an int32 index")
    dev = x.device
    _cuda.launch(
        take_kernel(0, idx.dtype, strip=True), "lux_block_take_strip",
        _cuda.ptr(x), _cuda.ptr(idx), x.shape[0], x.shape[1], block_rows,
        w, r, _cuda.ptr(out), _cuda.stream(dev),
    )


# -- P6: the 4-candidate merge level ------------------------------------------


def _check_merge4(cand, lane, sel):
    if cand.dim() != 3 or tuple(cand.shape[1:]) != (4, 128) \
            or cand.dtype != torch.float32:
        raise ValueError(f"cand must be (R, 4, 128) f32, got {cand.dtype} "
                         f"{tuple(cand.shape)}")
    want = (cand.shape[0], 128)
    for t, name in ((lane, "l"), (sel, "s")):
        if tuple(t.shape) != want or t.dtype != torch.int32:
            raise ValueError(f"{name} must be {want} int32")


def merge4_plain(cand, lane, sel):
    """``k_merge``'s body: zeros, then each candidate's lane gather,
    masked by ``sel == k``, added in candidate order."""
    _check_merge4(cand, lane, sel)
    li = lane.long()
    acc = torch.zeros(lane.shape, dtype=torch.float32, device=cand.device)
    for k in range(4):
        g = torch.take_along_dim(cand[:, k, :], li, dim=1)
        acc = acc + torch.where(sel == k, g, 0.0)
    return acc


def merge4(cand, lane, sel):
    """``out[i, j] = cand[i, sel[i, j], lane[i, j]]`` (+0 where ``sel``
    is outside [0, 4)); cand (R, 4, 128) f32, lane and sel (R, 128)
    int32."""
    if cand.device.type == "cpu":
        return merge4_plain(cand, lane, sel)
    _check_merge4(cand, lane, sel)
    dev = cand.device
    _cuda.check(cand, "cand", torch.float32, dev, ndim=3)
    _cuda.check(lane, "l", torch.int32, dev, ndim=2)
    _cuda.check(sel, "s", torch.int32, dev, ndim=2)
    if any(t.data_ptr() % 16 for t in (cand, lane, sel)):
        raise ValueError("cand, l and s must be 16-byte aligned (the "
                         "kernel streams them 16 bytes a thread)")
    out = torch.empty(lane.shape, dtype=torch.float32, device=dev)
    _cuda.launch("merge4", "lux_merge4", _cuda.ptr(cand), _cuda.ptr(lane),
                 _cuda.ptr(sel), cand.shape[0], _cuda.ptr(out),
                 _cuda.stream(dev))
    return out


# -- P7: the 2-candidate merge level over 8-row windows ---------------------


def _check_merge_level(stream, aoff, boff, idx):
    if stream.dim() != 2 or stream.shape[1] != 128 or stream.shape[0] % 8:
        raise ValueError("stream must be (8 k, 128)")
    g = aoff.shape[0]
    if aoff.dtype != torch.int32 or boff.dtype != torch.int32 \
            or tuple(boff.shape) != (g,):
        raise ValueError("aoff and boff must be (G,) int32")
    if tuple(idx.shape) != (16 * g, 128) or idx.dtype != torch.int8:
        raise ValueError(f"idx must be ({16 * g}, 128) int8")


def merge_level_plain(stream, aoff, boff, idx):
    """The probe's ``k_merge``: the (8, 128) windows at ``aoff[g]`` and
    ``boff[g]``, each row repeated twice, lane-gathered by ``idx & 127``
    and chosen by the sign of ``idx``."""
    _check_merge_level(stream, aoff, boff, idx)
    win = stream.view(-1, 8, 128)
    g = aoff.shape[0]
    v = idx.view(g, 16, 128).long()
    lane = v & 127
    ga = torch.take_along_dim(
        win[aoff.long()].repeat_interleave(2, dim=1), lane, dim=2)
    gb = torch.take_along_dim(
        win[boff.long()].repeat_interleave(2, dim=1), lane, dim=2)
    return torch.where(v >= 0, ga, gb).view(16 * g, 128)


def expand_offsets(off):
    """The K3 input row of each output row: ``8 * off[g] + i // 2`` for
    row ``16 g + i``."""
    rep = torch.arange(16, device=off.device) // 2
    return (8 * off.long()[:, None] + rep).view(-1).to(torch.int32)


def merge_level(stream, aoff, boff, idx):
    """One 2-candidate merge level: ``(16 G, 128)`` f32 out of a
    ``(rows, 128)`` stream, ``(G,)`` int32 window offsets (in 8-row
    blocks) and a ``(16 G, 128)`` int8 code plane. On the card: K3."""
    if stream.device.type == "cpu":
        return merge_level_plain(stream, aoff, boff, idx)
    _check_merge_level(stream, aoff, boff, idx)
    return level_apply(stream, expand_offsets(aoff), expand_offsets(boff),
                       idx)


# -- timing -----------------------------------------------------------------


def mean_ms(fn, device: torch.device, reps: int = 10) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after one warm-up call:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Cycles of the spin kernel that holds the card in median_ms: about 0.5 ms
# at the H100's boost clock, longer than the host takes to enqueue a call.
HOLD_CYCLES = 1_000_000


def median_ms(fn, device: torch.device, reps: int = 100,
              hold: bool = False) -> float:
    """Median ms of ``reps`` calls of ``fn()``, each timed alone after one
    warm-up call: between its own two CUDA events on the card, by the
    host clock on the CPU. With ``hold``, a spin kernel keeps the card
    busy while the host records the first event and enqueues the call,
    so the time is the device's alone; without, the host's enqueue of
    the call counts too."""
    fn()
    times = []
    if device.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def report(name: str, ms: float, per: int, width: int = 46) -> None:
    """One probe line as the TPU probes print it: ms per call and ns per
    item."""
    print(f"{name:{width}s} {ms:8.2f} ms  ({ms * 1e6 / per:.3f} ns/item)",
          flush=True)
