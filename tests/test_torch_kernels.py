"""Port parity: the plain versions of kernels K1–K4 against lux_tpu.

On the CPU each kernel wrapper runs its plain PyTorch version; these
tests hold those against the JAX package's functions on the same plans
(bitwise on integral values, whose per-row totals stay below 2^24 so
every f32 sum is exact in any order; rtol=5e-5, atol=1e-9 on floats;
the grouped-tail level always bitwise). They also check that K1's cell
streams give back the plan's strips, and, in numpy, the work items the
CUDA kernels walk. The kernels themselves are tested on the card by
tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lux_tpu.graph import generate as jgen
from lux_tpu.ops import merge_tail_kernel as jmtk
from lux_tpu.ops import merge_tail_plan as jmtp
from lux_tpu.ops import tiled_spmv as jts
from lux_tpu_torch import convert
from lux_tpu_torch.ops import _cuda
from lux_tpu_torch.ops import merge_tail_kernel as tmtk
from lux_tpu_torch.ops import merge_tail_plan as tmtp
from lux_tpu_torch.ops import segment as tseg
from lux_tpu_torch.ops import tiled_spmv as tts

RTOL, ATOL = 5e-5, 1e-9
CPU = torch.device("cpu")

PLANS = {
    "r8": (lambda: jgen.rmat(10, 14, seed=3), ((8, 2),)),
    "cascade": (lambda: jgen.rmat(10, 14, seed=3), ((128, 8), (8, 2))),
    "r2_r32": (lambda: jgen.rmat(9, 8, seed=1), ((32, 4), (2, 2))),
    "empty_level": (lambda: jgen.rmat(9, 8, seed=5), ((8, 10 ** 9),)),
    "zero_tail": (lambda: jgen.cycle_graph(100), ((8, 1),)),
    # A legacy plan: counts up to 127 in a cell (parallel edges below).
    "legacy_cap": (lambda: _multigraph(), ((8, 1),), 127),
}


def _multigraph():
    """An R-MAT with every edge repeated up to 40 times, so cells hold
    counts above the default cap of 15."""
    g = jgen.rmat(8, 8, seed=2)
    reps = np.random.default_rng(0).integers(1, 41, size=g.ne)
    dst = np.repeat(np.repeat(np.arange(g.nv), np.diff(g.row_ptr)), reps)
    row_ptr = np.zeros(g.nv + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=g.nv), out=row_ptr[1:])
    return type(g)(nv=g.nv, ne=int(reps.sum()), row_ptr=row_ptr,
                   col_src=np.repeat(g.col_src, reps))


def _plans(name):
    make, levels, *cap = PLANS[name]
    jplan = jts.plan_hybrid(make(), levels=levels, cap=(cap or [15])[0])
    tplan = convert.plan_from_numpy(convert.plan_to_numpy(jplan))
    jdh = jts.DeviceHybrid.build(jplan, chunk_strips=16, chunk_tail=64)
    tdh = tts.DeviceHybrid.build(tplan, CPU)
    return jplan, jdh, tdh


def _operands(nvb, seed):
    rng = np.random.default_rng(seed)
    x_int = rng.integers(0, 8, size=(nvb, 128)).astype(np.float32)
    x_float = rng.random((nvb, 128), dtype=np.float32) + np.float32(0.5)
    return x_int, x_float


def _compare(got, want, exact):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _jax_hybrid(jplan, jdh, x):
    """lux_tpu's per-level strip sums and tail sums, one jitted call."""
    nrbs = [jplan.nvb * (128 // lev.r) for lev in jplan.levels]

    def f(x, dh):
        return ([jts.strip_level_spmv(x, lev, n)
                 for lev, n in zip(dh.levels, nrbs)], jts.tail_sum(x, dh))

    return jax.jit(f)(jnp.asarray(x), jdh)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_strip_and_tail_plain_match_jax(name):
    jplan, jdh, tdh = _plans(name)
    for x, exact in zip(_operands(jplan.nvb, 1), (True, False)):
        jlevels, jtail = _jax_hybrid(jplan, jdh, x)
        tx = torch.from_numpy(x)
        for want, tl in zip(jlevels, tdh.levels):
            _compare(tts.strip_level_spmv(tx, tl), want, exact)
        _compare(tts.tail_sum(tx, tdh), jtail, exact)
        strips = np.zeros(jplan.nvb * 128, np.float32)
        for want in jlevels:
            strips = strips + np.asarray(want)
        _compare(tts.strips_sum(tx, tdh, jplan.nv), strips[: jplan.nv], exact)
        vals = x.reshape(-1)[: jplan.nv].copy()
        got = tts.hybrid_spmv(torch.from_numpy(vals), tdh)
        if exact:
            x0 = np.zeros_like(x).reshape(-1)
            x0[: jplan.nv] = vals
            jl0, jt0 = _jax_hybrid(jplan, jdh, x0.reshape(x.shape))
            want = sum(np.asarray(w) for w in jl0)[: jplan.nv] + np.asarray(jt0)
            _compare(got, np.asarray(want, np.float32), True)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_tail_stream_is_the_plan_tail(name):
    # The card holds the tail as one int32 stream, (sb << 7) | lane of
    # lux_tpu's plan, padded with zeros to a multiple of 4; every source
    # of the stream and of the cells is below src_end <= nv.
    jplan, _, tdh = _plans(name)
    m = jplan.tail_sb.shape[0]
    src = tdh.tail_src.numpy()
    assert src.dtype == np.int32 and src.shape[0] == m + (-m % 4)
    want = (np.asarray(jplan.tail_sb, np.int32) << 7) \
        | np.asarray(jplan.tail_lane, np.int32)
    np.testing.assert_array_equal(src[:m], want)
    assert not src[m:].any()
    np.testing.assert_array_equal(tdh.tail_row_ptr.numpy(),
                                  np.asarray(jplan.tail_row_ptr))
    ends = [int(src[:m].max(initial=-1)) + 1] + [
        int(lev.src[:lev.n_cells].max()) + 1 if lev.n_cells else 0
        for lev in tdh.levels]
    assert tdh.src_end == max(ends) <= jplan.nv
    assert [lev.src_end for lev in tdh.levels] == ends[1:]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_tail_plain_from_flat_values_adds_into_the_strips(name):
    # K2's plain version over the tail stream, reading the (nv,) values
    # as the executor hands them and adding into the strips' sums, equals
    # lux_tpu's strip and tail sums of the zero-padded operand.
    jplan, jdh, tdh = _plans(name)
    x = _operands(jplan.nvb, 6)[0]
    vals = x.reshape(-1)[: jplan.nv].copy()
    x0 = np.zeros_like(x).reshape(-1)
    x0[: jplan.nv] = vals
    jlevels, jtail = _jax_hybrid(jplan, jdh, x0.reshape(x.shape))
    tv = torch.from_numpy(vals)
    _compare(tts.tail_sum(tv, tdh), jtail, True)
    strips = sum(np.asarray(w) for w in jlevels) if jlevels else \
        np.zeros(jplan.nvb * 128, np.float32)
    acc = tts.strips_sum(tv, tdh, jplan.nv)
    _compare(acc, np.asarray(strips)[: jplan.nv], True)
    got = tts.tail_sum(tv, tdh, out=acc)
    assert got is acc
    _compare(got, np.asarray(strips)[: jplan.nv] + np.asarray(jtail), True)
    with pytest.raises(ValueError, match="sources"):
        tts.tail_sum(tv[: tdh.src_end - 1], tdh)


def _lower_bound_warp(rp, n, target):
    """csrc/segment_sum.cu's lower_bound_warp in numpy: the first row i in
    [0, n] at merge-path position rp[i] + i >= target, narrowed by 32
    probes a step as the warp does."""
    pos = lambda i: int(rp[i]) + i
    lo, hi = 0, n
    while hi - lo > 32:
        probes = [lo + (hi - lo) * (lane + 1) // 33 for lane in range(32)]
        k = sum(pos(p) < target for p in probes)
        if k > 0:
            lo = probes[k - 1] + 1
        if k < 32:
            hi = probes[k]
    return lo + sum(1 for p in range(lo, lo + 32) if p < hi
                    and pos(p) < target)


@pytest.mark.parametrize("shape", ["skewed", "hub", "trailing_empty",
                                   "no_edges"])
def test_tail_kernel_blocks_own_every_row_once(shape):
    # K2's blocks own the rows at merge-path positions rp[r] + r in
    # [b * P, (b + 1) * P), each found by the warp-wide search; with the
    # launch's (m4 + rows) // P + 1 blocks every row has one owner, and a
    # block owns at most P rows whose edges start in its stretch.
    rng = np.random.default_rng(len(shape))
    lens = rng.integers(0, 9, 3000)
    if shape == "hub":
        lens[5] = 100_000
    elif shape == "trailing_empty":
        lens[1000:] = 0
    elif shape == "no_edges":
        lens[:] = 0
    rp = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n, m = rp.shape[0] - 1, int(rp[-1])
    pos = rp[:-1] + np.arange(n)
    for target in list(range(0, 200)) + list(rng.integers(0, m + n + 50, 300)):
        assert _lower_bound_warp(rp, n, int(target)) == \
            np.searchsorted(pos, target, side="left")
    m4 = m + (-m % 4)
    p_items = 256
    owner = np.full(n, -1)
    for b in range((m4 + n) // p_items + 1):
        r0 = _lower_bound_warp(rp, n, b * p_items)
        r1 = _lower_bound_warp(rp, n, (b + 1) * p_items)
        assert np.all(owner[r0:r1] == -1)
        owner[r0:r1] = b
        assert r1 - r0 <= p_items
        if r1 > r0:
            assert b * p_items <= pos[r0] <= pos[r1 - 1] < (b + 1) * p_items
    assert np.all(owner >= 0)


def _grouped(seed, nsb=48, nv=700, m=15000):
    rng = np.random.default_rng(seed)
    sb = rng.integers(0, nsb, size=m)
    lane = rng.integers(0, 128, size=m)
    dst = np.sort(rng.integers(0, nv, size=m))
    row_ptr = np.searchsorted(dst, np.arange(nv + 1))
    jg = jmtp.plan_grouped_tail(sb, lane, row_ptr)
    tg = tmtp.plan_grouped_tail(sb, lane, row_ptr)
    return jg, tg, rng


@pytest.mark.parametrize("m", [15000, 700, 0])
def test_level_apply_ref_bitwise_matches_jax(m):
    jg, tg, rng = _grouped(4, m=m)
    jgt = jmtk.DeviceGroupedTail.build(jg)
    tgt = tmtk.DeviceGroupedTail.build(tg, CPU)
    x = rng.standard_normal((48, 128)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for k in range(tgt.n_levels + 1):
        jx = jmtk.level_apply_ref(jx, jgt.arow[k], jgt.brow[k], jgt.codes[k])
        tx = tmtk.level_apply(tx, tgt.arow[k], tgt.brow[k], tgt.codes[k])
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    # Root reduction (K4): bitwise against lux_tpu on integral streams.
    # On floats lux_tpu's f32 cumsum-diff drifts by ~1e-4 relative on a
    # stream this long, so the float reference is an f64 oracle.
    root_i = rng.integers(-40, 40, size=tx.shape).astype(np.float32)
    want = jmtk.root_reduce(jnp.asarray(root_i), jgt.nvalid_root,
                            jgt.dst_row_ptr)
    got = tmtk.root_reduce(torch.from_numpy(root_i), tgt.nvalid_root,
                           tgt.dst_row_ptr)
    _compare(got, want, True)
    root_f = rng.random(tx.shape, dtype=np.float32)
    got = tmtk.root_reduce(torch.from_numpy(root_f), tgt.nvalid_root,
                           tgt.dst_row_ptr)
    _compare(got, _root_oracle(root_f, tg), False)


def _root_oracle(root, plan):
    """f64 per-destination sums of a root stream's live lanes."""
    nvalid = plan.level(plan.n_levels)[3]
    live = np.arange(128)[None, :] < nvalid[:, None]
    flat = np.where(live, root.astype(np.float64), 0.0).reshape(-1)
    z = np.concatenate([[0.0], np.cumsum(flat)])
    ptr = np.asarray(plan.dst_row_ptr)
    return (z[ptr[1:]] - z[ptr[:-1]]).astype(np.float32)


def test_empty_level_returns_empty_stream_without_launch():
    before = dict(_cuda.LAUNCHES)
    x = torch.ones((3, 128))
    out = tmtk.level_apply(x, torch.zeros(0, dtype=torch.int32),
                           torch.zeros(0, dtype=torch.int32),
                           torch.zeros((0, 128), dtype=torch.int8))
    assert out.shape == (0, 128) and out.dtype == torch.float32
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("name", ["r8", "cascade"])
def test_grouped_tail_sums_match_jax_and_lane_select(name):
    jplan, jdh, tdh = _plans(name)
    tail = (jplan.tail_sb, jplan.tail_lane, jplan.tail_row_ptr)
    jgt = jmtk.DeviceGroupedTail.build(jmtp.plan_grouped_tail(*tail))
    tgt = tmtk.DeviceGroupedTail.build(tmtp.plan_grouped_tail(*tail), CPU)
    x_int, x_float = _operands(jplan.nvb, 3)
    for x, exact in ((x_int, True), (x_float, False)):
        got = tmtk.grouped_tail_sums(torch.from_numpy(x), tgt)
        _compare(got, jmtk.grouped_tail_sums(jnp.asarray(x), jgt), exact)
        _compare(got, tts.tail_sum(torch.from_numpy(x), tdh), exact)


@pytest.mark.parametrize("name", ["r8", "cascade"])
def test_grouped_tail_adds_into_the_strips_sums(name):
    # K4 adds its row sums into the strips' sums (``out``): the same f32
    # add per row as lux_tpu's ``strips_sum + grouped_tail_sums``, so
    # equal bitwise to the sum of the two, and hybrid_spmv equals
    # lux_tpu's on integral values.
    jplan, jdh, tdh = _plans(name)
    tail = (jplan.tail_sb, jplan.tail_lane, jplan.tail_row_ptr)
    jgt = jmtk.DeviceGroupedTail.build(jmtp.plan_grouped_tail(*tail))
    tgt = tmtk.DeviceGroupedTail.build(tmtp.plan_grouped_tail(*tail), CPU)
    x_int, x_float = _operands(jplan.nvb, 5)
    nv = jplan.nv
    for x, exact in ((x_int, True), (x_float, False)):
        tx = torch.from_numpy(x)
        acc_s = tts.strips_sum(tx, tdh, nv)
        want = acc_s + tmtk.grouped_tail_sums(tx, tgt)
        out = acc_s.clone()
        got = tmtk.grouped_tail_sums(tx, tgt, out=out)
        assert got is out
        assert torch.equal(got, want)
        vals = tx.reshape(-1)[:nv].contiguous()
        _compare(tts.hybrid_spmv(vals, tdh, tgt),
                 jts.hybrid_spmv(jnp.asarray(vals.numpy()), jdh, jgt),
                 exact)


def _emulate_items(values, row_ptr, item_len):
    """The CUDA two-pass segmented sum, in numpy: per-item sums, then each
    row's item sums in item order (float64, so any order is exact for
    the integers used here)."""
    item_lo, row_items = tseg.segment_items(row_ptr, item_len)
    n_items = item_lo.shape[0] - 1
    assert row_items[-1] == n_items
    assert np.all(np.diff(item_lo) >= 1) and np.all(np.diff(item_lo) <= item_len)
    owner = np.repeat(np.arange(row_ptr.shape[0] - 1), np.diff(row_items))
    # Each item lies inside its row.
    assert np.all(item_lo[:-1] >= row_ptr[owner])
    assert np.all(item_lo[1:] <= row_ptr[owner + 1])
    partial = np.array([values[item_lo[j]:item_lo[j + 1]].sum(axis=0)
                        for j in range(n_items)]).reshape(
        (n_items,) + values.shape[1:])
    out = np.zeros((row_ptr.shape[0] - 1,) + values.shape[1:])
    for v in range(out.shape[0]):
        out[v] = partial[row_items[v]:row_items[v + 1]].sum(axis=0)
    return out


@pytest.mark.parametrize("item_len", [1, 3, 64])
@pytest.mark.parametrize("kind", ["skewed", "empty_rows", "no_elements"])
def test_segment_items_tile_rows(item_len, kind):
    rng = np.random.default_rng(item_len)
    if kind == "no_elements":
        lens = np.zeros(9, np.int64)
    else:
        lens = rng.integers(0, 5, size=60)
        lens[7] = 500                           # a hub row
        if kind == "empty_rows":
            lens[::3] = 0
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    values = rng.integers(0, 100, size=int(row_ptr[-1])).astype(np.float64)
    got = _emulate_items(values, row_ptr, item_len)
    want = np.array([values[a:b].sum() for a, b in
                     zip(row_ptr[:-1], row_ptr[1:])])
    np.testing.assert_array_equal(got, want)


def _emulate_cells(lev, x, item_len):
    """K1's two passes over a level's cell stream, in numpy, as
    csrc/strip_spmv.cu runs them: G threads per item, each taking the
    stream-aligned quads q0 + sub, q0 + sub + G, ... of its item and
    masking the cells outside it; then each row's items in order. Also
    checks that every cell is read exactly once (float64, so any order
    is exact for the integers used here)."""
    group = tts.CELL_GROUP
    src, cnt = lev.src.numpy(), lev.cnt.numpy().astype(np.float64)
    xf = x.reshape(-1).astype(np.float64)
    item_lo = lev.items.item_lo.numpy()
    row_items = lev.items.row_items.numpy()
    seen = np.zeros(src.shape[0], np.int64)
    partial = np.zeros(item_lo.shape[0] - 1)
    for j in range(partial.shape[0]):
        lo, hi = item_lo[j], item_lo[j + 1]
        assert 1 <= hi - lo <= item_len
        for sub in range(group):
            for q in range((lo >> 2) + sub, -(-hi // 4), group):
                e = np.arange(4 * q, 4 * q + 4)
                e = e[(e >= lo) & (e < hi)]
                partial[j] += (cnt[e] * xf[src[e]]).sum()
                seen[e] += 1
    assert np.all(seen[:lev.n_cells] == 1) and not seen[lev.n_cells:].any()
    return np.array([partial[a:b].sum() for a, b in
                     zip(row_items[:-1], row_items[1:])])


def test_strip_items_follow_the_strip_row_pointer():
    # The K1 work items of a real level's cell stream, emulated in numpy,
    # give the plain version's per-row sums: at the kernel's item length,
    # and at a short one that cuts rows into many items.
    jplan, _, tdh = _plans("cascade")
    x = _operands(jplan.nvb, 5)[0]
    for lev in tdh.levels:
        row_ptr = lev.row_ptr.numpy()
        want = tts.strip_level_spmv(torch.from_numpy(x), lev).numpy()
        np.testing.assert_array_equal(lev.items.item_lo.numpy(),
                                      tseg.segment_items(
                                          row_ptr, tts.CELL_ITEM)[0])
        for item in (tts.CELL_ITEM, 5):
            cut = dataclasses.replace(lev, items=tseg.SegmentItems.build(
                row_ptr, item, CPU))
            np.testing.assert_array_equal(_emulate_cells(cut, x, item), want)


def _level_strips(lev, strip_rows, strip_cols):
    """The (T, r, 128) int8 strips whose cells ``lev`` holds, given the
    strips' destination strip-rows and source blocks: the cell build
    inverted."""
    r, n = lev.r, lev.n_cells
    row = torch.repeat_interleave(torch.arange(lev.nrows),
                                  lev.row_ptr.diff()) + lev.row0
    src = lev.src[:n].long()
    nvb = lev.height // 128
    sid = torch.from_numpy(np.asarray(strip_rows, np.int64) * nvb
                           + np.asarray(strip_cols, np.int64))
    t = torch.searchsorted(sid, (row // r) * nvb + src // 128)
    strips = torch.zeros((sid.shape[0], r, 128), dtype=torch.int8)
    strips[t, row % r, src % 128] = lev.cnt[:n]
    return strips


@pytest.mark.parametrize("name", sorted(PLANS))
def test_cell_stream_round_trips_to_the_plan_strips(name):
    jplan, _, tdh = _plans(name)
    assert len(tdh.levels) == len(jplan.levels)
    for jl, tl in zip(jplan.levels, tdh.levels):
        n = tl.n_cells
        assert n == np.count_nonzero(jl.strips)
        assert tl.src.dtype == torch.int32 and tl.cnt.dtype == torch.int8
        assert tl.src.shape[0] == tl.cnt.shape[0] == n + (-n % 4)
        assert not tl.src[n:].any() and not tl.cnt[n:].any()
        assert (tl.row0, tl.nrows, tl.height) == (0, jplan.nvb * 128,
                                                  jplan.nvb * 128)
        assert int(tl.row_ptr[-1]) == n
        assert bool((tl.cnt[:n] > 0).all())
        assert int(tl.cnt[:n].numpy().max(initial=0)) <= jplan.cap
        # Destination-major, and strip then lane order inside a row.
        row = np.repeat(np.arange(tl.nrows), np.diff(tl.row_ptr.numpy()))
        key = row.astype(np.int64) * (jplan.nvb * 128) + tl.src[:n].numpy()
        assert np.all(np.diff(key) > 0)
        strips = _level_strips(tl, jl.rows, jl.cols)
        np.testing.assert_array_equal(strips.numpy(), jl.strips)
    if name == "legacy_cap":
        assert jplan.cap == 127
        assert int(tdh.levels[0].cnt.max()) > 15


def test_cell_build_in_steps_equals_one_step(monkeypatch):
    # Steps of a few strips, each extended to the end of its strip-row,
    # give the same stream as one step.
    jplan, _, whole = _plans("cascade")
    tplan = convert.plan_from_numpy(convert.plan_to_numpy(jplan))
    monkeypatch.setattr(tts, "_BUILD_CHUNK", 3)
    for lev, want in zip(tplan.levels, whole.levels):
        got = tts.build_level(lev, tplan.nvb, CPU)
        for field in ("src", "cnt", "row_ptr"):
            assert torch.equal(getattr(got, field), getattr(want, field))
        assert got.n_cells == want.n_cells


def test_level_band_adds_into_out():
    # A run of strips as a band of rows, added into a full-height vector,
    # equals the whole level's rows of that band.
    jplan, _, tdh = _plans("r8")
    tplan = convert.plan_from_numpy(convert.plan_to_numpy(jplan))
    lev = tplan.levels[0]
    n = lev.rows.shape[0]
    x = torch.from_numpy(_operands(jplan.nvb, 8)[0])
    whole = tts.strip_level_spmv(x, tdh.levels[0])
    out = torch.full((jplan.nvb * 128,), 2.0)
    for lo, hi in ((0, n // 3), (n // 3, n)):
        band = tts.build_level(lev, tplan.nvb, CPU, lo, hi, band=True)
        assert band.row0 == int(lev.rows[lo]) * 8
        assert band.nrows == (int(lev.rows[hi - 1]) + 1) * 8 - band.row0
        assert tts.strip_level_spmv(x, band, out) is out
        alone = tts.strip_level_spmv(x, band)
        assert not alone[:band.row0].any()
        assert not alone[band.row0 + band.nrows:].any()
    np.testing.assert_array_equal(out.numpy(), whole.numpy() + 2.0)


def test_wrappers_refuse_other_devices():
    # Off the CPU a wrapper launches its kernel or raises: no fallback.
    meta = torch.device("meta")
    x = torch.empty((2, 128), device=meta)
    rows = torch.empty(4, dtype=torch.int32, device=meta)
    codes = torch.empty((4, 128), dtype=torch.int8, device=meta)
    with pytest.raises(ValueError):
        tmtk.level_apply(x, rows, rows, codes)
    with pytest.raises(ValueError):
        tseg.segment_sum_by_rowptr(x, torch.empty(3, dtype=torch.int64,
                                                  device=meta))
