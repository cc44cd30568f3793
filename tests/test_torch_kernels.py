"""Port parity: the plain versions of kernels K1–K4 against lux_tpu.

On the CPU each kernel wrapper runs its plain PyTorch version; these
tests hold those against the JAX package's functions on the same plans
(bitwise on integral values, whose per-row totals stay below 2^24 so
every f32 sum is exact in any order; rtol=5e-5, atol=1e-9 on floats;
the grouped-tail level always bitwise). They also check, in numpy, the
work-item tables the CUDA kernels walk. The kernels themselves are
tested on the card by tests/test_torch_cuda.py.
"""

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
}


def _plans(name):
    make, levels = PLANS[name]
    jplan = jts.plan_hybrid(make(), levels=levels)
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
                           tgt.dst_row_ptr, tgt.dst_items)
    _compare(got, want, True)
    root_f = rng.random(tx.shape, dtype=np.float32)
    got = tmtk.root_reduce(torch.from_numpy(root_f), tgt.nvalid_root,
                           tgt.dst_row_ptr, tgt.dst_items)
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


def test_strip_items_follow_the_strip_row_pointer():
    # The K1 work items of a real level, emulated in numpy, give the plain
    # version's per-row sums.
    jplan, _, tdh = _plans("cascade")
    x = _operands(jplan.nvb, 5)[0]
    for lev in tdh.levels:
        contrib = (lev.strips.numpy().astype(np.float64)
                   * x[lev.cols.numpy()][:, None, :]).sum(-1)
        row_ptr = lev.row_ptr.numpy()
        got = _emulate_items(contrib, row_ptr, tts.STRIP_ITEM).reshape(-1)
        np.testing.assert_array_equal(
            got, tts.strip_level_spmv(torch.from_numpy(x), lev).numpy())
        np.testing.assert_array_equal(lev.items.item_lo.numpy(),
                                      tseg.segment_items(
                                          row_ptr, tts.STRIP_ITEM)[0])


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
