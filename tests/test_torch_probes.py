"""Port parity: the gather probes P2-P7 against the TPU probes' Pallas
kernels.

The probe scripts under tools/ run full-size TPU probes when imported,
so this file takes their kernel bodies and ``pallas_call`` constructions
out of the source with ``ast`` and runs them with ``interpret=True`` on
the CPU, with the probes' own ``BlockSpec``s (for P7 its
``PrefetchScalarGridSpec``) at small shapes. The port's plain versions
(``lux_tpu_torch/probes/gather.py``) must equal them bitwise; P7 also
equals the probe's own numpy loop, and K3 with the expanded offsets
(P7's route on the card) equals its plain version. The kernels on the
card are tested by tests/test_torch_cuda.py.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lux_tpu_torch.ops import _cuda
from lux_tpu_torch.ops.merge_tail_kernel import level_apply
from lux_tpu_torch.probes import dgather, dgather2, merge_kernel
from lux_tpu_torch.probes import gather as pg

TOOLS = Path(__file__).resolve().parent.parent / "tools"


class _Interpret(ast.NodeTransformer):
    """Adds ``interpret=True`` to every ``pl.pallas_call(...)``."""

    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "pallas_call":
            node.keywords.append(
                ast.keyword(arg="interpret", value=ast.Constant(True)))
        return node


def _names(node):
    if isinstance(node, ast.FunctionDef):
        return {node.name}
    if isinstance(node, ast.Assign):
        return {t.id for t in node.targets if isinstance(t, ast.Name)}
    return set()


def _load(path, names, **consts):
    """The top-level functions and assignments of ``path`` named in
    ``names``, executed in a namespace holding JAX, Pallas and
    ``consts``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    body = [n for n in tree.body if _names(n) & set(names)]
    assert {k for n in body for k in _names(n)} >= set(names)
    mod = ast.fix_missing_locations(
        _Interpret().visit(ast.Module(body=body, type_ignores=[])))
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools,
              np=np, **consts)
    exec(compile(mod, str(path), "exec"), ns)
    return ns


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bitwise(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", [(8, 1, 2), (8, 0, 2), (32, 1, 2),
                                   (32, 0, 3)])
def test_p2_block_take_equals_kernel_ta(shape):
    S, axis, reps = shape
    ns = _load(TOOLS / "probe_dgather.py", ["kernel_ta", "make_ta"])
    rng = np.random.default_rng(S + axis)
    x = rng.standard_normal((reps * S, 128), dtype=np.float32)
    idx = rng.integers(0, S if axis == 0 else 128, x.shape, dtype=np.int32)
    want = ns["make_ta"](S, 128, axis, reps)(x, idx)
    _bitwise(pg.block_take(_t(x), _t(idx), axis, S), want)
    _bitwise(pg.block_take_plain(_t(x), _t(idx), axis, S), want)


def _dgather2(S=16, NB=3, R=32, RB=8):
    return _load(TOOLS / "probe_dgather2.py",
                 ["k_lane", "lane_call", "k_lane8", "lane8_call", "k_sub",
                  "sub_call", "k_merge", "merge_call"],
                 S=S, NB=NB, R=R, RB=RB)


@pytest.mark.parametrize("probe", ["lane_i32", "lane_i8", "sub_i32"])
def test_p3_p4_p5_block_take_equals_pallas(probe):
    S, NB = 16, 3
    ns = _dgather2(S, NB)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((S * NB, 128), dtype=np.float32)
    hi = 8 if probe == "sub_i32" else 128
    idx = rng.integers(0, hi, x.shape, dtype=np.int32)
    if probe == "lane_i8":
        idx = idx.astype(np.int8)
    call = {"lane_i32": "lane_call", "lane_i8": "lane8_call",
            "sub_i32": "sub_call"}[probe]
    want = ns[call](x, idx)
    axis, rows = (0, 8) if probe == "sub_i32" else (1, S)
    _bitwise(pg.block_take(_t(x), _t(idx), axis, rows), want)


def test_sublane_block_take_with_an_int8_index():
    # The fourth form, which no TPU probe ran: int8 equals int32.
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((64, 128), dtype=np.float32))
    idx = rng.integers(0, 8, (64, 128), dtype=np.int32)
    want = pg.block_take(x, _t(idx), 0, 8)
    assert torch.equal(pg.block_take(x, _t(idx.astype(np.int8)), 0, 8), want)
    assert torch.equal(want.view(8, 8, 128)[3, :, 5],
                       x.view(8, 8, 128)[3, :, 5][_t(idx).view(8, 8, 128)
                                                  [3, :, 5].long()])


@pytest.mark.parametrize("sel_hi", [4, 6])
def test_p6_merge4_equals_k_merge(sel_hi):
    R, RB = 32, 8
    ns = _dgather2(R=R, RB=RB)
    rng = np.random.default_rng(sel_hi)
    cand = rng.standard_normal((R, 4, 128), dtype=np.float32)
    lm = rng.integers(0, 128, (R, 128), dtype=np.int32)
    sm = rng.integers(0, sel_hi, (R, 128), dtype=np.int32)  # 4, 5: none
    want = ns["merge_call"](cand, lm, sm)
    _bitwise(pg.merge4(_t(cand), _t(lm), _t(sm)), want)
    inside = _t(sm) < 4
    gathered = torch.gather(_t(cand).view(R, 512), 1,
                            _t(sm).long().clamp(max=3) * 128 + _t(lm).long())
    assert torch.equal(pg.merge4(_t(cand), _t(lm), _t(sm))[inside],
                       gathered[inside])


def _merge_case(g, seed):
    rng = np.random.default_rng(seed)
    r_in = 8 * g + 8
    stream = rng.standard_normal((r_in, 128), dtype=np.float32)
    aoff = rng.integers(0, r_in // 8 - 1, g).astype(np.int32)
    boff = rng.integers(0, r_in // 8 - 1, g).astype(np.int32)
    idx = rng.integers(-128, 128, (16 * g, 128)).astype(np.int8)
    return stream, aoff, boff, idx


@pytest.mark.parametrize("g", [4, 9])
def test_p7_merge_level_equals_pallas_and_numpy(g):
    ns = _load(TOOLS / "probe_merge_kernel.py", ["k_merge", "make_merge"])
    stream, aoff, boff, idx = _merge_case(g, g)
    want = ns["make_merge"](g, stream.shape[0])(aoff, boff, stream, stream,
                                                idx)
    args = [_t(a) for a in (stream, aoff, boff, idx)]
    _bitwise(pg.merge_level(*args), want)
    _bitwise(pg.merge_level_plain(*args), want)
    _bitwise(pg.merge_level_plain(*args),
             merge_kernel.numpy_merge(stream, aoff, boff, idx))
    # P7's route on the card: K3 with one input row per output row.
    _bitwise(level_apply(args[0], pg.expand_offsets(args[1]),
                         pg.expand_offsets(args[2]), args[3]), want)


def test_p7_probe_loop_is_the_ports_numpy_loop():
    # The probe's own correctness loop, taken from its source.
    path = TOOLS / "probe_merge_kernel.py"
    tree = ast.parse(path.read_text())
    i = next(k for k, n in enumerate(tree.body)
             if isinstance(n, ast.Assign) and _names(n) == {"want"})
    assert isinstance(tree.body[i + 1], ast.For)
    stream, aoff, boff, idx = _merge_case(4, 0)
    got = merge_kernel.numpy_merge(stream, aoff, boff, idx)
    ns = dict(np=np, got=got, stream=stream, aoff=aoff, boff=boff, idx=idx,
              G=4)
    exec(compile(ast.Module(body=tree.body[i:i + 2], type_ignores=[]),
                 str(path), "exec"), ns)
    _bitwise(_t(got), ns["want"])


def test_expand_offsets():
    off = torch.tensor([0, 3], dtype=torch.int32)
    got = pg.expand_offsets(off)
    assert got.dtype == torch.int32
    assert got.tolist() == [i // 2 for i in range(16)] + \
        [24 + i // 2 for i in range(16)]


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(16, 128)
    with pytest.raises(ValueError, match="idx"):
        pg.block_take(x, torch.zeros(16, 128, dtype=torch.int64), 1, 8)
    with pytest.raises(ValueError, match="blocks"):
        pg.block_take(x, torch.zeros(16, 128, dtype=torch.int32), 0, 5)
    with pytest.raises(ValueError, match="axis"):
        pg.block_take(x, torch.zeros(16, 128, dtype=torch.int32), 2, 8)
    with pytest.raises(ValueError, match="cand"):
        pg.merge4(torch.zeros(4, 3, 128),
                  torch.zeros(4, 128, dtype=torch.int32),
                  torch.zeros(4, 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="int8"):
        pg.merge_level(x, torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32),
                       torch.zeros(16, 128, dtype=torch.int32))
    assert pg.take_kernel(0, torch.int8) == "block_take[axis=0 int8]"


def test_strip_route_by_block_shape():
    """Axis 0 with an int32 index over blocks of STRIP_MIN_ROWS rows or
    more takes the strip kernel, the widest strip whose rows fit in
    STRIP_SMEM, else 8 floats with STRIP_ROWS rows in shared memory; the
    probes' 8-row blocks, P5's and any int8 index keep the row kernel. On
    the CPU both are the plain version."""
    assert pg.strip_plan(8, 128) is None
    assert pg.strip_plan(pg.STRIP_MIN_ROWS - 1, 128) is None
    assert pg.strip_plan(512, 128) == (32, 512)
    assert pg.strip_plan(1024, 128) == (32, 1024)
    assert pg.strip_plan(2048, 128) == (16, 2048)
    assert pg.strip_plan(4096, 128) == (8, 4096)
    assert pg.strip_plan(8192, 128) == (8, pg.STRIP_ROWS)
    assert pg.strip_plan(5000, 128) == (8, 5000)
    assert pg.strip_plan(512, 24) == (8, 512)
    assert pg.strip_plan(512, 12) is None
    assert pg.strip_plan(4096, 128, torch.int8) is None
    assert pg.take_kernel(0, torch.int32, strip=True) == \
        "block_take_strip[axis=0 int32]"
    assert "block_take_strip[axis=0 int32]" in _cuda.LAUNCHES
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1024, 128), dtype=np.float32))
    idx = torch.from_numpy(rng.integers(0, 512, (1024, 128), dtype=np.int32))
    _cuda.reset_launches()
    assert torch.equal(pg.block_take(x, idx, 0, 512),
                       pg.block_take_plain(x, idx, 0, 512))
    assert not any(_cuda.LAUNCHES.values())
    with pytest.raises(ValueError, match="int32"):
        pg.take_strip(x, idx.to(torch.int8), 512, 8, 512, torch.empty_like(x))


@pytest.mark.parametrize("probe", ["dgather", "dgather2", "merge_kernel"])
def test_probe_runs_on_the_cpu(probe, monkeypatch, capsys):
    # The probes' entry points at small shapes, on the plain versions.
    if probe == "dgather":
        monkeypatch.setattr(dgather, "SHAPES", ((8, 128, 1, 2),
                                                (16, 128, 0, 2)))
        dgather.main([], device="cpu")
        want = ["ta axis=1 (8,128)x2", "ta axis=0 (16,128)x2"]
    elif probe == "dgather2":
        for name, v in (("S", 16), ("NB", 2), ("R", 16), ("TABLE_ROWS", 256),
                        ("TR", 100)):
            monkeypatch.setattr(dgather2, name, v)
        dgather2.main([], device="cpu")
        want = ["lane-gather 33.5M i32", "lane-gather 33.5M i8-idx",
                "sublane-gather(8) 33.5M", "sublane-gather(8) 33.5M i8-idx",
                "merge-level", "row-gather 300K from 150MB",
                "row-gather 300K segmented(4x)"]
    else:
        monkeypatch.setattr(merge_kernel, "G_RATE", 8)
        merge_kernel.main(device="cpu")
        want = ["merge kernel CORRECT on tiny case"] + ["ns/slot"] * 3
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(want)
    for line, w in zip(lines, want):
        assert w in line
        assert "ms" in line or "CORRECT" in line


def test_segmented_row_sum_equals_the_whole_gather():
    rng = np.random.default_rng(3)
    table = _t(rng.integers(0, 9, (64, 128)).astype(np.float32))
    ridx = _t(rng.integers(0, 64, 50))
    assert torch.equal(dgather2.segmented_row_sum(table, ridx),
                       table[ridx].sum(0))
