"""The port's app CLIs and converter against ``lux_tpu``'s, on the CPU.

Both packages' ``main(argv)`` run in this process on the same ``.lux``
files (the graphs of ``tests/test_cli.py``, plus a weighted R-MAT for
DeltaSSSP), with ``LUX_PLATFORM=cpu``: ``lux_tpu`` on the conftest's
virtual CPU devices, the port on the kernels' plain versions. Each run
writes a ``-save`` checkpoint; the checkpoints must agree (bitwise for
the integer apps, PageRank at ``rtol=5e-5, atol=1e-9`` as in
``tests/test_tiled.py``, CF at ``rtol=1e-4, atol=1e-7`` as in
``tests/test_colfilter.py``), and so must the ``iterations =`` and
``[PASS]``/``[FAIL]`` lines.
"""

import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lux_tpu.graph import Graph, generate, write_lux
from lux_tpu.graph import format as jax_format
from lux_tpu.models import bfs as jax_bfs
from lux_tpu.models import colfilter as jax_colfilter
from lux_tpu.models import components as jax_components
from lux_tpu.models import pagerank as jax_pagerank
from lux_tpu.models import sssp as jax_sssp
from lux_tpu.models import sssp_delta as jax_sssp_delta
from lux_tpu_torch.graph import format as torch_format
from lux_tpu_torch.models import bfs as torch_bfs
from lux_tpu_torch.models import colfilter as torch_colfilter
from lux_tpu_torch.models import components as torch_components
from lux_tpu_torch.models import pagerank as torch_pagerank
from lux_tpu_torch.models import sssp as torch_sssp
from lux_tpu_torch.models import sssp_delta as torch_sssp_delta
from lux_tpu_torch.tools import converter as torch_converter
from lux_tpu_torch.utils import checkpoint

MODULES = {
    "pagerank": (jax_pagerank, torch_pagerank),
    "colfilter": (jax_colfilter, torch_colfilter),
    "sssp": (jax_sssp, torch_sssp),
    "components": (jax_components, torch_components),
    "bfs": (jax_bfs, torch_bfs),
    "sssp_delta": (jax_sssp_delta, torch_sssp_delta),
}
# app -> (graph file, argv beyond -file)
APPS = {
    "pagerank": ("g.lux", ["-ni", "5", "-check"]),
    "colfilter": ("w.lux", ["-ni", "3", "-check"]),
    "sssp": ("g.lux", ["-start", "0", "-check"]),
    "components": ("u.lux", ["-check"]),
    "bfs": ("g.lux", ["-start", "0", "-check"]),
    "sssp_delta": ("gw.lux", ["-start", "3", "-check"]),
}
# Float apps' tolerances against lux_tpu; the others are bitwise.
TOLERANCES = {
    "pagerank": dict(rtol=5e-5, atol=1e-9),
    "colfilter": dict(rtol=1e-4, atol=1e-7),
}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    g = generate.rmat(9, 8, seed=1)
    write_lux(str(d / "g.lux"), g)
    write_lux(str(d / "u.lux"), generate.undirected(g))
    write_lux(str(d / "gw.lux"), generate.rmat(9, 8, seed=1, weighted=True))
    rng = np.random.default_rng(0)
    u = rng.integers(0, 100, 800)
    i = rng.integers(100, 160, 800)
    w = rng.integers(1, 6, 800).astype(np.int32)
    gw = Graph.from_edges(np.r_[u, i], np.r_[i, u], nv=160,
                          weights=np.r_[w, w])
    write_lux(str(d / "w.lux"), gw)
    return d


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUX_PLATFORM", "cpu")
        yield


def run_main(pkg: str, app: str, argv):
    """(exit code, stdout) of ``pkg``'s (``"jax"`` or ``"torch"``)
    ``main(argv)`` for ``app``."""
    module = MODULES[app][pkg == "torch"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main([str(a) for a in argv])
    return rc, out.getvalue()


def lines(out: str, pattern: str):
    return [ln for ln in out.splitlines() if re.match(pattern, ln)]


def load_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_values(app, got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if app in TOLERANCES:
        np.testing.assert_allclose(got, want, **TOLERANCES[app])
    else:
        np.testing.assert_array_equal(got, want)


def assert_checkpoints(app, got_path, want_path):
    """Two checkpoints of one run: every field and dtype equal, values
    bitwise or within the app's tolerance."""
    got, want = load_npz(got_path), load_npz(want_path)
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "values":
            assert_values(app, got[key], want[key])
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def run_both(graphs, tmp_path, app, extra=(), file=None):
    """Both packages on ``app``'s graph with ``-save``; asserts equal
    exit codes, ``iterations`` and check lines and checkpoints, and
    returns (the port's stdout, lux_tpu's, the port's checkpoint)."""
    name, argv = APPS[app]
    argv = ["-file", graphs / (file or name), *argv, *extra]
    outs = {}
    for pkg in ("jax", "torch"):
        ck = tmp_path / f"{app}_{pkg}.npz"
        outs[pkg] = run_main(pkg, app, [*argv, "-save", ck]) + (ck,)
    (rc_j, out_j, ck_j), (rc_t, out_t, ck_t) = outs["jax"], outs["torch"]
    assert rc_t == rc_j == 0
    for pattern in (r"iterations = ", r"\[(PASS|FAIL)\]"):
        assert lines(out_t, pattern) == lines(out_j, pattern)
    assert lines(out_t, r"\[PASS\]")
    assert lines(out_t, r"ELAPSED TIME = ") and lines(out_t, r"GTEPS = ")
    assert_checkpoints(app, ck_t, ck_j)
    return out_t, out_j, ck_t


@pytest.mark.parametrize("app", sorted(APPS))
def test_app_matches_lux_tpu(graphs, tmp_path, app):
    out, out_j, ck = run_both(graphs, tmp_path, app)
    saved = load_npz(ck)
    if app in ("sssp", "components", "bfs"):
        assert saved["values"].dtype == np.uint32
    if app in ("pagerank", "colfilter"):
        assert "frontier" not in saved
    else:
        assert saved["frontier"].dtype == bool and not saved["frontier"].any()
    # The advisory lines agree but for CF, whose K-vectors lux_tpu pads
    # to 128 lanes on the device and the port does not.
    advisory = lines(out, "memory advisory")
    assert len(advisory) == 1
    if app != "colfilter":
        assert advisory == lines(out_j, "memory advisory")


@pytest.mark.parametrize("app,extra", [
    ("pagerank", ["-layout", "flat"]),
    ("pagerank", ["-parts", "4"]),
    ("pagerank", ["-layout", "flat", "-parts", "4"]),
    ("colfilter", ["-layout", "flat"]),
    ("colfilter", ["-parts", "4"]),
    ("sssp", ["-parts", "4"]),
    ("components", ["-ng", "4"]),
], ids=lambda v: "_".join(v) if isinstance(v, list) else v)
def test_layouts_and_parts_match_lux_tpu(graphs, tmp_path, app, extra):
    out, _, _ = run_both(graphs, tmp_path, app, extra)
    assert lines(out, "memory advisory")


@pytest.mark.parametrize("app", ["pagerank", "sssp", "bfs"])
def test_verbose_lines_match_lux_tpu(graphs, app):
    """-verbose prints one line an iteration; for push apps each line's
    active count and branch equal lux_tpu's. lux_tpu's GAS apps print
    none (they run the fused loop); the port's print each iteration's
    direction."""
    name, argv = APPS[app]
    argv = ["-file", graphs / name, *argv, "-verbose"]
    (rc_j, out_j), (rc_t, out_t) = (run_main(p, app, argv)
                                    for p in ("jax", "torch"))
    assert rc_t == rc_j == 0
    it_j, it_t = lines(out_j, r"iter \d+: "), lines(out_t, r"iter \d+: ")
    if app == "bfs":
        assert not it_j
        n = lines(out_j, "iterations = ")[0].split()[-1]
        assert lines(out_t, "iterations = ") == [f"iterations = {n}"]
        assert len(it_t) == int(n)
        assert all(re.search(r"accTime \d+us .*\[(push|pull)\]$", ln)
                   for ln in it_t)
        return
    assert len(it_t) == len(it_j) > 0
    if app == "sssp":
        key = re.compile(r"(iter \d+: activeNodes \d+) .* (\[\S+\])$")
        assert ([key.match(ln).groups() for ln in it_t]
                == [key.match(ln).groups() for ln in it_j])
    else:
        assert all("strips" in ln and "tail" in ln for ln in it_t)
    assert lines(out_t, r"\[PASS\]") == lines(out_j, r"\[PASS\]")


# app -> iterations of the first run (pagerank: of its 5)
RESUME_SPLIT = {"pagerank": 2, "sssp": 2, "components": 2}


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("app", sorted(RESUME_SPLIT))
def test_checkpoint_resumes_across_packages(graphs, tmp_path, app, writer):
    """A checkpoint one package writes after k iterations, resumed by
    the other, ends where the reader's uninterrupted run ends, and the
    iteration counts add up."""
    reader = "torch" if writer == "jax" else "jax"
    name, argv = APPS[app]
    argv = ["-file", graphs / name, *argv]
    k = RESUME_SPLIT[app]
    half, resumed, whole = (tmp_path / f"{s}.npz"
                            for s in ("half", "resumed", "whole"))
    # No -check on the first run: a fixpoint app has not reached it.
    first = [a for a in argv if a != "-check"]
    if app == "pagerank":
        first[first.index("-ni") + 1] = str(k)
    else:
        first += ["-ni", str(k)]
    rc, out_half = run_main(writer, app, [*first, "-save", half])
    assert rc == 0 and load_npz(half)["iteration"] == k
    rc, out_res = run_main(reader, app, [*argv, "-resume", half,
                                         "-save", resumed])
    assert rc == 0 and lines(out_res, r"\[PASS\]")
    rc, out_whole = run_main(reader, app, [*argv, "-save", whole])
    assert rc == 0
    got, want = load_npz(resumed), load_npz(whole)
    assert_values(app, got["values"], want["values"])
    assert got["iteration"] == want["iteration"]
    if app != "pagerank":
        n = lambda out: int(lines(out, "iterations = ")[0].split()[-1])
        assert k + n(out_res) == n(out_whole)
        np.testing.assert_array_equal(got["frontier"], want["frontier"])


def test_checkpoint_module_is_lux_tpus(graphs):
    """Same fingerprint, and each package loads the other's file."""
    from lux_tpu.graph import read_lux as jax_read
    from lux_tpu.utils import checkpoint as jax_checkpoint
    from lux_tpu_torch.graph import read_lux as torch_read

    path = str(graphs / "g.lux")
    jg, tg = jax_read(path), torch_read(path)
    np.testing.assert_array_equal(checkpoint.fingerprint(tg),
                                  jax_checkpoint.fingerprint(jg))
    assert checkpoint.fingerprint_hex(tg) == jax_checkpoint.fingerprint_hex(jg)
    vals = np.arange(tg.nv, dtype=np.uint32)
    fr = vals % 3 == 0
    ck = str(graphs / "cross.npz")
    checkpoint.save(ck, tg, vals, 7, frontier=fr)
    got = jax_checkpoint.load(ck, jg)
    np.testing.assert_array_equal(got[0], vals)
    assert got[1] == 7
    np.testing.assert_array_equal(got[2], fr)
    with pytest.raises(checkpoint.CheckpointError, match="different graph"):
        checkpoint.load(ck, torch_read(str(graphs / "u.lux")))
    with pytest.raises(checkpoint.CheckpointError, match="does not exist"):
        checkpoint.load(str(graphs / "missing.npz"), tg)


# -- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("app", ["bfs", "sssp_delta"])
def test_gas_resume_is_refused(graphs, tmp_path, app, capsys):
    name, argv = APPS[app]
    argv = [a for a in argv if a != "-check"]
    ck = tmp_path / "gas.npz"
    rc, _ = run_main("torch", app, ["-file", graphs / name, *argv,
                                    "-ni", "2", "-save", ck])
    assert rc == 0 and ck.exists()
    capsys.readouterr()
    rc, out = run_main("torch", app, ["-file", graphs / name, *argv,
                                      "-resume", ck])
    assert rc == 1 and "ELAPSED" not in out
    assert "holds no direction" in capsys.readouterr().err


@pytest.mark.parametrize("app,extra", [
    ("bfs", ["-parts", "4"]),
    ("sssp_delta", ["-layout", "flat"]),
    ("sssp", ["-layout", "flat"]),
    ("components", ["-layout", "tiled"]),
    ("colfilter", ["-layout", "tiled"]),
], ids=lambda v: "_".join(v) if isinstance(v, list) else v)
def test_refusals_match_lux_tpu(graphs, app, extra):
    name, argv = APPS[app]
    argv = ["-file", graphs / name, *argv, *extra]
    msgs = []
    for pkg in ("jax", "torch"):
        with pytest.raises(SystemExit) as e:
            run_main(pkg, app, argv)
        msgs.append(str(e.value.code))
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("flag", ["-profile", "-metrics", "-trace"])
def test_telemetry_flags_are_refused(graphs, tmp_path, monkeypatch, flag):
    """The telemetry flags are no longer refused (the test keeps its
    name): each runs, and the checkpoint equals the run's without it.
    ``-metrics`` writes a line whose fixed fields equal ``lux_tpu``'s
    CLI's, ``-trace`` a file ``tools/trace_summary.py`` reads, and
    ``-profile DIR`` a trace ``lux_tpu_torch.tools.prof_summary``
    parses."""
    from lux_tpu import obs as jobs
    from lux_tpu_torch import obs as tobs

    argv = ["-file", graphs / "g.lux", "-ni", "5"]
    plain = tmp_path / "plain.npz"
    run_main("torch", "pagerank", [*argv, "-save", plain])
    out = tmp_path / "out"
    # Registered first, so the environment the CLI sets is restored.
    for name in ("LUX_METRICS", "LUX_TRACE"):
        monkeypatch.setenv(name, "")
    try:
        flagged = tmp_path / "flagged.npz"
        rc, said = run_main("torch", "pagerank",
                            [*argv, flag, out, "-save", flagged])
        if flag == "-metrics":
            jout = tmp_path / "jax_out"
            run_main("jax", "pagerank", [*argv, flag, jout])
    finally:
        for name in ("LUX_METRICS", "LUX_TRACE"):
            monkeypatch.setenv(name, "")
        tobs.reconfigure()
        jobs.reconfigure()
    assert rc == 0 and "ELAPSED TIME" in said
    got, want = load_npz(flagged), load_npz(plain)
    np.testing.assert_array_equal(got["values"], want["values"])
    assert got["iteration"] == want["iteration"] == 5
    tools = Path(__file__).resolve().parent.parent / "tools"
    if flag == "-metrics":
        rec = json.loads(out.read_text().splitlines()[-1])
        jrec = json.loads(jout.read_text().splitlines()[-1])
        for key in ("schema", "engine", "program", "nv", "ne", "num_iters",
                    "exchange_bytes_per_iter", "hbm_bytes_per_iter"):
            assert rec[key] == jrec[key], key
        assert [(r["iter"], r["flush_span"], r["active_edges"])
                for r in rec["iterations"]] == \
            [(r["iter"], r["flush_span"], r["active_edges"])
             for r in jrec["iterations"]]
        assert rec["compile_s"] > 0 and rec["execute_s"] > 0
    elif flag == "-trace":
        r = subprocess.run([sys.executable, tools / "trace_summary.py", out],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        assert "tiled.flush" in r.stdout
    else:
        r = subprocess.run(
            [sys.executable, "-m", "lux_tpu_torch.tools.prof_summary", out,
             "--json"], capture_output=True, text=True,
            cwd=Path(__file__).resolve().parent.parent)
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout)["schema"] == "profile.v1"


def test_colfilter_refuses_unweighted_graph(graphs, capsys):
    argv = ["-file", graphs / "g.lux", "-ni", "2"]
    for pkg in ("jax", "torch"):
        rc, out = run_main(pkg, "colfilter", argv)
        assert rc == 1 and "ELAPSED" not in out
        assert "colfilter needs a weighted graph" in capsys.readouterr().err


@pytest.mark.parametrize("app", sorted(APPS))
def test_no_card_exits_without_cpu_fallback(graphs, monkeypatch, app):
    monkeypatch.delenv("LUX_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name, argv = APPS[app]
    with pytest.raises(SystemExit) as e:
        run_main("torch", app, ["-file", graphs / name, *argv])
    assert "no CUDA device" in str(e.value.code)
    assert "LUX_PLATFORM=cpu" in str(e.value.code)


def test_unknown_platform_is_refused(graphs, monkeypatch):
    monkeypatch.setenv("LUX_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="LUX_PLATFORM='tpu'"):
        run_main("torch", "sssp", ["-file", graphs / "g.lux"])


# -- the converter -----------------------------------------------------------


def _edge_list(path, nv, ne, weighted, seed=3):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, nv, ne), rng.integers(0, nv, ne)]
    if weighted:
        cols.append(rng.integers(1, 100, ne))
    np.savetxt(path, np.stack(cols, axis=1), fmt="%d")


@pytest.mark.parametrize("weighted", [False, True])
def test_converter_output_is_lux_tpus(tmp_path, weighted):
    nv, ne = 300, 2000
    txt = tmp_path / "edges.txt"
    _edge_list(txt, nv, ne, weighted)
    want, got = tmp_path / "jax.lux", tmp_path / "torch.lux"
    jax_format.convert_edge_list(str(txt), str(want), nv, ne,
                                 weighted=weighted)
    out = io.StringIO()
    argv = ["-nv", nv, "-ne", ne, "-input", txt, "-output", got]
    with contextlib.redirect_stdout(out):
        rc = torch_converter.main(
            [str(a) for a in argv] + (["-weighted"] if weighted else []))
    assert rc == 0
    assert got.read_bytes() == want.read_bytes()
    said = out.getvalue().splitlines()
    assert said[0] == f"nv = {nv} ne = {ne} input = {txt} output = {got}"
    assert re.fullmatch(r"converted in \d+\.\d\ds", said[1])
    g = torch_format.read_lux(str(got))
    assert (g.nv, g.ne, g.weights is not None) == (nv, ne, weighted)


@pytest.mark.parametrize("case", ["src_range", "dst_range", "short",
                                  "columns"])
def test_converter_errors_are_lux_tpus(tmp_path, case):
    nv, ne, weighted = 50, 40, False
    txt = tmp_path / "edges.txt"
    _edge_list(txt, nv, ne, weighted=False)
    data = np.loadtxt(txt, dtype=np.int64)
    if case == "src_range":
        data[5, 0] = nv
    elif case == "dst_range":
        data[7, 1] = -1
    elif case == "short":
        ne += 1
    else:
        weighted = True
    np.savetxt(txt, data, fmt="%d")
    msgs = []
    for fmt in (jax_format, torch_format):
        with pytest.raises(ValueError) as e:
            fmt.convert_edge_list(str(txt), str(tmp_path / "o.lux"), nv, ne,
                                  weighted=weighted)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
