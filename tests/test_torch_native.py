"""Port parity: the native C++ loader, converter and CSR build
(``lux_tpu_torch/native``, ``Graph._csr_native``).

The counterparts of tests/test_native.py on the port (native against
the numpy paths, the converter's bad ids, a truncated file), and the
port held against ``lux_tpu``: reads, converter output and CSRs byte for
byte against ``lux_tpu``'s native paths and the port's numpy ones, the
fallback with the compiler made unavailable giving the same bytes, the
64-bit ctypes widths, the build directory keyed by the source, and the
callers (the CLIs' ``load_graph``, a session's graph path, the converter
CLI) going through the native paths.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from lux_tpu.graph import generate as jgen
from lux_tpu.graph import write_lux as jwrite_lux
from lux_tpu.native import io as jnio
from lux_tpu_torch.graph import Graph, generate, write_lux
from lux_tpu_torch.graph import format as lux_format
from lux_tpu_torch.native import build
from lux_tpu_torch.native import io as nio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def lib():
    """The native library, built on first use (decided here, in a test,
    never while the module is imported)."""
    try:
        return build.load_library()
    except Exception as e:
        pytest.skip(f"native toolchain unavailable: {e!r}")


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """A process whose native build fails: no library in a fresh build
    directory and a compiler that does not exist."""
    monkeypatch.setenv("LUX_NATIVE_CACHE", str(tmp_path / "native"))
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "_FAILED", None)
    monkeypatch.setattr(build, "_WARNED", False)
    yield
    build._LIB = None
    build._FAILED = None


def _same_graph(a, b):
    assert (a.nv, a.ne) == (b.nv, b.ne)
    for x, y in ((a.row_ptr, b.row_ptr), (a.col_src, b.col_src)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert (a.weights is None) == (b.weights is None)
    if a.weights is not None:
        assert a.weights.dtype == b.weights.dtype
        assert a.weights.tobytes() == b.weights.tobytes()


def _same_csr(a, b):
    for x, y in ((a.row_ptr, b.row_ptr), (a.col_dst, b.col_dst)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert (a.weights is None) == (b.weights is None)
    if a.weights is not None:
        assert a.weights.tobytes() == b.weights.tobytes()


def _edge_file(path, seed=5, ne=500, nv=64, weighted=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, ne)
    dst = rng.integers(0, nv, ne)
    w = rng.integers(-3, 100, ne)
    cols = (src, dst, w) if weighted else (src, dst)
    path.write_text("".join(" ".join(str(int(c)) for c in row) + "\n"
                            for row in zip(*cols)))
    return src, dst, w


# -- tests/test_native.py on the port --------------------------------------


def test_native_load_matches_python(lib, tmp_path):
    g = generate.rmat(10, 8, seed=3, weighted=True)
    p = str(tmp_path / "g.lux")
    write_lux(p, g)
    g2 = nio.read_lux(p)
    np.testing.assert_array_equal(g.row_ptr, g2.row_ptr)
    np.testing.assert_array_equal(g.col_src, g2.col_src)
    np.testing.assert_array_equal(g.weights, g2.weights)
    g3 = lux_format.read_lux(p)
    np.testing.assert_array_equal(g2.col_src, g3.col_src)


def test_native_convert_matches_python(lib, tmp_path):
    nv, ne = 64, 500
    el = tmp_path / "edges.txt"
    src, dst, w = _edge_file(el)
    out_native = str(tmp_path / "n.lux")
    nio.convert_edge_list(str(el), out_native, nv, ne, weighted=True)
    want = Graph.from_edges(src, dst, nv=nv, weights=w.astype(np.int32))
    got = lux_format.read_lux(out_native)
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.col_src, want.col_src)
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_array_equal(got.out_degrees, want.out_degrees)


def test_native_convert_rejects_bad_ids(lib, tmp_path):
    el = tmp_path / "bad.txt"
    el.write_text("0 1\n5 2\n")  # 5 >= nv
    rc = lib.lux_convert_edge_list(
        str(el).encode(), str(tmp_path / "x.lux").encode(), 4, 2, 0
    )
    assert rc == -2


def test_native_csr_matches_numpy(lib):
    g = generate.rmat(9, 8, seed=7, weighted=True)
    native = g._csr_native()
    assert native is not None
    _same_csr(native, g._csr_numpy())


def test_native_load_detects_size_mismatch(lib, tmp_path):
    p = tmp_path / "trunc.lux"
    g = generate.gnp(50, 200, seed=1)
    write_lux(str(p), g, include_degrees=False)
    p.write_bytes(p.read_bytes()[:-100])
    row_ends = np.zeros(50, np.int64)
    cols = np.zeros(200, np.int32)
    rc = lib.lux_load(
        str(p).encode(),
        ctypes.c_uint32(50),
        ctypes.c_uint64(200),
        ctypes.c_void_p(row_ends.ctypes.data),
        ctypes.c_void_p(cols.ctypes.data),
        None,
    )
    assert rc == -3
    # The reader falls back to numpy, which refuses the file too.
    with pytest.raises(Exception):
        nio.read_lux(str(p))


# -- against lux_tpu and the port's numpy paths ------------------------------


GRAPHS = {
    "rmat_w": lambda m: m.rmat(10, 8, seed=3, weighted=True),
    "rmat": lambda m: m.rmat(10, 16, seed=4),
    "gnp": lambda m: m.gnp(300, 2000, seed=5),
    "isolated": lambda m: m.gnp(1000, 40, seed=6),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("weighted", [None, False])
def test_read_lux_equals_lux_tpu_s(lib, tmp_path, name, weighted):
    p = str(tmp_path / "g.lux")
    jwrite_lux(p, GRAPHS[name](jgen))
    mine = nio.read_lux(p, weighted=weighted)
    _same_graph(mine, jnio.read_lux(p, weighted=weighted))
    if weighted is None:
        # numpy refuses weighted=False on a weighted file, as lux_tpu's
        # does; the native reader reads the unweighted prefix.
        _same_graph(mine, lux_format.read_lux(p))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_csr_equals_lux_tpu_s(lib, name):
    g, jg = GRAPHS[name](generate), GRAPHS[name](jgen)
    mine = g.csr()
    _same_csr(mine, jg._csr_native())
    _same_csr(mine, g._csr_numpy())
    _same_csr(mine, jg._csr_numpy())


def test_csr_rejects_ids_out_of_range(lib):
    g = generate.gnp(50, 200, seed=2)
    bad = Graph(nv=g.nv, ne=g.ne, row_ptr=g.row_ptr,
                col_src=np.where(np.arange(g.ne) == 7, 60,
                                 g.col_src).astype(np.int32))
    with pytest.raises(ValueError, match="outside"):
        bad.csr()


@pytest.mark.parametrize("weighted", [True, False])
def test_convert_bytes_equal_lux_tpu_s(lib, tmp_path, weighted):
    el = tmp_path / "edges.txt"
    _edge_file(el, seed=11, ne=3000, nv=200, weighted=weighted)
    outs = {}
    for label, fn in (("native", nio.convert_edge_list),
                      ("numpy", lux_format.convert_edge_list),
                      ("lux_tpu", jnio.convert_edge_list)):
        path = str(tmp_path / f"{label}.lux")
        fn(str(el), path, 200, 3000, weighted=weighted)
        outs[label] = open(path, "rb").read()
    assert outs["native"] == outs["numpy"] == outs["lux_tpu"]


def test_converter_cli_bytes_equal_tools_converter(lib, tmp_path):
    el = tmp_path / "edges.txt"
    _edge_file(el, seed=12, ne=800, nv=100)
    outs = []
    for cmd in ([sys.executable, "-m", "lux_tpu_torch.tools.converter"],
                [sys.executable, os.path.join(REPO, "tools",
                                              "converter.py")]):
        out = str(tmp_path / f"g{len(outs)}.lux")
        subprocess.run(cmd + ["-nv", "100", "-ne", "800", "-input",
                              str(el), "-output", out, "-weighted"],
                       check=True, capture_output=True, cwd=REPO)
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]


def test_fallback_without_a_compiler_gives_the_same_bytes(tmp_path, capsys,
                                                          no_compiler):
    """With the build failing, every entry point takes numpy, the failure
    is visible (``available()``, ``build_error()``, one warning) and the
    graphs are byte-identical to ``lux_tpu``'s."""
    from lux_tpu_torch import native

    jg = jgen.rmat(10, 8, seed=3, weighted=True)
    p = str(tmp_path / "g.lux")
    jwrite_lux(p, jg)
    mine = nio.read_lux(p)
    g = generate.rmat(10, 8, seed=3, weighted=True)
    csr = g.csr()
    assert not native.available()
    assert "no-such-g++" in build.build_error()
    assert capsys.readouterr().err.count("native library unavailable") == 1
    _same_graph(mine, jnio.read_lux(p))
    _same_csr(csr, jg._csr_numpy())
    el = tmp_path / "edges.txt"
    _edge_file(el)
    nio.convert_edge_list(str(el), str(tmp_path / "a.lux"), 64, 500, True)
    jnio.convert_edge_list(str(el), str(tmp_path / "b.lux"), 64, 500, True)
    assert (tmp_path / "a.lux").read_bytes() == (tmp_path / "b.lux").read_bytes()
    assert not build.library_path().exists()


def test_build_directory_and_widths(lib, tmp_path, monkeypatch):
    """The library builds into build/lux_tpu_torch/ unless
    LUX_NATIVE_CACHE names another directory, under a name keyed by the
    source's hash; pointers and sizes pass as 64-bit ctypes."""
    assert build.BUILD_DIR == (
        build.Path(REPO) / "build" / "lux_tpu_torch")
    monkeypatch.delenv("LUX_NATIVE_CACHE", raising=False)
    assert build.library_path().parent == build.BUILD_DIR
    monkeypatch.setenv("LUX_NATIVE_CACHE", str(tmp_path / "cache"))
    path = build.library_path()
    assert path.parent == tmp_path / "cache"
    assert path.name.startswith("lux_native_") and path.suffix == ".so"
    lib = build.load_library()
    assert lib.lux_load.argtypes[2] is ctypes.c_uint64
    assert all(t in (ctypes.c_void_p,) for t in lib.lux_load.argtypes[3:])
    assert lib.lux_convert_edge_list.argtypes[3] is ctypes.c_uint64
    assert lib.lux_build_csr.argtypes[1] is ctypes.c_uint64
    assert all(t is ctypes.c_void_p for t in lib.lux_build_csr.argtypes[2:])
    # The port's copy of the C ABI is lux_tpu's, line for line.
    src = open(build.SRC).read().split('extern "C" {')
    theirs = open(os.path.join(REPO, "lux_tpu", "native",
                               "lux_native.cc")).read().split('extern "C" {')
    assert len(src) == 2 and src[1] == theirs[1]


def test_callers_read_through_the_native_io(tmp_path, monkeypatch):
    """The CLIs' load_graph and a session given a path read with
    ``native/io.py::read_lux``."""
    from lux_tpu_torch.models import cli
    from lux_tpu_torch.serve import Session
    from lux_tpu_torch.utils.logging import get_logger

    p = str(tmp_path / "g.lux")
    write_lux(p, generate.gnp(120, 600, seed=8))
    calls = []
    real = nio.read_lux

    def spy(path, *a, **kw):
        calls.append(path)
        return real(path, *a, **kw)

    monkeypatch.setattr(nio, "read_lux", spy)
    monkeypatch.setenv("LUX_PLATFORM", "cpu")
    g, dev = cli.load_graph(p, get_logger("test"))
    assert dev.type == "cpu" and calls == [p]
    _same_graph(g, lux_format.read_lux(p))
    s = Session(p, warm=False, device="cpu")
    try:
        assert calls == [p, p]
        _same_graph(s.graph, g)
    finally:
        s.close()
