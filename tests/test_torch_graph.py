"""Port parity: graph generators and the .lux format, lux_tpu vs lux_tpu_torch."""

import numpy as np
import pytest

from lux_tpu.graph import format as jformat
from lux_tpu.graph import generate as jgen
from lux_tpu_torch.graph import format as tformat
from lux_tpu_torch.graph import generate as tgen

GENERATORS = {
    "rmat": lambda m: m.rmat(10, 8, seed=0),
    "rmat_weighted": lambda m: m.rmat(9, 4, seed=2, weighted=True),
    "gnp": lambda m: m.gnp(300, 2000, seed=1),
    "gnp_weighted": lambda m: m.gnp(200, 900, seed=4, weighted=True),
    "undirected": lambda m: m.undirected(m.rmat(8, 4, seed=1)),
    "small_world": lambda m: m.small_world(200, k=4, seed=3),
    "halo": lambda m: m.halo(4, 64, hubs=4, seed=1, weighted=True),
    "bipartite_ratings": lambda m: m.bipartite_ratings(50, 20, 400, seed=5),
    "path_graph": lambda m: m.path_graph(17),
    "star_graph": lambda m: m.star_graph(9),
    "cycle_graph": lambda m: m.cycle_graph(11),
}


def assert_same_graph(a, b):
    assert (a.nv, a.ne) == (b.nv, b.ne)
    for name in ("row_ptr", "col_src", "col_dst", "in_degrees",
                 "out_degrees"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.weights is None) == (b.weights is None)
    if a.weights is not None:
        assert a.weights.dtype == b.weights.dtype
        np.testing.assert_array_equal(a.weights, b.weights)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_byte_identical(name):
    make = GENERATORS[name]
    a, b = make(jgen), make(tgen)
    assert_same_graph(a, b)
    ca, cb = a.csr(), b.csr()
    np.testing.assert_array_equal(ca.row_ptr, cb.row_ptr)
    np.testing.assert_array_equal(ca.col_dst, cb.col_dst)


@pytest.mark.parametrize("writer", ["lux_tpu", "lux_tpu_torch"])
@pytest.mark.parametrize("weighted", [False, True])
def test_lux_files_cross_read(tmp_path, writer, weighted):
    g = tgen.rmat(9, 6, seed=7, weighted=weighted)
    mods = {"lux_tpu": jformat, "lux_tpu_torch": tformat}
    path = str(tmp_path / "g.lux")
    mods[writer].write_lux(path, g)
    other = tmp_path / "other.lux"
    [m for k, m in mods.items() if k != writer][0].write_lux(str(other), g)
    assert open(path, "rb").read() == other.read_bytes()
    for reader in mods.values():
        assert reader.detect_layout(path) == (g.nv, g.ne, weighted, True)
        assert_same_graph(reader.read_lux(path), g)
        mm = reader.read_lux_mmap(path)
        np.testing.assert_array_equal(np.asarray(mm.col_src), g.col_src)
        np.testing.assert_array_equal(mm.row_ptr, g.row_ptr)


@pytest.mark.parametrize("case", ["random", "sorted", "one_key", "empty",
                                  "negative", "wide"])
def test_stable_argsort_is_numpys(case):
    from lux_tpu_torch.graph.graph import stable_argsort

    rng = np.random.default_rng(7)
    keys = {
        "random": rng.integers(0, 300, 5000).astype(np.int32),
        "sorted": np.repeat(np.arange(50, dtype=np.int64), 7),
        "one_key": np.zeros(1000, dtype=np.int32),
        "empty": np.zeros(0, dtype=np.int32),
        "negative": rng.integers(-5, 5, 400),
        "wide": rng.integers(0, 2**40, 400),
    }[case]
    got = stable_argsort(keys)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
