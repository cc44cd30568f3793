"""The port never imports JAX or the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "lux_tpu")
FILES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "lux_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
)


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_found():
    assert "chip_smoke.py" in FILES
    assert "lux_tpu_torch/engine/tiled.py" in FILES
    assert "lux_tpu_torch/engine/pull.py" in FILES
    assert "lux_tpu_torch/models/colfilter.py" in FILES
    for name in ("engine/gas.py", "models/bfs.py", "models/sssp_delta.py",
                 "models/labelprop.py", "models/kcore.py"):
        assert f"lux_tpu_torch/{name}" in FILES
    for name in ("graph/partition.py", "parallel/shard.py",
                 "parallel/mesh.py", "engine/sharded.py",
                 "engine/pull_sharded.py", "engine/push_sharded.py",
                 "engine/tiled_sharded.py", "engine/gas_sharded.py",
                 "utils/logging.py", "utils/checkpoint.py",
                 "models/cli.py", "tools/converter.py",
                 "probes/gather.py", "probes/dgather.py",
                 "probes/dgather2.py", "probes/merge_kernel.py",
                 "utils/locks.py", "utils/faults.py", "utils/host.py",
                 "obs/__init__.py",
                 "obs/metrics.py", "obs/trace.py", "obs/spans.py",
                 "graph/delta.py", "graph/wal.py", "graph/snapshot.py",
                 "engine/incremental.py", "engine/telemetry.py",
                 "obs/engobs.py", "obs/flight.py", "obs/iterlog.py",
                 "obs/ledger.py", "obs/prof.py", "obs/report.py",
                 "obs/slo.py", "tools/prof_summary.py",
                 "analysis/__init__.py", "analysis/sentinel.py",
                 "serve/__init__.py", "serve/errors.py", "serve/cache.py",
                 "serve/cost.py", "serve/breaker.py", "serve/batcher.py",
                 "serve/pool.py", "serve/mesh.py", "serve/session.py",
                 "serve/http.py", "analysis/core.py",
                 "analysis/tuneck.py", "analysis/ir.py", "tune/space.py",
                 "tune/probe.py", "tune/search.py", "tune/artifact.py",
                 "tune/cache.py", "tools/luxlint.py", "native/build.py",
                 "native/io.py"):
        assert f"lux_tpu_torch/{name}" in FILES


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_or_lux_tpu_import(rel):
    bad = [
        m for m in imported_modules(ROOT / rel)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{rel} imports {bad}"
