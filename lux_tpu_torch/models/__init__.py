"""The applications and their registry, the counterpart of
``lux_tpu/models/__init__.py``: the four Lux applications (PageRank,
SSSP, CC, CF) and the GAS programs (BFS, weighted delta-SSSP, label
propagation, k-core).

The capability matrix (rooted, frontier_ok, incremental_ok) comes from
the ``gascap.v1`` artifact of the program-algebra lint
(``analysis/gasck.py``, ``lux_tpu_torch/analysis/gascap.json``), with
the class declarations as the fallback when it is missing or rejected.
"""

from lux_tpu_torch.models.bfs import BFS
from lux_tpu_torch.models.colfilter import CollaborativeFiltering
from lux_tpu_torch.models.components import ConnectedComponents
from lux_tpu_torch.models.kcore import KCore
from lux_tpu_torch.models.labelprop import LabelPropagation
from lux_tpu_torch.models.pagerank import PageRank
from lux_tpu_torch.models.sssp import SSSP
from lux_tpu_torch.models.sssp_delta import DeltaSSSP

# App registry: name -> program class. Programs with ``rooted=True`` take
# a per-query root (``start``) and can run as lanes of a multi-source
# executor.
PROGRAMS = {
    "pagerank": PageRank,
    "sssp": SSSP,
    "components": ConnectedComponents,
    "colfilter": CollaborativeFiltering,
    "bfs": BFS,
    "sssp_delta": DeltaSSSP,
    "labelprop": LabelPropagation,
    "kcore": KCore,
}


_CAPABILITY_REPORT = None


def capability_report(refresh: bool = False) -> dict:
    """The machine-checked capability matrix the registry trusts.

    Prefers the derived proof matrix of the ``gascap.v1`` artifact
    (``luxlint --programs``, ``analysis/gasck.py``, honouring
    ``LUX_GASCAP_DIR``); falls back to the class declarations when the
    artifact is missing or rejected (a tampered artifact raises inside
    gasck and lands here as ``error``). Returns ``{source, artifact_id,
    error, programs: {name: {rooted, frontier_ok, incremental_ok}}}``
    with ``source`` one of ``artifact`` / ``declared``; cached until
    ``refresh``.
    """
    global _CAPABILITY_REPORT
    if _CAPABILITY_REPORT is not None and not refresh:
        return _CAPABILITY_REPORT
    declared = {
        name: {
            "rooted": bool(getattr(cls, "rooted", False)),
            "frontier_ok": bool(getattr(cls, "frontier_ok", False)),
            "incremental_ok": bool(getattr(cls, "incremental_ok", False)),
        }
        for name, cls in PROGRAMS.items()
    }
    report = {"source": "declared", "artifact_id": None, "error": None,
              "programs": declared}
    try:
        from lux_tpu_torch.analysis import gasck

        art = gasck.load_capmap(gasck.capmap_path())
        programs = {}
        for name, caps in declared.items():
            entry = (art.get("programs") or {}).get(name)
            derived = entry.get("derived") if isinstance(entry, dict) \
                else None
            if isinstance(derived, dict):
                programs[name] = {
                    k: bool(derived.get(k, caps[k])) for k in caps
                }
            else:
                programs[name] = caps   # program newer than the artifact
        report = {"source": "artifact", "artifact_id": art.get("id"),
                  "error": None, "programs": programs}
    except FileNotFoundError:
        report["error"] = "artifact missing (run luxlint --programs)"
    except Exception as e:
        report["error"] = f"artifact rejected: {e!r}"
    _CAPABILITY_REPORT = report
    return report


def capabilities(refresh: bool = False) -> dict:
    """``{name: {rooted, frontier_ok, incremental_ok}}`` per program."""
    return capability_report(refresh)["programs"]


def frontier_ok(name: str) -> bool:
    """Proof-derived license for the frontier exchange / adaptive lanes."""
    return bool(capabilities().get(name, {}).get("frontier_ok", False))


def incremental_ok(name: str) -> bool:
    """Proof-derived license for IncrementalExecutor warm-starts."""
    return bool(capabilities().get(name, {}).get("incremental_ok", False))


def rooted_apps() -> frozenset:
    return frozenset(
        name for name, caps in capabilities().items() if caps["rooted"])


# Derived from the gascap.v1 proof matrix (the declarations as the
# no-artifact fallback), as lux_tpu's is.
ROOTED_APPS = rooted_apps()

# Which executor kinds can run each program: lux_tpu's table, kind for
# kind and in its order. tiled and tiled_sharded are spmv-only; push and
# push_incremental need a PushProgram; the multi-source kinds
# (push_multi, gas_multi, gas_multi_sharded) need a rooted frontier
# program; gas and gas_sharded run every program (PullPrograms as
# frontier-less dense pull); the *_sharded kinds run over the parts of a
# LocalMesh.
ENGINE_KINDS = {
    "pagerank": ("pull", "tiled", "pull_sharded", "tiled_sharded", "gas",
                 "gas_sharded"),
    "sssp": ("push", "push_multi", "push_incremental", "push_sharded",
             "push_multi_sharded", "gas", "gas_multi", "gas_sharded",
             "gas_multi_sharded"),
    "components": ("push", "push_incremental", "push_sharded", "gas",
                   "gas_sharded"),
    "colfilter": ("pull", "pull_sharded", "gas", "gas_sharded"),
    "bfs": ("gas", "gas_multi", "gas_sharded", "gas_multi_sharded"),
    "sssp_delta": ("gas", "gas_multi", "gas_sharded", "gas_multi_sharded"),
    "labelprop": ("gas", "gas_sharded"),
    "kcore": ("gas", "gas_sharded"),
}


def engine_kinds(name: str):
    """Executor kinds capable of running the program named ``name``."""
    try:
        return ENGINE_KINDS[name]
    except KeyError:
        raise KeyError(
            f"unknown app {name!r}; registered: {sorted(ENGINE_KINDS)}"
        ) from None


def get_program(name: str):
    """Instantiate the vertex program registered under ``name``."""
    try:
        return PROGRAMS[name]()
    except KeyError:
        raise KeyError(
            f"unknown app {name!r}; registered: {sorted(PROGRAMS)}"
        ) from None


__all__ = [
    "PageRank",
    "SSSP",
    "ConnectedComponents",
    "CollaborativeFiltering",
    "BFS",
    "DeltaSSSP",
    "LabelPropagation",
    "KCore",
    "PROGRAMS",
    "ROOTED_APPS",
    "ENGINE_KINDS",
    "capability_report",
    "capabilities",
    "frontier_ok",
    "incremental_ok",
    "rooted_apps",
    "engine_kinds",
    "get_program",
]
