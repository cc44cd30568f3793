"""The applications and their registry, the counterpart of
``lux_tpu/models/__init__.py``: the four Lux applications (PageRank,
SSSP, CC, CF) and the GAS programs (BFS, weighted delta-SSSP, label
propagation, k-core).

``lux_tpu``'s capability report prefers the ``gascap.v1`` artifact of
its program-algebra lint (``analysis/gasck``), which is not ported
(ROADMAP A16): here the source is always the class declarations.
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


def capability_report() -> dict:
    """``{source, artifact_id, error, programs: {name: {rooted,
    frontier_ok, incremental_ok}}}`` from the class declarations
    (``source`` is ``"declared"``)."""
    declared = {
        name: {
            "rooted": bool(getattr(cls, "rooted", False)),
            "frontier_ok": bool(getattr(cls, "frontier_ok", False)),
            "incremental_ok": bool(getattr(cls, "incremental_ok", False)),
        }
        for name, cls in PROGRAMS.items()
    }
    return {"source": "declared", "artifact_id": None,
            "error": "no gascap artifact in the port (ROADMAP A16)",
            "programs": declared}


def capabilities() -> dict:
    """``{name: {rooted, frontier_ok, incremental_ok}}`` per program."""
    return capability_report()["programs"]


def rooted_apps() -> frozenset:
    return frozenset(
        name for name, caps in capabilities().items() if caps["rooted"])


ROOTED_APPS = rooted_apps()

# Which executor kinds of this package can run each program: lux_tpu's
# table with the kinds not yet ported left out (each entry keeps
# lux_tpu's order). tiled is spmv-only; push needs a PushProgram; the
# multi-source kinds (push_multi, gas_multi, gas_multi_sharded) need a
# rooted frontier program; gas and gas_sharded run every program
# (PullPrograms as frontier-less dense pull); the *_sharded kinds run
# over the parts of a LocalMesh.
ENGINE_KINDS = {
    "pagerank": ("pull", "tiled", "pull_sharded", "gas", "gas_sharded"),
    "sssp": ("push", "push_multi", "push_sharded", "push_multi_sharded",
             "gas", "gas_multi", "gas_sharded", "gas_multi_sharded"),
    "components": ("push", "push_sharded", "gas", "gas_sharded"),
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
    "rooted_apps",
    "engine_kinds",
    "get_program",
]
