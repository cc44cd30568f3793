"""Warm-engine query serving with multi-source micro-batching.

The offline CLI pays graph load + engine build per invocation; this
subsystem pays them once. A :class:`Session` loads the graph, keeps
warmed executors in a keyed :class:`EnginePool`, answers queries
through a bounded admission queue (:class:`MicroBatcher`), and fronts an
LRU :class:`ResultCache`. K concurrent SSSP root queries inside one
batching window run as ONE dense multi-source sweep
(engine/push.py ``MultiSourcePushExecutor``); root-free fixpoints
(PageRank, CC) are served from the cache. With ``LUX_SERVE_MESH`` (or
``ServeConfig(mesh=...)``) every engine is *sharded* over the parts of
a ``LocalMesh`` on the one device (``serve/mesh.py``) — pool keys embed
the mesh shape so warm sharded engines serve with no rebuild.
``serve/http.py`` is the stdlib JSON front end:
``python -m lux_tpu_torch.serve.http -file g.lux``.

The counterpart of ``lux_tpu/serve``, on the card unless the caller
asks for the CPU.
"""

from lux_tpu_torch.serve.batcher import MicroBatcher, Request
from lux_tpu_torch.serve.breaker import CircuitBreaker
from lux_tpu_torch.serve.cache import ResultCache
from lux_tpu_torch.serve.errors import (
    BadQueryError,
    CircuitOpenError,
    DeadlineExceededError,
    PoolOverBudgetError,
    QueueFullError,
    ServeError,
    SnapshotSwapError,
)
from lux_tpu_torch.serve.mesh import MeshSpec, ShardPlanCache, serving_mesh
from lux_tpu_torch.serve.pool import EnginePool
from lux_tpu_torch.serve.session import ServeConfig, Session

__all__ = [
    "Session",
    "ServeConfig",
    "MeshSpec",
    "ShardPlanCache",
    "serving_mesh",
    "EnginePool",
    "ResultCache",
    "MicroBatcher",
    "Request",
    "CircuitBreaker",
    "ServeError",
    "QueueFullError",
    "DeadlineExceededError",
    "BadQueryError",
    "SnapshotSwapError",
    "CircuitOpenError",
    "PoolOverBudgetError",
]
