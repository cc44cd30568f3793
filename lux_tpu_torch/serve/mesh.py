"""Serving mesh resolution + the snapshot-keyed shard-plan cache.

Multi-part serving has two pieces of state the per-query path must never
rebuild:

- the **mesh** itself: ``LUX_SERVE_MESH`` (or ``ServeConfig.mesh``)
  names a part count (``"4"``) or a ``PxQ`` shape (``"2x2"``), folded
  onto the 1-D ``parts`` axis exactly as the CLI folds ``-parts N``. The
  parts are those of a :class:`~lux_tpu_torch.parallel.mesh.LocalMesh`
  on the session's one device, as the sharded executors have run since
  they were ported (``parallel/mesh.py::mesh_for``). ``lux_tpu``
  bootstraps virtual XLA host devices for a mesh on a CPU host; a
  ``LocalMesh`` needs no devices beyond the one it runs on, so that step
  has no counterpart here.
- the **partition plan**: :class:`~lux_tpu_torch.parallel.shard.ShardedGraph`
  is a host-side O(ne) construction (edge-balanced bounds, padded
  stacked CSC shards, the push CSR). Every sharded executor for one
  (snapshot, parts) pair must share ONE plan, and a hot-swap must evict
  the outgoing snapshot's plans the same way it retires its engines —
  that is :class:`ShardPlanCache`, keyed ``(fingerprint, num_parts)``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple

from lux_tpu_torch.obs import metrics
from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.locks import make_lock
from lux_tpu_torch.utils.logging import get_logger


def parse_mesh_spec(spec) -> Tuple[int, ...]:
    """``"8"`` -> (8,), ``"2x4"`` -> (2, 4). Every factor must be a
    positive integer; the product is the partition count (the shape is
    kept for pool keys and /statusz, the 1-D parts axis gets the fold)."""
    text = str(spec).strip().lower()
    if not text:
        raise ValueError(
            "empty mesh spec: use a part count ('4') or a PxQ shape "
            "('2x2'); '1' serves on one part"
        )
    try:
        shape = tuple(int(d) for d in text.split("x"))
    except ValueError:
        raise ValueError(
            f"bad mesh spec {spec!r}: use a part count ('4') or a "
            "PxQ shape ('2x2')"
        ) from None
    if not shape or any(d < 1 for d in shape):
        raise ValueError(
            f"bad mesh spec {spec!r}: every factor must be >= 1"
        )
    return shape


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A resolved serving mesh: the parsed shape (the pool-key
    component), the folded partition count, and the
    :class:`~lux_tpu_torch.parallel.mesh.LocalMesh` (None for
    single-part serving — the executors take the single-device path)."""

    spec: str                  # the string as given ("2x2")
    shape: Tuple[int, ...]     # parsed shape ((2, 2))
    num_parts: int             # folded product (4)
    mesh: object               # LocalMesh | None when num_parts == 1


def serving_mesh(spec: Optional[str] = None, device=None) -> MeshSpec:
    """Resolve ``spec`` (default: the ``LUX_SERVE_MESH`` flag) to a
    :class:`MeshSpec` whose parts live on ``device`` (``cuda`` unless
    named)."""
    raw = spec if spec is not None else flags.get("LUX_SERVE_MESH")
    shape = parse_mesh_spec(raw if raw is not None else "1")
    n = 1
    for d in shape:
        n *= d
    if n == 1:
        return MeshSpec(spec=str(raw), shape=shape, num_parts=1, mesh=None)
    from lux_tpu_torch.parallel.mesh import make_mesh

    return MeshSpec(
        spec=str(raw), shape=shape, num_parts=n, mesh=make_mesh(n, device)
    )


class ShardPlanCache:
    """LRU of host-side partition plans keyed ``(fingerprint, parts)``.

    One :class:`ShardedGraph` build is O(ne) host work; every sharded
    executor the pool warms for one snapshot — push, multi-source push,
    pull, GAS — shares the entry, and ``apply_edits`` warms the incoming
    fingerprint's plan exactly once. The hot-swap drain calls
    :meth:`evict_fingerprint` next to ``pool.retire`` so a swap
    atomically replaces the *mesh* of engines and its plan."""

    def __init__(self):
        self._lock = make_lock("mesh.plans")
        self._plans = OrderedDict()
        self._hits = metrics.counter("lux_serve_plan_hits_total")
        self._misses = metrics.counter("lux_serve_plan_misses_total")
        self._evicted = metrics.counter("lux_serve_plan_evicted_total")
        self.log = get_logger("serve")

    def get(self, fingerprint: str, graph, num_parts: int):
        """The plan for ``(fingerprint, num_parts)``, building it on
        first request. ``graph`` must be the snapshot's Graph object —
        the executors validate plan/graph identity, so a cached plan
        built from a *different* object with the same content is rebuilt
        in place rather than handed out."""
        from lux_tpu_torch.parallel.shard import ShardedGraph

        key = (fingerprint, int(num_parts))
        with self._lock:
            sg = self._plans.get(key)
            if sg is not None and sg.graph is graph:
                self._plans.move_to_end(key)
                self._hits.inc()
                return sg
            self._misses.inc()
            # Build under the lock for the same reason EnginePool does:
            # two concurrent warmups for one snapshot must not do the
            # O(ne) partition twice.
            sg = ShardedGraph.build(graph, int(num_parts))
            self._plans[key] = sg
            self._plans.move_to_end(key)
            cap = max(1, flags.get_int("LUX_SHARD_PLAN_CACHE"))
            while len(self._plans) > cap:
                old_key, _ = self._plans.popitem(last=False)
                self._evicted.inc()
                self.log.info("shard-plan cache evicted %r (LRU, cap %d)",
                              old_key, cap)
            return sg

    def evict_fingerprint(self, fingerprint: str) -> int:
        """Drop every plan built for ``fingerprint`` (hot-swap drain)."""
        with self._lock:
            victims = [k for k in self._plans if k[0] == fingerprint]
            for k in victims:
                del self._plans[k]
            if victims:
                self._evicted.inc(len(victims))
        return len(victims)

    def clear(self) -> int:
        with self._lock:
            n = len(self._plans)
            self._plans.clear()
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def stats(self) -> dict:
        return {
            "plans": len(self),
            "hits": int(self._hits.value),
            "misses": int(self._misses.value),
            "evicted": int(self._evicted.value),
            "capacity": max(1, flags.get_int("LUX_SHARD_PLAN_CACHE")),
        }


_PLANS = ShardPlanCache()


def plan_cache() -> ShardPlanCache:
    """The process-wide plan cache (sessions serving the same snapshot
    share partition work; keys embed the fingerprint so plans can never
    leak across graphs)."""
    return _PLANS
