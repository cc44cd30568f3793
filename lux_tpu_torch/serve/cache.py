"""LRU result cache keyed by (graph fingerprint, query key).

PageRank/CC answers are root-independent (one converged array serves
every client) and SSSP repeats are common in online traversal traffic
(PAPERS.md: Gunrock's query mix), so a small LRU in front of the engines
turns repeat queries into dictionary hits. Keys must embed the graph
fingerprint — the hardened utils/checkpoint.fingerprint — so a server
rotated onto a new graph can never serve stale arrays.

Eviction is byte-first: entries are priced by their value's nbytes
(tree-summed) and the LRU evicts once the summed bytes exceed
``capacity_bytes`` (``LUX_RESULT_CACHE_BYTES``). An entry count still
bounds the dict — a flood of tiny entries must not grow the key set
unboundedly — but the binding constraint on graph-sized arrays is the
byte budget: one RMAT22 distance array is ~16 MiB, so "256 entries"
silently meant gigabytes before bytes were priced.
"""

from __future__ import annotations

import sys
from collections import OrderedDict
from typing import Any, Hashable, Optional

from lux_tpu_torch.obs import metrics, spans
from lux_tpu_torch.utils import faults, flags
from lux_tpu_torch.utils.locks import make_lock


def _value_nbytes(value: Any) -> int:
    """Recursive nbytes of one cached value: array leaves report their
    buffer size, containers sum their children, everything else falls
    back to sys.getsizeof (host-object overhead, close enough for a
    budget)."""
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(value, dict):
        return sum(_value_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple, set, frozenset)):
        return sum(_value_nbytes(v) for v in value)
    return int(sys.getsizeof(value))


class ResultCache:
    """Thread-safe LRU over query results (host numpy arrays)."""

    def __init__(self, capacity: int = 256,
                 capacity_bytes: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        self.capacity = capacity
        if capacity_bytes is None:
            capacity_bytes = flags.get_int("LUX_RESULT_CACHE_BYTES")
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1 (got {capacity_bytes})")
        self.capacity_bytes = int(capacity_bytes)
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._sizes: dict = {}
        self._bytes = 0
        self._lock = make_lock("cache")
        self._hits = metrics.counter("lux_serve_cache_hits_total")
        self._misses = metrics.counter("lux_serve_cache_misses_total")
        self._evictions = metrics.counter("lux_serve_cache_evictions_total")
        self._invalidations = metrics.counter(
            "lux_serve_cache_invalidations_total"
        )
        self._bytes_gauge = metrics.gauge("lux_result_cache_bytes")

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self._hits.inc()
                hit, out = True, self._d[key]
            else:
                self._misses.inc()
                hit, out = False, None
        spans.complete("serve.cache.get", 0.0, hit=hit)
        return out

    def put(self, key: Hashable, value: Any) -> None:
        with spans.span("serve.cache.put"):
            faults.point("cache.put")
            size = _value_nbytes(value)
            with self._lock:
                if key in self._d:
                    self._bytes -= self._sizes.get(key, 0)
                self._d[key] = value
                self._sizes[key] = size
                self._bytes += size
                self._d.move_to_end(key)
                # Byte budget first (the binding constraint on
                # graph-sized arrays), entry count as the dict bound.
                # The newest entry is never evicted to make room for
                # itself — an oversized value simply occupies the whole
                # budget until the next put.
                while (self._bytes > self.capacity_bytes
                       or len(self._d) > self.capacity) and len(self._d) > 1:
                    k, _ = self._d.popitem(last=False)
                    self._bytes -= self._sizes.pop(k, 0)
                    self._evictions.inc()
                self._bytes_gauge.set(float(self._bytes))

    def keys(self) -> list:
        with self._lock:
            return list(self._d.keys())

    def evict_fingerprint(self, fingerprint: str) -> int:
        """Drop every entry keyed by ``fingerprint`` (hot-swap invalidation).

        Serving keys lead with the graph fingerprint, so entries for a
        retired snapshot are exactly the tuple keys whose first element
        matches. Without this they linger until LRU pressure, pinning the
        dead snapshot's arrays and inflating the /statusz hit-rate with
        unreachable entries."""
        with self._lock:
            victims = [
                k for k in self._d
                if isinstance(k, tuple) and k and k[0] == fingerprint
            ]
            for k in victims:
                del self._d[k]
                self._bytes -= self._sizes.pop(k, 0)
            if victims:
                self._invalidations.inc(len(victims))
                self._bytes_gauge.set(float(self._bytes))
        return len(victims)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def stats(self) -> dict:
        with self._lock:
            nbytes = self._bytes
        return {
            "size": len(self),
            "capacity": self.capacity,
            "bytes": int(nbytes),
            "capacity_bytes": self.capacity_bytes,
            "hits": int(self._hits.value),
            "misses": int(self._misses.value),
            "evictions": int(self._evictions.value),
            "invalidations": int(self._invalidations.value),
        }
