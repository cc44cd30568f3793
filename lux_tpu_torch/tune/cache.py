"""In-memory LRU of ``tuneconf.v1`` artifacts over the ``LUX_TUNE_DIR``
store, the counterpart of ``lux_tpu/tune/cache.py`` — keyed and evicted
exactly like :class:`ShardPlanCache` (serve/mesh.py): the hot-swap drain calls :meth:`evict_fingerprint`
next to the plan eviction, so a snapshot swap atomically retires the
mesh of engines, its partition plan, *and* its tuned configs. The new
fingerprint then misses here and serving falls back to defaults — a
counted (``lux_tune_fallback_total`` lives with the Session, which
knows the app label), never silent, event until someone re-tunes.

Disk artifacts are never deleted on eviction: they are evidence, and
``luxlint --tune`` holds the staleness/fingerprint line on them
offline.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

from lux_tpu_torch.obs import metrics
from lux_tpu_torch.tune import artifact
from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.locks import make_lock
from lux_tpu_torch.utils.logging import get_logger

__all__ = ["TuneCache", "tune_cache"]


class TuneCache:
    """LRU of tune artifacts keyed by the artifact key string."""

    def __init__(self, root: Optional[str] = None):
        self._lock = make_lock("tune.cache")
        self._entries = OrderedDict()  # guarded by _lock
        self._root = root
        self._hits = metrics.counter("lux_tune_hits_total")
        self._misses = metrics.counter("lux_tune_misses_total")
        self._evicted = metrics.counter("lux_tune_evicted_total")
        self.log = get_logger("tune")

    def root(self) -> Optional[str]:
        return self._root if self._root is not None \
            else flags.get("LUX_TUNE_DIR")

    def enabled(self) -> bool:
        return bool(self.root())

    def _cap(self) -> int:
        return max(1, flags.get_int("LUX_TUNE_CACHE"))

    def get(self, key: Dict[str, str]) -> Optional[dict]:
        """The artifact for ``key``: memory first, then one disk load.
        None when no artifact exists (the caller counts the fallback) or
        the cache is disarmed."""
        root = self.root()
        if not root:
            return None
        ks = artifact.key_string(key)
        with self._lock:
            art = self._entries.get(ks)
            if art is not None:
                self._entries.move_to_end(ks)
                self._hits.inc()
                return art
            self._misses.inc()
            art = artifact.load(root, key)
            if art is None:
                return None
            self._entries[ks] = art
            self._entries.move_to_end(ks)
            cap = self._cap()
            while len(self._entries) > cap:
                old_key, _ = self._entries.popitem(last=False)
                self._evicted.inc()
                self.log.info("tune cache evicted %r (LRU, cap %d)",
                              old_key, cap)
            return art

    def put(self, art: dict) -> str:
        """Persist a freshly searched artifact and admit it; returns the
        artifact path."""
        root = self.root()
        if not root:
            raise RuntimeError(
                "TuneCache.put with LUX_TUNE_DIR unset: nowhere to "
                "persist the artifact")
        path = artifact.save(root, art)
        ks = art["key_string"]
        with self._lock:
            self._entries[ks] = art
            self._entries.move_to_end(ks)
            cap = self._cap()
            while len(self._entries) > cap:
                self._entries.popitem(last=False)
                self._evicted.inc()
        return path

    def evict_fingerprint(self, fingerprint: str) -> int:
        """Drop every in-memory entry tuned for ``fingerprint``
        (hot-swap drain). Disk artifacts stay — they are evidence."""
        with self._lock:
            victims = [k for k, a in self._entries.items()
                       if a["key"]["graph_fingerprint"] == fingerprint]
            for k in victims:
                del self._entries[k]
            if victims:
                self._evicted.inc(len(victims))
        return len(victims)

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        return {
            "entries": len(self),
            "hits": int(self._hits.value),
            "misses": int(self._misses.value),
            "evicted": int(self._evicted.value),
            "capacity": self._cap(),
            "armed": self.enabled(),
        }


_CACHE = TuneCache()


def tune_cache() -> TuneCache:
    """The process-wide cache (Session warmup, chip_smoke.py)."""
    return _CACHE
