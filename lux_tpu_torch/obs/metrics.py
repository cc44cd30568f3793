"""Process-wide metrics registry: counters, gauges, histograms; a copy
of ``lux_tpu/obs/metrics.py``.

The reference has no metrics layer at all — its only instrumentation is
the wall-clock bracket around the iteration loop (pagerank.cc:108-118).
This registry follows the Prometheus client data model, dependency-free.
The run recorder (``obs/iterlog.py``) and report (``obs/report.py``)
dump it beside each run's records; the WAL, the snapshot store, the
fault points, the locks and the spans count into it too.

Identity semantics: a metric is keyed by ``(name, sorted(labels))``;
requesting the same key twice returns the SAME object (label dedup), and
re-requesting a name under a different metric kind raises — silent kind
drift is how counters get overwritten by gauges in long-lived processes.

Everything here is plain Python on the host; nothing imports torch.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

# Histogram bucket upper bounds (seconds-oriented: compile and iteration
# walls span ~100us CPU-test steps to minutes-long remote compiles).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, float("inf"),
)


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


class Counter:
    """Monotonically increasing count (iterations run, flushes, bytes)."""

    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += amount

    def snapshot(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "labels": self.labels,
            "value": self.value,
        }


class Gauge:
    """Point-in-time value (exchange bytes per iteration, frontier size)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, value: float):
        self.value = float(value)

    def inc(self, amount: float = 1.0):
        self.value += amount

    def dec(self, amount: float = 1.0):
        self.value -= amount

    def snapshot(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "labels": self.labels,
            "value": self.value,
        }


class Histogram:
    """Distribution of observations (per-iteration seconds, compile
    seconds) as cumulative bucket counts plus count/sum."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        labels: Dict[str, str],
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        bounds = tuple(sorted(buckets))
        if not bounds or bounds[-1] != float("inf"):
            bounds = bounds + (float("inf"),)
        self.name = name
        self.labels = labels
        self.bounds = bounds
        self.bucket_counts = [0] * len(bounds)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float):
        self.count += 1
        self.sum += value
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.bucket_counts[i] += 1
                break

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0..1) from the bucket counts, linearly
        interpolated within the winning bucket (the standard
        histogram_quantile estimate). Serving latency SLOs (p50/p99 in
        /stats and tools/serve_bench.py) read this; exact quantiles would
        need the raw observations we deliberately don't keep."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        lo = 0.0
        for b, c in zip(self.bounds, self.bucket_counts):
            if seen + c >= rank and c > 0:
                if b == float("inf"):
                    return lo  # open-ended bucket: report its lower bound
                frac = (rank - seen) / c
                return lo + (b - lo) * frac
            seen += c
            lo = b if b != float("inf") else lo
        return lo

    def snapshot(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "labels": self.labels,
            "count": self.count, "sum": self.sum,
            "buckets": [
                # inf serializes as a string: json.dumps(float('inf'))
                # emits the non-standard literal `Infinity`.
                {"le": b if b != float("inf") else "+Inf", "count": c}
                for b, c in zip(self.bounds, self.bucket_counts)
            ],
        }


class MetricsRegistry:
    """Thread-safe metric store; one per process (module-level REGISTRY)."""

    def __init__(self):
        self._metrics: Dict[tuple, object] = {}
        # Deliberately a bare Lock, not utils/locks.make_lock: this
        # registry is the substrate WatchedLock reports into — a watched
        # registry lock would re-enter _get from its own release path.
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]], **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, dict(labels or {}), **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str, labels=None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels=None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels=None, buckets=DEFAULT_BUCKETS):
        return self._get(Histogram, name, labels, buckets=buckets)

    def snapshot(self) -> list:
        """JSON-ready dump of every registered metric, sorted by name so
        dumps diff cleanly across runs."""
        with self._lock:
            metrics = list(self._metrics.values())
        return sorted(
            (m.snapshot() for m in metrics),
            key=lambda s: (s["name"], sorted(s["labels"].items())),
        )

    def reset(self):
        """Drop every metric (tests; a fresh process needs nothing)."""
        with self._lock:
            self._metrics.clear()


def _prom_label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _prom_num(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(snap: Optional[list] = None) -> str:
    """Prometheus text exposition (version 0.0.4) of a registry snapshot.

    Dependency-free renderer for the serve ``/metrics`` endpoint: one
    ``# TYPE`` line per metric family, histograms as CUMULATIVE
    ``_bucket{le=...}`` series plus ``_sum``/``_count`` (the registry
    stores per-bucket counts; Prometheus semantics require the running
    total). Families sort by name, so scrapes diff cleanly.
    """
    if snap is None:
        snap = REGISTRY.snapshot()
    lines = []
    typed = set()
    for m in snap:
        name, kind = m["name"], m["kind"]
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")
        labels = m["labels"]
        if kind in ("counter", "gauge"):
            lines.append(
                f"{name}{_prom_label_str(labels)} {_prom_num(m['value'])}"
            )
            continue
        cum = 0
        for b in m["buckets"]:
            cum += b["count"]
            le = b["le"] if b["le"] == "+Inf" else _prom_num(b["le"])
            lines.append(
                f"{name}_bucket{_prom_label_str(dict(labels, le=le))} {cum}"
            )
        lines.append(f"{name}_sum{_prom_label_str(labels)} "
                     f"{repr(float(m['sum']))}")
        lines.append(f"{name}_count{_prom_label_str(labels)} {m['count']}")
    return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()

# Module-level conveniences bound to the process registry.
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset
