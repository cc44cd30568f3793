"""Per-query cost attribution: what did answering this request spend?

Latency (obs/slo.py) tells you how long a tenant waited; it says
nothing about what the tenant *consumed* — a cache-hit PageRank and a
12-iteration sharded SSSP sweep both read as "fast". The admission
quotas of ROADMAP item 5 need the consumption signal, per tenant:

- :class:`QueryCost` rides one request end to end (created at
  ``Session.submit``, filled on the batcher thread before the future
  resolves): iterations, engine-execute seconds, exchange bytes,
  direction switches, cache outcome. Batch members split the batch's
  engine cost evenly, so per-query costs sum to the batch totals.
- :class:`CostAccounts` is the per-tenant rollup (SloWindows idiom:
  bounded observation deques + rolling-window quantiles, plus
  cumulative totals). ``snapshot()`` is the ``/costz`` payload; the
  totals are fed in lockstep with the ``lux_query_cost_*{tenant}``
  metrics, so the two always agree.

Tenancy comes from the ``X-Lux-Tenant`` header (serve/http.py) or the
``tenant=`` submit kwarg; unlabeled traffic books to ``default``.
"""

from __future__ import annotations

import bisect
from collections import deque
from typing import Dict, Optional

from ..obs import metrics, spans
from ..obs.slo import MAX_OBSERVATIONS, _quantile, windows_from_flags
from ..utils.locks import make_lock

DEFAULT_TENANT = "default"


class QueryCost:
    """Mutable cost record for one admitted query.

    Written on the batcher thread *before* ``future.set_result`` (the
    happens-before edge done-callbacks and ``.result()`` readers need),
    read after the future resolves.
    """

    __slots__ = ("tenant", "app", "outcome", "iterations",
                 "engine_s", "exchange_bytes", "direction_switches",
                 "latency_s")

    def __init__(self, tenant: Optional[str], app: str):
        self.tenant = str(tenant) if tenant else DEFAULT_TENANT
        self.app = app
        self.outcome = "miss"        # "hit" when the result cache answered
        self.iterations = 0
        self.engine_s = 0.0
        self.exchange_bytes = 0
        self.direction_switches = 0
        self.latency_s = 0.0

    def charge(self, iterations: int = 0, engine_s: float = 0.0,
               exchange_bytes: int = 0, direction_switches: int = 0):
        """Accumulate engine spend (a retried batch charges each
        attempt's share — the tenant consumed that time either way)."""
        self.iterations += int(iterations)
        self.engine_s += float(engine_s)
        self.exchange_bytes += int(exchange_bytes)
        self.direction_switches += int(direction_switches)

    def as_dict(self) -> dict:
        return {
            "tenant": self.tenant, "app": self.app,
            "outcome": self.outcome, "iterations": self.iterations,
            "engine_s": self.engine_s,
            "exchange_bytes": self.exchange_bytes,
            "direction_switches": self.direction_switches,
            "latency_s": self.latency_s,
        }

    def header(self) -> str:
        """Compact ``X-Lux-Cost`` response-header value."""
        return (
            "tenant={};outcome={};iters={};engine_s={:.6f};"
            "exchange_bytes={};switches={}".format(
                self.tenant, self.outcome, self.iterations,
                self.engine_s, self.exchange_bytes,
                self.direction_switches)
        )


class CostAccounts:
    """Per-tenant rolling + cumulative cost accounting (thread-safe).

    The cumulative totals and the ``lux_query_cost_*{tenant}`` metrics
    are incremented in the same :meth:`observe` call, so ``/costz``
    totals and metric deltas can never drift apart.
    """

    def __init__(self, windows=None, now=None):
        self.windows = tuple(windows) if windows else windows_from_flags()
        self._now = now or spans.clock
        self._lock = make_lock("serve.costs")
        self._obs: Dict[str, deque] = {}       # tenant -> (ts, engine_s)
        self._totals: Dict[str, dict] = {}

    def observe(self, cost: QueryCost):
        t = cost.tenant
        now = self._now()
        with self._lock:
            dq = self._obs.get(t)
            if dq is None:
                dq = self._obs[t] = deque(maxlen=MAX_OBSERVATIONS)
            dq.append((now, cost.engine_s))
            tot = self._totals.get(t)
            if tot is None:
                tot = self._totals[t] = {
                    "requests": 0, "hits": 0, "misses": 0,
                    "iterations": 0, "engine_s": 0.0,
                    "exchange_bytes": 0, "direction_switches": 0,
                }
            tot["requests"] += 1
            tot["hits" if cost.outcome == "hit" else "misses"] += 1
            tot["iterations"] += cost.iterations
            tot["engine_s"] += cost.engine_s
            tot["exchange_bytes"] += cost.exchange_bytes
            tot["direction_switches"] += cost.direction_switches
        lbl = {"tenant": t}
        metrics.counter("lux_query_cost_requests_total",
                        dict(lbl, outcome=cost.outcome)).inc()
        metrics.counter("lux_query_cost_engine_seconds", lbl).inc(
            max(0.0, cost.engine_s))
        metrics.counter("lux_query_cost_exchange_bytes", lbl).inc(
            max(0, cost.exchange_bytes))
        metrics.counter("lux_query_cost_iterations_total", lbl).inc(
            max(0, cost.iterations))

    def totals(self) -> Dict[str, dict]:
        with self._lock:
            return {t: dict(v) for t, v in self._totals.items()}

    def snapshot(self) -> dict:
        """The ``/costz`` payload: cumulative totals plus rolling
        engine-seconds quantiles per window per tenant."""
        now = self._now()
        out = {"schema": "costz.v1", "totals": self.totals(),
               "windows": {}}
        with self._lock:
            items = [(t, list(dq)) for t, dq in self._obs.items()]
        for w in self.windows:
            wkey = f"{int(w)}s"
            block = {}
            for tenant, obs in items:
                cut = now - w
                lo = bisect.bisect_right(obs, (cut, float("inf")))
                xs = sorted(x for _ts, x in obs[lo:])
                if not xs:
                    continue
                block[tenant] = {
                    "count": len(xs),
                    "engine_s_p50": _quantile(xs, 0.50),
                    "engine_s_p99": _quantile(xs, 0.99),
                }
            out["windows"][wkey] = block
        return out
