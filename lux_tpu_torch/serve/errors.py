"""Serving-layer error taxonomy.

Each class maps to one HTTP status in serve/http.py and one `obs`
counter, so clients and dashboards see the same three failure modes:
overload (backpressure), timeout (deadline shed), and bad input.
"""

from __future__ import annotations


class ServeError(Exception):
    """Base class for serving failures.

    ``retry_after_s`` (when not None) is surfaced by serve/http.py as a
    ``Retry-After`` header so well-behaved clients back off instead of
    hammering an overloaded or tripped server."""

    http_status = 500
    retry_after_s = None


class QueueFullError(ServeError):
    """The bounded admission queue is full — backpressure, not deadlock.

    The client should retry with backoff; the server sheds instantly
    instead of queueing unboundedly (HTTP 429)."""

    http_status = 429
    retry_after_s = 1.0


class DeadlineExceededError(ServeError):
    """The request's deadline expired before execution started (or the
    batch it rode in missed it); HTTP 504."""

    http_status = 504
    retry_after_s = 1.0


class BadQueryError(ServeError):
    """Malformed query: unknown app, missing/out-of-range parameters
    (HTTP 400)."""

    http_status = 400


class SnapshotSwapError(ServeError):
    """A snapshot hot-swap could not complete (engine warmup timed out or
    failed). The previous version keeps serving — the swap is abandoned,
    not half-applied; the client may retry (HTTP 503)."""

    http_status = 503
    retry_after_s = 2.0


class PoolOverBudgetError(ServeError):
    """The HBM-budgeted engine pool cannot admit this build: its
    memcap.v1-predicted footprint exceeds the per-device budget
    (LUX_HBM_BUDGET_BYTES, default the card's capacity x
    LUX_HBM_BUDGET_FRAC) even after evicting every cold engine. Shed
    with 503 + Retry-After. Advisory until ROADMAP C6 is repaired: the
    predicted footprint under-prices some engines on the card, so a
    build that is admitted may still not fit."""

    http_status = 503

    def __init__(self, msg: str, retry_after_s: float = 2.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class CircuitOpenError(ServeError):
    """The circuit breaker for this (program, fingerprint) is open: the
    engine failed ``LUX_BREAKER_THRESHOLD`` consecutive times and is
    being rebuilt/probed in the background. Shed with 503 + Retry-After
    instead of burning the batcher on an executor known to be bad."""

    http_status = 503

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
