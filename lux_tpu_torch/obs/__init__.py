"""Telemetry: the metrics registry, Chrome-trace events and
request-scoped spans, copies of ``lux_tpu/obs/{metrics,trace,spans}.py``.

Environment knobs (optional; each a no-op when unset):

- ``LUX_TRACE=<path>`` — stream Chrome trace_event JSON-lines.
- ``LUX_SPANS=0`` — disable spans (default on).

``lux_tpu``'s ``iterlog``, ``report``, ``engobs``, ``ledger``,
``flight``, ``slo`` and ``prof`` are not ported yet (ROADMAP A14).
"""

from . import metrics, spans, trace

__all__ = ["metrics", "spans", "trace"]
