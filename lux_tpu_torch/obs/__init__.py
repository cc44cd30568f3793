"""Unified telemetry: metrics registry, Chrome-trace spans, per-iteration
run records, end-of-run reports, the run ledger, the flight recorder and
device-timeline captures; the counterpart of ``lux_tpu/obs``.

Environment knobs (all optional; with every one unset no live recorder
is made, and the executors launch and synchronise exactly as without
this package):

- ``LUX_METRICS=<path>`` — append one JSON line per run: the
  ``lux.run_telemetry.v1`` summary with per-iteration records and a
  metrics-registry snapshot.
- ``LUX_TRACE=<path>`` — stream Chrome trace_event JSON-lines
  (``tools/trace_summary.py`` reads them).
- ``LUX_LOG=<level>`` — log level for the ``lux_tpu_torch.*``
  categories, including the ``perf`` run-report table.
- ``LUX_SPANS=0`` — disable request-scoped spans (obs/spans.py; default
  on).
- ``LUX_FLIGHT_DIR=<dir>`` — arm the flight recorder (obs/flight.py):
  ring-buffered traces + iteration records, ``flight.v1`` postmortem
  dumps (``tools/flight_summary.py`` reads them).
- ``LUX_FLIGHT_CAPACITY=<n>`` / ``LUX_STATUSZ_WINDOWS=<s,s>`` — flight
  ring size and rolling SLO window lengths (obs/slo.py).
- ``LUX_ENGOBS=1`` — run the sharded executors phase-fenced
  (obs/engobs.py): exchange against compute seconds per iteration.
- ``LUX_LEDGER_DIR=<dir>`` — append one ``runrec.v1`` record per run
  (obs/ledger.py; the same bytes as ``lux_tpu``'s).
- ``LUX_PROF_DIR=<dir>`` — arm the device-timeline profiler
  (obs/prof.py) for ``profile_window`` and the SIGUSR2 toggle; a capture
  window (the CLIs' ``-profile DIR``) writes a torch.profiler Chrome
  trace that ``python -m lux_tpu_torch.tools.prof_summary`` reads.

Where the port differs from ``lux_tpu``: captures are torch.profiler's
Chrome traces, not XLA's (no HLO op maps; kernels are joined to regions
by device ranges and launch correlation ids); the parts of a
``LocalMesh`` share one card, so no interconnect peak prices their
exchange (``ici_frac`` stays None, "one card").
"""

from lux_tpu_torch.obs import (
    engobs,
    flight,
    ledger,
    metrics,
    prof,
    report,
    slo,
    spans,
    trace,
)
from lux_tpu_torch.obs.iterlog import (
    NULL_RECORDER,
    IterationRecorder,
    consume_compile_seconds,
    engine_label,
    gteps,
    note_compile_seconds,
    recorder_for,
    telemetry_enabled,
)
from lux_tpu_torch.utils import logging as _logging

__all__ = [
    "metrics", "trace", "report", "spans", "flight", "slo", "prof",
    "ledger", "engobs",
    "IterationRecorder", "NULL_RECORDER", "recorder_for",
    "telemetry_enabled", "gteps", "engine_label",
    "note_compile_seconds", "consume_compile_seconds",
    "reconfigure",
]


def reconfigure():
    """Re-read LUX_TRACE, LUX_FLIGHT_CAPACITY and LUX_LOG after the
    environment changed (CLI flags set env vars post-import)."""
    trace.reconfigure()
    flight.reconfigure()
    _logging.reconfigure()
