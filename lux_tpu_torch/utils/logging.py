"""Category loggers, the counterpart of ``lux_tpu/utils/logging.py``.

``get_logger("engine")`` is the ``lux_tpu_torch.engine`` logger. The first
call gives the ``lux_tpu_torch`` root one stderr handler and the level
``LUX_LOG`` names (default INFO), so an executor's notes, such as a
logged exchange downgrade, show without any set-up by the caller.
``reconfigure()`` re-reads ``LUX_LOG`` (CLI flags set env vars after
first import). The ``lux_tpu_torch.perf`` category carries the
end-of-run telemetry table (``obs/report.py``).
"""

from __future__ import annotations

import logging
import sys

from lux_tpu_torch.utils import flags

ROOT = "lux_tpu_torch"
PERF_CATEGORY = "perf"


class _StderrHandler(logging.StreamHandler):
    """Writes to whatever ``sys.stderr`` is when a record is emitted."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


_configured = False


def _apply_level(root: logging.Logger) -> None:
    level = (flags.get("LUX_LOG") or "INFO").upper()
    root.setLevel(getattr(logging, level, logging.INFO))


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger(ROOT)
    handler = _StderrHandler()
    handler.setFormatter(
        logging.Formatter("{%(name)s} %(levelname)s: %(message)s"))
    root.addHandler(handler)
    root.propagate = False
    _apply_level(root)


def reconfigure() -> None:
    """Re-read ``LUX_LOG`` after the environment changed. Keeps the one
    stderr handler; only the level moves."""
    _configure()
    _apply_level(logging.getLogger(ROOT))


def get_logger(category: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"{ROOT}.{category}")


def perf_logger() -> logging.Logger:
    """The ``perf`` category the run-report writer logs to."""
    return get_logger(PERF_CATEGORY)
