"""Category loggers, the counterpart of ``lux_tpu/utils/logging.py``.

``get_logger("engine")`` is the ``lux_tpu_torch.engine`` logger. The first
call gives the ``lux_tpu_torch`` root one stderr handler and the level
INFO, so an executor's notes, such as a logged exchange downgrade, show
without any set-up by the caller.
"""

from __future__ import annotations

import logging
import sys

ROOT = "lux_tpu_torch"


class _StderrHandler(logging.StreamHandler):
    """Writes to whatever ``sys.stderr`` is when a record is emitted."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr


_configured = False


def get_logger(category: str) -> logging.Logger:
    global _configured
    root = logging.getLogger(ROOT)
    if not _configured:
        _configured = True
        handler = _StderrHandler()
        handler.setFormatter(
            logging.Formatter("{%(name)s} %(levelname)s: %(message)s"))
        root.addHandler(handler)
        root.propagate = False
        root.setLevel(logging.INFO)
    return logging.getLogger(f"{ROOT}.{category}")
