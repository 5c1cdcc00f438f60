"""Process-wide stdlib logging with one uniform format; the level comes
from the ``EWT_LOG`` environment variable (default INFO). The
``get_logger`` of the reference package, without its phase timers and
profiler hooks."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"
_configured = False


class _DynamicStderrHandler(logging.Handler):
    """Writes to the CURRENT ``sys.stderr`` at emit time, so pytest's
    capture or a later redirection still sees the log."""

    def emit(self, record):
        try:
            sys.stderr.write(self.format(record) + "\n")
        except Exception:   # noqa: BLE001 — logging must never raise
            self.handleError(record)


def get_logger(name: str = "ewt") -> logging.Logger:
    """Process-wide logger; level from ``EWT_LOG`` (default INFO). A
    host application that configured the root logger keeps its
    handlers and level."""
    global _configured
    if not _configured:
        root = logging.getLogger()
        if not root.handlers:
            handler = _DynamicStderrHandler()
            handler.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(handler)
            level = os.environ.get("EWT_LOG", "INFO").upper()
            root.setLevel(getattr(logging, level, logging.INFO))
        _configured = True
    return logging.getLogger(name)
