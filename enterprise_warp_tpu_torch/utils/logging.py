"""Process-wide stdlib logging with one uniform format; the level comes
from the ``EWT_LOG`` environment variable (default INFO). The
``get_logger`` and ``EvalRateMeter`` of the reference package, without
its phase timers and profiler hooks."""

from __future__ import annotations

import logging
import os
import sys
import time

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


class EvalRateMeter:
    """Likelihood-evals/s counter: ``add(n)`` after each batch of work;
    ``rate()`` is the throughput since the meter started, ``window_rate()``
    the rate since its previous call. ``initial_total`` seeds ``total``
    from a resumed run's checkpoint, so the count stays cumulative across
    resumes while both rates measure this process's work only."""

    def __init__(self, initial_total: int = 0):
        self.t0 = time.monotonic()
        self.total = int(initial_total)
        self._base = int(initial_total)
        self._win_t = self.t0
        self._win_n = 0

    def add(self, nevals: int):
        self.total += int(nevals)
        self._win_n += int(nevals)

    def rate(self) -> float:
        dt = time.monotonic() - self.t0
        return (self.total - self._base) / dt if dt > 0 else 0.0

    def window_rate(self) -> float:
        now = time.monotonic()
        dt = now - self._win_t
        out = self._win_n / dt if dt > 0 else 0.0
        self._win_t, self._win_n = now, 0
        return out
