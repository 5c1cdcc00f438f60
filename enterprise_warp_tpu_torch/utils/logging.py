"""Structured logging, phase timing and profiler capture.

Counterpart of ``enterprise_warp_tpu/utils/logging.py``:

- ``get_logger`` — stdlib logging with one uniform format, the level from
  the ``EWT_LOG`` environment variable (default INFO);
- ``PhaseTimer`` / ``log_phase`` — named wall-clock phases reported on
  exit;
- ``EvalRateMeter`` — the likelihood-evaluations-per-second counter;
- ``profiler_trace`` — a ``torch.profiler`` capture of the enclosed block
  written as a Chrome trace into a directory (a no-op without one).
"""

from __future__ import annotations

import contextlib
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


class PhaseTimer:
    """Accumulates named wall-clock phases (``with timer.phase(name):``);
    ``report()`` returns the totals, and each phase is logged on exit
    when a logger is given."""

    def __init__(self, logger: logging.Logger | None = None):
        self.durations: dict = {}
        self.counts: dict = {}
        self._log = logger

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if self._log is not None:
                self._log.info("phase %s: %.3fs (total %.3fs over %d)",
                               name, dt, self.durations[name],
                               self.counts[name])

    def report(self) -> dict:
        return dict(self.durations)


@contextlib.contextmanager
def log_phase(name: str, logger: logging.Logger | None = None):
    """One named phase, logged on exit."""
    log = logger or get_logger()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log.info("phase %s: %.3fs", name, time.perf_counter() - t0)


@contextlib.contextmanager
def profiler_trace(trace_dir: str | None):
    """Capture the enclosed block with ``torch.profiler`` (CPU and, where
    a card is present, CUDA activity) into ``<trace_dir>/trace.json``; a
    no-op when ``trace_dir`` is None."""
    if not trace_dir:
        yield None
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
