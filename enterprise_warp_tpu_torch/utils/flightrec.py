"""Flight recorder: a bounded ring of recent events and anomaly dumps.

Counterpart of ``enterprise_warp_tpu/utils/flightrec.py``. A long run that
goes non-finite leaves a scene to replay, not only a stack trace:

- :class:`FlightRecorder` — a bounded ring of recent telemetry events
  (fed by ``telemetry.RunRecorder.event`` through a hook) and the last
  known sampler state (:meth:`~FlightRecorder.note_state`: step, block,
  generator state, outdir), host-side appends only;
- :meth:`~FlightRecorder.anomaly` — writes ``<run_dir>/anomaly/``:
  ``anomaly-NN-<reason>.json`` per dump and ``anomaly.json`` (the first)
  with the reason, the offending parameter vectors and values (non-finite
  floats kept as ``"NaN"``/``"Infinity"`` strings), the state, the ring
  tail, the kernel routes and launches in force (``ops/routes.py``: the
  port has no probe ladder, so these stand in for the reference's probe
  verdicts), the registry snapshot and the device-memory watermark and
  live-block report; then arms a ``torch.profiler`` window
  (``EWT_PROFILE_CAPTURE``);
- fatal-exit handlers — bound to a run, ``atexit`` and ``SIGTERM`` dump
  the ring if the process dies with a run scope open.

``EWT_FLIGHTREC=1`` turns it on (master-gated by ``EWT_TELEMETRY``);
dumps are capped at three per process.
"""

from __future__ import annotations

import atexit
import collections
import os
import signal
import threading

from . import telemetry
from .profiling import walltime

__all__ = ["enabled", "flight_recorder", "FlightRecorder", "RING_DEFAULT"]

RING_DEFAULT = 256
_MAX_DUMPS = 3


def enabled() -> bool:
    """Opt-in (``EWT_FLIGHTREC=1``), master-gated by ``EWT_TELEMETRY``."""
    return telemetry.enabled() \
        and os.environ.get("EWT_FLIGHTREC", "0") == "1"


_INF = float("inf")


def _forensic(v, depth=0):
    """JSON encoding that keeps non-finite values as strings."""
    if depth > 6:
        return str(v)
    tolist = getattr(v, "tolist", None)
    if tolist is not None and not isinstance(v, (str, bytes)):
        v = tolist()
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v == _INF:
            return "Infinity"
        if v == -_INF:
            return "-Infinity"
        return v
    if isinstance(v, dict):
        return {str(k): _forensic(x, depth + 1) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_forensic(x, depth + 1) for x in v]
    if isinstance(v, (int, str, bool)) or v is None:
        return v
    return str(v)


def _route_verdicts():
    """The kernel routes, launches and designs in force (the port's
    counterpart of the reference's Pallas probe verdicts)."""
    from ..ops.routes import DESIGNS, LAUNCHES, ROUTES, kernels_enabled
    return {"kernels_enabled": kernels_enabled(),
            "routes": {f"{k}:{p}": int(n) for (k, p), n in ROUTES.items()},
            "launches": dict(LAUNCHES),
            "designs": {f"{k}:{d}": int(n) for (k, d), n in DESIGNS.items()}}


class FlightRecorder:
    """One per process (via :func:`flight_recorder`); ``bind``/``unbind``
    tie it to the outermost run scope."""

    def __init__(self, ring_len: int = RING_DEFAULT):
        self._ring = collections.deque(maxlen=int(ring_len))
        self._state: dict = {}
        # re-entrant: a SIGTERM can land inside anomaly()'s dedup block
        self._lock = threading.RLock()
        self.run_dir = None
        self.dumps = 0
        self._handlers_installed = False

    def record(self, type: str, **fields):
        rec = {"t": round(walltime(), 3), "type": type}
        rec.update(fields)
        self._ring.append(rec)

    def record_event(self, rec: dict):
        self._ring.append(rec)

    def note_state(self, **meta):
        self._state.update(meta)

    def tail(self, n=None):
        items = list(self._ring)
        return items if n is None else items[-int(n):]

    def bind(self, run_dir: str):
        self.run_dir = run_dir
        self._install_handlers()

    def unbind(self):
        self.run_dir = None

    def _install_handlers(self):
        if self._handlers_installed:
            return
        self._handlers_installed = True
        atexit.register(self._atexit_dump)
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                try:
                    self.anomaly("fatal_signal", signum=int(signum))
                finally:
                    if callable(prev):
                        prev(signum, frame)
                    elif prev is signal.SIG_IGN:
                        pass
                    else:
                        signal.signal(signal.SIGTERM, signal.SIG_DFL)
                        os.kill(os.getpid(), signum)

            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):
            pass    # not the main thread: atexit only

    def _atexit_dump(self):
        if telemetry.active_recorder() is not None \
                and self.run_dir is not None:
            self.anomaly("atexit_with_open_run")

    def anomaly(self, reason: str, run_dir=None, once_key=None, **payload):
        """Write the dump (module docstring) and arm a profiler window.
        Returns the dump path, or None when disabled, over the cap or
        already dumped for ``once_key``. Never raises."""
        if not enabled():
            return None
        run_dir = run_dir or self.run_dir
        # the dumps share the run directory's anomaly/ path: the primary
        # process alone writes them
        if run_dir is None or self.dumps >= _MAX_DUMPS \
                or not telemetry._is_primary():
            return None
        with self._lock:
            key = once_key or reason
            seen = self._state.setdefault("_dumped_keys", set())
            if key in seen:
                return None
            seen.add(key)
            self.dumps += 1
        try:
            return self._write_dump(reason, run_dir, payload)
        except Exception as exc:   # noqa: BLE001 — never kill the run
            from .logging import get_logger
            get_logger("ewt.flightrec").warning("anomaly dump failed (%r)",
                                                exc)
            return None

    def _write_dump(self, reason, run_dir, payload):
        from ..io.writers import atomic_write_json
        from .logging import get_logger
        from .profiling import (capture_arm, live_buffer_report,
                                memory_watermark)
        adir = os.path.join(run_dir, "anomaly")
        os.makedirs(adir, exist_ok=True)
        state = {k: v for k, v in self._state.items()
                 if not k.startswith("_")}
        safe_reason = "".join(c if c.isalnum() or c in "-_" else "_"
                              for c in reason)[:48]
        doc = {
            "reason": reason,
            "t": round(walltime(), 3),
            "run_dir": run_dir,
            "state": _forensic(state),
            "payload": _forensic(payload),
            "ring_tail": _forensic(self.tail()),
            "kernels": _route_verdicts(),
            "metrics": _forensic(telemetry.registry().snapshot()),
            "memory": {"watermark": memory_watermark(),
                       "live_buffers": live_buffer_report()},
        }
        path = os.path.join(adir,
                            f"anomaly-{self.dumps:02d}-{safe_reason}.json")
        atomic_write_json(path, doc, default=str)
        primary = os.path.join(adir, "anomaly.json")
        if not os.path.exists(primary):
            atomic_write_json(primary, doc, default=str)
        capture_arm()
        rec = telemetry.active_recorder()
        if rec is not None:
            rec.event("anomaly", reason=reason, dump=path)
            rec.flush()
        get_logger("ewt.flightrec").warning(
            "anomaly '%s': forensics dumped to %s", reason, path)
        return path


class _NoopFlightRecorder:
    """Inert twin handed out when flight recording is off."""

    run_dir = None
    dumps = 0

    def record(self, *a, **k):
        pass

    record_event = note_state = record

    def tail(self, n=None):
        return []

    def bind(self, run_dir):
        pass

    def unbind(self):
        pass

    def anomaly(self, *a, **k):
        return None


_NOOP = _NoopFlightRecorder()
_RECORDER = None


def flight_recorder():
    """The process-wide flight recorder (the inert twin when disabled),
    registered as the telemetry mirror hook on first enabled use."""
    global _RECORDER
    if not enabled():
        return _NOOP
    if _RECORDER is None:
        try:
            ring_len = int(os.environ.get("EWT_FLIGHTREC_RING",
                                          str(RING_DEFAULT)))
        except ValueError:
            ring_len = RING_DEFAULT
        _RECORDER = FlightRecorder(ring_len=ring_len)
        telemetry.set_flight_hook(_RECORDER.record_event)
    return _RECORDER
