"""Run telemetry: the metrics registry and the structured event stream.

Counterpart of ``enterprise_warp_tpu/utils/telemetry.py``, with the same
names, event types, field names and ``EWT_*`` switches:

- :func:`registry` — a process-wide registry of counters, gauges and
  streaming histograms with labels (``nonfinite_eval{where=block}``),
  snapshot-able to JSON. Every increment is host-side Python.
- :class:`RunRecorder` / :func:`run_scope` — the JSONL event stream
  ``<run_dir>/events.jsonl`` (buffered, flushed every ``flush_every``
  events or ``flush_interval`` seconds as one ``O_APPEND`` write, a torn
  tail healed on open) with typed events: ``run_start`` (config hash,
  torch and CUDA versions, the device), ``run_lineage``, ``heartbeat``,
  ``checkpoint``, ``run_end``, and from the resilience layer ``fault``,
  ``retry``, ``demotion``, ``anomaly``, ``kernel_health``,
  ``psr_quarantined``, ``ckpt_corrupt``, ``data_quality``.
- :data:`KNOWN_EVENT_TYPES` / :data:`KNOWN_HEARTBEAT_FIELDS` /
  :func:`check_stream` — the stream vocabulary, a copy of
  ``tools/report.py``'s (``tests/test_torch_telemetry.py`` holds the two
  equal), so a stream can be checked where the JAX package is absent.

Heartbeats and ``run_end`` refresh the OpenMetrics textfile and a run
scope arms the ``/metrics`` endpoint (``utils/metricsexport.py``; both
off without their switches). The device diagnostics plane
(``utils/devicemetrics.py``) adds the ``mixing`` event, the
``rhat_stream``/``ess_stream`` heartbeat keys (PT, HMC), HMC's energy-error
and nested sampling's walk-scale keys, and the gauges ``swap_rate{edge}``,
``rung_accept{rung}``, ``stream_rhat``, ``stream_ess``, ``walk_scale`` and
``budget_exhaust_frac``, all in the vocabulary below.

The port has no jit, so the reference's ``traced`` wrapper and the
``compile``, ``cost_analysis`` and ``retraces{fn=}`` records it makes
have no counterpart here. ``pallas_path`` in a heartbeat is the port's
route counter ``ops/routes.py:ROUTES``.

``EWT_TELEMETRY=0`` turns everything off: recorders become no-ops and the
registry hands out no-op metrics. Heartbeats are emitted only at the
samplers' existing block-boundary host syncs; nothing here touches a
device tensor.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid

__all__ = ["enabled", "registry", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "RunRecorder", "run_scope", "active_recorder",
           "set_flight_hook", "last_lineage", "LINEAGE_REASONS",
           "route_summary", "KNOWN_EVENT_TYPES", "KNOWN_HEARTBEAT_FIELDS",
           "check_stream"]


def enabled() -> bool:
    """Telemetry master switch: ``EWT_TELEMETRY=0`` disables everything."""
    return os.environ.get("EWT_TELEMETRY", "1") != "0"


# ------------------------------------------------------------------ #
#  metrics registry                                                   #
# ------------------------------------------------------------------ #

def _metric_key(name: str, labels: dict) -> str:
    """``name{k=v,...}`` with sorted label keys."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone host-side counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n


class Gauge:
    """Last-value-wins gauge."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = float(v)


class Histogram:
    """Streaming histogram: exact count/sum/min/max plus quantiles from a
    bounded deterministic reservoir (every k-th observation once the
    buffer is full). An empty histogram's quantiles are None;
    ``samples_dropped`` says how many observations the reservoir no longer
    holds."""

    __slots__ = ("count", "sum", "min", "max", "_buf", "_cap", "_stride")

    def __init__(self, cap: int = 4096):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._buf = []
        self._cap = cap
        self._stride = 1

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if self.count % self._stride == 0:
            self._buf.append(v)
            if len(self._buf) >= self._cap:
                # decimate: keep every other sample, double the stride
                self._buf = self._buf[::2]
                self._stride *= 2

    @property
    def samples_dropped(self) -> int:
        return self.count - len(self._buf)

    def quantile(self, q: float):
        if not self._buf:
            return None
        q = min(max(float(q), 0.0), 1.0)
        s = sorted(self._buf)
        return s[min(int(q * len(s)), len(s) - 1)]

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.5), "p90": self.quantile(0.9),
                "p99": self.quantile(0.99),
                "samples_dropped": self.samples_dropped}


class _NoopMetric:
    """Stands in for every metric type when telemetry is disabled."""

    __slots__ = ()
    value = None
    count = 0
    samples_dropped = 0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def quantile(self, q):
        return None

    def summary(self):
        return {}


_NOOP_METRIC = _NoopMetric()


class MetricsRegistry:
    """Process-wide named metrics with labels; JSON-snapshot-able."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    def _get(self, store, cls, name, labels):
        if not enabled():
            return _NOOP_METRIC
        key = _metric_key(name, labels)
        with self._lock:
            m = store.get(key)
            if m is None:
                m = store[key] = cls()
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.summary()
                               for k, h in self._histograms.items()},
            }

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide metrics registry."""
    return _REGISTRY


def route_summary():
    """``{kernel: {path: count}}`` from the port's route counter
    (``ops/routes.py:ROUTES``), the heartbeat's ``pallas_path`` field;
    empty before any kernel was routed."""
    from ..ops.routes import ROUTES
    out: dict = {}
    for (kernel, path), count in sorted(ROUTES.items()):
        out.setdefault(kernel, {})[path] = int(count)
    return out


# ------------------------------------------------------------------ #
#  the stream vocabulary (a copy of tools/report.py's)                #
# ------------------------------------------------------------------ #

KNOWN_EVENT_TYPES = frozenset({
    "run_start", "run_end", "compile", "heartbeat", "checkpoint",
    "span", "cost_analysis", "anomaly", "fault", "retry", "demotion",
    "run_lineage", "metrics_export", "mixing",
    "serve_request", "serve_result", "serve_summary",
    "serve_rejected", "serve_expired", "serve_quarantined",
    "serve_stage", "serve_requeue", "slo_breach", "slo_config",
    "ckpt_corrupt",
    "data_quality", "kernel_health", "psr_quarantined",
    "flow_train", "flow_rescore",
    "mesh_stats",
})

KNOWN_HEARTBEAT_FIELDS = frozenset({
    "phase", "step", "nsamp", "iteration", "round", "steps",
    "accept", "swap", "ladder", "evals_per_s", "evals_total",
    "cache_hit_rate", "host_sync_wall_s", "block_bubble_s",
    "max_lnl", "wall_s", "bubble_s", "host_sync_s",
    "rhat", "ess", "rhat_stream", "ess_stream", "diag_mode",
    "accept_rung", "swap_rung", "fam_accept",
    "rss_bytes", "hbm_in_use_bytes", "hbm_peak_bytes", "pallas_path",
    "eps", "divergences", "warmup", "energy_err_mean",
    "energy_err_std", "energy_err_max", "eps_min", "eps_max",
    "lnz", "dlogz", "scale", "insertion_ks", "converged",
    "scale_min", "scale_max", "budget_exhaust_frac",
    "first_accept_frac",
    "queue_depth", "queue_depth_max", "queue_age_ms", "shed_per_s",
    "batch_fill", "dispatches", "requests_done",
    "requests_rejected", "requests_expired", "requests_quarantined",
    "elbo", "best_lnpost", "is_ess",
    "loss",
    "jitter_engaged", "refine_diverged", "kernel_cond",
    "shard_skew", "collective_wall_ms", "straggler_index",
    "process_index",
})


def load_events(path):
    """``(events, dropped)``: every parseable JSON-object line of an
    ``events.jsonl``, and the count of torn or malformed ones."""
    events, dropped = [], 0
    with open(path, "rb") as fh:
        for raw in fh:
            try:
                ev = json.loads(raw)
            except ValueError:
                dropped += 1
                continue
            if isinstance(ev, dict):
                events.append(ev)
            else:
                dropped += 1
    return events, dropped


def check_stream(path):
    """``tools/report.py --check`` on one stream: returns ``(problems,
    messages)`` — torn records, unknown event types, unknown heartbeat
    fields, unbalanced spans and events without a numeric ``t``."""
    events, dropped = load_events(path)
    msgs = []
    if dropped:
        msgs.append(f"{dropped} torn/malformed record(s)")
    problems = dropped
    unknown = sorted({str(ev.get("type")) for ev in events
                      if ev.get("type") not in KNOWN_EVENT_TYPES})
    n_unknown = sum(ev.get("type") not in KNOWN_EVENT_TYPES
                    for ev in events)
    if n_unknown:
        problems += n_unknown
        msgs.append(f"unknown event type(s): {unknown}")
    bad_hb = [k for ev in events if ev.get("type") == "heartbeat"
              for k in ev if k not in ("t", "type")
              and k not in KNOWN_HEARTBEAT_FIELDS]
    if bad_hb:
        problems += len(bad_hb)
        msgs.append(f"unknown heartbeat field(s): {sorted(set(bad_hb))}")
    open_ids = {}
    for ev in events:
        if ev.get("type") != "span":
            continue
        if ev.get("ev") == "B":
            open_ids[ev.get("id")] = ev.get("name")
        elif ev.get("ev") == "E" and ev.get("id") in open_ids:
            open_ids.pop(ev.get("id"))
        else:
            problems += 1
            msgs.append(f"unmatched span record {ev}")
    if open_ids:
        problems += len(open_ids)
        msgs.append(f"{len(open_ids)} span(s) never closed")
    if any(not isinstance(ev.get("t"), (int, float)) for ev in events):
        problems += 1
        msgs.append("event missing/invalid 't'")
    return problems, msgs


# ------------------------------------------------------------------ #
#  run recorder: structured JSONL event stream                        #
# ------------------------------------------------------------------ #

def _json_default(o):
    tolist = getattr(o, "tolist", None)
    if tolist is not None:
        return tolist()
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


_INF = float("inf")
_NINF = float("-inf")


def _sanitize(v):
    """Strict-JSON cleanup: numpy scalars/arrays become plain values and
    non-finite floats become None (the schema promises ``null``, never
    ``Infinity``)."""
    tolist = getattr(v, "tolist", None)
    if tolist is not None and not isinstance(v, (str, bytes)):
        v = tolist()
    if isinstance(v, float):
        return v if v == v and v not in (_INF, _NINF) else None
    if isinstance(v, dict):
        return {k: _sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_sanitize(x) for x in v]
    return v


def _sanitize_dumps(rec) -> str:
    return json.dumps(_sanitize(rec), default=_json_default)


# flight-recorder mirror hook (utils/flightrec.py): every recorded event
# is also appended to the flight recorder's ring when one is live
_FLIGHT_HOOK = None


def set_flight_hook(hook):
    """Install (or clear, with None) the per-event flight-recorder mirror."""
    global _FLIGHT_HOOK
    _FLIGHT_HOOK = hook


#: the ``run_lineage`` event's ``reason`` vocabulary: how this session
#: relates to the previous one in the same stream
LINEAGE_REASONS = ("fresh", "resume", "demotion", "preempt-restart")

_LINEAGE_SCAN_BYTES = 1 << 19
_LAST_LINEAGE: dict | None = None


def last_lineage() -> dict | None:
    """Identity of the most recent (possibly closed) recorder in this
    process: ``{"run_id", "campaign", "parent", "reason", "run_dir"}``,
    or None if none ever started."""
    return _LAST_LINEAGE


def _scan_prev_session(path: str) -> dict:
    """Summary of the LAST session in an existing stream's tail:
    ``{"run_id", "campaign", "end_status", "end_reason", "demoted"}``."""
    out = {"run_id": None, "campaign": None, "end_status": None,
           "end_reason": None, "demoted": False}
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(size - _LINEAGE_SCAN_BYTES, 0))
            tail = fh.read()
    except OSError:
        return out
    if size > _LINEAGE_SCAN_BYTES:
        tail = tail.split(b"\n", 1)[-1]
    for raw in tail.splitlines():
        try:
            ev = json.loads(raw)
        except ValueError:
            continue
        if not isinstance(ev, dict):
            continue
        t = ev.get("type")
        if t == "run_start":
            out = {"run_id": ev.get("run_id"),
                   "campaign": ev.get("campaign"),
                   "end_status": None, "end_reason": None,
                   "demoted": False}
        elif t == "run_lineage":
            out["run_id"] = ev.get("run_id") or out["run_id"]
            out["campaign"] = ev.get("campaign") or out["campaign"]
        elif t == "run_end":
            out["end_status"] = ev.get("status")
            out["end_reason"] = ev.get("reason")
        elif t == "demotion":
            out["demoted"] = True
    return out


def _classify_reason(prev: dict) -> str:
    if prev.get("run_id") is None:
        return "fresh"
    if prev.get("end_reason") == "preempted":
        return "preempt-restart"
    if prev.get("demoted") and prev.get("end_status") != "ok":
        return "demotion"
    return "resume"


def _device_fingerprint() -> dict:
    """torch, CUDA and the device, for ``run_start``."""
    import torch
    info = {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda}
    if torch.cuda.is_available():
        info["backend"] = "cuda"
        info["device_count"] = torch.cuda.device_count()
        info["device_name"] = torch.cuda.get_device_name(0)
    else:
        info["backend"] = "cpu"
        info["device_count"] = 0
    return info


class RunRecorder:
    """Structured JSONL event stream for one run directory.

    Events are buffered and flushed to ``<run_dir>/events.jsonl`` every
    ``flush_every`` events or ``flush_interval`` seconds, each flush one
    ``write`` on a file opened for appending. Every event is one JSON
    object per line with at least ``t`` (unix seconds) and ``type``.

    Run lineage: every recorder mints a ``run_id`` and works out its
    parent, from ``EWT_PARENT_RUN_ID`` / ``EWT_LINEAGE_REASON`` (consumed
    once) or from the tail of the existing stream; the campaign id comes
    from ``EWT_CAMPAIGN_ID``, else the previous session, else is minted.
    ``run_start`` is followed by a ``run_lineage`` event. Events may come
    from the sampler's thread and its block-writer thread: a lock keeps
    the buffer and its flushes whole.

    Processes: every process records its own stream, ``events.jsonl`` on
    the primary and ``events.<i>.jsonl`` on process ``i`` (telemetry is
    exempt from the single-writer rule because the name carries the
    index; ``tools/report.py`` stitches the streams); with more than one
    process ``run_start`` and every heartbeat carry ``process_index``."""

    def __init__(self, run_dir: str, flush_every: int = 20,
                 flush_interval: float = 5.0):
        self.run_dir = run_dir
        self.process_index, self.process_count = _host_identity()
        self.path = os.path.join(
            run_dir, "events.jsonl" if self.process_index == 0
            else f"events.{self.process_index}.jsonl")
        self.enabled = enabled()
        self._buf: list = []
        self._flush_every = flush_every
        self._flush_interval = flush_interval
        self._last_flush = time.time()
        self._in_flush = False
        self._ended = False
        self._lock = threading.RLock()
        self.run_id = uuid.uuid4().hex[:12]
        self.campaign = None
        self.parent_run_id = None
        self.lineage_reason = "fresh"
        if self.enabled:
            os.makedirs(run_dir, exist_ok=True)
            self._heal_torn_tail()
            self._resolve_lineage()

    def _resolve_lineage(self):
        prev = _scan_prev_session(self.path)
        env_parent = os.environ.pop("EWT_PARENT_RUN_ID", None)
        env_reason = os.environ.pop("EWT_LINEAGE_REASON", None)
        if env_reason not in LINEAGE_REASONS:
            env_reason = None
        self.parent_run_id = env_parent or prev.get("run_id")
        if self.parent_run_id is None:
            self.lineage_reason = "fresh"
        elif env_reason is not None:
            self.lineage_reason = env_reason
        elif prev.get("run_id") is not None:
            self.lineage_reason = _classify_reason(prev)
        else:
            self.lineage_reason = "resume"
        self.campaign = (os.environ.get("EWT_CAMPAIGN_ID")
                         or prev.get("campaign")
                         or uuid.uuid4().hex[:12])

    def _heal_torn_tail(self):
        """Truncate a partial final record (a process killed mid-write)
        so the new session's first event is not welded onto it."""
        try:
            with open(self.path, "rb+") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                if size == 0:
                    return
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) == b"\n":
                    return
                chunk = 1 << 16
                end = size
                keep = 0
                while end > 0:
                    start = max(end - chunk, 0)
                    fh.seek(start)
                    tail = fh.read(end - start)
                    cut = tail.rfind(b"\n")
                    if cut >= 0:
                        keep = start + cut + 1
                        break
                    end = start
                fh.truncate(keep)
        except OSError:
            pass    # absent file; flush() reports an unwritable dir

    def event(self, type: str, **fields):
        """Append one typed event (buffered)."""
        if not self.enabled:
            return
        rec = {"t": round(time.time(), 3), "type": type}
        rec.update(fields)
        if _FLIGHT_HOOK is not None:
            _FLIGHT_HOOK(rec)
        with self._lock:
            self._buf.append(_sanitize_dumps(rec))
            if (len(self._buf) >= self._flush_every
                    or time.time() - self._last_flush
                    >= self._flush_interval):
                self.flush()

    def flush(self):
        with self._lock:
            self._flush_locked()

    def _flush_locked(self):
        if not self._buf or not self.enabled or self._in_flush:
            return
        # fault site events.flush: torn/kill truncate the payload
        # mid-record; the guard keeps the injection's own fault event from
        # recursing into this flush
        self._in_flush = True
        try:
            from ..resilience import faults
            spec = faults.fire("events.flush", write=True, path=self.path)
        finally:
            self._in_flush = False
        payload = "\n".join(self._buf) + "\n"
        self._buf = []
        self._last_flush = time.time()
        if spec is not None and spec.kind in ("torn", "kill"):
            payload = faults.torn_bytes(spec, payload)
        try:
            with open(self.path, "a") as fh:
                fh.write(payload)
                if spec is not None and spec.kind == "kill":
                    fh.flush()
                    faults.kill_now(spec)
        except OSError as exc:
            # telemetry never kills a run: an unwritable run dir turns the
            # recorder off for the rest of the run
            self.enabled = False
            from .logging import get_logger
            get_logger("ewt.telemetry").warning(
                "event-stream write to %s failed (%s); disabling "
                "telemetry recording for this run", self.path, exc)

    def close(self):
        self.flush()

    def run_start(self, **fields):
        """``run_start`` (the device fingerprint and the caller's fields),
        then the session's ``run_lineage``."""
        if not self.enabled:
            return
        global _LAST_LINEAGE
        info = dict(fields)
        info.setdefault("run_id", self.run_id)
        info.setdefault("campaign", self.campaign)
        if self.process_count > 1 or self.process_index:
            info.setdefault("process_index", self.process_index)
            info.setdefault("process_count", self.process_count)
        try:
            for k, v in _device_fingerprint().items():
                info.setdefault(k, v)
        except Exception:   # noqa: BLE001 — the fingerprint is best-effort
            pass
        self.event("run_start", **info)
        self.event("run_lineage", run_id=self.run_id,
                   campaign=self.campaign, parent=self.parent_run_id,
                   reason=self.lineage_reason, pid=os.getpid())
        _LAST_LINEAGE = {"run_id": self.run_id, "campaign": self.campaign,
                         "parent": self.parent_run_id,
                         "reason": self.lineage_reason,
                         "run_dir": self.run_dir}
        self.flush()        # the header must survive an early crash

    def heartbeat(self, **fields):
        if self.process_count > 1 or self.process_index:
            fields.setdefault("process_index", self.process_index)
        self.event("heartbeat", **fields)
        # the OpenMetrics textfile at heartbeat cadence
        # (utils/metricsexport.py; a no-op without EWT_METRICS_TEXTFILE)
        try:
            from .metricsexport import maybe_export
            maybe_export()
        except Exception:   # noqa: BLE001 — export never stops a run
            pass

    def checkpoint(self, **fields):
        self.event("checkpoint", **fields)

    def run_end(self, **fields):
        """``run_end``: status and the final registry snapshot; emitted
        once (the preemption path emits it before the scope closes)."""
        if not self.enabled or self._ended:
            return
        self._ended = True
        fields.setdefault("metrics", _REGISTRY.snapshot())
        self.event("run_end", **fields)
        self.flush()
        # the final textfile: the scrape target ends on this registry
        try:
            from .metricsexport import maybe_export
            maybe_export(force=True)
        except Exception:   # noqa: BLE001 — export never stops a run
            pass


class _NoopRecorder:
    """Inert recorder handed out when telemetry is off."""

    enabled = False
    run_dir = None
    path = None
    run_id = None
    campaign = None
    parent_run_id = None
    lineage_reason = None
    process_index = 0
    process_count = 1

    def event(self, *args, **fields):
        pass

    run_start = heartbeat = checkpoint = run_end = event

    def flush(self):
        pass

    def close(self):
        pass


_NOOP_RECORDER = _NoopRecorder()
_ACTIVE: list = []


def active_recorder():
    """The innermost live recorder (None outside any run scope)."""
    return _ACTIVE[-1] if _ACTIVE else None


def _is_primary() -> bool:
    """``parallel.distributed.is_primary``, True where that fails:
    telemetry never stops a run."""
    try:
        from ..parallel.distributed import is_primary
        return is_primary()
    except Exception:   # noqa: BLE001 — telemetry never kills a run
        return True


def _host_identity() -> tuple:
    """``(process_index, process_count)``, ``(0, 1)`` where the
    distributed layer fails: telemetry never stops a run."""
    try:
        from ..parallel.distributed import process_count, process_index
        return process_index(), process_count()
    except Exception:   # noqa: BLE001 — telemetry never kills a run
        return 0, 1


def _preempted() -> bool:
    from ..resilience.supervisor import preemption_requested
    return preemption_requested()


@contextlib.contextmanager
def run_scope(run_dir, **start_fields):
    """Open (or join) the event stream of ``run_dir``.

    The outermost scope owns the stream: ``run_start`` on entry, and on
    exit ``run_end`` (status ``ok`` or ``error``, with a registry
    snapshot; after a SIGTERM, ``reason="preempted"`` and then the flight
    recorder's ring dump). Nested scopes (a sampler inside
    ``sample_to_convergence`` or the CLI) reuse the active recorder. Yields a recorder, a
    no-op one when telemetry is off or ``run_dir`` is None. The outermost
    scope also binds the flight recorder to the run and, on exit, writes
    ``<run_dir>/trace.json`` when spans are on. Every process records its
    own stream (:class:`RunRecorder`); the artifacts (the flight
    recorder's dumps, ``trace.json``, the metrics exporters) are the
    primary's alone."""
    if _ACTIVE:
        yield _ACTIVE[-1]
        return
    if not enabled() or run_dir is None:
        yield _NOOP_RECORDER
        return
    from . import profiling
    from .flightrec import flight_recorder
    rec = RunRecorder(run_dir)
    rec.run_start(**start_fields)
    _ACTIVE.append(rec)
    primary = _is_primary()
    if primary:
        flight_recorder().bind(run_dir)
        # the metrics exporters (utils/metricsexport.py): the /metrics
        # endpoint (EWT_METRICS_PORT) and a metrics_export event for
        # each armed exporter; inert without their switches
        try:
            from .metricsexport import autostart
            autostart(rec)
        except Exception:   # noqa: BLE001 — export never stops a run
            pass
    status = "ok"
    try:
        yield rec
    except BaseException:
        status = "error"
        raise
    finally:
        # the error-path dump fires while this recorder is active, so its
        # anomaly event lands in the stream before run_end
        if status == "error":
            flight_recorder().anomaly("run_scope_error", run_dir=run_dir,
                                      once_key=f"run_scope_error:{run_dir}")
        elif _preempted():
            rec.run_end(status=status, reason="preempted")
            flight_recorder().anomaly("preempted", run_dir=run_dir,
                                      once_key=f"preempted:{run_dir}")
        _ACTIVE.remove(rec)
        if primary:
            flight_recorder().unbind()
            profiling.flush_trace(run_dir)
        profiling.capture_stop()
        rec.run_end(status=status)
        rec.close()
