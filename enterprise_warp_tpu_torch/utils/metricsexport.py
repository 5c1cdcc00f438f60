"""OpenMetrics export of the process metrics registry.

Counterpart of ``enterprise_warp_tpu/utils/metricsexport.py``, the same
text byte for byte for every family the port emits (the reference's
``# HELP`` lines belong to its serving families, which the port does not
have yet). It serializes the registry (``utils/telemetry.py``)
to the `OpenMetrics text format
<https://prometheus.io/docs/specs/om/open_metrics_spec/>`_ and exposes it
two ways, both off unless asked for and both master-gated by
``EWT_TELEMETRY``:

- **Textfile** (``EWT_METRICS_TEXTFILE=<path>``): an atomic (tmp +
  rename) rewrite of the file at the samplers' heartbeat cadence, the
  node-exporter ``textfile collector`` contract. The write is throttled
  (:data:`_MIN_INTERVAL_S`) and forced once at ``run_end``, so the scrape
  target ends on the final registry.
- **HTTP endpoint** (``EWT_METRICS_PORT=<port>``): a stdlib
  ``http.server`` daemon thread serving ``GET /metrics``. Port 0 binds an
  ephemeral port; the address defaults to loopback (``EWT_METRICS_ADDR``
  overrides it).

Mapping: counters become ``<name>_total`` counter samples, gauges become
gauges (None-valued gauges are skipped), and the streaming histograms
export as OpenMetrics summaries (``quantile`` labels plus
``_count``/``_sum``). Metric names are prefixed ``ewt_`` and label values
are escaped per the spec. Every exposition ends with ``# EOF``.

When an exporter arms, the active run recorder receives a
``metrics_export`` event (mode, path or port).
"""

from __future__ import annotations

import os
import re
import threading

from . import telemetry
from .profiling import monotonic

__all__ = ["openmetrics", "textfile_path", "write_textfile",
           "maybe_export", "http_port", "start_http_server",
           "stop_http_server", "autostart"]

#: heartbeat-cadence throttle for the textfile rewrite: heartbeats
#: arrive once per sampler block (seconds apart); anything faster is a
#: storm the exporter must not amplify into file IO.
_MIN_INTERVAL_S = 1.0

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_KEY_RE = re.compile(r"^(?P<name>[^{]+)(?:\{(?P<labels>.*)\})?$")


def _split_key(key: str):
    """``name{k=v,...}`` (the registry's snapshot key format, see
    ``telemetry._metric_key``) back into ``(name, {k: v})``."""
    m = _KEY_RE.match(key)
    if m is None:
        return key, {}
    labels = {}
    raw = m.group("labels")
    if raw:
        for part in raw.split(","):
            k, _, v = part.partition("=")
            labels[k] = v
    return m.group("name"), labels


def _metric_name(name: str) -> str:
    return "ewt_" + _NAME_OK.sub("_", name)


def _escape(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labelstr(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{_NAME_OK.sub("_", k)}="{_escape(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def openmetrics(snapshot: dict | None = None) -> str:
    """The registry snapshot as one OpenMetrics exposition (see module
    docstring). ``snapshot`` defaults to the live registry."""
    snap = snapshot if snapshot is not None \
        else telemetry.registry().snapshot()
    # group samples per metric family so each family gets exactly one
    # TYPE line followed by all of its labeled samples
    families: dict = {}

    def fam(name, kind):
        return families.setdefault(name, {"type": kind, "lines": []})

    for key, value in sorted(snap.get("counters", {}).items()):
        name, labels = _split_key(key)
        mname = _metric_name(name)
        fam(mname, "counter")["lines"].append(
            f"{mname}_total{_labelstr(labels)} {_fmt(value)}")
    for key, value in sorted(snap.get("gauges", {}).items()):
        if value is None:
            continue
        name, labels = _split_key(key)
        mname = _metric_name(name)
        fam(mname, "gauge")["lines"].append(
            f"{mname}{_labelstr(labels)} {_fmt(value)}")
    for key, summ in sorted(snap.get("histograms", {}).items()):
        if not summ:
            continue
        name, labels = _split_key(key)
        mname = _metric_name(name)
        f = fam(mname, "summary")
        for q, field in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            if summ.get(field) is not None:
                f["lines"].append(
                    f"{mname}{_labelstr(labels, {'quantile': q})} "
                    f"{_fmt(summ[field])}")
        f["lines"].append(
            f"{mname}_count{_labelstr(labels)} "
            f"{_fmt(summ.get('count', 0))}")
        f["lines"].append(
            f"{mname}_sum{_labelstr(labels)} "
            f"{_fmt(summ.get('sum', 0.0))}")

    out = []
    for mname in sorted(families):
        out.append(f"# TYPE {mname} {families[mname]['type']}")
        out.extend(families[mname]["lines"])
    out.append("# EOF")
    return "\n".join(out) + "\n"


# ------------------------------------------------------------------ #
#  textfile exporter                                                  #
# ------------------------------------------------------------------ #

_last_write = [float("-inf")]


def textfile_path() -> str | None:
    """The armed textfile target, or None (unset or telemetry off)."""
    if not telemetry.enabled():
        return None
    return os.environ.get("EWT_METRICS_TEXTFILE") or None


def write_textfile(path: str | None = None) -> str | None:
    """Atomically rewrite the OpenMetrics textfile (a scraper reading
    between two writes sees the previous whole exposition). Returns the
    path, or None when no target is armed or the write failed."""
    path = path or textfile_path()
    if path is None:
        return None
    # the throttle clock advances whatever the outcome: a dead target
    # must not turn every heartbeat into a fresh write attempt
    _last_write[0] = monotonic()
    try:
        from ..io.writers import atomic_write_text

        atomic_write_text(path, openmetrics())
    except OSError:
        # export never stops a run
        return None
    return path


def maybe_export(force: bool = False) -> str | None:
    """Heartbeat-cadence textfile refresh: rewrite the armed target
    unless one landed within :data:`_MIN_INTERVAL_S` (``force``
    bypasses the throttle — the run_end final export). The textfile is
    a shared path: only the primary process writes it."""
    path = textfile_path()
    if path is None or not telemetry._is_primary():
        return None
    if not force and monotonic() - _last_write[0] < _MIN_INTERVAL_S:
        return None
    return write_textfile(path)


# ------------------------------------------------------------------ #
#  HTTP endpoint                                                      #
# ------------------------------------------------------------------ #

_server = None
_server_thread = None
_server_lock = threading.Lock()

_CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                 "charset=utf-8")


def http_port() -> int | None:
    """The armed ``/metrics`` port, or None (unset, unparseable, or
    telemetry off). 0 means "bind an ephemeral port"."""
    if not telemetry.enabled():
        return None
    raw = os.environ.get("EWT_METRICS_PORT")
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def start_http_server(port: int | None = None, addr: str | None = None):
    """Start (or return the already-running) ``/metrics`` endpoint:
    a stdlib ThreadingHTTPServer on a daemon thread. Returns the bound
    ``(host, port)`` or None when no port is armed."""
    global _server, _server_thread
    if port is None:
        port = http_port()
    if port is None:
        return None
    with _server_lock:
        if _server is not None:
            return _server.server_address[:2]
        import http.server

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):   # noqa: N802 — stdlib contract
                if self.path.split("?")[0].rstrip("/") \
                        not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = openmetrics().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", _CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass    # scrapes must not spam the run's stderr

        host = addr if addr is not None \
            else os.environ.get("EWT_METRICS_ADDR", "127.0.0.1")
        _server = http.server.ThreadingHTTPServer((host, port),
                                                  _Handler)
        _server.daemon_threads = True
        _server_thread = threading.Thread(
            target=_server.serve_forever, daemon=True,
            name="ewt-metrics-http")
        _server_thread.start()
        return _server.server_address[:2]


def stop_http_server():
    """Shut the endpoint down (tests; long-lived processes keep it)."""
    global _server, _server_thread
    with _server_lock:
        if _server is None:
            return
        _server.shutdown()
        _server.server_close()
        _server = None
        _server_thread = None


# ------------------------------------------------------------------ #
#  run-scope integration                                              #
# ------------------------------------------------------------------ #

def autostart(rec=None):
    """Called by ``telemetry.run_scope`` on entry: arm whatever the
    environment asks for and announce each armed exporter as a
    ``metrics_export`` event on ``rec`` so the stream records where
    its live metrics went. No-op without the knobs."""
    if not telemetry.enabled():
        return
    path = textfile_path()
    if path is not None:
        write_textfile(path)
        if rec is not None:
            rec.event("metrics_export", mode="textfile",
                      path=os.path.abspath(path))
    bound = start_http_server()
    if bound is not None and rec is not None:
        rec.event("metrics_export", mode="http", addr=bound[0],
                  port=int(bound[1]))
