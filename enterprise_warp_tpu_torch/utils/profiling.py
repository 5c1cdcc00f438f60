"""Profiling: hierarchical spans, device-memory watermarks, profiler
capture windows and the shared kernel-timing protocol.

Counterpart of ``enterprise_warp_tpu/utils/profiling.py``:

- :func:`span` — hierarchical timing spans (``EWT_SPANS=1``): nested
  records (host wall, and the device tail by ``torch.cuda.synchronize``
  when ``device_sync`` is set — only with spans on) that feed
  ``span_ms{span=}`` histograms, ``span`` open/close events and a
  Chrome-trace export to ``<run_dir>/trace.json`` when the outermost
  ``telemetry.run_scope`` closes.
- :func:`capture_tick` / :func:`capture_arm` — ``torch.profiler`` capture
  windows (``EWT_PROFILE_CAPTURE=<dir>``): the first ``EWT_PROFILE_BLOCKS``
  sampler blocks are captured, and a flight-recorder anomaly re-arms a
  window; each window is written to ``<dir>/trace_<n>.json``.
- :func:`memory_watermark` — ``hbm_in_use_bytes``/``hbm_peak_bytes`` from
  the caching allocator of the current CUDA device (None on the CPU);
  :func:`live_buffer_report` groups the allocator's live blocks
  (``torch.cuda.memory_snapshot``) by size; :func:`host_rss_bytes`.
- :func:`timeit` — CUDA-event timing with warm-up and repetitions.

Everything honours ``EWT_TELEMETRY=0``; the disabled :func:`span` returns
one shared inert object.
"""

from __future__ import annotations

import json
import os
import threading
import time

from . import telemetry

__all__ = ["spans_enabled", "span", "span_records",
           "reset_spans", "flush_trace", "export_chrome_trace",
           "monotonic", "walltime", "timeit", "memory_watermark",
           "host_rss_bytes", "live_buffer_report", "capture_dir",
           "capture_arm", "capture_tick", "capture_stop"]

monotonic = time.perf_counter
walltime = time.time


def spans_enabled() -> bool:
    """Spans are opt-in (``EWT_SPANS=1``), master-gated by
    ``EWT_TELEMETRY``."""
    return telemetry.enabled() and os.environ.get("EWT_SPANS", "0") == "1"


_RECORDS_CAP = 200_000
_records: list = []
_records_dropped = 0
_records_lock = threading.Lock()
_seq_lock = threading.Lock()
_seq = [0]
_tls = threading.local()


def _next_id() -> int:
    with _seq_lock:
        _seq[0] += 1
        return _seq[0]


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _NoopSpan:
    """Shared inert span handed out when spans are disabled."""

    __slots__ = ()
    name = None
    device_sync = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setattr__(self, k, v):
        pass


_NOOP_SPAN = _NoopSpan()


def _sync_device(obj):
    """Wait for the device work behind ``obj`` (a tensor or a device): a
    ``torch.cuda.synchronize`` of its CUDA device, nothing on the CPU."""
    import torch
    dev = obj.device if torch.is_tensor(obj) else torch.device(obj)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Span:
    """One live span (use via :func:`span`). ``device_sync`` may name a
    tensor or a device; the close then also measures the wall spent
    waiting for that device."""

    __slots__ = ("name", "id", "parent", "depth", "t0_wall", "t0",
                 "device_sync", "attrs")

    def __init__(self, name, device_sync=None, **attrs):
        self.name = name
        self.device_sync = device_sync
        self.attrs = attrs or None
        self.id = _next_id()
        self.parent = None
        self.depth = 0

    def __enter__(self):
        st = _stack()
        if st:
            self.parent = st[-1].id
            self.depth = st[-1].depth + 1
        st.append(self)
        self.t0_wall = walltime()
        self.t0 = monotonic()
        rec = telemetry.active_recorder()
        if rec is not None:
            rec.event("span", ev="B", id=self.id, name=self.name,
                      depth=self.depth)
        return self

    def __exit__(self, exc_type, exc, tb):
        device_s = 0.0
        if self.device_sync is not None and exc_type is None:
            td = monotonic()
            _sync_device(self.device_sync)
            device_s = monotonic() - td
        dur = monotonic() - self.t0
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        telemetry.registry().histogram(
            "span_ms", span=self.name).observe(dur * 1e3)
        record = {"name": self.name, "id": self.id, "parent": self.parent,
                  "depth": self.depth, "t0": self.t0_wall, "dur_s": dur,
                  "device_s": device_s, "tid": threading.get_ident()}
        if self.attrs:
            record["attrs"] = self.attrs
        global _records_dropped
        with _records_lock:
            if len(_records) < _RECORDS_CAP:
                _records.append(record)
            else:
                _records_dropped += 1
        rec = telemetry.active_recorder()
        if rec is not None:
            ev = dict(ev="E", id=self.id, name=self.name, depth=self.depth,
                      dur_ms=round(dur * 1e3, 3))
            if device_s:
                ev["device_ms"] = round(device_s * 1e3, 3)
            if self.attrs:
                ev.update(self.attrs)
            rec.event("span", **ev)
        return False


def span(name, device_sync=None, **attrs):
    """Open a hierarchical timing span; the shared no-op span when spans
    are off, so callers use it unconditionally."""
    if not spans_enabled():
        return _NOOP_SPAN
    return Span(name, device_sync=device_sync, **attrs)


def span_records():
    with _records_lock:
        return list(_records)


def reset_spans():
    global _records_dropped
    with _records_lock:
        _records.clear()
        _records_dropped = 0


def export_chrome_trace(path: str):
    """Write the completed spans as a Chrome-trace JSON (one ``"ph":
    "X"`` event per span, tid the recording thread). Returns the path,
    or None when there is nothing to write."""
    with _records_lock:
        recs = list(_records)
        dropped = _records_dropped
    if not recs:
        return None
    events = [{"name": "process_name", "ph": "M", "pid": os.getpid(),
               "args": {"name": "enterprise_warp_tpu_torch"}}]
    for r in recs:
        ev = {"name": r["name"], "ph": "X", "pid": os.getpid(),
              "tid": r.get("tid", 0), "ts": round(r["t0"] * 1e6, 1),
              "dur": round(r["dur_s"] * 1e6, 1),
              "args": {"id": r["id"], "parent": r["parent"],
                       "depth": r["depth"],
                       "device_ms": round(r["device_s"] * 1e3, 3)}}
        if r.get("attrs"):
            ev["args"].update(r["attrs"])
        events.append(ev)
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"spans_dropped": dropped}}
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return path


def flush_trace(run_dir):
    """Export ``<run_dir>/trace.json`` when spans are on and any were
    recorded, then clear the records (each run its own trace)."""
    if run_dir is None or not spans_enabled():
        return None
    path = export_chrome_trace(os.path.join(run_dir, "trace.json"))
    if path is not None:
        reset_spans()
    return path


# ------------------------------------------------------------------ #
#  kernel timing                                                       #
# ------------------------------------------------------------------ #

def timeit(fn, *args, reps: int = 10, warmup: int = 1,
           name: str | None = None):
    """Per-call time of ``fn(*args)`` in seconds: ``warmup`` calls, then
    ``reps`` calls between two CUDA events on the current stream (the
    host clock around a ``synchronize`` on the CPU). Recorded as a span
    ``timeit.<name>`` when spans are on."""
    import torch
    for _ in range(warmup):
        fn(*args)
    cuda = torch.cuda.is_available() and any(
        torch.is_tensor(a) and a.device.type == "cuda" for a in args)
    with span(f"timeit.{name or getattr(fn, '__name__', 'fn')}", reps=reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps
        t0 = monotonic()
        for _ in range(reps):
            fn(*args)
        return (monotonic() - t0) / reps


# ------------------------------------------------------------------ #
#  memory                                                              #
# ------------------------------------------------------------------ #

def memory_watermark(device=None):
    """``{"hbm_in_use_bytes", "hbm_peak_bytes"}`` of the caching
    allocator on ``device`` (default the current CUDA device), with the
    matching registry gauges set; None on the CPU or with telemetry off.
    Reads allocator counters only: no device synchronisation."""
    if not telemetry.enabled():
        return None
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return None
    out = {"hbm_in_use_bytes": int(torch.cuda.memory_allocated(dev)),
           "hbm_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    reg = telemetry.registry()
    reg.gauge("hbm_in_use_bytes").set(out["hbm_in_use_bytes"])
    reg.gauge("hbm_peak_bytes").set(out["hbm_peak_bytes"])
    return out


try:
    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):
    _PAGE_SIZE = 4096


def host_rss_bytes():
    """Resident-set size of this process from ``/proc/self/statm`` (None
    off Linux); sets the ``rss_bytes`` gauge."""
    try:
        with open("/proc/self/statm") as fh:
            rss = int(fh.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return None
    if telemetry.enabled():
        telemetry.registry().gauge("rss_bytes").set(rss)
    return rss


def live_buffer_report(top: int = 20):
    """Where the device memory went: the caching allocator's live blocks
    (``torch.cuda.memory_snapshot()``) grouped by block size, the ``top``
    groups by total bytes plus the total. The allocator does not know the
    tensor shapes behind its blocks, so a group is a size, not a shape.
    Walks every segment: for an anomaly dump, not for a heartbeat."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {"total_bytes": None, "groups": [],
                "error": "no CUDA device in use"}
    groups: dict = {}
    total = 0
    for seg in torch.cuda.memory_snapshot():
        for blk in seg.get("blocks", ()):
            if blk.get("state") != "active_allocated":
                continue
            size = int(blk.get("size", 0))
            g = groups.setdefault(size, [0, 0])
            g[0] += 1
            g[1] += size
            total += size
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
    return {"total_bytes": total,
            "n_blocks": sum(g[0] for g in groups.values()),
            "groups": [{"block_bytes": k, "count": g[0], "bytes": g[1]}
                       for k, g in ranked]}


# ------------------------------------------------------------------ #
#  torch.profiler capture windows                                      #
# ------------------------------------------------------------------ #

_capture = {"active": None, "blocks_left": 0, "armed": None,
            "started_once": False, "n": 0}
_capture_lock = threading.Lock()


def capture_dir():
    """The capture directory (``EWT_PROFILE_CAPTURE``), or None."""
    return os.environ.get("EWT_PROFILE_CAPTURE") or None


def _default_blocks() -> int:
    try:
        return max(1, int(os.environ.get("EWT_PROFILE_BLOCKS", "2")))
    except ValueError:
        return 2


def capture_arm(n_blocks=None):
    """Arm a window: the next ``n_blocks`` sampler blocks run under
    ``torch.profiler``. A no-op without ``EWT_PROFILE_CAPTURE``."""
    if capture_dir() is None:
        return
    with _capture_lock:
        _capture["armed"] = (n_blocks if n_blocks is not None
                             else _default_blocks())


def capture_tick():
    """Mark one sampler block boundary: start an armed window (the first
    one is armed at start-up), count blocks down, stop and export when the
    window closes. A no-op without ``EWT_PROFILE_CAPTURE``."""
    cdir = capture_dir()
    if cdir is None:
        return
    with _capture_lock:
        if not _capture["started_once"] and _capture["armed"] is None:
            _capture["armed"] = _default_blocks()
        if _capture["active"] is not None:
            _capture["blocks_left"] -= 1
            if _capture["blocks_left"] <= 0:
                _stop_locked()
            return
        if _capture["armed"] is not None:
            _capture["started_once"] = True
            try:
                import torch
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
                _capture["active"] = prof
                _capture["blocks_left"] = _capture["armed"]
            except Exception as exc:   # noqa: BLE001 — never kill a run
                from .logging import get_logger
                get_logger("ewt.profiling").warning(
                    "profiler capture start failed (%r); disabling "
                    "capture for this process", exc)
            _capture["armed"] = None


def _stop_locked():
    prof = _capture["active"]
    _capture["active"] = None
    _capture["blocks_left"] = 0
    try:
        prof.__exit__(None, None, None)
        cdir = capture_dir()
        os.makedirs(cdir, exist_ok=True)
        _capture["n"] += 1
        prof.export_chrome_trace(
            os.path.join(cdir, f"trace_{os.getpid()}_{_capture['n']}.json"))
    except Exception as exc:   # noqa: BLE001 — never kill a run
        from .logging import get_logger
        get_logger("ewt.profiling").warning(
            "profiler capture export failed (%r)", exc)


def capture_stop():
    """Stop and export an active window (end of a run scope)."""
    with _capture_lock:
        if _capture["active"] is not None:
            _stop_locked()
