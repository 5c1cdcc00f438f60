"""The port's OpenMetrics exporter (``utils/metricsexport.py``) against the
JAX package's, on the CPU.

- ``openmetrics`` of one registry snapshot (counters with labels, gauges,
  a None gauge, summaries, names and label values that need escaping; the
  families the port emits, so none of the reference's serving families
  with their ``# HELP`` lines) is byte for byte the reference's, and so is
  the exposition of two live registries fed the same metrics;
- the textfile (``EWT_METRICS_TEXTFILE``) is written atomically (no
  ``.tmp`` left, the previous exposition whole until the rename), at the
  heartbeat cadence with the reference's throttle, forced at ``run_end``,
  announced by a ``metrics_export`` event, and inert with telemetry off;
- the ``/metrics`` endpoint on an ephemeral port on 127.0.0.1 answers
  with the same text, 404 elsewhere, and ``EWT_METRICS_PORT`` arms it
  from a run scope.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from enterprise_warp_tpu.utils import metricsexport as jme
from enterprise_warp_tpu.utils import telemetry as jtel
from enterprise_warp_tpu_torch.utils import metricsexport as me
from enterprise_warp_tpu_torch.utils import telemetry


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    for k in ("EWT_METRICS_TEXTFILE", "EWT_METRICS_PORT",
              "EWT_METRICS_ADDR"):
        monkeypatch.delenv(k, raising=False)
    telemetry.registry().reset()
    me._last_write[0] = float("-inf")
    yield
    me.stop_http_server()
    telemetry.registry().reset()


SNAPSHOT = {
    "counters": {"nonfinite_eval{where=block}": 3,
                 "nonfinite_eval{where=init}": 1,
                 "retries{site=pt.dispatch}": 2,
                 "odd-name.x{label=a\"b\\c}": 7},
    "gauges": {"stream_rhat": 1.0123456789, "swap_rate{edge=0}": 0.25,
               "swap_rate{edge=1}": 0.5, "walk_scale": None,
               "big": 1e20, "nan_gauge": float("nan"),
               "inf_gauge": float("inf")},
    "histograms": {"lat{kind=a}": {"count": 10, "sum": 55.5, "p50": 5.0,
                                   "p90": 9.0, "p99": None},
                   "empty": {}},
}


def _populate(reg):
    reg.counter("nonfinite_eval", where="block").inc(3)
    reg.counter("retries", site="pt.dispatch").inc()
    reg.gauge("stream_ess").set(812.5)
    reg.gauge("rung_accept", rung=1).set(0.3125)
    h = reg.histogram("block_s")
    for v in np.random.default_rng(0).uniform(0.0, 2.0, 200):
        h.observe(float(v))


def test_openmetrics_byte_equal_to_reference():
    assert me.openmetrics(SNAPSHOT) == jme.openmetrics(SNAPSHOT)
    text = me.openmetrics(SNAPSHOT)
    assert text.endswith("# EOF\n")
    assert "ewt_nonfinite_eval_total{where=\"block\"} 3" in text
    assert "walk_scale" not in text and "# HELP" not in text
    jtel.registry().reset()
    try:
        _populate(telemetry.registry())
        _populate(jtel.registry())
        assert me.openmetrics() == jme.openmetrics()
    finally:
        jtel.registry().reset()


def test_textfile_atomic_throttled_and_forced(tmp_path, monkeypatch):
    path = tmp_path / "ewt.prom"
    assert me.write_textfile() is None          # nothing armed
    monkeypatch.setenv("EWT_METRICS_TEXTFILE", str(path))
    telemetry.registry().gauge("stream_rhat").set(1.5)
    assert me.write_textfile() == str(path)
    assert path.read_text() == me.openmetrics()
    assert [p.name for p in tmp_path.iterdir()] == ["ewt.prom"]
    # a rewrite replaces the file whole: a reader holding the old file
    # keeps the previous exposition
    with open(path) as old:
        telemetry.registry().gauge("stream_rhat").set(2.5)
        assert me.maybe_export() is None        # inside the throttle
        assert me.maybe_export(force=True) == str(path)
        assert "1.5" in old.read()
    assert "ewt_stream_rhat 2.5" in path.read_text()
    # a dead target never raises
    monkeypatch.setenv("EWT_METRICS_TEXTFILE", str(tmp_path / "no" / "x"))
    assert me.maybe_export(force=True) is None
    # telemetry off: inert
    monkeypatch.setenv("EWT_TELEMETRY", "0")
    monkeypatch.setenv("EWT_METRICS_TEXTFILE", str(tmp_path / "off.prom"))
    assert me.maybe_export(force=True) is None
    assert not (tmp_path / "off.prom").exists()


def test_run_scope_exports_at_heartbeats_and_run_end(tmp_path,
                                                     monkeypatch):
    path = tmp_path / "metrics.prom"
    monkeypatch.setenv("EWT_METRICS_TEXTFILE", str(path))
    run = tmp_path / "run"
    with telemetry.run_scope(str(run), sampler="t") as rec:
        assert path.exists()                    # armed on entry
        telemetry.registry().gauge("stream_ess").set(99.0)
        rec.heartbeat(step=1)
        telemetry.registry().gauge("stream_ess").set(123.0)
    # run_end forced the final registry past the throttle
    assert "ewt_stream_ess 123" in path.read_text()
    ev = [json.loads(ln) for ln in
          (run / "events.jsonl").read_text().splitlines()]
    exp = [e for e in ev if e["type"] == "metrics_export"]
    assert exp and exp[0]["mode"] == "textfile"
    assert exp[0]["path"] == os.path.abspath(str(path))
    assert telemetry.check_stream(run / "events.jsonl") == (0, [])


def test_http_endpoint_serves_the_text(tmp_path, monkeypatch):
    telemetry.registry().counter("nonfinite_eval", where="block").inc(2)
    host, port = me.start_http_server(port=0, addr="127.0.0.1")
    assert host == "127.0.0.1" and port > 0
    assert me.start_http_server(port=0) == (host, port)   # one server
    url = f"http://127.0.0.1:{port}/metrics"
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
        ctype = r.headers["Content-Type"]
    assert body == me.openmetrics()
    assert ctype.startswith("application/openmetrics-text")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/other",
                               timeout=10)
    assert err.value.code == 404
    me.stop_http_server()
    # armed from the environment by a run scope, announced as an event
    monkeypatch.setenv("EWT_METRICS_PORT", "0")
    monkeypatch.setenv("EWT_METRICS_ADDR", "127.0.0.1")
    run = tmp_path / "run"
    with telemetry.run_scope(str(run), sampler="t"):
        pass
    ev = [json.loads(ln) for ln in
          (run / "events.jsonl").read_text().splitlines()]
    http = [e for e in ev if e["type"] == "metrics_export"
            and e["mode"] == "http"]
    assert http and http[0]["addr"] == "127.0.0.1" and http[0]["port"] > 0
    with urllib.request.urlopen(
            f"http://127.0.0.1:{http[0]['port']}/metrics", timeout=10) as r:
        assert r.read().decode() == me.openmetrics()
