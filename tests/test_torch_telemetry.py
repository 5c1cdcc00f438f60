"""The port's run telemetry (``utils/telemetry.py``, ``utils/profiling.py``,
``utils/flightrec.py``) against the reference's contracts, on the CPU.

- the host-only cases of ``tests/test_telemetry.py`` and
  ``tests/test_profiling.py`` on the port's modules: the registry and its
  histograms, the event schema round trip, nested run scopes, the
  ``EWT_TELEMETRY=0`` no-op, spans and their Chrome trace (also through
  the PT and nested samplers), ``PhaseTimer``/``log_phase``/
  ``profiler_trace``, the CPU memory watermark, the profiler capture
  window, the flight recorder's ring, encoding and dump;
- the port's copy of the stream vocabulary equals ``tools/report.py``'s,
  and its ``check_stream`` agrees with ``report.py --check`` on a clean
  and a dirty stream;
- the port's CLI on ``system_noise.dat --num 1`` (PT, 200 steps in two
  blocks), ``hmc_single_psr.dat --num 1`` (HMC, 20 steps) and
  ``default_model_nested.dat --num 0`` (nested, 60 live points) writes an
  ``events.jsonl`` that ``tools/report.py --check`` accepts with zero
  problems and that ``tools/report.py`` folds; its event types, in order,
  and its heartbeat key sets equal the JAX package's CLI on the same
  paramfile and knobs (``EWT_DEVICE_DIAG=0``, ``EWT_STREAMING_DIAG=0``,
  ``EWT_MESH_STATS=0``, ``EWT_TELEMETRY_DIAG_S=0`` on both), except for
  what a plane this slice leaves out emits (named in ``NOT_PORTED``) and
  the data-dependent ``kernel_health`` events (``DATA_DEPENDENT``: the
  two packages draw different chains); the nested run's number of blocks
  is where its evidence converges, so there repeats are collapsed;
- with ``EWT_TELEMETRY=0`` there is no stream, and the chain is bit for
  bit the telemetry-on chain.
"""

import importlib.util
import itertools
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.config.paramfile import IMPLEMENTED_SAMPLERS
from enterprise_warp_tpu_torch.utils import flightrec, profiling, telemetry

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"

#: what the reference emits from planes this slice leaves out: ``compile``
#: events (its ``traced`` jit wrapper; the port has no jit) and ``mixing``
#: events plus the heartbeat keys of the device diagnostics plane
NOT_PORTED = {
    "events": {"compile", "mixing"},
    "heartbeat": {"energy_err_mean", "energy_err_std", "energy_err_max",
                  "eps_min", "eps_max", "scale_min", "scale_max",
                  "budget_exhaust_frac", "first_accept_frac",
                  "rhat_stream", "ess_stream"},
}
#: events whose number and place depend on the chain's draws
DATA_DEPENDENT = {"kernel_health"}
#: the reference's planes this slice leaves out, switched off on both
SAME_KNOBS = {"EWT_DEVICE_DIAG": "0", "EWT_STREAMING_DIAG": "0",
              "EWT_MESH_STATS": "0", "EWT_TELEMETRY_DIAG_S": "0"}


@pytest.fixture(autouse=True)
def _telemetry_on(monkeypatch):
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    for k in ("EWT_SPANS", "EWT_FLIGHTREC", "EWT_FAULT_PLAN", "EWT_PALLAS",
              "EWT_PALLAS_MEGA", "EWT_KERNEL_HEALTH"):
        monkeypatch.delenv(k, raising=False)
    telemetry.registry().reset()
    yield
    telemetry.registry().reset()


def _report_cli():
    spec = importlib.util.spec_from_file_location(
        "ewt_report_cli", str(REPO / "tools" / "report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _events(path):
    return [json.loads(ln) for ln in
            pathlib.Path(path).read_text().splitlines()]


# ------------------------------------------------------------------ #
#  registry, schema, scopes                                           #
# ------------------------------------------------------------------ #

def test_registry_counters_gauges_labels():
    reg = telemetry.registry()
    reg.counter("evals", mask_class="site").inc()
    reg.counter("evals", mask_class="site").inc(2)
    reg.counter("evals", mask_class="full").inc()
    reg.gauge("scale").set(0.25)
    snap = reg.snapshot()
    assert snap["counters"]["evals{mask_class=site}"] == 3
    assert snap["counters"]["evals{mask_class=full}"] == 1
    assert snap["gauges"]["scale"] == 0.25
    json.dumps(snap, allow_nan=False)


def test_histogram_quantiles_and_edges():
    h = telemetry.registry().histogram("lat")
    for v in np.random.default_rng(0).permutation(1000):
        h.observe(float(v))
    s = h.summary()
    assert s["count"] == 1000 and s["min"] == 0.0 and s["max"] == 999.0
    assert abs(s["p50"] - 500) < 60 and abs(s["p90"] - 900) < 60
    for v in range(20000):
        h.observe(float(v % 1000))
    assert len(h._buf) <= h._cap
    assert h.summary()["samples_dropped"] == h.count - len(h._buf) > 0
    empty = telemetry.Histogram()
    assert empty.quantile(0.5) is None
    assert empty.summary()["p99"] is None
    json.dumps(empty.summary(), allow_nan=False)


def test_event_schema_roundtrip(tmp_path):
    rec = telemetry.RunRecorder(str(tmp_path), flush_every=2)
    rec.run_start(sampler="test", config_hash="abc123")
    rec.heartbeat(step=10, evals_per_s=123.4, cache_hit_rate=0.5,
                  rhat=1.01, ess=np.float64(250.0),
                  ladder=np.array([1.0, 1.7]), max_lnl=float("-inf"))
    rec.checkpoint(step=10)
    rec.run_end(status="ok")
    rec.close()
    events = _events(tmp_path / "events.jsonl")
    assert [e["type"] for e in events] == [
        "run_start", "run_lineage", "heartbeat", "checkpoint", "run_end"]
    assert events[1]["run_id"] == events[0]["run_id"]
    assert events[1]["reason"] == "fresh" and events[1]["parent"] is None
    start = events[0]
    assert start["config_hash"] == "abc123" and start["campaign"]
    assert start["torch_version"] == torch.__version__
    assert start["backend"] == "cpu"
    hb = events[2]
    assert hb["ess"] == 250.0 and hb["ladder"] == [1.0, 1.7]
    assert hb["max_lnl"] is None          # strict JSON: no -Infinity
    assert events[-1]["status"] == "ok" and "metrics" in events[-1]
    # a second session appends and links to the first
    rec2 = telemetry.RunRecorder(str(tmp_path))
    rec2.run_start(sampler="again")
    rec2.run_end(status="ok")
    lin = [e for e in _events(tmp_path / "events.jsonl")
           if e["type"] == "run_lineage"]
    assert lin[1]["parent"] == lin[0]["run_id"]
    assert lin[1]["reason"] == "resume"
    assert telemetry.last_lineage()["run_id"] == rec2.run_id


def test_torn_tail_healed(tmp_path):
    rec = telemetry.RunRecorder(str(tmp_path))
    rec.run_start(sampler="a")
    rec.run_end(status="ok")
    with open(rec.path, "a") as fh:
        fh.write('{"t": 1.0, "type": "heart')
    rec2 = telemetry.RunRecorder(str(tmp_path))
    rec2.run_start(sampler="b")
    rec2.run_end(status="ok")
    assert telemetry.check_stream(rec.path) == (0, [])


def test_run_scope_nesting_single_start_end(tmp_path):
    with telemetry.run_scope(str(tmp_path), sampler="outer") as rec:
        with telemetry.run_scope(str(tmp_path / "inner"),
                                 sampler="inner") as rec2:
            assert rec2 is rec
            rec2.heartbeat(step=1)
    events = _events(tmp_path / "events.jsonl")
    assert [e["type"] for e in events] == \
        ["run_start", "run_lineage", "heartbeat", "run_end"]
    assert events[0]["sampler"] == "outer"
    assert not (tmp_path / "inner").exists()


def test_disabled_is_noop(tmp_path, monkeypatch):
    monkeypatch.setenv("EWT_TELEMETRY", "0")
    reg = telemetry.registry()
    reg.counter("x").inc()
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}
    with telemetry.run_scope(str(tmp_path), sampler="off") as rec:
        rec.heartbeat(step=1)
        rec.event("anything", a=1)
    assert not (tmp_path / "events.jsonl").exists()


# ------------------------------------------------------------------ #
#  profiling                                                          #
# ------------------------------------------------------------------ #

def test_span_nesting_and_trace_export(monkeypatch, tmp_path):
    monkeypatch.setenv("EWT_SPANS", "1")
    profiling.reset_spans()
    with telemetry.run_scope(str(tmp_path), sampler="t") as rec:
        with profiling.span("outer") as so:
            with profiling.span("inner", device_sync="cpu") as si:
                assert si.depth == 1 and si.parent == so.id
            with profiling.span("inner2"):
                pass
        rec.flush()
        recs = profiling.span_records()
        assert [r["name"] for r in recs] == ["inner", "inner2", "outer"]
        by = {r["name"]: r for r in recs}
        assert by["inner"]["parent"] == by["outer"]["id"]
        assert by["outer"]["dur_s"] >= by["inner"]["dur_s"]
        assert by["inner"]["device_s"] >= 0.0
    assert profiling.span_records() == []
    doc = json.load(open(tmp_path / "trace.json"))
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in evs} == {"outer", "inner", "inner2"}
    assert all(e["dur"] >= 0 and "depth" in e["args"] for e in evs)
    snap = telemetry.registry().snapshot()
    assert snap["histograms"]["span_ms{span=outer}"]["count"] == 1
    sp = [e for e in _events(tmp_path / "events.jsonl")
          if e["type"] == "span"]
    assert sum(e["ev"] == "B" for e in sp) == sum(e["ev"] == "E"
                                                  for e in sp) == 3
    assert telemetry.check_stream(tmp_path / "events.jsonl")[0] == 0


def test_sampler_spans_and_trace(monkeypatch, tmp_path):
    """``EWT_SPANS=1`` on a PT and a nested run: the block spans (the
    block writes on the PT writer thread, on their own track) land in a
    check-clean stream and in ``trace.json``."""
    from enterprise_warp_tpu_torch.samplers import PTSampler, run_nested
    from test_torch_ptmcmc import GaussianLike
    monkeypatch.setenv("EWT_SPANS", "1")
    profiling.reset_spans()
    like = GaussianLike([1.0, -1.0], [0.5, 0.5])
    PTSampler(like, str(tmp_path / "pt"), ntemps=2, nchains=4, seed=0,
              cov_update=30).sample(60, resume=False, verbose=False)
    run_nested(like, outdir=str(tmp_path / "ns"), nlive=40, kbatch=8,
               nsteps=5, dlogz=1e-9, max_iter=8, block_iters=4,
               verbose=False)
    for run, names in (("pt", {"pt.dispatch", "pt.host_work"}),
                       ("ns", {"ns.dispatch", "ns.commit", "ns.host_work"})):
        assert telemetry.check_stream(tmp_path / run / "events.jsonl") \
            == (0, [])
        doc = json.load(open(tmp_path / run / "trace.json"))
        evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        assert {e["name"] for e in evs} == names
    tids = {e["name"]: e["tid"] for e in json.load(open(
        tmp_path / "pt" / "trace.json"))["traceEvents"] if e.get("ph") == "X"}
    assert tids["pt.dispatch"] != tids["pt.host_work"]


def test_phase_timer_and_profiler_trace(tmp_path, caplog):
    import logging

    from enterprise_warp_tpu_torch.utils.logging import (PhaseTimer,
                                                         log_phase,
                                                         profiler_trace)
    timer = PhaseTimer(logging.getLogger("ewt.test"))
    with caplog.at_level(logging.INFO, logger="ewt.test"):
        for _ in range(2):
            with timer.phase("build"):
                pass
        with log_phase("load", logging.getLogger("ewt.test")):
            pass
    assert set(timer.report()) == {"build"} and timer.counts["build"] == 2
    assert "phase load" in caplog.text and "total" in caplog.text
    with profiler_trace(None) as prof:
        assert prof is None
    with profiler_trace(str(tmp_path / "tr")):
        torch.ones(16).sum()
    doc = json.load(open(tmp_path / "tr" / "trace.json"))
    assert doc["traceEvents"]


def test_spans_disabled_noop(tmp_path):
    s1 = profiling.span("x")
    s2 = profiling.span("y", device_sync="cpu")
    assert s1 is s2
    with s1 as s:
        s.device_sync = "cpu"
    assert profiling.span_records() == []
    assert profiling.flush_trace(str(tmp_path)) is None


def test_timeit_and_memory_on_cpu():
    dt = profiling.timeit(lambda x: x * 2.0, torch.ones(8), reps=3,
                          name="toy")
    assert dt >= 0.0
    # no CUDA device in use: the watermark is None, the live-block report
    # says why, and both are JSON-ready
    assert profiling.memory_watermark() is None
    rep = profiling.live_buffer_report()
    assert rep["total_bytes"] is None and rep["groups"] == []
    json.dumps(rep)
    assert profiling.host_rss_bytes() > 0


def test_profiler_capture_window(monkeypatch, tmp_path):
    monkeypatch.setenv("EWT_PROFILE_CAPTURE", str(tmp_path / "cap"))
    monkeypatch.setenv("EWT_PROFILE_BLOCKS", "1")
    monkeypatch.setattr(profiling, "_capture",
                        {"active": None, "blocks_left": 0, "armed": None,
                         "started_once": False, "n": 0})
    profiling.capture_tick()          # starts the start-up window
    torch.ones(4).sum()
    profiling.capture_tick()          # one block later: stop and export
    assert len(os.listdir(tmp_path / "cap")) == 1
    profiling.capture_arm(1)          # an anomaly re-arms a window
    profiling.capture_tick()
    profiling.capture_stop()
    assert len(os.listdir(tmp_path / "cap")) == 2


# ------------------------------------------------------------------ #
#  flight recorder                                                    #
# ------------------------------------------------------------------ #

def test_flightrec_ring_and_encoding():
    fr = flightrec.FlightRecorder(ring_len=4)
    for i in range(7):
        fr.record("tick", i=i)
    assert [r["i"] for r in fr.tail()] == [3, 4, 5, 6]
    assert [r["i"] for r in fr.tail(2)] == [5, 6]
    enc = flightrec._forensic({"a": float("nan"),
                               "b": [1.0, float("inf")],
                               "c": np.array([np.nan, 2.0])})
    assert enc == {"a": "NaN", "b": [1.0, "Infinity"], "c": ["NaN", 2.0]}
    json.dumps(enc, allow_nan=False)


def test_flightrec_disabled_noop(tmp_path):
    fr = flightrec.flight_recorder()
    fr.record("x")
    fr.note_state(step=1)
    assert fr.anomaly("nope", run_dir=str(tmp_path)) is None
    assert not (tmp_path / "anomaly").exists()


def test_flightrec_anomaly_dump(monkeypatch, tmp_path):
    monkeypatch.setenv("EWT_FLIGHTREC", "1")
    fr = flightrec.FlightRecorder()
    fr.record("heartbeat", step=10)
    fr.note_state(sampler="test", step=10)
    path = fr.anomaly("unit_test", run_dir=str(tmp_path),
                      bad_lnl=np.array([np.nan, -1.0]))
    doc = json.load(open(path))
    json.dumps(doc, allow_nan=False)
    assert doc["reason"] == "unit_test"
    assert doc["payload"]["bad_lnl"] == ["NaN", -1.0]
    assert doc["state"]["sampler"] == "test"
    assert doc["ring_tail"][-1]["type"] == "heartbeat"
    assert set(doc["kernels"]) >= {"routes", "launches", "kernels_enabled"}
    assert (tmp_path / "anomaly" / "anomaly.json").exists()
    assert fr.anomaly("unit_test", run_dir=str(tmp_path)) is None


# ------------------------------------------------------------------ #
#  the vocabulary                                                     #
# ------------------------------------------------------------------ #

def test_vocabulary_copy_equals_report():
    rep = _report_cli()
    assert telemetry.KNOWN_EVENT_TYPES == rep.KNOWN_EVENT_TYPES
    assert telemetry.KNOWN_HEARTBEAT_FIELDS == rep.KNOWN_HEARTBEAT_FIELDS


def test_check_stream_agrees_with_report(tmp_path, capsys):
    rep = _report_cli()
    rec = telemetry.RunRecorder(str(tmp_path))
    rec.run_start(sampler="t")
    rec.event("span", ev="B", id=1, name="blk", depth=0)
    rec.heartbeat(step=1)
    rec.event("span", ev="E", id=1, name="blk", depth=0, dur_ms=1.0)
    rec.run_end(status="ok")
    assert telemetry.check_stream(rec.path) == (0, [])
    assert rep.main([str(tmp_path), "--check"]) == 0
    with open(rec.path, "a") as fh:
        fh.write('{"t": 1.0, "type": "mystery"}\n')
        fh.write('{"t": 1.5, "type": "heartbeat", "typo_key": 1}\n')
        fh.write('{"t": 2.0, "type": "span", "ev": "B", "id": 99, '
                 '"name": "lost", "depth": 0}\n')
        fh.write('{"t": 3.0, "type": "hea')
    problems, msgs = telemetry.check_stream(rec.path)
    assert problems == 4 and len(msgs) == 4
    assert rep.main([str(tmp_path), "--check"]) == 1
    capsys.readouterr()


# ------------------------------------------------------------------ #
#  the samplers' streams, against the JAX package's                   #
# ------------------------------------------------------------------ #

RUNS = (
    ("pt", "system_noise.dat", 1, dict(nsamp=200, covUpdate=100)),
    ("hmc", "hmc_single_psr.dat", 1, dict(nsamp=20, warmup=10, nchains=8,
                                          n_leapfrog=4, advi_init=0)),
    ("nested", "default_model_nested.dat", 0,
     dict(nlive=60, kbatch=30, nsteps=4, dlogz=1.0)),
)


def _paramfile(tmp, name, **keys):
    lines = []
    with open(EXAMPLES / "example_params" / name) as fh:
        for line in fh.read().splitlines():
            key, _, val = line.partition(":")
            key = key.strip()
            if key == "datadir":
                line = f"datadir: {EXAMPLES / 'data'}"
            elif key == "out":
                line = f"out: {tmp / 'out'}"
            elif key in keys:
                line = f"{key}: {keys.pop(key)}"
            elif key == "noise_model_file":
                line = f"{key}: {EXAMPLES / val.strip()}"
            elif line.strip() == "{0}":
                lines += [f"{k}: {v}" for k, v in keys.items()]
                keys = {}
            lines.append(line)
    path = tmp / "run.dat"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _stream_dir(tmp):
    found = [r for r, _, fs in os.walk(tmp / "out") if "events.jsonl" in fs]
    assert len(found) == 1, found
    return pathlib.Path(found[0])


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Each RUNS entry through the port's CLI and the JAX package's, with
    the same paramfile and knobs; returns ``{kind: (port_dir, jax_dir)}``."""
    from enterprise_warp_tpu import cli as jcli
    from enterprise_warp_tpu.config.paramfile import \
        IMPLEMENTED_SAMPLERS as JSAMPLERS
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SAME_KNOBS.items():
            mp.setenv(k, v)
        mp.setenv("EWT_TELEMETRY", "1")
        for k in ("EWT_PALLAS", "EWT_FLIGHTREC", "EWT_FAULT_PLAN",
                  "EWT_KERNEL_HEALTH"):
            mp.delenv(k, raising=False)
        # the paramfile parsers drop ``advi_init`` for hmc (both); it is
        # registered so the 1500-step warm start is skipped
        mp.setitem(IMPLEMENTED_SAMPLERS["hmc"], "advi_init", 1)
        mp.setitem(JSAMPLERS["hmc"], "advi_init", 1)
        for kind, name, num, keys in RUNS:
            dirs = []
            for who, main in (("port", lambda a: cli.main(a, device="cpu")),
                              ("jax", jcli.main)):
                tmp = tmp_path_factory.mktemp(f"{kind}_{who}")
                assert main(["--prfile", _paramfile(tmp, name, **keys),
                             "--num", str(num)]) == 0
                dirs.append(_stream_dir(tmp))
            out[kind] = tuple(dirs)
    return out


@pytest.mark.parametrize("kind", [r[0] for r in RUNS])
def test_port_stream_checks_and_folds(streams, kind, capsys):
    port_dir, _ = streams[kind]
    rep = _report_cli()
    assert rep.main([str(port_dir), "--check"]) == 0
    assert "clean" in capsys.readouterr().out
    assert telemetry.check_stream(port_dir / "events.jsonl") == (0, [])
    assert rep.main([str(port_dir), "-q"]) == 0
    report = json.load(open(port_dir / "run_report.json"))
    json.dumps(report, allow_nan=False)
    assert report["status"] == "ok"
    assert report["eval_rate"]["evals_total"] > 0


@pytest.mark.parametrize("kind", [r[0] for r in RUNS])
def test_port_stream_matches_reference(streams, kind):
    port_dir, jax_dir = streams[kind]
    drop = NOT_PORTED["events"] | DATA_DEPENDENT

    def types(d):
        return [e["type"] for e in _events(d / "events.jsonl")
                if e["type"] not in drop]

    def hb_keys(d):
        return [frozenset(k for k in e if k not in ("t", "type"))
                - NOT_PORTED["heartbeat"]
                for e in _events(d / "events.jsonl")
                if e["type"] == "heartbeat"]

    if kind == "nested":
        # the number of blocks is where each chain's evidence converges,
        # a property of the draws: the sequences are held equal with
        # repeats collapsed, and the key sets as a set, first and last
        def collapse(seq):
            return [t for t, _ in itertools.groupby(seq)]
        assert collapse(types(port_dir)) == collapse(types(jax_dir))
        assert set(hb_keys(port_dir)) == set(hb_keys(jax_dir))
        assert hb_keys(port_dir)[::len(hb_keys(port_dir)) - 1] \
            == hb_keys(jax_dir)[::len(hb_keys(jax_dir)) - 1]
    else:
        assert types(port_dir) == types(jax_dir)
        assert hb_keys(port_dir) == hb_keys(jax_dir)
    # the reference's PT run arms the health plane on the CPU by default,
    # and so does the port's: its heartbeats carry the plane's keys
    if kind == "pt":
        assert {"jitter_engaged", "refine_diverged", "kernel_cond"} \
            <= hb_keys(port_dir)[0]


def test_telemetry_off_no_stream_same_chain(tmp_path, monkeypatch):
    """``EWT_TELEMETRY=0``: no stream, no health plane, and the chain bit
    for bit the telemetry-on one."""
    chains = []
    for flag in ("1", "0"):
        monkeypatch.setenv("EWT_TELEMETRY", flag)
        tmp = tmp_path / flag
        tmp.mkdir()
        assert cli.main(["--prfile", _paramfile(tmp, "system_noise.dat",
                                                nsamp=120, covUpdate=60),
                         "--num", "1"], device="cpu") == 0
        run = [r for r, _, fs in os.walk(tmp / "out") if "chain_1.txt" in fs]
        assert len(run) == 1
        has_stream = os.path.exists(os.path.join(run[0], "events.jsonl"))
        assert has_stream == (flag == "1")
        chains.append(open(os.path.join(run[0], "chain_1.txt"), "rb").read())
    assert chains[0] == chains[1]
