"""Request tracing and the tenant SLO plane of the port's serving layer.

- every completed request's latency decomposition (``queue_ms + pack_ms
  + dispatch_ms + harvest_ms + other_ms``) sums to its ``latency_ms``
  within 0.01 ms, with telemetry on and off;
- a request keeps one trace id across a bottom-rung demotion, the queue
  checkpoint and a second session's restore, and through the bisect
  re-dispatches of a poisoned batch (``tools/observatory.py``'s trace
  check finds no problem);
- ``SLOEngine`` gives the reference's burn rates, budgets, gauges and
  breach events on the same injected elapsed times, and the driver's
  gauges equal the observatory's recount from the streams;
- every driver and tenant stream passes ``tools/report.py --check``;
- with ``EWT_TELEMETRY=0`` the results are bit-equal, the dispatches the
  same and nothing is written.
"""

import importlib.util
import io
import json
import math
import os
import pathlib

import numpy as np
import pytest
import torch

from enterprise_warp_tpu_torch.models.prior_mixin import PriorMixin
from enterprise_warp_tpu_torch.models.priors import Parameter, Uniform
from enterprise_warp_tpu_torch.resilience import faults
from enterprise_warp_tpu_torch.resilience.supervisor import \
    PlatformDemotion
from enterprise_warp_tpu_torch.serve import SLOEngine, ServeDriver
from enterprise_warp_tpu_torch.utils import telemetry

torch.set_num_threads(2)
REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
# each of latency_ms and the five stage fields is rounded to 3 decimals
# at emit: at most 6 x 0.0005 ms of rounding slack
RECONCILE_TOL_MS = 0.01


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ewt_tool_torch_trc_{name}", str(REPO_ROOT / "tools" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.install_plan(None)


class GaussianLike(PriorMixin):
    """Analytic Gaussian in a uniform box (float64 torch)."""

    device = torch.device("cpu")

    def __init__(self, ndim=2):
        self.ndim = ndim
        self.params = [Parameter(f"p{i}", Uniform(-5.0, 5.0))
                       for i in range(ndim)]
        self.param_names = [p.name for p in self.params]

    def loglike_batch(self, theta):
        theta = torch.as_tensor(theta, dtype=torch.float64)
        return (-0.5 * torch.sum(theta * theta, dim=-1)
                - 0.5 * self.ndim * math.log(2 * math.pi))


def driver(root, like, width=8, buckets=(1, 2, 4, 8), **kw):
    drv = ServeDriver(str(root), buckets=buckets, **kw)
    drv.register("m0", like, width=width)
    return drv


def events(path):
    return [json.loads(ln) for ln in open(path)] if os.path.exists(path) \
        else []


def tenant_events(root):
    tdir = os.path.join(str(root), "tenants")
    out = []
    for name in sorted(os.listdir(tdir)) if os.path.isdir(tdir) else []:
        out.extend(events(os.path.join(tdir, name, "events.jsonl")))
    return out


def reconciles(ev):
    staged = sum(ev.get(f, 0.0) for f in ("queue_ms", "pack_ms",
                                          "dispatch_ms", "harvest_ms",
                                          "other_ms"))
    return abs(ev["latency_ms"] - staged) <= RECONCILE_TOL_MS


def streams_clean(root):
    report = _tool("report")
    paths = [pathlib.Path(root) / "events.jsonl"] + sorted(
        (pathlib.Path(root) / "tenants").glob("*/events.jsonl"))
    for p in paths:
        assert report.check_stream(str(p), out=io.StringIO()) == 0, p
        assert telemetry.check_stream(str(p))[0] == 0, p
    return len(paths)


@pytest.mark.parametrize("telemetry_on", [True, False])
def test_decomposition_reconciles(tmp_path, monkeypatch, telemetry_on):
    if not telemetry_on:
        monkeypatch.setenv("EWT_TELEMETRY", "0")
    like = GaussianLike()
    rng = np.random.default_rng(3)
    with driver(tmp_path / "dec", like, width=4, buckets=(1, 4)) as drv:
        for i in range(7):
            drv.submit(f"t{i % 2}", "m0", like.sample_prior(rng, 1 + i % 3),
                       rid=f"d{i}")
        s = drv.run()
    dec = s["decomposition"]
    assert dec["n"] == 7 and dec["unaccounted_ms_max"] <= RECONCILE_TOL_MS
    for row in drv.request_log:
        assert reconciles(row), row
    results = [e for e in tenant_events(tmp_path / "dec")
               if e["type"] == "serve_result"]
    if telemetry_on:
        assert len(results) == 7 and all(reconciles(e) for e in results)
        assert streams_clean(tmp_path / "dec") == 3
        hb = [e for e in events(tmp_path / "dec" / "events.jsonl")
              if e["type"] == "heartbeat"]
        assert hb[-1]["queue_depth"] == 0 and hb[-1]["requests_done"] == 7
        for k in ("queue_depth_max", "queue_age_ms", "shed_per_s",
                  "batch_fill"):
            assert any(k in e for e in hb), k
    else:
        assert not results
        assert not (tmp_path / "dec" / "events.jsonl").exists()


def test_trace_ids_across_the_queue_checkpoint(tmp_path, monkeypatch):
    """A bottom-rung demotion requeues and checkpoints mid-drain; a second
    driver restores and drains. Each request keeps the trace id minted at
    submit through its requeue and its result, and its decomposition
    reconciles against the cross-session latency."""
    like = GaussianLike()
    root = tmp_path / "dem"
    rng = np.random.default_rng(0)
    drv = driver(root, like)
    for t, n, rid in (("t0", 2, "a0"), ("t1", 3, "a1"), ("t0", 1, "a2")):
        drv.submit(t, "m0", like.sample_prior(rng, n), rid=rid)
    live = {r.rid: r.trace_id for r in drv.queue}

    def demoting_call(thunk, **kw):
        raise PlatformDemotion("classic", None, "serve.dispatch")

    monkeypatch.setattr(drv.sup, "call", demoting_call)
    with pytest.raises(PlatformDemotion):
        drv.run()
    assert os.path.exists(root / "state.npz")
    drv.close()
    trace = {e["request_id"]: e["trace_id"] for e in tenant_events(root)
             if e["type"] == "serve_request"}
    assert trace == live and len(set(trace.values())) == 3
    requeues = [e for e in events(root / "events.jsonl")
                if e["type"] == "serve_requeue"]
    assert {e["request_id"] for e in requeues} == set(trace)
    assert all(e["trace_id"] == trace[e["request_id"]]
               and e["reason"] == "demotion" for e in requeues)
    drv2 = driver(root, like)
    assert drv2.restore() == 3
    s = drv2.run()
    drv2.close()
    assert s["requests_done"] == 3 and s["accounting"]["balanced"]
    results = [e for e in tenant_events(root) if e["type"] == "serve_result"]
    assert {e["request_id"] for e in results} == set(trace)
    for ev in results:
        assert ev["trace_id"] == trace[ev["request_id"]]
        assert ev.get("requeues") == 1 and reconciles(ev), ev
    seen = {tid for e in events(root / "events.jsonl")
            if e["type"] == "serve_stage" and e["stage"] == "dispatch"
            for tid in e["trace_ids"]}
    assert set(trace.values()) <= seen
    assert _tool("observatory").trace_problems(str(root)) == []
    streams_clean(root)


def test_poison_bisect_keeps_co_tenant_traces(tmp_path):
    like = GaussianLike()
    rng = np.random.default_rng(1)
    root = tmp_path / "poison"
    faults.install_plan({"faults": [{"site": "serve.harvest",
                                     "kind": "nonfinite", "where": "r3"}]})
    with driver(root, like) as drv:
        for i in range(8):
            drv.submit(f"t{i % 3}", "m0", like.sample_prior(rng, 1),
                       rid=f"r{i}")
        s = drv.run()
    faults.install_plan(None)
    assert set(drv.quarantined) == {"r3"} and s["bisect_dispatches"] > 0
    trace = {e["request_id"]: e["trace_id"] for e in tenant_events(root)
             if e["type"] == "serve_request"}
    quar = [e for e in tenant_events(root)
            if e["type"] == "serve_quarantined"]
    assert len(quar) == 1 and quar[0]["trace_id"] == trace["r3"]
    results = [e for e in tenant_events(root) if e["type"] == "serve_result"]
    assert {e["request_id"] for e in results} == set(trace) - {"r3"}
    assert all(e["trace_id"] == trace[e["request_id"]] and reconciles(e)
               for e in results)
    bisects = [e for e in events(root / "events.jsonl")
               if e["type"] == "serve_stage" and e["stage"] == "dispatch"
               and e.get("bisect")]
    assert bisects and any(trace["r3"] in e["trace_ids"] for e in bisects)
    assert _tool("observatory").trace_problems(str(root)) == []
    streams_clean(root)


def test_telemetry_off_is_bit_equal_and_writes_nothing(tmp_path,
                                                       monkeypatch):
    like = GaussianLike()
    rng = np.random.default_rng(2)
    jobs = [(f"t{i % 2}", like.sample_prior(rng, 1 + i % 3), f"z{i}")
            for i in range(6)]

    def run(root):
        with driver(root, like) as drv:
            for t, th, rid in jobs:
                drv.submit(t, "m0", th, rid=rid)
            s = drv.run()
        return {r: drv.results[r].copy() for _, _, r in jobs}, s

    on, s_on = run(tmp_path / "on")
    monkeypatch.setenv("EWT_TELEMETRY", "0")
    off, s_off = run(tmp_path / "off")
    for _, _, rid in jobs:
        assert np.array_equal(on[rid], off[rid]), rid
    assert s_on["dispatches"] == s_off["dispatches"]
    assert s_on["requests_done"] == s_off["requests_done"] == 6
    assert not (tmp_path / "off" / "events.jsonl").exists()
    assert not (tmp_path / "off" / "tenants").exists()


# ------------------------------------------------------------------ #
#  the SLO plane                                                      #
# ------------------------------------------------------------------ #

SLO_CASES = [
    ({"default": {"p95_ms": 5.0, "success": 0.9}}, 8),
    ({"default": {"p95_ms": 10.0}, "t1": {"success": 0.5}}, 4),
    ({"t0": {"success": 0.99}}, 32),
]


@pytest.mark.parametrize("objectives,window", SLO_CASES)
def test_slo_engine_matches_reference(objectives, window):
    from enterprise_warp_tpu.serve import SLOEngine as JSLOEngine
    from enterprise_warp_tpu.utils import telemetry as jtelemetry
    rng = np.random.default_rng(window)
    outcomes = [(f"t{int(rng.integers(3))}", float(rng.exponential(8.0)),
                 bool(rng.random() < 0.8)) for _ in range(60)]
    got = {}
    for name, cls, reg in (("t", SLOEngine, telemetry.registry()),
                           ("j", JSLOEngine, jtelemetry.registry())):
        reg.reset()
        eng = cls(objectives, window=window)
        emitted = []
        verdicts = [eng.observe(t, e, ok,
                                emit=lambda typ, **f: emitted.append(
                                    (typ, f)))
                    for t, e, ok in outcomes]
        got[name] = (verdicts, emitted, eng.summary(), eng.breach_count,
                     reg.snapshot()["gauges"])
    assert got["t"] == got["j"]
    assert got["t"][3] >= 1 and got["t"][1][0][0] == "slo_breach"


def test_slo_gauges_match_the_observatory_recount(tmp_path):
    telemetry.registry().reset()
    like = GaussianLike()
    rng = np.random.default_rng(4)
    objectives = {"default": {"p95_ms": 0.001, "success": 0.9},
                  "t1": {"p95_ms": 60000.0}}
    root = tmp_path / "slo"
    with driver(root, like, slo={"objectives": objectives,
                                 "window": 32}) as drv:
        assert drv.slo is not None
        for i in range(9):
            drv.submit(f"t{i % 3}", "m0", like.sample_prior(rng, 1),
                       rid=f"s{i}")
        s = drv.run()
    assert s["requests_done"] == 9
    breaches = [e for e in events(root / "events.jsonl")
                if e["type"] == "slo_breach"]
    assert breaches and s["slo"]["breach_episodes"] >= 1
    assert all(e["burn_rate"] > 1.0 for e in breaches)
    cfg = [e for e in events(root / "events.jsonl")
           if e["type"] == "slo_config"]
    assert len(cfg) == 1 and cfg[0]["window"] == 32
    obs = _tool("observatory")
    gauges = telemetry.registry().snapshot()["gauges"]
    for tenant in ("t0", "t1", "t2"):
        evs = events(root / "tenants" / tenant / "events.jsonl")
        rec = obs.recount_burn(obs.tenant_outcomes(evs),
                               obs.effective_objective(objectives, tenant),
                               window=32)
        assert rec, tenant
        for slo, v in rec.items():
            key = f"slo_burn_rate{{slo={slo},tenant={tenant}}}"
            assert abs(gauges[key] - v["burn_rate"]) < 1e-9, (tenant, slo)
            live = s["slo"]["tenants"][tenant]["slo"][slo]
            assert abs(live["burn_rate"] - v["burn_rate"]) < 1e-9
    streams_clean(root)


def test_no_slo_engine_without_objectives(tmp_path):
    assert SLOEngine.from_config(None) is None
    assert SLOEngine.from_config({"window": 9}) is None
    with driver(tmp_path / "noslo", GaussianLike()) as drv:
        assert drv.slo is None
        drv.submit("t0", "m0", np.zeros((1, 2)), rid="n0")
        s = drv.run()
    assert s["slo"] is None
    assert not [e for e in events(tmp_path / "noslo" / "events.jsonl")
                if e["type"] in ("slo_breach", "slo_config")]
