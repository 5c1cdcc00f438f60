"""The port's serving layer under adversity, against the JAX package's.

- admission: the typed rejections with the reference's reasons, the
  queue bound and the tenant quota, the ``serve.admit`` drill,
  ``parse_serve_config`` and the weighted fair-share order, each equal
  to the reference's on the same inputs;
- deadlines shed at pack time;
- quarantine: one poison row in a full bucket (``serve.harvest``
  ``nonfinite``) isolated by bisection with every co-tenant bit-equal to
  a clean run, direct attribution without bisection, and a dispatch
  exception bisected — the same quarantines and bisect dispatches as the
  reference's driver;
- the queue checkpoint: round trip, the corrupt-generation fallback, an
  unconsumed checkpoint preserved, a demotion in the final flush
  checkpointed, remaining deadlines re-armed, and ``restore`` of an
  unknown model or a wrong geometry rejected with the accounting
  balanced.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from enterprise_warp_tpu.resilience import faults as jfaults
from enterprise_warp_tpu_torch.io.writers import checkpoint_exists
from enterprise_warp_tpu_torch.models.prior_mixin import PriorMixin
from enterprise_warp_tpu_torch.models.priors import Parameter, Uniform
from enterprise_warp_tpu_torch.resilience import faults
from enterprise_warp_tpu_torch.resilience.supervisor import \
    PlatformDemotion
from enterprise_warp_tpu_torch.serve import (Rejection, ServeDriver,
                                             fair_share_order,
                                             parse_serve_config)
from enterprise_warp_tpu_torch.utils import telemetry

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.install_plan(None)
    jfaults.install_plan(None)


class GaussianLike(PriorMixin):
    """Analytic Gaussian in a uniform box (float64 torch), NaN on rows
    equal to ``poison`` (a marker theta)."""

    device = torch.device("cpu")

    def __init__(self, ndim=2, lo=-5.0, hi=5.0, poison=None):
        self.ndim = ndim
        self.params = [Parameter(f"p{i}", Uniform(lo, hi))
                       for i in range(ndim)]
        self.param_names = [p.name for p in self.params]
        self.poison = poison

    def loglike_batch(self, theta):
        theta = torch.as_tensor(theta, dtype=torch.float64)
        out = (-0.5 * torch.sum(theta * theta, dim=-1)
               - 0.5 * self.ndim * math.log(2 * math.pi))
        if self.poison is not None:
            hit = torch.all((theta - self.poison).abs() < 1e-12, dim=-1)
            out = torch.where(hit, torch.full_like(out, math.nan), out)
        return out


def j_like(ndim=2):
    from test_samplers import GaussianLike as JGaussianLike
    return JGaussianLike([0.0] * ndim, [1.0] * ndim, lo=-5.0, hi=5.0)


def driver(root, like, width=8, buckets=(1, 2, 4, 8), cls=ServeDriver,
           **kw):
    drv = cls(str(root), buckets=buckets, **kw)
    drv.register("m0", like, width=width)
    return drv


def j_driver(root, like, **kw):
    from enterprise_warp_tpu.serve import ServeDriver as JDriver
    return driver(root, like, cls=JDriver, **kw)


def events(path):
    return [json.loads(ln) for ln in open(path)] if os.path.exists(path) \
        else []


# ------------------------------------------------------------------ #
#  admission                                                          #
# ------------------------------------------------------------------ #

REJECT_CASES = [(np.full((1, 2), np.nan), "nonfinite"),
                (np.ones((1, 3)), "bad_shape"),
                (np.ones((2, 2, 2)), "bad_shape"),
                (np.zeros((0, 2)), "bad_shape"),
                (np.full((1, 2), 99.0), "prior_support"),
                ([["a", "b"]], "bad_dtype")]


def test_typed_rejections_match_reference(tmp_path):
    from enterprise_warp_tpu.serve import Rejection as JRejection
    reasons = {}
    for name, mk, like, rej_cls in (
            ("t", driver, GaussianLike(), Rejection),
            ("j", j_driver, j_like(), JRejection)):
        got = []
        with mk(tmp_path / name, like) as drv:
            for thetas, _ in REJECT_CASES:
                with pytest.raises(rej_cls) as ei:
                    drv.submit("t0", "m0", thetas)
                got.append((ei.value.reason, ei.value.detail))
            with pytest.raises(KeyError, match="not registered"):
                drv.submit("t0", "nope", np.zeros((1, 2)))
            assert drv.rejected_requests == len(REJECT_CASES) + 1
            assert drv.requests_seen == 0
            assert drv.summary()["accounting"]["balanced"]
        reasons[name] = got
    assert reasons["t"] == reasons["j"]
    assert [r for r, _ in reasons["t"]] == [r for _, r in REJECT_CASES]
    rej = [e for e in events(tmp_path / "t" / "tenants" / "t0"
                             / "events.jsonl")
           if e["type"] == "serve_rejected"]
    assert len(rej) == len(REJECT_CASES) + 1
    assert all(e["reason"] and e["detail"] and e["trace_id"] for e in rej)


def test_queue_bound_and_quota_match_reference(tmp_path):
    out = {}
    for name, mk, like in (("t", driver, GaussianLike()),
                           ("j", j_driver, j_like())):
        got = []
        with mk(tmp_path / name, like, max_queue=3, tenant_quota=2) as drv:
            for tenant in ("t0", "t0", "t0", "t1", "t2"):
                try:
                    drv.submit(tenant, "m0", np.zeros((1, 2)))
                    got.append("ok")
                except Exception as exc:   # noqa: BLE001 — typed below
                    got.append(exc.reason)
            s = drv.run()
        assert s["accounting"]["balanced"]
        out[name] = (got, s["requests_done"], s["rejected_requests"])
    assert out["t"] == out["j"] == (
        ["ok", "ok", "tenant_quota", "ok", "queue_full"], 3, 2)


def test_admit_fault_drill_keeps_accounting_balanced(tmp_path):
    faults.install_plan({"faults": [
        {"site": "serve.admit", "kind": "error", "at": 1}]})
    with driver(tmp_path / "drill", GaussianLike()) as drv:
        with pytest.raises(faults.InjectedFault):
            drv.submit("t0", "m0", np.zeros((1, 2)))
        drv.submit("t0", "m0", np.zeros((1, 2)))
        s = drv.run()
    assert s["requests_done"] == 1 and s["accounting"]["submitted"] == 1
    assert s["accounting"]["balanced"]


class _R:
    def __init__(self, rid, tenant):
        self.rid, self.tenant = rid, tenant


@pytest.mark.parametrize("weights", [None, {"t0": 2}, {"t1": 3, "t2": 0}])
def test_fair_share_order_matches_reference(weights):
    from enterprise_warp_tpu.serve import fair_share_order as j_order
    reqs = [_R(f"g{i}", "t0") for i in range(5)] + [
        _R("a", "t1"), _R("b", "t2"), _R("c", "t1"), _R("g5", "t0")]
    got = [r.rid for r in fair_share_order(reqs, weights)]
    assert got == [r.rid for r in j_order(reqs, weights)]
    if weights is None:
        assert got[:3] == ["g0", "a", "b"]
    assert fair_share_order([], weights) == []


@pytest.mark.parametrize("value", [
    "max_queue=64 tenant_quota=8 default_deadline_ms=5000 weight.gold=4",
    ["max_queue=8"], None, "",
    "slo_p95_ms=250 slo_success=0.99 slo_p95_ms.gold=100 slo_window=128",
    "bogus_knob=1", "max_queue"])
def test_parse_serve_config_matches_reference(value):
    from enterprise_warp_tpu.serve import parse_serve_config as j_parse
    try:
        want = j_parse(value)
    except ValueError as exc:
        with pytest.raises(ValueError) as ei:
            parse_serve_config(value)
        assert str(ei.value) == str(exc)
        return
    assert parse_serve_config(value) == want


def test_driver_fair_share_under_greedy_tenant(tmp_path):
    like = GaussianLike()
    rng = np.random.default_rng(0)
    with driver(tmp_path / "greedy", like, width=2, buckets=(1, 2)) as drv:
        for i in range(6):
            drv.submit("greedy", "m0", like.sample_prior(rng, 1),
                       rid=f"g{i}")
        drv.submit("small", "m0", like.sample_prior(rng, 1), rid="s0")
        s = drv.run()
    assert s["requests_done"] == 7
    assert "s0" in [r["rid"] for r in drv.request_log][:2]


# ------------------------------------------------------------------ #
#  deadlines                                                          #
# ------------------------------------------------------------------ #

def test_deadline_expiry_at_pack_time(tmp_path):
    with driver(tmp_path / "dl", GaussianLike()) as drv:
        ok = drv.submit("t0", "m0", np.zeros((1, 2)), deadline_ms=60000.0)
        dead = drv.submit("t0", "m0", np.zeros((1, 2)), deadline_ms=0.0)
        s = drv.run()
    assert s["requests_done"] == 1 and ok in drv.results
    assert s["expired_requests"] == 1 and dead in drv.expired
    assert dead not in drv.results and s["accounting"]["balanced"]
    evs = events(tmp_path / "dl" / "tenants" / "t0" / "events.jsonl")
    exp = [e for e in evs if e["type"] == "serve_expired"]
    assert len(exp) == 1 and exp[0]["request_id"] == dead
    res = [e for e in evs if e["type"] == "serve_result"]
    assert res[0]["deadline_ms"] == 60000.0 and res[0]["deadline_met"]
    with driver(tmp_path / "dl2", GaussianLike(),
                default_deadline_ms=0.0) as drv:
        rid = drv.submit("t0", "m0", np.zeros((1, 2)))
        s = drv.run()
    assert s["expired_requests"] == 1 and rid in drv.expired


# ------------------------------------------------------------------ #
#  poison quarantine                                                  #
# ------------------------------------------------------------------ #

def _poison_jobs(like, n, seed):
    rng = np.random.default_rng(seed)
    return [(f"t{i % 3}", like.sample_prior(rng, 1), f"r{i}")
            for i in range(n)]


def test_one_poison_row_in_full_bucket(tmp_path):
    """One poison row in a full width-8 bucket: exactly that request
    quarantined by bisection, every co-tenant bit-equal to a clean run,
    and the reference's driver quarantines and bisects the same."""
    like = GaussianLike()
    jobs = _poison_jobs(like, 8, 1)
    with driver(tmp_path / "clean", like) as drv:
        for t, th, rid in jobs:
            drv.submit(t, "m0", th, rid=rid)
        drv.run()
        clean = {r: drv.results[r].copy() for _, _, r in jobs}
    plan = {"faults": [{"site": "serve.harvest", "kind": "nonfinite",
                        "where": "r3"}]}
    out = {}
    for name, mk, lk, fl in (("t", driver, like, faults),
                             ("j", j_driver, j_like(), jfaults)):
        fl.install_plan(plan)
        with mk(tmp_path / f"poison_{name}", lk) as drv:
            for t, th, rid in jobs:
                drv.submit(t, "m0", th, rid=rid)
            s = drv.run()
        fl.install_plan(None)
        out[name] = (dict(drv.quarantined), s["bisect_dispatches"],
                     s["dispatches"], s["requests_done"])
        if name == "t":
            for _, _, rid in jobs:
                if rid != "r3":
                    assert np.array_equal(drv.results[rid], clean[rid]), rid
            assert s["accounting"]["balanced"] and s["dropped_requests"] == 0
    assert out["t"] == out["j"]
    assert out["t"][0] == {"r3": "nonfinite_result"} and out["t"][1] > 0
    q = [e for e in events(tmp_path / "poison_t" / "tenants" / "t0"
                           / "events.jsonl")
         if e["type"] == "serve_quarantined"]
    assert len(q) == 1 and q[0]["request_id"] == "r3"
    counters = telemetry.registry().snapshot()["counters"]
    assert counters.get("serve_quarantined{tenant=t0}", 0) >= 1


def test_partial_contamination_attributes_directly(tmp_path):
    marker = np.full((1, 2), 4.75)
    like = GaussianLike(poison=torch.as_tensor(marker[0]))
    with driver(tmp_path / "direct", like) as drv:
        for t, th, rid in _poison_jobs(like, 4, 2):
            drv.submit(t, "m0", th, rid=rid)
        drv.submit("tbad", "m0", marker, rid="bad")
        s = drv.run()
    assert drv.quarantined == {"bad": "nonfinite_result"}
    assert s["requests_done"] == 4 and s["bisect_dispatches"] == 0
    assert s["accounting"]["balanced"]


def test_dispatch_exception_bisects(tmp_path, monkeypatch):
    like = GaussianLike()
    with driver(tmp_path / "exc", like) as drv:
        real_exec = drv.cache.executable

        def tripwire_exec(lk, bucket):
            exe = real_exec(lk, bucket)

            def run(rows):
                if np.any(np.all(np.abs(np.asarray(rows) - 4.75) < 1e-12,
                                 axis=1)):
                    raise RuntimeError("poisoned batch crash")
                return exe(rows)
            return run

        monkeypatch.setattr(drv.cache, "executable", tripwire_exec)
        for t, th, rid in _poison_jobs(like, 5, 3):
            drv.submit(t, "m0", th, rid=rid)
        drv.submit("tbad", "m0", np.full((1, 2), 4.75), rid="bad")
        s = drv.run()
    assert set(drv.quarantined) == {"bad"}
    assert drv.quarantined["bad"].startswith("dispatch_error")
    assert s["requests_done"] == 5 and s["dropped_requests"] == 0
    assert s["dispatch_error_quarantines"] == 1
    assert s["accounting"]["balanced"]


# ------------------------------------------------------------------ #
#  the queue checkpoint                                               #
# ------------------------------------------------------------------ #

def test_checkpoint_roundtrip_and_corruption_fallback(tmp_path):
    like = GaussianLike()
    root = tmp_path / "q"
    drv = driver(root, like)
    drv.submit("t0", "m0", np.zeros((2, 2)), rid="q0")
    drv.submit("t1", "m0", np.ones((1, 2)), rid="q1", deadline_ms=60000.0)
    drv.checkpoint()                           # generation 1 (2 requests)
    drv.submit("t2", "m0", np.zeros((1, 2)), rid="q2")
    drv.checkpoint()                           # generation 2 (3 requests)
    drv.close()
    ckpt = str(root / "state.npz")
    with open(ckpt, "r+b") as fh:              # rot the newest
        fh.seek(os.path.getsize(ckpt) // 2)
        fh.write(b"\xde\xad\xbe\xef")
    drv2 = driver(root, like)
    assert drv2.restore() == 2                 # the previous generation
    assert {r.rid for r in drv2.queue} == {"q0", "q1"}
    s = drv2.run()
    drv2.close()
    assert s["requests_done"] == 2 and s["restored_requests"] == 2
    assert s["accounting"]["balanced"]
    np.testing.assert_array_equal(
        drv2.results["q0"], like.loglike_batch(np.zeros((2, 2))).numpy())
    assert not checkpoint_exists(ckpt)
    evs = events(root / "events.jsonl")
    assert any(e["type"] == "ckpt_corrupt" for e in evs)


@pytest.mark.parametrize("case", ["unknown_model", "geometry"])
def test_restore_rejects_what_no_longer_fits(tmp_path, case):
    root = tmp_path / case
    drv = driver(root, GaussianLike())
    drv.submit("t0", "m0", np.zeros((1, 2)), rid="k0")
    if case == "unknown_model":
        drv.register("m1", GaussianLike(), width=8)
        drv.submit("t0", "m1", np.zeros((1, 2)), rid="k1")
    drv.checkpoint()
    drv.close()
    drv2 = driver(root, GaussianLike(ndim=2 if case == "unknown_model"
                                     else 3))
    if case == "unknown_model":
        assert drv2.restore() == 1
        assert drv2.rejected == {"k1": "unknown_model"}
        s = drv2.run()
        assert s["requests_done"] == 1
    else:
        assert drv2.restore() == 0
        assert drv2.rejected == {"k0": "bad_shape"}
        s = drv2.summary()
    drv2.close()
    assert s["accounting"]["balanced"], s["accounting"]


def test_unconsumed_checkpoint_preserved(tmp_path):
    like = GaussianLike()
    root = tmp_path / "qu"
    drv = driver(root, like)
    drv.submit("t0", "m0", np.zeros((1, 2)), rid="u0")
    drv.checkpoint()
    drv.close()
    drv2 = driver(root, like)
    drv2.submit("t1", "m0", np.ones((1, 2)), rid="v0")
    assert drv2.run()["requests_done"] == 1
    drv2.close()
    assert os.path.exists(root / "state.npz")
    drv3 = driver(root, like)
    assert drv3.restore() == 1
    drv3.run()
    drv3.close()
    assert "u0" in drv3.results
    assert not checkpoint_exists(str(root / "state.npz"))


def test_demotion_during_final_flush_checkpoints(tmp_path, monkeypatch):
    like = GaussianLike()
    root = tmp_path / "qf"
    drv = driver(root, like)
    drv.submit("t0", "m0", np.zeros((1, 2)), rid="f0")
    real_flush = drv.pipe.flush
    state = {"n": 0}

    def demoting_flush():
        if state["n"] == 0:
            state["n"] = 1
            raise PlatformDemotion("classic", None, "serve.dispatch")
        return real_flush()

    monkeypatch.setattr(drv.pipe, "flush", demoting_flush)
    with pytest.raises(PlatformDemotion):
        drv.run()
    assert os.path.exists(root / "state.npz")
    drv.close()
    drv2 = driver(root, like)
    assert drv2.restore() == 1
    s = drv2.run()
    drv2.close()
    assert "f0" in drv2.results and s["accounting"]["balanced"]


def test_restore_rearms_remaining_deadline(tmp_path):
    like = GaussianLike()
    root = tmp_path / "qd"
    drv = driver(root, like)
    drv.submit("t0", "m0", np.zeros((1, 2)), rid="d0", deadline_ms=0.0)
    drv.submit("t0", "m0", np.zeros((1, 2)), rid="d1",
               deadline_ms=120000.0)
    drv.checkpoint()
    drv.close()
    drv2 = driver(root, like)
    assert drv2.restore() == 2
    s = drv2.run()
    drv2.close()
    assert "d0" in drv2.expired and "d1" in drv2.results
    assert s["accounting"]["balanced"]


def test_quarantined_model_refused(tmp_path):
    like = GaussianLike()
    like.quarantined = True
    with ServeDriver(str(tmp_path / "qm"), buckets=(1, 8)) as drv:
        with pytest.raises(Rejection) as ei:
            drv.register("m0", like)
        assert ei.value.reason == "model_quarantined"
        with pytest.raises(ValueError, match="configured bucket"):
            drv.register("m1", GaussianLike(), width=3)
