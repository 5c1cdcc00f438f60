"""The port's resilience layer (``resilience/faults.py``,
``resilience/supervisor.py``, ``utils/deviceprobe.py``) on the CPU.

- ``FaultPlan`` against the JAX package's class on the same plan JSONs:
  the same spec fires at the same occurrence of the same site;
- the supervisor contracts of ``tests/test_resilience.py::TestSupervisor``
  (inline fast path, retry then success, exhaustion and hang demoting
  with the checkpoint flushed first, non-transient errors unwrapped, the
  ladder ``mega -> classic -> restart``), plus CUDA errors that leave the
  context unusable: raised as they are, never retried, never demoted to
  the plain version;
- an injected dispatch error retried bit for bit for PT, HMC and nested,
  and the threaded watchdog leaving the PT chain bit for bit as it was;
- kill-and-resume: a subprocess killed at ``pt.ckpt``, ``pt.chain``,
  ``hmc.ckpt`` or ``nested.ckpt`` (blocked and per-iteration), resumed,
  ends with the uninterrupted run's output byte for byte, its stream
  check-clean;
- SIGTERM on the port's CLI gives ``run_end(reason="preempted")`` before
  the ring dump, and a resume completes; a planted ``pt.nonfinite`` dumps
  ``anomaly/anomaly.json``; non-finite evaluations are counted apart from
  the likelihood kernel route's rejections; a watchdog hang demotes ``mega -> classic`` in
  process and the run completes; a nested breaker trip checkpoints the
  last committed block and a resume reproduces the uninterrupted run; the
  ladder's bottom exits 75 with no re-execution, and a resume completes;
- ``deviceprobe``'s outcomes, memo and counter; ``ckpt.verify``'s torn
  checkpoint falling back a generation with a ``ckpt_corrupt`` event.
"""

import json
import math
import os
import runpy
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from enterprise_warp_tpu.resilience import faults as jfaults
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.resilience import faults, supervisor
from enterprise_warp_tpu_torch.samplers import PTSampler, run_nested
from enterprise_warp_tpu_torch.samplers.hmc import HMCSampler
from enterprise_warp_tpu_torch.utils import deviceprobe, flightrec, telemetry

from test_torch_ptmcmc import GaussianLike
from test_torch_telemetry import _events, _paramfile, _report_cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No plan, no pending preemption, the kernels on, telemetry on."""
    faults.install_plan(None)
    supervisor.clear_preemption()
    for k in ("EWT_PALLAS", "EWT_PALLAS_MEGA"):
        monkeypatch.setenv(k, "1")             # restored after the test
        monkeypatch.delenv(k)
    for k in ("EWT_WATCHDOG_S", "EWT_FAULT_PLAN", "EWT_FLIGHTREC",
              "EWT_TELEMETRY", "EWT_DISPATCH_RETRIES",
              "EWT_DISPATCH_STRIKES"):
        monkeypatch.delenv(k, raising=False)
    telemetry.registry().reset()
    yield
    faults.install_plan(None)
    supervisor.clear_preemption()


# ------------------------------------------------------------------ #
#  the fault plan                                                     #
# ------------------------------------------------------------------ #

PLANS = [
    {"faults": [{"site": "pt.dispatch", "kind": "error", "at": 2}]},
    {"faults": [{"site": "a", "kind": "error", "at": 2, "count": 2},
                {"site": "b", "kind": "nonfinite"}]},
    {"faults": [{"site": "io.atomic_json", "kind": "torn",
                 "where": "mask_stats", "frac": 0.3},
                {"site": "pt.ckpt", "kind": "kill", "at": 3}]},
    [{"site": "nested.iteration", "kind": "hang", "at": 1, "hang_s": 5}],
]
CALLS = [("pt.dispatch", {}), ("a", {}), ("b", {}), ("a", {}),
         ("io.atomic_json", {"path": "/x/chain_1.txt"}),
         ("io.atomic_json", {"path": "/x/mask_stats.json"}), ("a", {}),
         ("pt.dispatch", {}), ("pt.ckpt", {"step": 3}), ("pt.ckpt", {}),
         ("pt.ckpt", {}), ("nested.iteration", {}), ("a", {}),
         ("pt.dispatch", {})]


@pytest.mark.parametrize("plan", PLANS)
def test_fault_plan_fires_as_the_reference(plan):
    seq = []
    for mod in (faults, jfaults):
        p = mod.FaultPlan.from_json(json.dumps(plan))
        fired = []
        for site, ctx in CALLS:
            spec = p.check(site, ctx)
            fired.append(None if spec is None else
                         (spec.kind, spec.at, spec.frac, spec.hang_s))
        seq.append((fired, {s: p.occurrences(s) for s, _ in CALLS}))
    assert seq[0] == seq[1]


def test_fault_plan_env_schema_and_torn_bytes(monkeypatch):
    assert faults.plan() is None and faults.fire("pt.dispatch") is None
    monkeypatch.setenv("EWT_FAULT_PLAN", json.dumps(
        {"faults": [{"site": "a", "kind": "error", "at": 2}]}))
    monkeypatch.setattr(faults, "_PLAN", False)
    assert faults.fire("a") is None
    with pytest.raises(faults.InjectedFault):
        faults.fire("a")
    assert telemetry.registry().snapshot()["counters"][
        "fault_injected{site=a}"] == 1
    for bad in ({"site": "x", "kind": "melt"},
                {"site": "x", "kind": "error", "banana": 1}):
        with pytest.raises(ValueError):
            faults.FaultPlan.from_json({"faults": [bad]})
    spec = faults.FaultSpec(site="s", kind="torn", frac=0.5)
    assert faults.torn_bytes(spec, b"0123456789") == b"01234"
    assert faults.torn_bytes(spec, "ab") == "a"


# ------------------------------------------------------------------ #
#  the supervisor                                                     #
# ------------------------------------------------------------------ #

def test_inline_fast_path_when_unarmed():
    sup = supervisor.BlockSupervisor("s", watchdog_s=0)
    assert not sup.supervised()
    assert sup.call(lambda: 41 + 1) == 42
    assert sup.calls == 0


def test_retry_then_success_counts_a_strike():
    faults.install_plan({"faults": [
        {"site": "s", "kind": "error", "at": 1, "count": 2}]})
    sup = supervisor.BlockSupervisor("s", retries=3, backoff_s=0.001)
    assert sup.call(lambda: "ok") == "ok"
    assert sup.strikes == 1
    snap = telemetry.registry().snapshot()["counters"]
    assert snap["dispatch_retry{site=s}"] == 2


def test_retry_exhaustion_demotes_with_checkpoint():
    faults.install_plan({"faults": [{"site": "s", "kind": "error"}]})
    flushed = []
    sup = supervisor.BlockSupervisor("s", retries=1, backoff_s=0.001,
                                     on_checkpoint=lambda: flushed.append(1))
    with pytest.raises(supervisor.PlatformDemotion) as ei:
        sup.call(lambda: "never")
    assert flushed == [1]
    assert (ei.value.from_level, ei.value.to_level) == ("mega", "classic")
    assert isinstance(ei.value.cause, faults.InjectedFault)


def test_watchdog_converts_hang_into_demotion():
    faults.install_plan({"faults": [
        {"site": "h", "kind": "hang", "at": 1, "hang_s": 30}]})
    ran = []
    sup = supervisor.BlockSupervisor("h", watchdog_s=0.2, retries=0)
    t0 = time.monotonic()
    with pytest.raises(supervisor.PlatformDemotion) as ei:
        sup.call(lambda: ran.append(1))
    assert time.monotonic() - t0 < 10
    assert isinstance(ei.value.cause, supervisor.DispatchHang)
    snap = telemetry.registry().snapshot()["counters"]
    assert snap["dispatch_hang{site=h}"] == 1
    assert snap["demotion{from=mega,to=classic}"] == 1
    assert ran == []          # the abandoned attempt never ran the block


def test_non_transient_errors_propagate_unwrapped():
    faults.install_plan({"faults": []})
    sup = supervisor.BlockSupervisor("s", retries=3, backoff_s=0.001)

    def boom():
        raise ValueError("shape mismatch")
    with pytest.raises(ValueError):
        sup.call(boom)


def test_non_transient_error_on_retry_demotes():
    faults.install_plan({"faults": [{"site": "s", "kind": "error",
                                     "at": 1}]})
    flushed, calls = [], []
    sup = supervisor.BlockSupervisor("s", retries=3, backoff_s=0.001,
                                     on_checkpoint=lambda: flushed.append(1))

    def thunk():
        calls.append(1)
        raise RuntimeError("input was consumed")
    with pytest.raises(supervisor.PlatformDemotion) as ei:
        sup.call(thunk)
    assert calls == [1] and flushed == [1]
    assert isinstance(ei.value.cause, RuntimeError)


STICKY = [
    "mega_like CUDA launch failed: cudaError 700",
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered",
    # torch's text for cudaErrorDevicesUnavailable holds a transient
    # marker of the reference ("unavailable"): sticky all the same
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
]


@pytest.mark.parametrize("msg", STICKY)
@pytest.mark.parametrize("first_attempt_injected", [False, True])
def test_sticky_cuda_errors_propagate_unwrapped(msg, first_attempt_injected):
    """A CUDA error that leaves the context unusable is raised as it is:
    no retry, no demotion (the routes' switches untouched), even when it comes
    on a retry of an injected fault."""
    plan = [{"site": "s", "kind": "error", "at": 1}] \
        if first_attempt_injected else []
    faults.install_plan({"faults": plan})
    calls, flushed = [], []
    sup = supervisor.BlockSupervisor("s", retries=3, backoff_s=0.001,
                                     on_checkpoint=lambda: flushed.append(1))

    def thunk():
        calls.append(1)
        raise RuntimeError(msg)
    with pytest.raises(RuntimeError) as ei:
        sup.call(thunk)
    assert str(ei.value) == msg and type(ei.value) is RuntimeError
    assert calls == [1] and flushed == []
    assert "EWT_PALLAS" not in os.environ
    assert "EWT_PALLAS_MEGA" not in os.environ
    assert not supervisor._is_transient(ei.value)


def test_ladder_and_apply_demotion():
    assert supervisor.current_level() == "mega"
    assert supervisor.next_level("mega") == "classic"
    assert supervisor.next_level("classic") is None
    d = supervisor.PlatformDemotion("mega", "classic", "s")
    assert supervisor.apply_demotion(d)
    # the classic chain with its preconditioner kernel: no kernel is
    # switched to its plain version
    assert os.environ["EWT_PALLAS_MEGA"] == "0"
    assert "EWT_PALLAS" not in os.environ
    assert supervisor.current_level() == "classic"
    assert not supervisor.apply_demotion(
        supervisor.PlatformDemotion("classic", None, "s"))


def test_watchdog_worker_runs_the_block():
    sup = supervisor.BlockSupervisor("w", watchdog_s=30)
    gen = torch.Generator().manual_seed(3)
    want = torch.rand(4, generator=torch.Generator().manual_seed(3))
    got = sup.call(lambda: torch.rand(4, generator=gen), gen=gen)
    assert torch.equal(got, want)


# ------------------------------------------------------------------ #
#  the samplers under injected faults (in process)                    #
# ------------------------------------------------------------------ #

def _like():
    return GaussianLike([1.0, -1.0], [0.5, 0.5])


def _run_pt(outdir, nsamp=90):
    s = PTSampler(_like(), str(outdir), ntemps=2, nchains=4, seed=0,
                  cov_update=30)
    s.sample(nsamp, resume=False, verbose=False)
    return (outdir / "chain_1.txt").read_bytes()


def _run_hmc(outdir):
    s = HMCSampler(_like(), str(outdir), nchains=8, seed=0, warmup=20,
                   n_leapfrog=4)
    s.sample(40, resume=False, verbose=False, block_size=20)
    return (outdir / "chain_1.txt").read_bytes()


def _run_nested(outdir, block_iters=4):
    run_nested(_like(), outdir=str(outdir), nlive=40, kbatch=8, nsteps=5,
               dlogz=1e-9, max_iter=12, seed=0, label="r", verbose=False,
               block_iters=block_iters, kernel="walk")
    return (outdir / "r_result.json").read_bytes() \
        + (outdir / "r_nested.npz").read_bytes()


@pytest.mark.parametrize("run,site", [
    (_run_pt, "pt.dispatch"), (_run_hmc, "hmc.dispatch"),
    (_run_nested, "nested.iteration"),
    (lambda d: _run_nested(d, block_iters=0), "nested.iteration")],
    ids=["pt", "hmc", "nested", "nested-periter"])
def test_injected_dispatch_error_is_retried_bit_equal(tmp_path, run, site):
    ref = run(tmp_path / "ref")
    faults.install_plan({"faults": [{"site": site, "kind": "error",
                                     "at": 2}]})
    got = run(tmp_path / "flaky")
    assert got == ref
    assert telemetry.registry().snapshot()["counters"][
        f"dispatch_retry{{site={site}}}"] == 1
    retries = [e for e in _events(tmp_path / "flaky" / "events.jsonl")
               if e["type"] == "retry"]
    assert len(retries) == 1 and retries[0]["site"] == site


def test_threaded_watchdog_is_transparent(tmp_path, monkeypatch):
    ref = _run_pt(tmp_path / "ref")
    monkeypatch.setenv("EWT_WATCHDOG_S", "120")
    assert _run_pt(tmp_path / "watched") == ref


def test_nonfinite_injection_dumps_anomaly(tmp_path, monkeypatch):
    monkeypatch.setenv("EWT_FLIGHTREC", "1")
    monkeypatch.setattr(flightrec, "_RECORDER", None)
    ref = _run_pt(tmp_path / "ref")
    faults.install_plan({"faults": [{"site": "pt.nonfinite",
                                     "kind": "nonfinite", "at": 2}]})
    got = _run_pt(tmp_path / "nf")
    telemetry.set_flight_hook(None)
    assert got == ref                 # the escalation leaves the chain
    doc = json.loads((tmp_path / "nf" / "anomaly" / "anomaly.json")
                     .read_text())
    assert doc["reason"] == "nonfinite_eval"
    assert doc["payload"]["n_bad_evals"] == 1
    assert doc["state"]["sampler"] == "ptmcmc"
    assert telemetry.registry().snapshot()["counters"][
        "nonfinite_eval{where=block}"] == 1
    events = _events(tmp_path / "nf" / "events.jsonl")
    assert [e["reason"] for e in events if e["type"] == "anomaly"] == \
        ["nonfinite_eval"]
    assert telemetry.check_stream(tmp_path / "nf" / "events.jsonl")[0] == 0


class _CornerLike(GaussianLike):
    """NaN (mapped to -inf, as the likelihood constructors map it) above
    ``p0 = 3``; with ``reject`` those walkers are flagged as the kernel
    route's chosen rejections (``last_reject``)."""

    def __init__(self, reject):
        super().__init__([1.0, -1.0], [0.5, 0.5])
        self.reject = reject
        self.last_reject = None

    def loglike_batch(self, theta):
        th = torch.as_tensor(theta, dtype=torch.float64)
        lnl = super().loglike_batch(th)
        corner = th[:, 0] > 3.0
        if self.reject:
            self.last_reject = corner
        return torch.where(corner, -math.inf, lnl)


@pytest.mark.parametrize("reject", [False, True])
def test_nonfinite_evaluations_counted_apart_from_rejections(tmp_path,
                                                             reject):
    """Non-finite evaluations at finite-prior points are counted (and
    dumped once); the likelihood kernel route's chosen rejections are
    counted as ``schur_rejected`` instead, and dump nothing."""
    from enterprise_warp_tpu_torch.samplers import PTSampler as PT
    s = PT(_CornerLike(reject), str(tmp_path), ntemps=1, nchains=16,
           seed=2, cov_update=100, prior_weight=50)
    s.sample(200, resume=False, verbose=False)
    c = telemetry.registry().snapshot()["counters"]
    nf = c.get("nonfinite_eval{where=block}", 0)
    rej = c.get("schur_rejected{where=block}", 0)
    if reject:
        assert nf == 0 and rej > 0
    else:
        assert nf > 0 and rej == 0


def test_preemption_stops_at_block_boundary(tmp_path):
    s = PTSampler(_like(), str(tmp_path), ntemps=2, nchains=4, seed=0,
                  cov_update=30)
    supervisor.request_preemption()
    st = s.sample(90, resume=False, verbose=False)
    assert st.step == 0
    ends = [e for e in _events(tmp_path / "events.jsonl")
            if e["type"] == "run_end"]
    assert len(ends) == 1 and ends[0]["reason"] == "preempted"


def test_watchdog_hang_demotes_mega_to_classic(tmp_path, monkeypatch):
    """A block that hangs past ``EWT_WATCHDOG_S``: the breaker demotes
    ``mega -> classic`` (``EWT_PALLAS_MEGA=0``), ``run_ptmcmc`` re-enters from
    the checkpoint, and the run completes with the uninterrupted chain."""
    from enterprise_warp_tpu_torch.samplers import run_ptmcmc
    ref = _run_pt(tmp_path / "ref")
    monkeypatch.setenv("EWT_WATCHDOG_S", "0.5")
    faults.install_plan({"faults": [{"site": "pt.dispatch", "kind": "hang",
                                     "at": 2, "hang_s": 20}]})
    run_ptmcmc(_like(), str(tmp_path / "hang"), 90, ntemps=2, nchains=4,
               cov_update=30, verbose=False)
    assert os.environ["EWT_PALLAS_MEGA"] == "0"
    assert "EWT_PALLAS" not in os.environ
    assert (tmp_path / "hang" / "chain_1.txt").read_bytes() == ref
    events = _events(tmp_path / "hang" / "events.jsonl")
    dem = [e for e in events if e["type"] == "demotion"]
    assert len(dem) == 1 and (dem[0]["from"], dem[0]["to"]) == \
        ("mega", "classic")
    lin = [e for e in events if e["type"] == "run_lineage"]
    assert [e["reason"] for e in lin] == ["fresh", "demotion"]
    assert telemetry.check_stream(tmp_path / "hang" / "events.jsonl")[0] == 0


def test_nested_breaker_resumes_last_commit(tmp_path, monkeypatch):
    """A breaker trip between ``checkpoint_every`` marks finds a checkpoint
    at the last committed block (the supervisor's ``on_checkpoint``): with
    the faults persisting, ``run_nested`` re-enters in process on the
    classic rung, trips again at the bottom and raises; a clean rerun
    resumes from the last commit and reproduces the uninterrupted run."""
    kw = dict(nlive=40, kbatch=8, nsteps=5, dlogz=1e-9, seed=1,
              verbose=False, checkpoint_every=40, block_iters=4, label="r",
              max_iter=12, kernel="walk")
    ref = run_nested(_like(), outdir=str(tmp_path / "ref"), **kw)
    monkeypatch.setenv("EWT_DISPATCH_RETRIES", "1")
    monkeypatch.setenv("EWT_DISPATCH_STRIKES", "1")
    faults.install_plan({"faults": [{"site": "nested.iteration",
                                     "kind": "error", "at": 3,
                                     "count": 10}]})
    with pytest.raises(supervisor.PlatformDemotion) as ei:
        run_nested(_like(), outdir=str(tmp_path / "chaos"), **kw)
    assert ei.value.to_level is None
    assert os.environ["EWT_PALLAS_MEGA"] == "0"
    assert "EWT_PALLAS" not in os.environ
    faults.install_plan(None)
    res = run_nested(_like(), outdir=str(tmp_path / "chaos"), resume=True,
                     **{k: v for k, v in kw.items() if k != "resume"})
    assert res["log_evidence"] == ref["log_evidence"]
    assert np.array_equal(res["samples"], ref["samples"])
    dem = [e for e in _events(tmp_path / "chaos" / "events.jsonl")
           if e["type"] == "demotion"]
    assert [(e["from"], e["to"]) for e in dem] == [("mega", "classic"),
                                                  ("classic", "restart")]


def test_ckpt_verify_torn_falls_back_a_generation(tmp_path):
    from enterprise_warp_tpu_torch.io import writers
    path = str(tmp_path / "state.npz")
    for gen in (b"first generation", b"second generation"):
        tmp = str(tmp_path / "tmp.npz")
        with open(tmp, "wb") as fh:
            fh.write(gen)
        writers.checkpoint_replace(tmp, path)
    faults.install_plan({"faults": [{"site": "ckpt.verify", "kind": "torn",
                                     "at": 1}]})
    with telemetry.run_scope(str(tmp_path), sampler="t"):
        got = writers.resolve_checkpoint(path, what="pt checkpoint")
    assert got == writers.prev_generation(path)
    bad = [e for e in _events(tmp_path / "events.jsonl")
           if e["type"] == "ckpt_corrupt"]
    assert len(bad) == 1 and bad[0]["generation"] == 0


def _corrupt(path):
    """Overwrite four bytes of a checkpoint generation in place (its
    sidecar digest no longer matches)."""
    with open(path, "r+b") as fh:
        fh.seek(10)
        fh.write(b"\x00\x00\x00\x00")


def _corrupt_count():
    return telemetry.registry().snapshot()["counters"].get(
        "ckpt_verify{outcome=corrupt}", 0)


def test_repeat_resolve_memoized_single_telemetry(tmp_path):
    """The twin of the reference's memo test: one corrupt archive resolved
    twice counts one ``ckpt_verify{outcome=corrupt}`` and writes one
    ``ckpt_corrupt`` event; a write invalidates the memo."""
    from enterprise_warp_tpu_torch.io import writers
    path = str(tmp_path / "state.npz")

    def gen(i):
        tmp = str(tmp_path / "tmp.npz")
        with open(tmp, "wb") as fh:
            fh.write(b"generation %d " % i * 8)
        writers.checkpoint_replace(tmp, path)

    gen(1)
    gen(2)
    _corrupt(path)
    c0 = _corrupt_count()
    with telemetry.run_scope(str(tmp_path), sampler="t"):
        r1 = writers.resolve_checkpoint(path)
        assert _corrupt_count() == c0 + 1
        assert writers.resolve_checkpoint(path) == r1     # a memo hit
        assert _corrupt_count() == c0 + 1
        gen(3)                                            # invalidates
        assert writers.resolve_checkpoint(path) == path
    assert r1 == writers.prev_generation(path)
    assert _corrupt_count() == c0 + 1
    bad = [e for e in _events(tmp_path / "events.jsonl")
           if e["type"] == "ckpt_corrupt"]
    assert len(bad) == 1


def test_one_resume_of_a_corrupt_archive_writes_one_ckpt_corrupt(
        tmp_path, monkeypatch):
    """A resume through ``sample_to_convergence`` (which resolves the
    checkpoint, then the sampler again) and one through ``run_hmc`` (which
    decides it is resuming by ``checkpoint_exists`` and resolves once, in
    the sampler) each write exactly one ``ckpt_corrupt``, as the
    reference's do."""
    from enterprise_warp_tpu_torch.samplers import hmc as thmc
    from enterprise_warp_tpu_torch.samplers.convergence import \
        sample_to_convergence

    pt_dir = tmp_path / "pt"
    s = PTSampler(_like(), str(pt_dir), ntemps=1, nchains=8, seed=0,
                  cov_update=40)
    s.sample(120, resume=False, verbose=False)
    _corrupt(str(pt_dir / "state.npz"))
    s = PTSampler(_like(), str(pt_dir), ntemps=1, nchains=8, seed=0,
                  cov_update=40)
    with telemetry.run_scope(str(pt_dir), sampler="ptmcmc"):
        sample_to_convergence(s, target_ess=1e9, check_every=40,
                              max_steps=160, block_size=40, resume=True,
                              verbose=False)
    bad = [e for e in _events(pt_dir / "events.jsonl")
           if e["type"] == "ckpt_corrupt"]
    assert len(bad) == 1 and bad[0]["generation"] == 0

    hmc_dir = tmp_path / "hmc"
    opts = dict(nchains=8, warmup=10, n_leapfrog=4, advi_init=False,
                verbose=False)
    thmc.run_hmc(_like(), str(hmc_dir), 40, resume=False, **opts)
    _corrupt(str(hmc_dir / "state.npz"))
    calls = []
    real = thmc.resolve_checkpoint

    def counted(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(thmc, "resolve_checkpoint", counted)
    with telemetry.run_scope(str(hmc_dir), sampler="hmc"):
        thmc.run_hmc(_like(), str(hmc_dir), 60, resume=True, **opts)
    assert len(calls) == 1
    bad = [e for e in _events(hmc_dir / "events.jsonl")
           if e["type"] == "ckpt_corrupt"]
    assert len(bad) == 1 and bad[0]["what"] == "hmc checkpoint"


# ------------------------------------------------------------------ #
#  kill and resume, across processes                                  #
# ------------------------------------------------------------------ #

CHILD = """\
import math, os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from enterprise_warp_tpu_torch.models.prior_mixin import PriorMixin
from enterprise_warp_tpu_torch.models.priors import Parameter, Uniform


class Like(PriorMixin):
    device = torch.device("cpu")

    def __init__(self):
        self.mu = torch.tensor([1.0, -1.0], dtype=torch.float64)
        self.sigma = torch.tensor([0.5, 0.5], dtype=torch.float64)
        self.ndim = 2
        self.params = [Parameter(f"p{{i}}", Uniform(-10.0, 10.0))
                       for i in range(2)]
        self.param_names = [p.name for p in self.params]

    def loglike_batch(self, theta):
        z = (torch.as_tensor(theta, dtype=torch.float64) - self.mu) \\
            / self.sigma
        return -0.5 * torch.sum(z * z, dim=-1)


like = Like()
outdir = sys.argv[1]
"""

BODIES = {
    "pt": """\
from enterprise_warp_tpu_torch.samplers import PTSampler
PTSampler(like, outdir, ntemps=2, nchains=4, seed=0,
          cov_update=30).sample(90, resume=True, verbose=False)
""",
    "hmc": """\
from enterprise_warp_tpu_torch.samplers.hmc import HMCSampler
HMCSampler(like, outdir, nchains=8, seed=0, warmup=20,
           n_leapfrog=4).sample(60, resume=True, verbose=False,
                                block_size=20)
""",
    "nested": """\
from enterprise_warp_tpu_torch.samplers.nested import run_nested
run_nested(like, outdir=outdir, nlive=40, kbatch=8, nsteps=5, dlogz=0.5,
           seed=0, checkpoint_every=5, label="r", verbose=False,
           block_iters=5, kernel="slice")
""",
    "nested-periter": """\
from enterprise_warp_tpu_torch.samplers.nested import run_nested
run_nested(like, outdir=outdir, nlive=40, kbatch=8, nsteps=5, dlogz=0.5,
           seed=0, checkpoint_every=5, label="r", verbose=False,
           block_iters=0)
""",
}


def _child_env(plan=None):
    env = dict(os.environ)
    env.pop("EWT_FAULT_PLAN", None)
    # the health plane is armed on the CPU by default, and its ladder
    # quarantines J0042-0000 after four blocks at prior corners (as the
    # reference's does, ROADMAP Queue 3): the CLI runs here test other
    # planes
    env["EWT_KERNEL_HEALTH"] = "0"
    if plan is not None:
        env["EWT_FAULT_PLAN"] = json.dumps(plan)
    return env


@pytest.mark.parametrize("body,site,at,artifact", [
    ("pt", "pt.ckpt", 1, "chain_1.txt"),
    ("pt", "pt.chain", 2, "chain_1.txt"),
    ("hmc", "hmc.ckpt", 2, "chain_1.txt"),
    ("nested", "nested.ckpt", 1, "r_result.json"),
    ("nested-periter", "nested.ckpt", 1, "r_result.json"),
], ids=["pt-ckpt-kill", "pt-chain-kill", "hmc-ckpt-kill",
        "nested-ckpt-kill", "nested-periter-ckpt-kill"])
def test_kill_and_resume_reproduces_uninterrupted(tmp_path, body, site, at,
                                                  artifact):
    script = tmp_path / "child.py"
    script.write_text(CHILD.format(repo=REPO) + BODIES[body])
    # the uninterrupted run, in this process (one thread, as the child)
    threads = torch.get_num_threads()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", [str(script), str(tmp_path / "ref")])
            runpy.run_path(str(script), run_name="__main__")
    finally:
        torch.set_num_threads(threads)
    plan = {"faults": [{"site": site, "kind": "kill", "at": at}]}
    attempts = 0
    for attempt in range(1, 5):
        attempts = attempt
        r = subprocess.run(
            [sys.executable, str(script), str(tmp_path / "chaos")],
            env=_child_env(plan if attempt == 1 else None), timeout=300,
            capture_output=True)
        if r.returncode == 0:
            break
        assert r.returncode == -signal.SIGKILL, r.stderr.decode()[-2000:]
    assert attempts == 2          # killed once, resumed once
    assert (tmp_path / "chaos" / artifact).read_bytes() == \
        (tmp_path / "ref" / artifact).read_bytes()
    stream = tmp_path / "chaos" / "events.jsonl"
    assert telemetry.check_stream(stream) == (0, [])
    lin = [e["reason"] for e in _events(stream) if e["type"] == "run_lineage"]
    assert lin == ["fresh", "resume"]


def test_cli_sigterm_preempts_cleanly(tmp_path):
    """SIGTERM a live CLI run: the block in flight finishes, the sampler
    checkpoints, ``run_end(reason="preempted")`` lands before the ring
    dump; a rerun resumes and completes."""
    prfile = _paramfile(tmp_path, "system_noise.dat", nsamp=300,
                        covUpdate=50)
    script = tmp_path / "run.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\ntorch.set_num_threads(1)\n"
        "from enterprise_warp_tpu_torch import cli\n"
        f"sys.exit(cli.main(['--prfile', {prfile!r}, '--num', '1'], "
        "device='cpu'))\n")
    env = _child_env()
    env["EWT_FLIGHTREC"] = "1"
    proc = subprocess.Popen([sys.executable, str(script)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    chain, deadline = None, time.monotonic() + 120
    while time.monotonic() < deadline and proc.poll() is None:
        hits = [os.path.join(r, "chain_1.txt")
                for r, _, fs in os.walk(tmp_path / "out")
                if "chain_1.txt" in fs]
        if hits and os.path.getsize(hits[0]) > 0:
            chain = hits[0]
            break
        time.sleep(0.2)
    assert chain is not None, proc.stderr.read().decode()[-2000:]
    proc.send_signal(signal.SIGTERM)
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err.decode()[-2000:]
    outdir = os.path.dirname(chain)
    events = _events(os.path.join(outdir, "events.jsonl"))
    ends = [i for i, e in enumerate(events) if e["type"] == "run_end"]
    assert len(ends) == 1 and events[ends[0]]["reason"] == "preempted"
    pre = [i for i, e in enumerate(events) if e["type"] == "anomaly"
           and e["reason"] == "preempted"]
    assert pre and pre[0] > ends[0]
    step = int(np.load(os.path.join(outdir, "state.npz"))["step"])
    assert 0 < step < 300
    # the rerun resumes from the preempted checkpoint and completes
    r = subprocess.run([sys.executable, str(script)], env=_child_env(),
                       timeout=300, capture_output=True)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert int(np.load(os.path.join(outdir, "state.npz"))["step"]) == 300
    events = _events(os.path.join(outdir, "events.jsonl"))
    assert [e["reason"] for e in events if e["type"] == "run_lineage"] == \
        ["fresh", "preempt-restart"]
    assert _report_cli().main([outdir, "--check"]) == 0


def test_ladder_bottom_exits_75_without_reexec(tmp_path, monkeypatch,
                                               capsys):
    """At the bottom rung (the classic chain pinned) an exhausted retry
    budget prints the demotion and returns 75 from ``main`` itself (no
    process replaced it with a CPU re-execution); a clean rerun resumes
    from the checkpoint and completes."""
    monkeypatch.setenv("EWT_PALLAS_MEGA", "0")
    monkeypatch.setenv("EWT_DISPATCH_RETRIES", "0")
    monkeypatch.setenv("EWT_KERNEL_HEALTH", "0")
    prfile = _paramfile(tmp_path, "system_noise.dat", nsamp=120,
                        covUpdate=40)
    faults.install_plan({"faults": [{"site": "pt.dispatch", "kind": "error",
                                     "at": 2}]})
    assert cli.main(["--prfile", prfile, "--num", "1"], device="cpu") == \
        supervisor.EXIT_DEMOTED == 75
    assert "platform demotion" in capsys.readouterr().err
    run = [r for r, _, fs in os.walk(tmp_path / "out") if "state.npz" in fs]
    assert int(np.load(os.path.join(run[0], "state.npz"))["step"]) == 40
    faults.install_plan(None)
    assert cli.main(["--prfile", prfile, "--num", "1"], device="cpu") == 0
    assert int(np.load(os.path.join(run[0], "state.npz"))["step"]) == 120
    events = _events(os.path.join(run[0], "events.jsonl"))
    dem = [e for e in events if e["type"] == "demotion"]
    assert len(dem) == 1 and (dem[0]["from"], dem[0]["to"]) == \
        ("classic", "restart")
    assert [e["reason"] for e in events if e["type"] == "run_lineage"] == \
        ["fresh", "demotion"]


# ------------------------------------------------------------------ #
#  the device probe                                                   #
# ------------------------------------------------------------------ #

def _fake_run(rc=None, exc=None, calls=None):
    def run(*a, **k):
        calls.append(a[0])
        if exc is not None:
            raise exc

        class R:
            returncode = rc
            stderr = b"AssertionError: no CUDA device\n"
        return R()
    return run


@pytest.mark.parametrize("rc,exc,outcome", [
    (0, None, "ok"), (1, None, "exit"),
    (None, subprocess.TimeoutExpired(cmd="x", timeout=5), "timeout"),
    (None, OSError("no python"), "oserror")])
def test_device_probe_outcomes(monkeypatch, rc, exc, outcome):
    monkeypatch.setattr(deviceprobe, "_MEMO", {})
    calls = []
    monkeypatch.setattr(deviceprobe.subprocess, "run",
                        _fake_run(rc, exc, calls))
    res = deviceprobe.probe_device(timeout=5)
    assert res.outcome == outcome and bool(res) == (outcome == "ok")
    if outcome == "exit":
        assert "no CUDA device" in res.reason
    if outcome == "timeout":
        assert "hung" in res.reason
    # the child runs a torch operation, never jax
    assert "torch" in calls[0][-1] and "jax" not in calls[0][-1]
    deviceprobe.probe_device(timeout=5)          # memoized
    assert len(calls) == 1
    deviceprobe.probe_device(timeout=5, refresh=True)
    assert len(calls) == 2
    assert telemetry.registry().snapshot()["counters"][
        f"device_probe{{outcome={outcome}}}"] == 2


def test_device_probe_real_child_on_cpu():
    res = deviceprobe.probe_device(timeout=120, require_accelerator=False,
                                   refresh=True)
    assert res and res.outcome == "ok"
