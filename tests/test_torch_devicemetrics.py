"""The port's device diagnostics plane (``utils/devicemetrics.py`` and its
sampler wiring) against the JAX package's, on the CPU.

- the primitives on the same numpy-seeded inputs: ``hist_add`` step by
  step (bit for bit: the same affine grid and truncation), ``hist_bounds``,
  ``welford_merge``/``welford_finalize``;
- the port's one fold a block (``block_moments``) against the reference's
  per-step ``welford_add``/``minmax_add``/``hist_add`` over the same rows:
  means and M2 within rtol 1e-12 (float64 rounding of two summation
  orders), extrema and histograms exact;
- ``MomentLedger``: every method (``split_rhat``, ``moment_ess``,
  ``worst``, ``param_summary``, ``total_steps``, compaction past
  ``COMPACT_CAP``) and the ``state_dict``/``from_state`` round trip
  against the reference's on the same blocks (rtol 1e-12), and the
  reference's gates of streaming against exact estimators
  (``tests/test_devicemetrics.py``) on the port's ledger;
- a port PT run's ledger equal, block by block, to a reference
  ``MomentLedger`` fed the port's own ``chain_1.txt`` (rtol 1e-12), its
  cumulative histogram the count of every kept row, its family matrices
  the cold counters;
- chains bit for bit equal with the plane on and off (and with telemetry
  off), no ``mixing_stats.json`` and no ``diag_*`` checkpoint keys off; kill and resume continue the ledger and the histogram as one run;
- HMC's energy-error and step-size heartbeat keys and its ledger through
  a resume; nested sampling's walk-scale and shrink-budget keys.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ptmcmc import GaussianLike

from enterprise_warp_tpu.models.priors import Normal as JNormal
from enterprise_warp_tpu.models.priors import Parameter as JParameter
from enterprise_warp_tpu.models.priors import Uniform as JUniform
from enterprise_warp_tpu.utils import devicemetrics as jdm
from enterprise_warp_tpu_torch.models.priors import Normal, Parameter, Uniform
from enterprise_warp_tpu_torch.samplers import PTSampler
from enterprise_warp_tpu_torch.samplers.hmc import HMCSampler
from enterprise_warp_tpu_torch.utils import devicemetrics as dm
from enterprise_warp_tpu_torch.utils import telemetry
from enterprise_warp_tpu_torch.utils.diagnostics import summarize_chains

torch.set_num_threads(2)
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _plane_on(monkeypatch):
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    for k in ("EWT_DEVICE_DIAG", "EWT_KERNEL_HEALTH", "EWT_FAULT_PLAN"):
        monkeypatch.delenv(k, raising=False)
    telemetry.registry().reset()
    yield
    telemetry.registry().reset()


def _rows(seed=1, steps=120, nchains=5, nd=3):
    return np.random.default_rng(seed).uniform(-3.0, 3.0,
                                               (steps, nchains, nd))


# ------------------------------------------------------------------ #
#  primitives                                                         #
# ------------------------------------------------------------------ #

def test_primitives_match_reference():
    x = _rows()
    lo, span = np.full(3, -4.0), np.full(3, 8.0)
    t, j = dm.hist_init(3, nbins=16), jdm.hist_init(3, nbins=16)
    for row in x:
        t = dm.hist_add(t, torch.as_tensor(row), torch.as_tensor(lo),
                        torch.as_tensor(span))
        j = jdm.hist_add(j, jnp.asarray(row), jnp.asarray(lo),
                         jnp.asarray(span))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    ref, _ = np.histogram(x[:, :, 0].ravel(), bins=16, range=(-4.0, 4.0))
    np.testing.assert_array_equal(t.numpy()[0], ref)
    # merge and finalize are the same numpy on both sides
    a = (50.0, x[:50].mean(0), ((x[:50] - x[:50].mean(0)) ** 2).sum(0))
    b = (70.0, x[50:].mean(0), ((x[50:] - x[50:].mean(0)) ** 2).sum(0))
    for u, v in zip(dm.welford_finalize(dm.welford_merge(a, b)),
                    jdm.welford_finalize(jdm.welford_merge(a, b))):
        np.testing.assert_array_equal(u, v)
    tp = [Parameter("a", Uniform(-2.0, 5.0)), Parameter("b", Normal(1.0, 2.0))]
    jp = [JParameter("a", JUniform(-2.0, 5.0)),
          JParameter("b", JNormal(1.0, 2.0))]
    for u, v in zip(dm.hist_bounds(tp), jdm.hist_bounds(jp)):
        np.testing.assert_array_equal(u, v)


def test_block_fold_matches_reference_per_step():
    """One fold a block (the port) against the reference's in-scan update
    every step, over the same rows."""
    x = _rows(seed=7, steps=200)
    lo, span = np.array([-3.0, -1.0, -2.5]), np.array([6.0, 2.0, 5.0])
    mean, m2, mn, mx, hist = dm.block_moments(
        torch.as_tensor(x), torch.as_tensor(lo), torch.as_tensor(span))
    st, mm = jdm.welford_init((5, 3)), jdm.minmax_init((5, 3))
    h = jdm.hist_init(3)
    for row in x:
        xj = jnp.asarray(row)
        st = jdm.welford_add(st, xj)
        mm = jdm.minmax_add(mm, xj)
        h = jdm.hist_add(h, xj, jnp.asarray(lo), jnp.asarray(span))
    assert float(st[0]) == x.shape[0]
    np.testing.assert_allclose(mean.numpy(), np.asarray(st[1]), rtol=RTOL)
    np.testing.assert_allclose(m2.numpy(), np.asarray(st[2]), rtol=RTOL)
    np.testing.assert_array_equal(mn.numpy(), np.asarray(mm[0]))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(mm[1]))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(h))
    assert hist.sum() == x.size


# ------------------------------------------------------------------ #
#  the ledger                                                         #
# ------------------------------------------------------------------ #

def _ledgers(blocks, nchains, nd):
    t, j = dm.MomentLedger(nchains, nd), jdm.MomentLedger(nchains, nd)
    for b in blocks:
        t.append_samples(b)
        j.append_samples(b)
    return t, j


def _assert_ledgers_equal(t, j, rtol=RTOL):
    assert len(t) == len(j) and t.total_steps == j.total_steps
    for burn in (0.0, 0.25, 0.5):
        for fn in ("split_rhat", "moment_ess"):
            a, b = getattr(t, fn)(burn), getattr(j, fn)(burn)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=rtol)
        assert t.worst(burn) == pytest.approx(j.worst(burn), rel=rtol)
        ps, pj = t.param_summary(burn), j.param_summary(burn)
        for k in ps:
            if ps[k] is not None:
                np.testing.assert_allclose(ps[k], pj[k], rtol=rtol)
    for k, v in t.state_dict().items():
        np.testing.assert_allclose(v, j.state_dict()[k], rtol=rtol)


def test_ledger_matches_reference_and_round_trips():
    rng = np.random.default_rng(3)
    # an AR(1) walk with uneven blocks and one offset chain
    x = np.zeros((900, 6, 2))
    for t in range(1, 900):
        x[t] = 0.9 * x[t - 1] + rng.standard_normal((6, 2)) * 0.44
    x[:, 0] += 0.3
    cuts = np.cumsum([0, 100, 150, 50, 200, 125, 75, 100, 100])
    blocks = [x[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    t, j = _ledgers(blocks, 6, 2)
    _assert_ledgers_equal(t, j)
    # the state round trip, and a checkpoint of another geometry
    clone = dm.MomentLedger.from_state(6, 2, t.state_dict())
    _assert_ledgers_equal(clone, j)
    jclone = jdm.MomentLedger.from_state(6, 2, t.state_dict())
    _assert_ledgers_equal(clone, jclone)
    assert len(dm.MomentLedger.from_state(8, 2, t.state_dict())) == 0


def test_ledger_compaction_matches_reference():
    rng = np.random.default_rng(4)
    blocks = [rng.standard_normal((3, 2, 2)) for _ in range(dm.COMPACT_CAP
                                                             + 9)]
    t, j = _ledgers(blocks, 2, 2)
    assert len(t) < dm.COMPACT_CAP and t.total_steps == 3 * len(blocks)
    _assert_ledgers_equal(t, j)


def test_streaming_tracks_exact_at_reference_gates():
    """The reference's gates (``tests/test_devicemetrics.py``) on the
    port's ledger: R-hat on an aligned split equal to the exact one, the
    batch-means ESS within a factor 3 of Geyer's on an AR(1) walk and
    near the sample count on iid draws, the burn window dropping a
    transient."""
    from enterprise_warp_tpu_torch.utils.diagnostics import (
        effective_sample_size, gelman_rubin)
    rng = np.random.default_rng(2)
    m, d, nblocks, L = 6, 3, 8, 125
    data = rng.standard_normal((nblocks * L, m, d))
    data[:, 0] += 0.3
    led = dm.MomentLedger(m, d)
    for b in range(nblocks):
        led.append_samples(data[b * L:(b + 1) * L])
    chains = np.transpose(data, (1, 0, 2))
    exact = np.array([gelman_rubin(chains[:, :, i]) for i in range(d)])
    np.testing.assert_allclose(led.split_rhat(burn_frac=0.0), exact,
                               rtol=1e-10)
    m, d, nblocks = 8, 2, 16
    n = nblocks * L
    x = np.zeros((n, m, d))
    eps = rng.standard_normal((n, m, d)) * np.sqrt(1 - 0.81)
    for t in range(1, n):
        x[t] = 0.9 * x[t - 1] + eps[t]
    led = dm.MomentLedger(m, d)
    iid = dm.MomentLedger(m, d)
    y = rng.standard_normal((n, m, d))
    for b in range(nblocks):
        led.append_samples(x[b * L:(b + 1) * L])
        iid.append_samples(y[b * L:(b + 1) * L])
    ex = np.array([effective_sample_size(np.transpose(x, (1, 0, 2))[:, :, i])
                   for i in range(d)])
    ratio = led.moment_ess(burn_frac=0.0) / ex
    assert np.all(ratio > 1.0 / 3.0) and np.all(ratio < 3.0)
    assert np.all(iid.moment_ess(burn_frac=0.0) > 0.4 * m * n)
    tr = dm.MomentLedger(4, 1)
    start = rng.standard_normal((100, 4, 1)) \
        + (10.0 * np.arange(4))[None, :, None]
    tr.append_samples(start)
    for _ in range(5):
        tr.append_samples(rng.standard_normal((100, 4, 1)))
    assert tr.split_rhat(0.0)[0] > 1.1 and tr.split_rhat(0.2)[0] < 1.02


# ------------------------------------------------------------------ #
#  the PT sampler                                                     #
# ------------------------------------------------------------------ #

def _run_pt(outdir, nsamp=300, block_size=100, seed=0, ntemps=2,
            resume=False, collect=None):
    s = PTSampler(GaussianLike([0.0, 1.0], [0.5, 0.3]), str(outdir),
                  ntemps=ntemps, nchains=4, seed=seed, device="cpu")
    s.sample(nsamp, resume=resume, verbose=False, block_size=block_size,
             collect=collect)
    return s, open(os.path.join(str(outdir), "chain_1.txt"), "rb").read()


def test_pt_ledger_equals_reference_fed_the_chain(tmp_path):
    blocks = []
    s, _ = _run_pt(tmp_path, nsamp=600, block_size=100, collect=blocks)
    raw = np.loadtxt(tmp_path / "chain_1.txt")
    cold = raw[:, :s.ndim].reshape(-1, s.nchains, s.ndim)
    ref = jdm.MomentLedger(s.nchains, s.ndim)
    for b in range(6):
        ref.append_samples(cold[b * 100:(b + 1) * 100])
    _assert_ledgers_equal(s.diag_ledger, ref)
    assert s.diag_hist.sum() == 600 * s.nchains * s.ndim
    # the cold rung's family matrix row is the cold counters
    np.testing.assert_array_equal(s.fam_rung_propose[0], s.fam_propose)
    np.testing.assert_array_equal(s.fam_rung_accept[0], s.fam_accept)
    assert s.fam_rung_propose.sum() == 600 * s.W
    # streaming against exact at the reference's gates
    c = np.concatenate(blocks, axis=0).astype(np.float64)
    keep = int(c.shape[0] * 0.75)
    exact = summarize_chains(np.transpose(c[-keep:], (1, 0, 2)),
                             s.like.param_names)["_worst"]
    stream = s.diag_ledger.worst(0.25)
    assert abs(stream["rhat"] - exact["rhat"]) < 0.1
    assert 1 / 3 < stream["ess"] / exact["ess"] < 3
    ev = [json.loads(ln) for ln in
          (tmp_path / "events.jsonl").read_text().splitlines()]
    hb = [e for e in ev if e["type"] == "heartbeat"][-1]
    assert hb["rhat_stream"] is not None and len(hb["accept_rung"]) == 2
    assert len([e for e in ev if e["type"] == "mixing"]) == 6
    gauges = telemetry.registry().snapshot()["gauges"]
    assert "stream_rhat" in gauges and "swap_rate{edge=0}" in gauges
    ms = json.load(open(tmp_path / "mixing_stats.json"))
    assert ms["steps_folded"] == 600
    assert sum(ms["params"]["p0"]["hist"]) == 600 * s.nchains
    z = np.load(tmp_path / "state.npz")
    assert list(z["diag_counts"]) == [100] * 6


def test_pt_chains_bit_equal_plane_on_and_off(tmp_path, monkeypatch):
    s_on, on = _run_pt(tmp_path / "on")
    monkeypatch.setenv("EWT_DEVICE_DIAG", "0")
    s_off, off = _run_pt(tmp_path / "off")
    monkeypatch.setenv("EWT_TELEMETRY", "0")
    monkeypatch.delenv("EWT_DEVICE_DIAG")
    s_tel, tel = _run_pt(tmp_path / "tel")
    assert on == off == tel
    assert s_off.diag_ledger is None and s_tel.diag_ledger is None
    # the cold family counters fold once a block, plane on or off: every
    # cold proposal counted, the acceptances those of the chain file
    for s in (s_off, s_tel):
        np.testing.assert_array_equal(s.fam_propose, s_on.fam_propose)
        np.testing.assert_array_equal(s.fam_accept, s_on.fam_accept)
    assert s_on.fam_propose.sum() == 300 * s_on.nchains
    acc_rate = np.loadtxt(tmp_path / "off" / "chain_1.txt")[-1, -2]
    np.testing.assert_allclose(s_off.fam_accept.sum(),
                               acc_rate * 300 * s_off.nchains, rtol=1e-12)
    assert (tmp_path / "on" / "mixing_stats.json").exists()
    for d in ("off", "tel"):
        assert not (tmp_path / d / "mixing_stats.json").exists()
        assert "diag_counts" not in np.load(tmp_path / d / "state.npz")


def test_pt_resume_continues_the_ledger(tmp_path):
    s_ref, chain_ref = _run_pt(tmp_path / "full", nsamp=400)
    _run_pt(tmp_path / "cut", nsamp=200)
    s_res, chain_res = _run_pt(tmp_path / "cut", nsamp=400, resume=True)
    assert chain_ref == chain_res
    assert s_res.diag_ledger.total_steps == 400
    assert s_ref.diag_ledger.worst() == s_res.diag_ledger.worst()
    np.testing.assert_array_equal(s_ref.diag_hist, s_res.diag_hist)
    np.testing.assert_array_equal(s_ref.fam_rung_propose,
                                  s_res.fam_rung_propose)


# ------------------------------------------------------------------ #
#  HMC and nested sampling                                            #
# ------------------------------------------------------------------ #

def test_hmc_energy_keys_and_ledger(tmp_path):
    def sampler():
        return HMCSampler(GaussianLike([0.5, -0.5], [0.4, 0.8]),
                          str(tmp_path), nchains=8, seed=0, warmup=100,
                          n_leapfrog=4)
    s = sampler()
    s.sample(200, resume=False, verbose=False, block_size=50)
    ev = [json.loads(ln) for ln in
          (tmp_path / "events.jsonl").read_text().splitlines()]
    hb = [e for e in ev if e["type"] == "heartbeat"][-1]
    assert "energy_err_mean" in hb and "energy_err_max" in hb
    assert hb["energy_err_std"] >= 0.0 and hb["eps_min"] <= hb["eps_max"]
    assert hb["rhat_stream"] is not None
    assert s.diag_ledger.total_steps == 200
    # blocks end at the mass-matrix step (75) and at the warmup's end
    counts = s.diag_ledger.state_dict()["counts"]
    assert list(counts) == [50, 25, 25, 50, 50]
    raw = np.loadtxt(tmp_path / "chain_1.txt")[:, :2].reshape(200, 8, 2)
    ref = jdm.MomentLedger(8, 2)
    for a, b in zip(np.cumsum(counts) - counts, np.cumsum(counts)):
        ref.append_samples(raw[a:b])
    _assert_ledgers_equal(s.diag_ledger, ref)
    s2 = sampler()
    s2.sample(300, resume=True, verbose=False, block_size=50)
    assert s2.diag_ledger.total_steps == 300
    s2.sample(100, resume=False, verbose=False, block_size=50)
    assert s2.diag_ledger.total_steps == 100


def test_hmc_chain_bit_equal_plane_on_and_off(tmp_path, monkeypatch):
    chains = []
    for flag in ("1", "0"):
        monkeypatch.setenv("EWT_DEVICE_DIAG", flag)
        out = tmp_path / flag
        HMCSampler(GaussianLike([0.5, -0.5], [0.4, 0.8]), str(out),
                   nchains=8, seed=0, warmup=40, n_leapfrog=4).sample(
            80, resume=False, verbose=False, block_size=20)
        chains.append((out / "chain_1.txt").read_bytes())
    assert chains[0] == chains[1]


def test_nested_scale_and_budget_heartbeats(tmp_path):
    from enterprise_warp_tpu_torch.samplers.nested import run_nested
    run_nested(GaussianLike([0.0], [0.5]), outdir=str(tmp_path), nlive=100,
               dlogz=0.5, nsteps=8, seed=3, verbose=False, max_iter=64,
               label="dg", kernel="slice", block_iters=16)
    ev = [json.loads(ln) for ln in
          (tmp_path / "events.jsonl").read_text().splitlines()]
    hbs = [e for e in ev if e["type"] == "heartbeat" and "scale_min" in e]
    assert hbs
    hb = hbs[-1]
    assert hb["scale_min"] <= hb["scale_max"]
    assert 0.0 <= hb["budget_exhaust_frac"] <= 1.0
    assert 0.0 <= hb["first_accept_frac"] <= 1.0
    assert telemetry.check_stream(tmp_path / "events.jsonl") == (0, [])
    gauges = telemetry.registry().snapshot()["gauges"]
    assert "walk_scale" in gauges and "budget_exhaust_frac" in gauges
