"""The port's PT-MCMC sampler: posterior recovery, on-disk contract, resume.

Mirrors ``tests/test_samplers.py::TestPTMCMC`` on an analytic Gaussian in
a uniform box, with the likelihood written in torch. The two packages draw
from different random streams (numpy-seeded threefry keys against a
``torch.Generator``), so the chains are compared in distribution, not
draw by draw; a port run directory must load through the reference's
results layer unchanged, and through the port's own.
"""

import math
import os
import types

import numpy as np
import pytest
import torch

from enterprise_warp_tpu.results import EnterpriseWarpResult
from enterprise_warp_tpu_torch.results import \
    EnterpriseWarpResult as PortResult
from enterprise_warp_tpu_torch.models.prior_mixin import PriorMixin
from enterprise_warp_tpu_torch.models.priors import Parameter, Uniform
from enterprise_warp_tpu_torch.samplers import PTSampler

torch.set_num_threads(2)


class GaussianLike(PriorMixin):
    """Analytic multivariate Gaussian in a uniform box (float64 torch)."""

    device = torch.device("cpu")

    def __init__(self, mu, sigma, lo=-10.0, hi=10.0):
        self.mu = torch.tensor(mu, dtype=torch.float64)
        self.sigma = torch.tensor(sigma, dtype=torch.float64)
        self.ndim = len(mu)
        self.params = [Parameter(f"p{i}", Uniform(lo, hi))
                       for i in range(self.ndim)]
        self.param_names = [p.name for p in self.params]
        self.calls = 0

    def loglike_batch(self, theta):
        self.calls += 1
        z = (torch.as_tensor(theta, dtype=torch.float64) - self.mu) \
            / self.sigma
        return (-0.5 * torch.sum(z * z, dim=-1)
                - torch.sum(torch.log(self.sigma))
                - 0.5 * self.ndim * math.log(2 * math.pi))


def test_gaussian_posterior_recovery(tmp_path):
    like = GaussianLike([1.0, -2.0, 0.5], [0.3, 0.7, 1.1])
    s = PTSampler(like, str(tmp_path), ntemps=2, nchains=8, seed=1,
                  cov_update=500)
    st = s.sample(6000, resume=False, verbose=False)
    chain = np.loadtxt(tmp_path / "chain_1.txt")
    assert chain.shape == (6000 * 8, like.ndim + 4)
    burn = len(chain) // 4
    post = chain[burn:, :like.ndim]
    np.testing.assert_allclose(post.mean(0), [1.0, -2.0, 0.5], atol=0.15)
    np.testing.assert_allclose(post.std(0), [0.3, 0.7, 1.1], rtol=0.35)
    # one batched likelihood call per step for all W = 16 walkers
    assert like.calls == 6000 + 1
    # PT swaps ran and the ladder adapted away from its geometric start
    assert st.swaps_proposed.sum() == 6000 // 10 * 8
    assert 0 < st.swaps_accepted.sum() < st.swaps_proposed.sum()
    assert st.ladder[0] == 1.0 and st.ladder[1] != 1.7
    # every jump family with weight was proposed and accepted on the cold
    # rung, and no other
    w = s.jump_probs > 0
    assert list(w) == [True] * 4 + [False] * 5
    assert (s.fam_propose[w] > 0).all() and (s.fam_accept[w] > 0).all()
    assert (s.fam_propose[~w] == 0).all()


def test_chain_contract(tmp_path):
    like = GaussianLike([0.0, 1.0], [1.0, 0.5])
    s = PTSampler(like, str(tmp_path), ntemps=1, nchains=4, seed=3,
                  cov_update=50)
    s.sample(120, resume=False, verbose=False, thin=2)
    chain = np.loadtxt(tmp_path / "chain_1.txt")
    # [theta..., lnpost, lnlike, accept_rate, pt_accept_rate], thinned
    assert chain.shape == (4 * (25 + 25 + 10), like.ndim + 4)
    assert np.isfinite(chain).all()
    lnp = -2.0 * math.log(20.0)
    np.testing.assert_allclose(chain[:, 2], chain[:, 3] + lnp, rtol=1e-12)
    assert ((chain[:, 4] > 0) & (chain[:, 4] < 1)).all()
    assert (chain[:, 5] == 0).all()
    row = open(tmp_path / "chain_1.txt").readline().split()
    assert all(len(v.split("e")[0].lstrip("-")) == 20 for v in row)
    pars = open(tmp_path / "pars.txt").read().split()
    assert pars == like.param_names
    cov = np.load(tmp_path / "cov.npy")
    assert cov.shape == (2, 2) and np.all(np.linalg.eigvalsh(cov) > 0)
    for f in ("state.npz", "state.npz.sha256"):
        assert os.path.exists(tmp_path / f)


def test_resume_continues_the_same_chain(tmp_path):
    like = GaussianLike([1.0, -1.0], [0.5, 0.5])
    kw = dict(ntemps=2, nchains=4, seed=7, cov_update=100)
    PTSampler(like, str(tmp_path / "a"), **kw).sample(
        600, resume=False, verbose=False)
    PTSampler(like, str(tmp_path / "b"), **kw).sample(
        300, resume=False, verbose=False)
    st = PTSampler(like, str(tmp_path / "b"), **kw).sample(
        600, resume=True, verbose=False)
    assert st.step == 600
    a = np.loadtxt(tmp_path / "a" / "chain_1.txt")
    b = np.loadtxt(tmp_path / "b" / "chain_1.txt")
    assert a.shape == b.shape == (600 * 4, 6)
    # the checkpoint carries positions, generator state and adaptation:
    # an interrupted run continues exactly as an uninterrupted one
    np.testing.assert_array_equal(a[:, :2], b[:, :2])
    np.testing.assert_array_equal(np.load(tmp_path / "a" / "cov.npy"),
                                  np.load(tmp_path / "b" / "cov.npy"))
    # a resume at the end is a no-op
    st2 = PTSampler(like, str(tmp_path / "b"), **kw).sample(
        600, resume=True, verbose=False)
    assert st2.step == 600
    assert np.loadtxt(tmp_path / "b" / "chain_1.txt").shape == a.shape


def test_failed_block_write_keeps_the_last_checkpoint(tmp_path,
                                                      monkeypatch):
    """A block's files are written while the next block runs: a failed
    chain write surfaces from ``sample``, and the checkpoint stays the
    last block's whose rows reached the file, so a resume continues the
    uninterrupted chain."""
    from enterprise_warp_tpu_torch.samplers import ptmcmc
    like = GaussianLike([1.0, -1.0], [0.5, 0.5])
    kw = dict(ntemps=1, nchains=4, seed=5, cov_update=100)
    PTSampler(like, str(tmp_path / "a"), **kw).sample(
        500, resume=False, verbose=False)
    real, calls = ptmcmc.write_table, []

    def fail_third(path, rows, append=True):
        calls.append(len(rows))
        if len(calls) == 3:
            raise OSError("disk full")
        real(path, rows, append=append)
    monkeypatch.setattr(ptmcmc, "write_table", fail_third)
    with pytest.raises(OSError, match="disk full"):
        PTSampler(like, str(tmp_path / "b"), **kw).sample(
            500, resume=False, verbose=False)
    monkeypatch.setattr(ptmcmc, "write_table", real)
    assert int(np.load(tmp_path / "b" / "state.npz")["step"]) == 200
    st = PTSampler(like, str(tmp_path / "b"), **kw).sample(
        500, resume=True, verbose=False)
    assert st.step == 500
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "a" / "chain_1.txt"),
                                  np.loadtxt(tmp_path / "b" / "chain_1.txt"))


def test_flow_family_raises(tmp_path):
    """The flow family waits for the port of ``flows/``: a weight or a
    flow object stops the sampler before it runs."""
    like = GaussianLike([0.0], [1.0])
    for kw in (dict(flow_weight=5), dict(flow=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PTSampler(like, str(tmp_path), **kw)


def _injected_block(lnl_of, nchains, ndim):
    """A stand-in for a sampler's ``_run_block`` that moves no walker and
    sets each walker's lnL from its marker (column 0 of its position):
    the anneal's resampling then sees the same injected lnL in both
    packages."""
    def run_block(st, todo, temps=None):
        marker = np.asarray(st.x)[:, 0].astype(int)
        lnl = lnl_of[marker]
        st.lnl = torch.as_tensor(lnl) if torch.is_tensor(st.x) else lnl
        cold = np.zeros((todo, nchains, ndim))
        return cold, cold[..., 0], cold[..., 0]
    return run_block


@pytest.mark.parametrize("seed", [0, 3])
def test_anneal_resampling_matches_jax(tmp_path, seed):
    """``anneal_init``'s resampling, bit for bit the reference's: with the
    same injected lnL at every stage (a spread of 0 to 60 nats over 16
    walkers, so the ESS test resamples at the hot stages and not at all
    of them), the same walkers survive in the same order; the counters
    are reset and the step count is 0."""
    import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, 64-bit)
    from enterprise_warp_tpu.samplers import PTSampler as JPTSampler
    from test_samplers import GaussianLike as JGaussianLike
    W, nd = 16, 2
    lnl_of = -np.random.default_rng(seed).uniform(0.0, 60.0, W)
    markers = np.stack([np.arange(W, dtype=float), np.zeros(W)], axis=1)
    out = []
    for mod, Like in ((PTSampler, GaussianLike), (JPTSampler,
                                                  JGaussianLike)):
        like = Like([0.0, 0.0], [1.0, 1.0], lo=-100, hi=100)
        s = mod(like, str(tmp_path / mod.__module__), ntemps=1, nchains=W,
                seed=seed)
        s._run_block = _injected_block(lnl_of, W, nd)
        st = s._fresh_state()
        if torch.is_tensor(st.x):
            st.x = torch.as_tensor(markers)
            st.lnl = torch.as_tensor(lnl_of)
            st.accepted = st.accepted + 3.0
        else:
            st.x, st.lnl = markers.copy(), lnl_of.copy()
            st.accepted = st.accepted + 3.0
        s._fresh_state = lambda st=st: st
        s.fam_accept[:] = 5.0
        st = s.anneal_init(verbose=False)
        out.append(np.asarray(st.x)[:, 0])
        assert st.step == 0 and float(np.sum(np.asarray(st.accepted))) == 0
        assert not s.fam_accept.any() and not s.fam_propose.any()
        assert not s.mask_counts.any()
        assert s._anneal_state is st
    np.testing.assert_array_equal(out[0], out[1])
    # the resampling ran: some walkers were dropped, some duplicated
    assert len(np.unique(out[0])) < W


def test_anneal_init_one_shot_and_reset(tmp_path):
    """The reference's ``test_anneal_init_one_shot_and_reset`` on the
    port: the annealed ensemble is :meth:`sample`'s fresh start, consumed
    once; with a checkpoint on disk, ``anneal_init`` is a no-op."""
    like = GaussianLike([1.0, -1.0], [0.5, 0.5])
    s = PTSampler(like, str(tmp_path), ntemps=1, nchains=32, seed=0)
    st = s.anneal_init(schedule=[8.0], steps_per=50, verbose=False)
    assert st.step == 0 and float(st.accepted.sum()) == 0
    assert torch.isfinite(st.lnl).all()
    x0 = st.x.clone()
    calls = like.calls
    s.sample(100, resume=False, verbose=False)
    assert like.calls == calls + 100      # no fresh prior draw
    assert s._anneal_state is None
    chain = np.loadtxt(tmp_path / "chain_1.txt")
    assert chain.shape == (100 * 32, 6)
    assert not np.allclose(chain[:32, :2], x0.numpy())   # it moved on
    assert s.anneal_init(schedule=[8.0], steps_per=50) is None


def test_hot_chain_files(tmp_path):
    """``writeHotChains`` on a two-rung run: the ladder is pinned, the
    tempered rung writes ``chain_<T>.txt`` with the cold file's columns
    taken rung-locally (the tempered lnpost, lnlike, the rung's
    acceptance, the swap rate of its edge), the cold file is unchanged
    in form, and a fresh run removes a stale hot file."""
    like = GaussianLike([1.0, -1.0], [0.5, 0.5])
    (tmp_path / "chain_9.txt").write_text("stale\n")
    s = PTSampler(like, str(tmp_path), ntemps=2, nchains=4, seed=2,
                  cov_update=50, write_hot_chains=True, tmax=3.0)
    st = s.sample(100, resume=False, verbose=False, thin=5)
    assert not s.adapt_ladder and list(st.ladder) == [1.0, 3.0]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["chain_1.txt", "chain_3.txt", "cov.npy", "events.jsonl",
         "pars.txt", "state.npz",
         "state.npz.sha256"] + (["state.prev.npz", "state.prev.npz.sha256"]
                                if os.path.exists(tmp_path / "state.prev.npz")
                                else []))
    cold = np.loadtxt(tmp_path / "chain_1.txt")
    hot = np.loadtxt(tmp_path / "chain_3.txt")
    assert cold.shape == hot.shape == (100 // 5 * 4, 6)
    theta, lnpost, lnl, acc, swap = (hot[:, :2], hot[:, 2], hot[:, 3],
                                     hot[:, 4], hot[:, 5])
    lp = like.log_prior(torch.as_tensor(theta)).numpy()
    np.testing.assert_allclose(lnpost, lp + lnl / 3.0, rtol=1e-12)
    np.testing.assert_allclose(
        lnl, like.loglike_batch(torch.as_tensor(theta)).numpy(), rtol=1e-12)
    accepted = st.accepted.numpy()
    assert acc[-1] == pytest.approx(accepted[4:].mean() / 100)
    assert swap[-1] == pytest.approx(st.swaps_accepted[0]
                                     / st.swaps_proposed[0])
    assert acc[-1] != cold[-1, 4]


def test_resume_cuts_hot_chain_files(tmp_path):
    """A run killed after a block's rows reached the chain files but
    before its checkpoint: the resume cuts the cold file and every hot
    rung's ``chain_<T>.txt`` back to the checkpoint, so both end as an
    uninterrupted run's, with equal rows."""
    like = GaussianLike([1.0, -1.0], [0.5, 0.5])
    kw = dict(ntemps=2, nchains=4, seed=7, cov_update=100,
              write_hot_chains=True, tmax=3.0)
    PTSampler(like, str(tmp_path / "a"), **kw).sample(
        600, resume=False, verbose=False)
    PTSampler(like, str(tmp_path / "b"), **kw).sample(
        300, resume=False, verbose=False)
    for name in ("chain_1.txt", "chain_3.txt"):
        path = tmp_path / "b" / name
        rows = path.read_text().splitlines(keepends=True)
        with open(path, "a") as fh:
            fh.writelines(rows[-8:])
    PTSampler(like, str(tmp_path / "b"), **kw).sample(
        600, resume=True, verbose=False)
    for name in ("chain_1.txt", "chain_3.txt"):
        a = np.loadtxt(tmp_path / "a" / name)
        b = np.loadtxt(tmp_path / "b" / name)
        assert a.shape == b.shape == (600 * 4, 6)
        np.testing.assert_array_equal(a[:, :2], b[:, :2])


def test_run_ptmcmc_warm_starts(tmp_path, monkeypatch):
    """``run_ptmcmc`` reads ``advi_init`` (the variational fit's draws seed
    the walkers, ``advi_steps`` steps) and ``anneal_init`` from the
    paramfile, and skips both on resume."""
    from enterprise_warp_tpu_torch.samplers import ptmcmc, vi
    like = GaussianLike([1.0, -1.0], [0.5, 0.5])
    fits, anneals = [], []
    real_fit = vi.fit_advi

    def fit(like, steps, mc, seed):
        fits.append(steps)
        return real_fit(like, steps=steps, mc=mc, seed=seed)
    monkeypatch.setattr(vi, "fit_advi", fit)
    real_anneal = PTSampler.anneal_init

    def anneal(self, **kw):
        anneals.append(self.init_x is not None)
        return real_anneal(self, schedule=[4.0], steps_per=20, **kw)
    monkeypatch.setattr(PTSampler, "anneal_init", anneal)
    params = types.SimpleNamespace(
        sampler_kwargs=dict(ntemps=1, advi_init=True, advi_steps=30,
                            anneal_init=True), covUpdate=50)
    s = ptmcmc.run_ptmcmc(like, str(tmp_path), 60, params=params,
                          resume=True, verbose=False)
    assert fits == [30] and anneals == [True]
    assert s.init_x.shape == (4096, 2)
    assert np.loadtxt(tmp_path / "chain_1.txt").shape == (60 * 8, 6)
    ptmcmc.run_ptmcmc(like, str(tmp_path), 80, params=params, resume=True,
                      verbose=False)
    assert fits == [30] and len(anneals) == 2    # the anneal was a no-op
    assert np.loadtxt(tmp_path / "chain_1.txt").shape == (80 * 8, 6)


def _joint_like():
    """A small joint PTA likelihood (3 fake pulsars, efac, spin noise and
    a Hellings-Downs ``gwb``), whose parameters fall into blocks."""
    from enterprise_warp_tpu_torch.models import StandardModels, TermList
    from enterprise_warp_tpu_torch.parallel import build_pta_likelihood
    from enterprise_warp_tpu_torch.sim import make_fake_pta
    psrs = make_fake_pta(npsr=3, ntoa=60, seed=4)
    rng = np.random.default_rng(4)
    tls = []
    for p in psrs:
        p.residuals = p.toaerrs * rng.standard_normal(len(p))
        m = StandardModels(psr=p)
        tls.append(TermList(p, [m.efac("by_backend"),
                                m.spin_noise("powerlaw_3_nfreqs"),
                                m.gwb("hd_vary_gamma_3_nfreqs")]))
    return build_pta_likelihood(psrs, tls, device="cpu")


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "single"])
def test_mask_stats(tmp_path, monkeypatch, joint):
    """A joint run writes ``mask_stats.json`` with the reference's keys,
    its counts summing to the cold proposals (nchains x steps) and its
    maskable share equal to the cold prior draws; a likelihood without
    parameter blocks writes none."""
    from enterprise_warp_tpu.utils.diagnostics import \
        cache_hit_summary as j_summary
    monkeypatch.delenv("EWT_UPDATE_MASK", raising=False)
    like = _joint_like() if joint else GaussianLike([0.0, 1.0], [1.0, 0.5])
    s = PTSampler(like, str(tmp_path), ntemps=2, nchains=4, seed=5,
                  cov_update=15, prior_weight=40)
    s.sample(30, resume=False, verbose=False)
    path = tmp_path / "mask_stats.json"
    if not joint:
        assert not path.exists()
        return
    import json
    got = json.load(open(path))
    ref = j_summary(1, 2, 3)
    assert sorted(got) == sorted(ref)
    assert sorted(got["proposals"]) == sorted(ref["proposals"])
    p = got["proposals"]
    assert p["site"] + p["common"] + p["full"] == got["total"] == 4 * 30
    assert p["site"] + p["common"] == s.fam_propose[3] > 0
    assert p["site"] > 0 and p["common"] > 0
    assert got == j_summary(*s.mask_counts)


def _port_run(tmp_path):
    psr = "J0000+0000"
    like = GaussianLike([1.0, -14.0, 3.0], [0.1, 0.2, 0.3], lo=-20, hi=20)
    like.params = [Parameter(f"{psr}_{n}", p.prior) for n, p in zip(
        ("efac", "red_noise_log10_A", "red_noise_gamma"), like.params)]
    like.param_names = [p.name for p in like.params]
    run = tmp_path / f"0_{psr}"
    PTSampler(like, str(run), ntemps=1, nchains=8, seed=2,
              cov_update=200).sample(800, resume=False, verbose=False)
    return psr, like


def _results_opts(tmp_path):
    return types.SimpleNamespace(
        result=str(tmp_path), info=0, name="all", corner=0, par=None,
        chains=0, logbf=0, noisefiles=1, credlevels=0, diagnostics=0,
        separate_earliest=0.0, mpi_regime=0, load_separated=0, covm=0,
        bilby=0, optimal_statistic=0,
        optimal_statistic_orfs="hd,dipole,monopole",
        optimal_statistic_nsamples=50, custom_models_py=None,
        custom_models=None)


def test_port_run_loads_through_reference_results(tmp_path):
    _loads_through(tmp_path, EnterpriseWarpResult)


def test_port_run_loads_through_port_results(tmp_path):
    _loads_through(tmp_path, PortResult)


def _loads_through(tmp_path, results):
    psr, like = _port_run(tmp_path)
    r = results(_results_opts(tmp_path))
    chain, diag, pars = r.load_chains(f"0_{psr}")
    assert list(pars) == like.param_names
    assert chain.shape == (600 * 8, 3) and diag.shape[1] == 4
    r.main_pipeline()
    noise = (tmp_path / "noisefiles" / f"{psr}_noise.json").read_text()
    assert f"{psr}_red_noise_gamma" in noise
