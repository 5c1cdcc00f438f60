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
    # every jump family was proposed and accepted on the cold rung
    assert (s.fam_propose > 0).all() and (s.fam_accept > 0).all()


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


def test_unported_families_raise(tmp_path):
    like = GaussianLike([0.0], [1.0])
    for kw in (dict(ind_weight=5), dict(kde_weight=1), dict(cg_weight=2),
               dict(ns_weight=1), dict(write_hot_chains=True)):
        with pytest.raises(NotImplementedError):
            PTSampler(like, str(tmp_path), **kw)


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
