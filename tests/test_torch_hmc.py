"""Parity of the port's gradient path and gradient samplers with the JAX
package.

- The likelihood gradient of ``examples/example_params/hmc_single_psr.dat``
  (``--num 0``: J1234-5678, 10 parameters; ``--num 1``: fake_psr_0, 4
  parameters; split mode, CPU) against ``jax.vmap(jax.grad(like.loglike))``
  at 8 points near typical noise values: |dg| <= 1e-3 max(1, |g|) (the
  reference's own split-vs-float64 gradient gap there is <= 2.5e-4). The
  same on the card's route (forward through the likelihood megakernel,
  backward through the classic chain), forced on CPU tensors.
- The float64 path against central finite differences, rel 2e-4 /
  abs 1e-5 (``tests/test_hmc.py``).
- ``make_logp_z`` value and z-gradient against the JAX package's.
- One leapfrog trajectory from fixed (z, p0, eps, L) through the port's
  integrator against the same integrator written here on ``jax.grad`` of
  the JAX ``logp_z`` (float64 likelihood): positions atol 1e-6. The
  samplers' random streams differ (threefry vs Philox), so the draws are
  injected.
- The ADVI ELBO gradient at injected draws against the reference formula
  (``samplers/vi.py``) on the JAX ``logp_z``.
- Posterior recovery on an analytic Gaussian for HMC and ADVI at the
  reference tests' tolerances (``tests/test_hmc.py``,
  ``tests/test_vi.py``), and pulsar sampling with resume at a reduced
  length.
"""

import copy
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.models.assemble import \
    init_model_likelihoods as j_init
from enterprise_warp_tpu.samplers.evalproto import eval_protocol
from enterprise_warp_tpu.samplers.transform import \
    make_logp_z as j_make_logp_z
from enterprise_warp_tpu_torch import F64
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.io import load_pulsar
from enterprise_warp_tpu_torch.models import (Parameter, StandardModels,
                                              TermList, Uniform,
                                              build_pulsar_likelihood)
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init
from enterprise_warp_tpu_torch.models.prior_mixin import PriorMixin
from enterprise_warp_tpu_torch.ops import megakernel as tmk
from enterprise_warp_tpu_torch.ops import routes as troutes
from enterprise_warp_tpu_torch.samplers import HMCSampler, fit_advi
from enterprise_warp_tpu_torch.samplers.hmc import leapfrog
from enterprise_warp_tpu_torch.samplers.transform import (make_logp_z,
                                                          value_and_grad)
from enterprise_warp_tpu_torch.samplers.vi import elbo_grad

from test_torch_cholfuse import typical_points

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRFILE = os.path.join(REPO, "examples", "example_params",
                      "hmc_single_psr.dat")
DATA = os.path.join(REPO, "examples", "data")


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    """An in-process demotion elsewhere in the suite may have left a
    kernel opt-out set; each test here starts without it."""
    for var in ("EWT_PALLAS", "EWT_PALLAS_MEGA", "EWT_PALLAS_CHOL",
                "EWT_FUSED_CHOL"):
        monkeypatch.delenv(var, raising=False)


def _likes(num, gram_mode="split"):
    opts = types.SimpleNamespace(num=num, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)
    jl = j_init(JParams(PRFILE, opts=opts), gram_mode=gram_mode,
                write_pars=False)[0]
    tl = t_init(TParams(PRFILE, opts=opts), gram_mode=gram_mode,
                write_pars=False, device="cpu")[0]
    return jl, tl


def _assert_grad_close(gt, gj):
    gt, gj = np.asarray(gt), np.asarray(gj)
    assert np.isfinite(gt).all()
    rel = np.abs(gt - gj) / np.maximum(1.0, np.abs(gj))
    assert rel.max() <= 1e-3, rel.max()


def _z_of(like, theta):
    """Unconstrained coordinates of ``theta`` (every prior Uniform)."""
    lo = np.array([p.prior.lo for p in like.params])
    hi = np.array([p.prior.hi for p in like.params])
    u = (theta - lo) / (hi - lo)
    return np.log(u) - np.log1p(-u)


@pytest.mark.parametrize("num", [0, 1])
def test_loglike_gradient_matches_jax(num):
    jl, tl = _likes(num)
    theta = typical_points(tl, 8, seed=7)
    gj = jax.vmap(jax.grad(jl.loglike))(jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    troutes.reset_counts()
    lnl = tl.loglike_batch(th)
    gt, = torch.autograd.grad(lnl.sum(), th)
    # CPU tensors: the classic chain with the fused preconditioner, whose
    # backward runs the AD-safe twin
    assert troutes.ROUTES[("chol_precond", "plain-cpu")] == 1
    _assert_grad_close(gt.numpy(), gj)


@pytest.mark.parametrize("num", [0, 1])
def test_card_route_gradient_matches_jax(num, monkeypatch):
    """The route the card takes — forward through the likelihood
    megakernel, backward re-derived through the classic chain and its
    fused preconditioner — forced on CPU tensors, where both kernels run
    their plain versions."""
    jl, tl = _likes(num)
    theta = typical_points(tl, 8, seed=9)
    lnl_j = jax.vmap(jl.loglike)(jnp.asarray(theta))
    gj = jax.vmap(jax.grad(jl.loglike))(jnp.asarray(theta))
    monkeypatch.setattr(tmk, "mega_like_route", lambda *a: True)
    th = torch.tensor(theta, requires_grad=True)
    troutes.reset_counts()
    lnl = tl.loglike_batch(th)
    assert troutes.ROUTES[("mega_like", "plain-cpu")] == 1
    assert ("chol_precond", "plain-cpu") not in troutes.ROUTES
    gt, = torch.autograd.grad(lnl.sum(), th)
    assert troutes.ROUTES[("chol_precond", "plain-cpu")] == 1
    # the megakernel's float32 class on the value (tests/test_megakernel.py)
    np.testing.assert_allclose(lnl.detach().numpy(), np.asarray(lnl_j),
                               rtol=1e-3, atol=5e-2)
    _assert_grad_close(gt.numpy(), gj)


def _fake_psr_like(gram_mode, seed):
    psr = load_pulsar(os.path.join(DATA, "fake_psr_0.par"),
                      os.path.join(DATA, "fake_psr_0.tim"))
    psr = copy.deepcopy(psr)
    psr.residuals = psr.toaerrs * np.random.default_rng(seed).standard_normal(
        len(psr))
    m = StandardModels(psr=psr)
    terms = TermList(psr, [m.efac("by_backend"),
                           m.spin_noise("powerlaw_10_nfreqs")])
    return build_pulsar_likelihood(psr, terms, gram_mode=gram_mode,
                                   device="cpu")


def test_f64_gradient_matches_finite_difference():
    like = _fake_psr_like("f64", seed=0)
    theta = np.array([1.1, -13.5, 4.0])
    th = torch.tensor(theta[None], requires_grad=True)
    g, = torch.autograd.grad(like.loglike_batch(th).sum(), th)
    g = g[0].numpy()

    def lnl(t):
        return float(like.loglike_batch(t[None])[0])

    for i in range(len(theta)):
        h = 1e-6 * max(1.0, abs(theta[i]))
        tp, tm = theta.copy(), theta.copy()
        tp[i] += h
        tm[i] -= h
        fd = (lnl(tp) - lnl(tm)) / (2 * h)
        assert g[i] == pytest.approx(fd, rel=2e-4, abs=1e-5)


@pytest.fixture(scope="module")
def num1_split():
    """``--num 1`` in split mode: both likelihoods and the JAX per-row
    value-and-gradient of ``logp_z``."""
    jl, tl = _likes(1)
    logp = j_make_logp_z(jl)
    consts = eval_protocol(jl)[2]
    vg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda z: logp(z, consts)[0])))
    return jl, tl, vg


def test_logp_z_matches_jax(num1_split):
    _, tl, vg = num1_split
    z = _z_of(tl, typical_points(tl, 8, seed=5))
    lpj, gj = vg(jnp.asarray(z))
    lpt, lnlt, gt = value_and_grad(make_logp_z(tl), torch.as_tensor(z))
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), rtol=0,
                               atol=1e-3)
    # lp = lnL + the sigmoid Jacobian
    u = 1.0 / (1.0 + np.exp(-z))
    np.testing.assert_allclose(
        lpt.numpy() - lnlt.numpy(),
        np.sum(np.log(u) + np.log1p(-u), axis=1), rtol=1e-12)
    _assert_grad_close(gt.numpy(), gj)


def test_leapfrog_matches_jax_integrator(tmp_path):
    jl, tl = _likes(1, "f64")
    logp = j_make_logp_z(jl)
    consts = eval_protocol(jl)[2]
    vg = jax.jit(jax.vmap(jax.value_and_grad(lambda z: logp(z, consts)[0])))
    W, nd, L = 6, tl.ndim, 5
    rng = np.random.default_rng(12)
    z0 = _z_of(tl, typical_points(tl, W, seed=12))
    mass = 1.0 + rng.random(nd)
    p0 = rng.standard_normal((W, nd)) * np.sqrt(mass)
    eps_c = 0.02 * (1.0 + 0.1 * (2.0 * rng.random((W, 1)) - 1.0))

    zj, pj = jnp.asarray(z0), jnp.asarray(p0)
    _, gj = vg(zj)
    for _ in range(L):
        pj = pj + 0.5 * eps_c * gj
        zj = zj + eps_c * pj / mass
        _, gj = vg(zj)
        gj = jnp.where(jnp.isfinite(gj), gj, 0.0)
        pj = pj + 0.5 * eps_c * gj

    vgrad = HMCSampler(tl, str(tmp_path), nchains=W).vgrad
    zt = torch.as_tensor(z0)
    lp, lnl, g = vgrad(zt)
    zt, pt, _, lp1, _ = leapfrog(vgrad, zt, torch.as_tensor(p0), g, lp, lnl,
                                 torch.as_tensor(eps_c),
                                 torch.as_tensor(mass), L)
    assert np.isfinite(lp1.numpy()).all()
    assert np.abs(zt.numpy() - z0).max() > 1e-3       # it moved
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-4)


def test_advi_elbo_gradient_matches_jax(num1_split):
    _, tl, vg = num1_split
    nd = tl.ndim
    mu = _z_of(tl, typical_points(tl, 1, seed=2))[0]
    log_sig = np.full(nd, -3.0)
    eps = np.random.default_rng(8).standard_normal((16, nd))
    # the reference's formula (samplers/vi.py), on the JAX target
    sig = np.exp(log_sig)
    lp, g = map(np.asarray, vg(jnp.asarray(mu + sig * eps)))
    ok = np.isfinite(lp) & np.all(np.isfinite(g), axis=1)
    n_ok = max(ok.sum(), 1)
    gm = np.where(ok[:, None], g, 0.0)
    gj_mu = gm.sum(0) / n_ok
    gj_ls = (gm * eps * sig).sum(0) / n_ok + 1.0
    elbo_j = (np.where(ok, lp, 0.0).sum() / n_ok + log_sig.sum()
              + 0.5 * nd * np.log(2 * np.pi * np.e))
    g_mu, g_ls, val = elbo_grad(make_logp_z(tl), torch.as_tensor(mu),
                                torch.as_tensor(log_sig),
                                torch.as_tensor(eps))
    assert ok.all()
    _assert_grad_close(g_mu.numpy(), gj_mu)
    _assert_grad_close(g_ls.numpy(), gj_ls)
    assert float(val) == pytest.approx(elbo_j, abs=1e-3)


def test_elbo_gradient_masks_failed_draws():
    """A draw whose lp is -inf drops out of the average; when every draw
    fails both gradients are zero (no entropy-only step)."""
    like = GaussianLike([0.0, 0.0], [1.0, 1.0])
    bad = torch.tensor([[1.0, 0.0], [0.0, 0.0]], dtype=F64)

    def logp_z(z):
        lp, lnl = make_logp_z(like)(z)
        lp = torch.where(z[:, 0] > 0.5, torch.full_like(lp, -math.inf), lp)
        return lp, lnl

    mu, ls = torch.zeros(2, dtype=F64), torch.zeros(2, dtype=F64)
    g_mu, g_ls, _ = elbo_grad(logp_z, mu, ls, bad)
    g1_mu, g1_ls, _ = elbo_grad(make_logp_z(like), mu, ls, bad[1:])
    torch.testing.assert_close(g_mu, g1_mu)
    torch.testing.assert_close(g_ls, g1_ls)
    g_mu, g_ls, _ = elbo_grad(logp_z, mu, ls, bad[:1])
    assert not g_mu.any() and not g_ls.any()


class GaussianLike(PriorMixin):
    """Analytic Gaussian likelihood in a uniform box (the torch twin of
    ``tests/test_samplers.py:GaussianLike``)."""

    def __init__(self, mu, sigma, lo=-10.0, hi=10.0):
        self.mu = torch.tensor(mu, dtype=F64)
        self.sigma = torch.tensor(sigma, dtype=F64)
        self.ndim = len(mu)
        self.params = [Parameter(f"p{i}", Uniform(lo, hi))
                       for i in range(self.ndim)]
        self.param_names = [p.name for p in self.params]
        self.device = torch.device("cpu")

    def loglike_batch(self, theta):
        z = (theta - self.mu) / self.sigma
        return (-0.5 * torch.sum(z * z, dim=-1)
                - torch.sum(torch.log(self.sigma))
                - 0.5 * self.ndim * math.log(2 * math.pi))


def test_hmc_gaussian_posterior_recovery(tmp_path):
    like = GaussianLike([1.0, -2.0, 0.5], [0.3, 0.7, 1.1])
    s = HMCSampler(like, str(tmp_path), nchains=32, seed=1, n_leapfrog=12,
                   warmup=400)
    s.sample(1500, resume=False, verbose=False)
    chain = np.loadtxt(tmp_path / "chain_1.txt")
    assert chain.shape == (1500 * 32, like.ndim + 4)
    flat = chain[len(chain) // 2:, :like.ndim]
    np.testing.assert_allclose(flat.mean(0), [1.0, -2.0, 0.5], atol=0.1)
    np.testing.assert_allclose(flat.std(0), [0.3, 0.7, 1.1], rtol=0.25)
    # lnpost = lnlike + the uniform prior's log density
    np.testing.assert_allclose(chain[:, like.ndim],
                               chain[:, like.ndim + 1] - 3 * np.log(20.0),
                               atol=1e-6)


def test_advi_gaussian_mean_and_width():
    like = GaussianLike([1.0, -2.0, 0.5], [0.3, 0.7, 1.1])
    # at atol 0.1 the noise of Adam's final iterate decides: the JAX fit
    # of tests/test_vi.py misses at 2 of seeds 0-5 and the port's at 2 of
    # seeds 0-3 (the two use different random streams); like the
    # reference's test, this one fixes a seed at which it holds
    fit = fit_advi(like, steps=1500, mc=16, seed=1)
    np.testing.assert_allclose(fit["mean"], [1.0, -2.0, 0.5], atol=0.1)
    np.testing.assert_allclose(fit["std"], [0.3, 0.7, 1.1], rtol=0.3)
    assert np.mean(fit["elbo"][-100:]) > np.mean(fit["elbo"][:100])
    assert fit["samples"].shape == (4096, 3)
    assert fit["param_names"] == ["p0", "p1", "p2"]


def test_pulsar_sampling_and_resume(tmp_path):
    like = _fake_psr_like("split", seed=3)
    kw = dict(nchains=8, seed=4, n_leapfrog=8, warmup=40)
    HMCSampler(like, str(tmp_path), **kw).sample(60, resume=False,
                                                 verbose=False)
    chain1 = np.loadtxt(tmp_path / "chain_1.txt")
    assert chain1.shape == (60 * 8, like.ndim + 4)
    assert np.isfinite(chain1).all()
    # a torn append past the checkpoint is cut back on resume
    with open(tmp_path / "chain_1.txt", "a") as fh:
        fh.write("1.0 2.0\n")
    st = HMCSampler(like, str(tmp_path), **kw).sample(90, resume=True,
                                                      verbose=False)
    chain2 = np.loadtxt(tmp_path / "chain_1.txt")
    assert chain2.shape == (90 * 8, like.ndim + 4)
    np.testing.assert_array_equal(chain2[:60 * 8], chain1)
    assert st.step == 90 and st.ngrad > 90
    assert 0.4 < chain2[-1, -2] <= 1.0


@pytest.mark.parametrize("switch", ["argument", "env", "paramfile"])
def test_device_state_off_matches_default(tmp_path, monkeypatch, switch):
    """``device_state`` off (the argument, ``EWT_DEVICE_STATE=0`` or the
    paramfile key through ``run_hmc``) is accepted, and the chain is bit
    for bit the default (device-resident) one's, resume included."""
    from enterprise_warp_tpu_torch.samplers.hmc import run_hmc
    kw = dict(nchains=8, seed=0, warmup=20, n_leapfrog=4)
    like = GaussianLike([0.5, -0.5], [0.4, 0.8])
    HMCSampler(like, str(tmp_path / "dev"), **kw).sample(
        60, resume=False, verbose=False, block_size=20)
    out = tmp_path / "host"
    if switch == "paramfile":
        params = types.SimpleNamespace(sampler_kwargs=dict(
            nchains=8, n_leapfrog=4, warmup=20, device_state=0,
            advi_init=0))
        run_hmc(like, str(out), 40, params=params, resume=False, seed=0,
                verbose=False)
        run_hmc(like, str(out), 60, params=params, resume=True, seed=0,
                verbose=False)
    else:
        if switch == "env":
            monkeypatch.setenv("EWT_DEVICE_STATE", "0")
            extra = {}
        else:
            extra = dict(device_state=False)
        HMCSampler(like, str(out), **kw, **extra).sample(
            40, resume=False, verbose=False, block_size=20)
        HMCSampler(like, str(out), **kw, **extra).sample(
            60, resume=True, verbose=False, block_size=20)
    assert (out / "chain_1.txt").read_bytes() == \
        (tmp_path / "dev" / "chain_1.txt").read_bytes()
