"""The port's CEM/AMIS warm start (``samplers/cem.py``) against the JAX
package's, on the CPU.

Both fits draw all their randomness from numpy (``default_rng(seed)``
and the likelihood's ``sample_prior``), so on the same analytic Gaussian
and seed the two packages make the same draws and the same elite and
importance-weight decisions: ``mean``, ``cov``, ``lnZ`` and ``init_x``
agree within 1e-8 at small rounds (search 6, refine 4, batch 64), and at
the ``rounds=`` budget. The port's fit recovers the Gaussian's moments
and its evidence at the defaults, keeps ``init_x`` inside the prior's
support, and its entry point needs a card unless the caller asks for
the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.models.priors import Parameter as JParameter
from enterprise_warp_tpu.models.priors import Uniform as JUniform
from enterprise_warp_tpu.samplers.cem import fit_cem as j_fit_cem
from enterprise_warp_tpu_torch.models.prior_mixin import PriorMixin
from enterprise_warp_tpu_torch.models.priors import Parameter, Uniform
from enterprise_warp_tpu_torch.samplers import fit_cem

torch.set_num_threads(2)

MU = [1.0, -2.0, 0.5]
SIGMA = [0.3, 0.7, 1.1]
RHO = 0.6
SMALL = dict(search_rounds=6, refine_rounds=4, batch=64, seed=0)


def _cov():
    c = np.diag(np.square(SIGMA))
    c[0, 1] = c[1, 0] = RHO * SIGMA[0] * SIGMA[1]
    return c


class JGaussianLike:
    """Correlated analytic Gaussian in a uniform box (the reference's
    likelihood protocol: per-vector ``log_prior``, batched lnL)."""

    def __init__(self, lo=-10.0, hi=10.0):
        self.ndim = len(MU)
        self.params = [JParameter(f"p{i}", JUniform(lo, hi))
                       for i in range(self.ndim)]
        self.param_names = [p.name for p in self.params]
        prec = jnp.asarray(np.linalg.inv(_cov()))
        mu = jnp.asarray(MU)
        norm = -0.5 * np.linalg.slogdet(_cov())[1] \
            - 0.5 * self.ndim * math.log(2 * math.pi)

        def ll(theta):
            d = theta - mu
            return -0.5 * d @ prec @ d + norm
        self.loglike_batch = jax.jit(jax.vmap(ll))

    def log_prior(self, theta):
        theta = jnp.atleast_1d(theta)
        out = 0.0
        for i, p in enumerate(self.params):
            out = out + p.prior.logpdf(theta[..., i])
        return out

    def sample_prior(self, rng, n=1):
        out = np.empty((n, self.ndim))
        for i, p in enumerate(self.params):
            out[:, i] = [p.prior.sample(rng) for _ in range(n)]
        return out


class TGaussianLike(PriorMixin):
    """The same Gaussian in float64 torch."""

    device = torch.device("cpu")

    def __init__(self, lo=-10.0, hi=10.0):
        self.ndim = len(MU)
        self.params = [Parameter(f"p{i}", Uniform(lo, hi))
                       for i in range(self.ndim)]
        self.param_names = [p.name for p in self.params]
        self.prec = torch.as_tensor(np.linalg.inv(_cov()))
        self.mu = torch.as_tensor(MU, dtype=torch.float64)
        self.norm = -0.5 * np.linalg.slogdet(_cov())[1] \
            - 0.5 * self.ndim * math.log(2 * math.pi)
        self.calls = []

    def loglike_batch(self, theta):
        self.calls.append(tuple(theta.shape))
        d = theta - self.mu
        return -0.5 * torch.einsum("bi,ij,bj->b", d, self.prec, d) \
            + self.norm


def _held(ref, got):
    for key in ("mean", "cov", "init_x", "samples"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-8, atol=1e-8,
                                   err_msg=key)
    np.testing.assert_allclose(got["lnZ"], ref["lnZ"], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got["lnZ_err"], ref["lnZ_err"], rtol=1e-6,
                               atol=1e-8)
    for key in ("rounds_used", "lnZ_reliable", "param_names"):
        assert got[key] == ref[key], key
    np.testing.assert_allclose(got["ess_is"], ref["ess_is"], rtol=1e-8)
    np.testing.assert_allclose(got["best_lnpost"], ref["best_lnpost"],
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kw", [SMALL, dict(rounds=10, batch=64, seed=3)])
def test_fit_cem_matches_the_reference(kw):
    ref = j_fit_cem(JGaussianLike(), **kw)
    like = TGaussianLike()
    got = fit_cem(like, device="cpu", **kw)
    _held(ref, got)
    # one batched evaluation a round, at the fit's batch
    assert like.calls == [(kw["batch"], like.ndim)] * got["rounds_used"]


def test_fit_cem_recovers_the_gaussian():
    like = TGaussianLike()
    out = fit_cem(like, batch=256, seed=0, device="cpu")
    sd = np.sqrt(np.diag(out["cov"]))
    np.testing.assert_allclose(out["mean"], MU, atol=0.25 * max(SIGMA))
    np.testing.assert_allclose(sd, SIGMA, rtol=0.3)
    # the box's prior mass is 20^-3, the Gaussian's all inside it
    np.testing.assert_allclose(out["lnZ"], -3 * math.log(20.0), atol=0.2)
    assert np.isfinite(out["lnZ_err"]) and out["lnZ_err"] < 0.2
    assert out["init_x"].shape == (256, 3)
    assert torch.isfinite(like.log_prior(
        torch.as_tensor(out["init_x"]))).all()


def test_fit_cem_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_cem(TGaussianLike(), **SMALL)
