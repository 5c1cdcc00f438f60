"""Parity of the torch port's classic likelihood chain with the JAX package.

- ``gram_mode='f64'`` (the oracle path) at 8 prior draws of both example
  pulsars: rtol 1e-9 (float64 on both sides; only summation order and
  LAPACK-vs-XLA factorization details differ).
- ``gram_mode='split'`` on the classic route at 16 points near the
  J1234-5678 injection (sigma 0.05; the two system-noise parameters at
  prior midpoints): |dlnL| <= 1e-3. The JAX split path itself sits
  ~1e-4 from its float64 oracle there; far from the posterior (at prior
  corners) it drifts by up to O(100) from the oracle, so split parity is
  only asserted near the truth.
- the three-tier jitter fixture of ``tests/test_megakernel.py`` through
  ``_mixed_psd_solve_logdet`` on the plain chain.
- the factorizations read a symmetrized input, as ``jnp.linalg.cholesky``
  and ``jnp.linalg.eigh`` do: two timing-model Schur complements
  ``P - H^T Z`` of ``fixed_white_noise.dat --num 0`` at prior draws
  (equilibrated Sigma at condition ~1e9), whose lower triangle alone is
  not positive definite.
"""

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
from enterprise_warp_tpu.ops.kernel import \
    _mixed_psd_solve_logdet as j_mixed
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init
from enterprise_warp_tpu_torch.ops import routes as troutes
from enterprise_warp_tpu_torch.ops.kernel import cholesky_nan, gram_blocks
from enterprise_warp_tpu_torch.ops.megakernel import _safe_eigh
from enterprise_warp_tpu_torch.ops.kernel import \
    _mixed_psd_solve_logdet as t_mixed

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    """The route decisions read ``EWT_PALLAS``/``EWT_PALLAS_MEGA``; an
    in-process demotion elsewhere in the suite may have left the opt-out
    set, so each test here starts without it."""
    monkeypatch.delenv("EWT_PALLAS", raising=False)
    monkeypatch.delenv("EWT_PALLAS_MEGA", raising=False)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRFILE = os.path.join(REPO, "examples", "example_params", "system_noise.dat")
TRUTH = {
    "J1234-5678_CPSR2_20CM_efac": 1.1, "J1234-5678_CPSR2_50CM_efac": 1.35,
    "J1234-5678_CASPSR_40CM_efac": 0.95, "J1234-5678_PDFB_10CM_efac": 1.05,
    "J1234-5678_CPSR2_20CM_log10_equad": -6.6,
    "J1234-5678_CPSR2_50CM_log10_equad": -6.2,
    "J1234-5678_CASPSR_40CM_log10_equad": -6.9,
    "J1234-5678_PDFB_10CM_log10_equad": -7.0,
    "J1234-5678_red_noise_log10_A": -13.3,
    "J1234-5678_red_noise_gamma": 3.8,
    "J1234-5678_dm_gp_log10_A": -13.6, "J1234-5678_dm_gp_gamma": 2.9,
}


def _likes(num, gram_mode):
    opts = types.SimpleNamespace(num=num, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)
    jl = j_init(JParams(PRFILE, opts=opts), gram_mode=gram_mode,
                write_pars=False)[0]
    tl = t_init(TParams(PRFILE, opts=opts), gram_mode=gram_mode,
                write_pars=False, device="cpu")[0]
    return jl, tl


def near_truth(like, n, seed=0):
    mid = [TRUTH.get(p.name, 0.5 * (p.prior.lo + p.prior.hi))
           for p in like.params]
    rng = np.random.default_rng(seed)
    return np.asarray(mid) + 0.05 * rng.standard_normal((n, like.ndim))


def _sigma_condition(tl, theta):
    """Condition number of each walker's equilibrated Sigma (float64)."""
    st = tl.static
    G = gram_blocks(tl.eval_nw(theta), st["r_w"], st["M_w"], st["T_w"],
                    gram_mode="f64")[0].numpy()
    S = G + np.stack([np.diag(1.0 / p) for p in tl.eval_phi(theta).numpy()])
    d = np.sqrt(np.einsum("wii->wi", S))
    return np.linalg.cond(S / d[:, :, None] / d[:, None, :])


@pytest.mark.parametrize("num", [0, 1])
def test_f64_lnl_at_prior_draws(num):
    jl, tl = _likes(num, "f64")
    theta = jl.sample_prior(np.random.default_rng(3), 8)
    lnl_j = np.asarray(jl.loglike_batch(jnp.asarray(theta)))
    lnl_t = tl.loglike_batch(theta).numpy()
    assert np.isfinite(lnl_t).all()
    # rtol 1e-9; prior corners whose equilibrated Sigma has a condition
    # number past 1e7 lose digits in ANY float64 factorization, so there
    # the bound is the conditioning limit 10 * kappa * eps_f64
    kappa = _sigma_condition(tl, theta)
    rtol = np.maximum(1e-9, 10.0 * kappa * np.finfo(np.float64).eps)
    assert np.all(np.abs(lnl_t - lnl_j) <= rtol * np.abs(lnl_j)), \
        (lnl_t - lnl_j, kappa)
    assert np.sum(kappa < 1e7) >= 4      # most draws hold the 1e-9 bound


def test_split_classic_near_truth():
    jl, tl = _likes(0, "split")
    assert tl.param_names == jl.param_names
    theta = near_truth(tl, 16)
    lnl_j = np.asarray(jl.loglike_batch(jnp.asarray(theta)))
    troutes.reset_counts()
    lnl_t = tl.loglike_batch(theta).numpy()
    # CPU tensors take the classic chain (the reference's non-TPU route)
    assert troutes.ROUTES[("mega_like", "over-cap")] == 1
    assert troutes.ROUTES[("mega_solve", "plain-cpu")] == 1
    assert sum(troutes.LAUNCHES.values()) == 0
    assert np.isfinite(lnl_t).all()
    assert np.max(np.abs(lnl_t - lnl_j)) <= 1e-3


def _three_tier_fixture():
    n = 16
    rng = np.random.default_rng(13)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.5, 1.5, n)
    ev[0] = -5e-5
    S_mid = (Q * ev) @ Q.T
    A = np.random.default_rng(2).standard_normal((n, n))
    S0 = A @ A.T / n + 0.5 * np.eye(n)
    d = np.sqrt(np.diag(S0))
    S0 = S0 / d[:, None] / d[None, :]
    S = np.stack([S0, S_mid, -np.eye(n)]) * np.array([1.0, 3.0, 2.0])[
        :, None, None]
    B = rng.standard_normal((3, n, 2))
    return S, B


def test_three_tier_mixed_solve():
    S, B = _three_tier_fixture()
    Zj, ldj = jax.vmap(lambda s, b: j_mixed(
        s, b, 1e-6, 1e-3, refine=2, delta_mode="split", mega=False))(
            jnp.asarray(S), jnp.asarray(B))
    Zt, ldt = t_mixed(torch.as_tensor(S), torch.as_tensor(B), 1e-6, 1e-3,
                      refine=2, delta_mode="split", mega=False)
    assert torch.isfinite(Zt).all() and torch.isfinite(ldt).all()
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=2e-4,
                               atol=2e-4)


# the split chain's timing-model Schur complements A = P - H^T Z at rows
# 13 and 15 of the serving layer's synthetic trace (seed 0, 24 requests,
# 4 tenants, max_theta 6) on fixed_white_noise.dat --num 0: Z is inexact
# at an equilibrated condition of ~1e9, so A is asymmetric by ~1e-7
ASYM_SCHUR = [
    [[0.09125661583700839, -0.07902829470230366, -0.06781527503129336],
     [-0.07902822964120237, 0.07195690305473235, 0.06328829519736645],
     [-0.06781532356485698, 0.06328841893412473, 0.05630618863182002]],
    [[0.09124325546881495, -0.07901338342790742, -0.06780093292956646],
     [-0.07901329761994103, 0.07194011412656665, 0.06327210464647559],
     [-0.06780094720819807, 0.06327221797517601, 0.056290553168262036]],
]


@pytest.mark.parametrize("row", [0, 1])
def test_factorizations_symmetrize_like_jax(row):
    """``cholesky_nan`` and ``_safe_eigh`` factor ``(A + A^T) / 2`` as the
    reference's ``jnp.linalg`` calls do: on a Schur complement whose lower
    triangle alone is indefinite the factor is finite and equals JAX's
    (the lnL was -inf where the reference's is finite), and a symmetric
    input is factored bit for bit as before."""
    A = np.asarray(ASYM_SCHUR[row])
    d = 1.0 / np.sqrt(np.diag(A))
    An = torch.as_tensor(A * d[:, None] * d[None, :])
    assert int(torch.linalg.cholesky_ex(An)[1]) != 0
    L = cholesky_nan(An[None])[0]
    Lj = np.asarray(jnp.linalg.cholesky(jnp.asarray(An.numpy())))
    assert torch.isfinite(L).all() and np.isfinite(Lj).all()
    np.testing.assert_allclose(L.numpy(), Lj, rtol=1e-9, atol=1e-12)
    ev = _safe_eigh(An[None])[0][0]
    evj = np.asarray(jnp.linalg.eigh(jnp.asarray(An.numpy()))[0])
    np.testing.assert_allclose(ev.numpy(), evj, rtol=1e-6, atol=1e-12)
    assert float(ev.min()) > 0
    S = 0.5 * (An + An.T)
    assert torch.equal(cholesky_nan(S[None])[0],
                       torch.linalg.cholesky_ex(S)[0])
