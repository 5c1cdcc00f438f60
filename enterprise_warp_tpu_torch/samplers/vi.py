# ewt: allow-precision module — ADVI's variational parameters and draws are
# float64 sampler state
"""Mean-field variational inference (ADVI) over the unconstrained space.

Counterpart of ``enterprise_warp_tpu/samplers/vi.py``. The variational
family is a diagonal Gaussian N(mu, diag(exp(2 log_sig))) in the z-space
of ``samplers/transform.py`` (``theta = from_unit(sigmoid(z))``, so the
target is ``lnL + sum ln sigmoid'(z)``); the reparameterized ELBO is
maximized with Adam (``torch.optim.Adam`` has ``optax.adam``'s update at
their shared defaults), every Monte Carlo sample a row of one batched
likelihood call. The draws come from an explicit ``torch.Generator``; the
reference's threefry stream is not reproduced.

Used by ``samplers/hmc.py:run_hmc`` as the HMC warm start. Mean-field
underestimates correlations: treat widths as lower bounds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import F64
from ..utils.logging import get_logger
from ..utils.profiling import monotonic
from .transform import make_logp_z, value_and_grad

_log = get_logger("ewt.vi")


def elbo_grad(logp_z, mu, log_sig, eps):
    """The ELBO and its gradient at the draws ``eps`` (mc, ndim): returns
    ``(g_mu, g_ls, elbo)``. Per-sample values and gradients, so a draw
    whose solve failed is masked out of the Monte Carlo average instead
    of poisoning it; the diagonal-Gaussian entropy gradient (+1 per
    ``log_sig``) is exact; if every draw failed there is no likelihood
    signal and both gradients are zero (the bare entropy gradient would
    only widen sigma into the failing region)."""
    nd = mu.shape[-1]
    sig = torch.exp(log_sig)
    z = mu + sig[None, :] * eps
    lp, _, g = value_and_grad(logp_z, z)
    ok = torch.isfinite(lp) & torch.all(torch.isfinite(g), dim=1)
    n_ok = torch.clamp(ok.sum(), min=1).to(F64)
    gm = torch.where(ok[:, None], g, torch.zeros_like(g))
    g_mu = gm.sum(dim=0) / n_ok
    g_ls = (gm * eps * sig[None, :]).sum(dim=0) / n_ok + 1.0
    val = (torch.where(ok, lp, torch.zeros_like(lp)).sum() / n_ok
           + log_sig.sum() + 0.5 * nd * math.log(2 * math.pi * math.e))
    any_ok = ok.any()
    g_mu = torch.where(any_ok, g_mu, torch.zeros_like(g_mu))
    g_ls = torch.where(any_ok, g_ls, torch.zeros_like(g_ls))
    return g_mu, g_ls, val


# ewt: allow-host-sync — ADVI's epilogue reads its trace and 4096 draws back
# once, after the fit
def fit_advi(like, steps=2000, mc=16, lr=0.02, seed=0, device=None,
             verbose=False):
    """Fit a mean-field Gaussian in unconstrained space.

    ``like`` provides ``loglike_batch``, ``from_unit``, ``ndim``,
    ``param_names`` and ``device`` (a :class:`PulsarLikelihood`);
    ``device`` defaults to the likelihood's. Returns a dict with
    ``mean``/``std`` (theta space, from 4096 transformed draws),
    ``z_mu``/``z_log_sig`` (variational parameters), ``elbo`` (one value
    per step), ``samples`` (the 4096 draws in theta space) and
    ``param_names``.
    """
    dev = torch.device(device if device is not None else
                       getattr(like, "device", "cpu"))
    nd = like.ndim
    logp_z = make_logp_z(like)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    mu = torch.zeros(nd, dtype=F64, device=dev)
    log_sig = torch.full((nd,), -1.0, dtype=F64, device=dev)
    opt = torch.optim.Adam([mu, log_sig], lr=lr)
    vals = []
    t0 = monotonic()
    for i in range(steps):
        eps = torch.randn((mc, nd), generator=gen, dtype=F64, device=dev)
        g_mu, g_ls, val = elbo_grad(logp_z, mu, log_sig, eps)
        mu.grad, log_sig.grad = -g_mu, -g_ls
        opt.step()
        vals.append(val)
        if verbose and (i + 1) % max(steps // 10, 1) == 0:
            _log.info("advi step %d/%d elbo=%.2f", i + 1, steps, float(val))
    trace = torch.stack(vals).cpu().numpy() if vals else np.zeros(0)
    wall = monotonic() - t0
    _log.info("advi: %d steps x %d draws in %.2f s", steps, mc, wall,
              extra={"advi_stats": {"steps": steps, "mc": mc,
                                    "wall_s": wall}})
    with torch.no_grad():
        z = mu + torch.exp(log_sig) * torch.randn(
            (4096, nd), generator=gen, dtype=F64, device=dev)
        thetas = like.from_unit(torch.sigmoid(z)).cpu().numpy()
    return dict(mean=thetas.mean(0), std=thetas.std(0),
                z_mu=mu.detach().cpu().numpy(),
                z_log_sig=log_sig.detach().cpu().numpy(),
                elbo=trace, samples=thetas,
                param_names=list(like.param_names))
