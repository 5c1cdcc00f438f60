"""The shared unconstrained-space target density of the gradient samplers.

Counterpart of ``enterprise_warp_tpu/samplers/transform.py``. HMC and ADVI
work in z-space via ``theta = from_unit(sigmoid(z))``: the ``from_unit``
leg's Jacobian is ``1/p(theta)``, cancelling the prior density, so the
target reduces to ``lnL(theta(z)) + sum ln sigmoid'(z)``. One
implementation keeps their targets identical by construction.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def make_logp_z(like):
    """Return ``logp_z(z) -> (lp, lnl)`` on ``(W, ndim)`` tensors: the
    z-space log-density per row (non-finite mapped to -inf, so a
    prior-corner solve failure rejects instead of poisoning a
    trajectory) and the raw log-likelihood. Differentiable in ``z``."""

    def logp_z(z):
        theta = like.from_unit(torch.sigmoid(z))
        lnl = like.loglike_batch(theta)
        ljac = torch.sum(F.logsigmoid(z) + F.logsigmoid(-z), dim=-1)
        lp = lnl + ljac
        lp = torch.where(torch.isfinite(lp), lp,
                         torch.full_like(lp, -math.inf))
        return lp, lnl

    return logp_z


def value_and_grad(logp_z, z):
    """Per-row ``(lp, lnl, d lp / d z)`` at ``z`` (W, ndim): one batched
    evaluation, then one backward pass of ``lp.sum()`` — rows are
    independent, so that is every row's own gradient."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        lp, lnl = logp_z(zz)
        g, = torch.autograd.grad(lp.sum(), zz)
    return lp.detach(), lnl.detach(), g
