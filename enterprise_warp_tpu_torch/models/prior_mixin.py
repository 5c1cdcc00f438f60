"""Shared prior interface for likelihood objects.

Counterpart of ``enterprise_warp_tpu/models/prior_mixin.py``. Every
operation takes a float64 tensor whose last axis is the parameter vector
(``(ndim,)`` or ``(W, ndim)``) and returns tensors on the same device;
``sample_prior`` stays numpy (initial ensembles are drawn on the host).
"""

from __future__ import annotations

import math

import numpy as np
import torch


class PriorMixin:
    """Requires ``self.params`` (list of Parameter with priors)."""

    def _uniform_tables(self, ref):
        """``(lo, hi, -log width)`` tensors on ``ref``'s device when EVERY
        prior is Uniform (one fused op per call instead of ndim), else
        None. Cached per device."""
        from .priors import Uniform
        if not all(type(p.prior) is Uniform for p in self.params):
            return None
        cache = self.__dict__.setdefault("_unif_tab", {})
        key = (ref.device, ref.dtype)
        if key not in cache:
            lo = torch.tensor([p.prior.lo for p in self.params],
                              dtype=ref.dtype, device=ref.device)
            hi = torch.tensor([p.prior.hi for p in self.params],
                              dtype=ref.dtype, device=ref.device)
            cache[key] = (lo, hi, -torch.log(hi - lo))
        return cache[key]

    def log_prior(self, theta):
        theta = torch.atleast_1d(theta)
        tab = self._uniform_tables(theta)
        if tab is not None:
            lo, hi, neglogw = tab
            inside = torch.all((theta >= lo) & (theta <= hi), dim=-1)
            return torch.where(inside, torch.sum(neglogw),
                               torch.full_like(inside, -math.inf,
                                               dtype=theta.dtype))
        out = torch.zeros(theta.shape[:-1], dtype=theta.dtype,
                          device=theta.device)
        for i, p in enumerate(self.params):
            out = out + p.prior.logpdf(theta[..., i])
        return out

    def log_prior_dims(self, theta):
        """Per-parameter prior log-densities, shape ``(..., ndim)`` (the
        prior-draw jump's asymmetry correction)."""
        theta = torch.atleast_1d(theta)
        tab = self._uniform_tables(theta)
        if tab is not None:
            lo, hi, neglogw = tab
            inside = (theta >= lo) & (theta <= hi)
            return torch.where(inside, neglogw,
                               torch.full_like(theta, -math.inf))
        return torch.stack([p.prior.logpdf(theta[..., i])
                            for i, p in enumerate(self.params)], dim=-1)

    def from_unit(self, u):
        """Unit-cube transform across all sampled parameters."""
        tab = self._uniform_tables(u)
        if tab is not None:
            lo, hi, _ = tab
            return lo + (hi - lo) * u
        cols = [p.prior.from_unit(u[..., i])
                for i, p in enumerate(self.params)]
        return torch.stack(cols, dim=-1)

    def sample_prior(self, rng, n=1):
        out = np.empty((n, len(self.params)))
        for i, p in enumerate(self.params):
            out[:, i] = [p.prior.sample(rng) for _ in range(n)]
        return out
