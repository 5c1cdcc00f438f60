# ewt: allow-precision module — CEM's mean, covariance and importance weights are
# float64 sampler state
"""Adaptive-importance-sampling Gaussian warm start (CEM search + AMIS).

Counterpart of ``enterprise_warp_tpu/samplers/cem.py``. Fits a
full-covariance Gaussian to the posterior from batched likelihood values
alone (no gradients): pass ``batch`` equal to the sampler's walker count
and each round is one evaluation at the sampler's own batch.

Two phases, as the reference's:

1. **Search** (cross-entropy method): refit a Gaussian to the global
   top-``elite_frac`` pool of everything evaluated so far, with annealed
   importance reweighting mixed in when the weights are usable.
2. **Refine** (adaptive multiple importance sampling, Cornuet et al.
   2012): restart the history from the search fit with its covariance
   boosted back out, re-weight the whole phase-2 history under the
   mixture of all phase-2 proposals (balance heuristic) and refit by
   weighted moments.

The mixture-IS over the refine history also yields a log-evidence
estimate ``lnZ = log mean(post / q_mix)`` with a bootstrap stderr.

Each round sends its draws to the likelihood's device as one ``(batch,
ndim)`` tensor and reads the lnL and log-prior back (the round boundary
is the host sync, as in the reference); everything else is float64 numpy
on the host, line for line the reference's. All randomness is numpy's
``default_rng(seed)`` and ``like.sample_prior(rng, n)``, as the
reference's, so the same likelihood values give the same fit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import F64, resolve_device
from ..utils import telemetry
from ..utils.logging import get_logger

__all__ = ["fit_cem"]

_log = get_logger("ewt.cem")


def _lnq_gauss(x, mean, L):
    """Normalized log-density of N(mean, L L^T) at rows of x."""
    from scipy.linalg import solve_triangular
    d = solve_triangular(L, (x - mean).T, lower=True)
    return (-0.5 * np.sum(d * d, axis=0)
            - np.sum(np.log(np.diag(L)))
            - 0.5 * x.shape[1] * np.log(2 * np.pi))


def _chol(cov, nd):
    try:
        return np.linalg.cholesky(cov), cov
    except np.linalg.LinAlgError:
        cov = cov + 1e-6 * max(np.trace(cov) / nd, 1e-12) * np.eye(nd)
        return np.linalg.cholesky(cov), cov


def fit_cem(like, rounds=None, batch=256, inflate=1.5, seed=0,
            search_rounds=35, refine_rounds=15, boost=9.0,
            elite_frac=0.25, smooth=0.7, anneal_T0=8.0, anneal_tau=8.0,
            ess_target_factor=8.0, reg_floor=1e-12, verbose=False,
            device=None):
    """CEM-search + AMIS-refine Gaussian fit; returns a warm-start dict.

    Parameters
    ----------
    like : likelihood with ``loglike_batch`` and ``log_prior`` on
        ``(B, ndim)`` tensors, ``sample_prior``, ``ndim``,
        ``param_names``.
    rounds : optional total budget; when given, overrides
        ``search_rounds``/``refine_rounds`` in a 70/30 split.
    batch : draws per round; pass the sampler's walker count.
    inflate : std-inflation of the Gaussian half of ``init_x``.
    boost : covariance re-inflation between the phases.
    device : where the likelihood is evaluated (the card unless the
        caller asks for the CPU).

    Returns the reference's dict: ``mean``/``cov`` (phase-2 weighted
    moments), ``init_x`` (``batch`` in-support starts: half weighted-
    resampled history, half inflated-Gaussian), ``samples``, ``lnZ``/
    ``lnZ_err``, ``lnZ_reliable``, ``rounds_used``, ``ess_is``,
    ``best_lnpost`` and ``param_names``.
    """
    dev = resolve_device(device or "cuda")
    if rounds is not None:
        search_rounds = max(int(0.7 * rounds), 3)
        refine_rounds = max(rounds - search_rounds, 2)
    nd = like.ndim
    rng = np.random.default_rng(seed)

    # the likelihood's own log_prior takes a batch (the reference vmaps a
    # per-vector one: its evalproto.prior_protocol)
    # ewt: allow-host-sync — CEM is host-driven numpy: each round uploads its
    # draws and reads back their log prior
    def lnp_batch(x):
        return like.log_prior(torch.as_tensor(x, dtype=F64, device=dev)) \
            .cpu().numpy()

    # ewt: allow-host-sync — CEM is host-driven numpy: one upload and one read
    # of lnL and log prior a round
    def eval_batch(x):
        xt = torch.as_tensor(x, dtype=F64, device=dev)
        lnl = like.loglike_batch(xt).cpu().numpy()
        lnp = like.log_prior(xt).cpu().numpy()
        return np.where(np.isfinite(lnp) & np.isfinite(lnl),
                        lnl + lnp, -np.inf)

    # ---------------- phase 1: CEM search ------------------------------ #
    mean = cov = None
    x = like.sample_prior(rng, batch)
    lnq = None
    k_elite = max(int(elite_frac * batch), nd + 2)
    pool_x = np.empty((0, nd))
    pool_lp = np.empty((0,))
    best = -np.inf
    used = 0
    for r in range(1, search_rounds + 1):
        used = r
        lnpost = eval_batch(x)
        finite = np.isfinite(lnpost)
        if finite.sum() < batch // 4 and cov is not None:
            # proposal mostly out of the prior's support: shrink toward
            # the current mean and redraw
            cov = cov * 0.25
            L, cov = _chol(cov, nd)
            x = mean + rng.standard_normal((batch, nd)) @ L.T
            lnq = _lnq_gauss(x, mean, L)
            continue
        best = max(best, float(lnpost[finite].max(initial=-np.inf)))
        pool_x = np.concatenate([pool_x, x[finite]])
        pool_lp = np.concatenate([pool_lp, lnpost[finite]])
        if len(pool_lp) > k_elite:
            keep = np.argsort(pool_lp)[-k_elite:]
            pool_x, pool_lp = pool_x[keep], pool_lp[keep]
        T = 1.0 + (anneal_T0 - 1.0) * np.exp(-(r - 1) / anneal_tau)
        use_weights = False
        if lnq is not None and finite.sum() > nd + 2:
            lw = np.where(finite, (lnpost - lnq) / T, -np.inf)
            lw -= lw.max()
            w = np.exp(lw)
            w = np.minimum(w, w.mean() * np.sqrt(len(w)))
            w /= w.sum()
            use_weights = 1.0 / np.sum(w ** 2) >= nd + 2
        if use_weights:
            new_mean = w @ x
            d = x - new_mean
            new_cov = (w[:, None] * d).T @ d \
                / max(1.0 - np.sum(w ** 2), 1e-3)
        elif len(pool_lp) >= nd + 2:
            new_mean = pool_x.mean(0)
            new_cov = np.cov(pool_x.T)
        else:
            x = like.sample_prior(rng, batch)
            lnq = None
            continue
        new_cov = np.atleast_2d(new_cov) + reg_floor * np.eye(nd)
        if mean is None:
            mean, cov = new_mean, new_cov
        else:
            mean = (1 - smooth) * mean + smooth * new_mean
            cov = (1 - smooth) * cov + smooth * new_cov
        if verbose:
            _log.info("cem search %d: best=%.2f", r, best)
        _rec = telemetry.active_recorder()
        if _rec is not None:
            _rec.heartbeat(phase="cem_search", round=r,
                           best_lnpost=round(best, 2))
        L, cov = _chol(cov, nd)
        x = mean + rng.standard_normal((batch, nd)) @ L.T
        lnq = _lnq_gauss(x, mean, L)

    # ---------------- phase 2: AMIS refine ----------------------------- #
    if mean is None:
        raise RuntimeError(
            "fit_cem: no finite posterior evaluation in "
            f"{search_rounds} search rounds of {batch} prior draws — "
            "likelihood/prior support appears empty")
    cov = cov * boost
    L, cov = _chol(cov, nd)
    X = np.empty((0, nd))
    LP = np.empty((0,))
    lnq_comp = []                       # per-component densities
    comps = []                          # (mu, L) per phase-2 round
    prev_mean = None
    stable = 0
    ess_is = 0.0
    for r in range(1, refine_rounds + 1):
        used += 1
        x = mean + rng.standard_normal((batch, nd)) @ L.T
        lnpost = eval_batch(x)
        if not np.isfinite(lnpost).any() and not len(LP):
            # the whole first refine batch out of support (the boosted
            # cov overshot the prior box): shrink and redraw
            cov = cov * 0.25
            L, cov = _chol(cov, nd)
            continue
        for c, (mu_c, L_c) in enumerate(comps):
            lnq_comp[c] = np.concatenate(
                [lnq_comp[c], _lnq_gauss(x, mu_c, L_c)])
        comps.append((mean.copy(), L.copy()))
        lnq_comp.append(np.concatenate(
            [_lnq_gauss(X, mean, L), _lnq_gauss(x, mean, L)]))
        X = np.concatenate([X, x])
        LP = np.concatenate([LP, lnpost])

        M = np.stack(lnq_comp)
        mmax = M.max(axis=0)
        lnq_mix = mmax + np.log(np.mean(np.exp(M - mmax), axis=0))
        finite = np.isfinite(LP)
        best = max(best, float(LP[finite].max(initial=best)))
        lw = np.where(finite, LP - lnq_mix, -np.inf)
        lw -= lw.max()
        w = np.exp(lw)
        w /= w.sum()
        ess_is = 1.0 / np.sum(w ** 2)
        new_mean = w @ X
        d = X - new_mean
        new_cov = (w[:, None] * d).T @ d \
            / max(1.0 - np.sum(w ** 2), 1e-3)
        new_cov = np.atleast_2d(new_cov) + reg_floor * np.eye(nd)
        # no geometric smoothing: the full-history weighted fit is
        # already an average over rounds
        mean, cov = new_mean, new_cov
        if verbose:
            _log.info("cem refine %d: best=%.2f is_ess=%.0f",
                      r, best, ess_is)
        _rec = telemetry.active_recorder()
        if _rec is not None:
            _rec.heartbeat(phase="cem_refine", round=r,
                           best_lnpost=round(best, 2),
                           is_ess=round(ess_is, 1))
        if (prev_mean is not None
                and ess_is >= ess_target_factor * (nd + 2)
                and np.all(np.abs(mean - prev_mean)
                           <= 0.1 * np.sqrt(np.diag(cov)) + 1e-300)):
            stable += 1
        else:
            stable = 0
        prev_mean = mean.copy()
        L, cov = _chol(cov, nd)
        if stable >= 2:
            break

    if not len(LP) or not np.isfinite(LP).any():
        raise RuntimeError(
            "fit_cem: refine phase found no finite posterior "
            "evaluation — search-phase fit does not overlap the "
            "prior support")
    # evidence over the phase-2 history under its final mixture, shifted
    # by the true max (LP is unnormalized and can sit thousands of nats
    # below zero)
    lw = np.where(finite, LP - lnq_mix, -np.inf)
    lw_max = float(lw[finite].max()) if finite.any() else 0.0
    wz = np.where(finite, np.exp(lw - lw_max), 0.0)
    lnZ = float(lw_max + np.log(wz.mean() + 1e-300))
    boots = [np.log(np.mean(wz[rng.integers(0, len(wz), len(wz))])
                    + 1e-300)
             for _ in range(64)]
    lnZ_err = float(np.std(boots))

    wfin = np.where(finite, np.exp(lw - lw.max()), 0.0)
    wfin /= wfin.sum()
    idx = rng.choice(len(X), size=batch, replace=True, p=wfin)
    samples = X[idx]

    # starting ensemble: half weighted resample, half inflated Gaussian;
    # out-of-support Gaussian rows fall back to resampled rows
    init = samples.copy()
    half = batch // 2
    g = mean + inflate * (rng.standard_normal((half, nd)) @ L.T)
    lnp0 = lnp_batch(np.concatenate([g, samples[:batch - half]]))[:half]
    ok = np.isfinite(lnp0)
    init[:half][ok] = g[ok]
    # self-normalized IS lnZ is biased low when q misses posterior mass:
    # flagged, not trusted, below the ESS target
    lnZ_reliable = bool(ess_is >= ess_target_factor * (nd + 2))
    return dict(mean=np.asarray(mean), cov=np.asarray(cov),
                init_x=init, samples=samples,
                lnZ=lnZ, lnZ_err=lnZ_err,
                lnZ_reliable=lnZ_reliable, rounds_used=used,
                ess_is=float(ess_is), best_lnpost=best,
                param_names=list(like.param_names))
