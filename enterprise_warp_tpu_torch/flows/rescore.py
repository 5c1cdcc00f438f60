"""Exact-likelihood honesty rescoring of flow draws (importance weights).

Counterpart of ``enterprise_warp_tpu/flows/rescore.py``. Every amortized
posterior ships with an importance-sampling audit against the exact
marginalized likelihood: draws ``x_i ~ q`` re-scored through the same
batched evaluator the samplers use (one ``loglike_batch`` call of all
``n`` draws), weights ``log w_i = ln p(x_i) + ln L(x_i) - ln q(x_i)``,
and the reference's three verdicts:

- **IS-ESS efficiency** ``(1 / sum w_n^2) / n`` of the normalized weights
  (floor ``ess_floor``, default 0.1);
- **weight tail**: the largest normalized weight and the top-5 share;
- **moment and width match**: the IS-reweighted mean and std against the
  raw flow's, per dimension (a mean shift beyond ``mean_shift_tol``
  posterior sigmas, or a width ratio outside ``width_band``, fails), and
  against a reference chain where one is given.

``match`` is the headline boolean. The draws come from
``flow.sample(n, generator)`` with a ``torch.Generator`` on the device
seeded with ``seed``; the weight algebra runs on the host in float64, as
the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..utils import telemetry

__all__ = ["rescore_flow"]


def rescore_flow(flow, like, n=1024, seed=0, ess_floor=0.1,
                 mean_shift_tol=0.5, width_band=(0.5, 2.0),
                 ref_chain=None, device=None):
    """Audit ``flow`` against the exact likelihood ``like``.

    Parameters
    ----------
    flow : :class:`~.model.FlowPosterior` over the same parameter space
        (and ordering) as ``like``.
    like : exact likelihood with ``loglike_batch`` and ``log_prior``
        (both on ``(n, ndim)`` tensors).
    n : number of flow draws to audit.
    ess_floor / mean_shift_tol / width_band : verdict thresholds.
    ref_chain : optional (m, ndim) exact-sampler draws; the IS moments
        must then also match the chain's.
    device : where the draws are made and scored (the card unless the
        caller asks for the CPU).

    Returns the reference's dict (host scalars and lists) whose ``match``
    is the verdict; emits a ``flow_rescore`` event when a recorder is
    active.
    """
    dev = resolve_device(device or "cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    draws_t, logq_t = flow.to(dev).sample(n, generator=gen)
    lnl_t = like.loglike_batch(draws_t)
    lnp_t = like.log_prior(draws_t)
    # the audit's one read of the device: draws, log q, lnL, log prior
    draws, logq, lnl, lnp = (
        np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t,
                   dtype=np.float64)
        for t in (draws_t, logq_t, lnl_t, lnp_t))

    logw = lnp + lnl - logq
    ok = np.isfinite(logw)
    n_bad = int(n - ok.sum())
    if not ok.any():
        out = {"n": int(n), "n_nonfinite": n_bad, "ess": 0.0,
               "ess_efficiency": 0.0, "match": False,
               "failure": "all importance weights non-finite"}
        _emit(out)
        return out
    lw = np.where(ok, logw, -np.inf)
    lw = lw - lw.max()
    w = np.exp(lw)
    w = w / w.sum()

    ess = float(1.0 / np.sum(w * w))
    eff = ess / float(n)
    w_sorted = np.sort(w)[::-1]
    tail = {"max_weight": float(w_sorted[0]),
            "top5_share": float(w_sorted[:5].sum())}

    mu_is = w @ draws
    var_is = w @ (draws - mu_is) ** 2
    sd_is = np.sqrt(np.maximum(var_is, 1e-300))
    mu_q = draws.mean(0)
    sd_q = draws.std(0)

    mean_shift = np.abs(mu_is - mu_q) / sd_is
    width_ratio = sd_q / sd_is
    checks = {
        "ess_ok": bool(eff >= ess_floor),
        "mean_ok": bool(np.all(mean_shift <= mean_shift_tol)),
        "width_ok": bool(np.all((width_ratio >= width_band[0])
                                & (width_ratio <= width_band[1]))),
    }
    chain_cmp = None
    if ref_chain is not None:
        ref = np.asarray(ref_chain, dtype=np.float64)
        mu_c = ref.mean(0)
        sd_c = np.maximum(ref.std(0), 1e-300)
        chain_shift = np.abs(mu_is - mu_c) / sd_c
        chain_width = sd_is / sd_c
        checks["chain_ok"] = bool(
            np.all(chain_shift <= mean_shift_tol)
            and np.all((chain_width >= width_band[0])
                       & (chain_width <= width_band[1])))
        chain_cmp = {"mean_shift_sigma": chain_shift.tolist(),
                     "width_ratio": chain_width.tolist()}

    out = {
        "n": int(n),
        "n_nonfinite": n_bad,
        "ess": ess,
        "ess_efficiency": eff,
        "weight_tail": tail,
        "moments": {
            "flow_mean": mu_q.tolist(), "flow_std": sd_q.tolist(),
            "is_mean": mu_is.tolist(), "is_std": sd_is.tolist(),
            "mean_shift_sigma": mean_shift.tolist(),
            "width_ratio": width_ratio.tolist(),
        },
        "thresholds": {"ess_floor": float(ess_floor),
                       "mean_shift_tol": float(mean_shift_tol),
                       "width_band": [float(width_band[0]),
                                      float(width_band[1])]},
        "checks": checks,
        "match": bool(all(checks.values())),
    }
    if chain_cmp is not None:
        out["chain"] = chain_cmp
    _emit(out)
    return out


def _emit(out):
    rec = telemetry.active_recorder()
    if rec:
        rec.event("flow_rescore", n=out["n"],
                  ess=round(out.get("ess", 0.0), 2),
                  ess_efficiency=round(out.get("ess_efficiency", 0.0), 4),
                  max_weight=round(out.get("weight_tail", {})
                                   .get("max_weight", 1.0), 4),
                  n_nonfinite=out.get("n_nonfinite", 0),
                  match=out["match"])
