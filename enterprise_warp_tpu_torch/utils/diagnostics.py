"""Convergence diagnostics: split-R-hat and effective sample size.

Counterpart of ``enterprise_warp_tpu/utils/diagnostics.py`` (a numpy
copy; the port imports nothing of the JAX package). The upstream
workflow publishes no convergence criteria (runs are judged by eye or by
fixed ``nsamp`` budgets, e.g. ``nsamp: 100000`` in
``examples/example_params/default_hypermodel.dat``), so R-hat and ESS
are first-class here; the results layer's ``--diagnostics`` reads them.
``cache_hit_summary`` is the PT sampler's ``mask_stats.json``;
``throttled_block_worst`` gives the samplers' heartbeats their worst
R-hat/ESS.

Pure numpy (host-side post-processing, like the results layer). Formulas
follow Gelman et al. (BDA3) / Vehtari et al. 2021 rank-normalized
split-R-hat and the Geyer initial-positive-sequence ESS used by Stan.
"""

from __future__ import annotations

import numpy as np


def _split_chains(chains):
    """(m, n) or (m, n, d) chains -> split each chain in half: (2m, n//2[, d])."""
    c = np.asarray(chains)
    n = c.shape[1] // 2
    return np.concatenate([c[:, :n], c[:, n:2 * n]], axis=0)


def gelman_rubin(chains):
    """Split-R-hat for one parameter.

    Parameters
    ----------
    chains : (m, n) array — m chains of length n (post burn-in).

    Returns the scalar split-R-hat; 1.0 means converged, > ~1.01 suspect.
    """
    c = _split_chains(np.atleast_2d(np.asarray(chains, dtype=np.float64)))
    m, n = c.shape
    if n < 2:
        return np.inf
    means = c.mean(axis=1)
    B = n * np.var(means, ddof=1)
    W = np.mean(np.var(c, axis=1, ddof=1))
    if W == 0:
        return 1.0
    var_plus = (n - 1) / n * W + B / n
    return float(np.sqrt(var_plus / W))


def _autocovariance(x):
    """FFT autocovariance of each sequence along the last axis (biased
    normalization), all rows in one transform."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[-1]
    x = x - x.mean(axis=-1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=-1)[..., :n].real
    return acov / n


def effective_sample_size(chains):
    """Multi-chain ESS for one parameter (Geyer initial positive sequence,
    as in Stan): combines within-chain autocorrelations with between-chain
    variance so stuck chains deflate the estimate.

    Parameters
    ----------
    chains : (m, n) array — m chains of length n (post burn-in).
    """
    c = _split_chains(np.atleast_2d(np.asarray(chains, dtype=np.float64)))
    m, n = c.shape
    if n < 4:
        return 0.0
    acov = _autocovariance(c)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = np.mean(chain_var)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += np.var(c.mean(axis=1), ddof=1)
    if var_plus == 0:
        return float(m * n)

    rho = 1.0 - (mean_var - np.mean(acov, axis=0)) / var_plus
    # Geyer: sum consecutive pairs while positive and monotone decreasing
    pair_prev = np.inf
    tau = 1.0
    t = 1
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, pair_prev)     # enforce monotone decrease
        pair_prev = pair
        tau += 2.0 * pair
        t += 2
    return float(m * n / tau)


def summarize_chains(chains, names=None):
    """Per-parameter diagnostics table.

    Parameters
    ----------
    chains : (m, n, d) array — m chains, n steps, d parameters.
    names : optional list of d parameter names.

    Returns a dict ``{name: {"rhat": ..., "ess": ..., "mean": ...,
    "std": ...}}`` plus ``"_worst"`` with the max R-hat / min ESS.

    JSON contract: every value is either a finite float or ``None``.
    Empty chain sets (``d == 0``) and chains too short for the
    estimators (``gelman_rubin`` returns ``inf`` below 4 steps) clamp
    to ``None`` instead of leaking ``inf`` — ``json.dump`` serializes
    ``inf`` as the non-standard token ``Infinity``, which breaks every
    strict reader of the diagnostics/telemetry artifacts downstream.
    """
    c = np.asarray(chains, dtype=np.float64)
    if c.ndim == 2:
        c = c[None]
    m, n, d = c.shape
    names = list(names) if names is not None else \
        [f"p{i}" for i in range(d)]
    out = {}
    worst_rhat, worst_ess = 0.0, np.inf
    for i, name in enumerate(names):
        r = gelman_rubin(c[:, :, i])
        e = effective_sample_size(c[:, :, i])
        out[name] = {"rhat": float(r) if np.isfinite(r) else None,
                     "ess": float(e) if np.isfinite(e) else None,
                     "mean": float(c[:, :, i].mean()),
                     "std": float(c[:, :, i].std())}
        worst_rhat = max(worst_rhat, r)
        worst_ess = min(worst_ess, e)
    out["_worst"] = {
        "rhat": float(worst_rhat) if names and np.isfinite(worst_rhat)
        else None,
        "ess": float(worst_ess) if names and np.isfinite(worst_ess)
        else None,
    }
    return out


def cache_hit_summary(site, common, full):
    """The evaluation cache's record (JSON-ready), the reference's keys:
    ``site``/``common``/``full`` count evaluations (or emitted proposal
    masks) by update_mask class (``samplers/evalproto.py``), and
    ``cache_hit_rate`` is the share that could reuse cached per-pulsar
    factorizations."""
    site, common, full = float(site), float(common), float(full)
    total = site + common + full
    rate = (site + common) / total if total else 0.0
    return {
        "proposals": {"site": site, "common": common, "full": full},
        "total": total,
        "cache_hit_rate": round(rate, 4),
    }


def throttled_block_worst(block, param_names, last_t, max_kept=256):
    """Worst R-hat/ESS of one sampler block's emissions, throttled: the
    heartbeat diagnostics of the PT and HMC samplers.

    ``block`` — (steps, nchains, ndim) host emissions; ``last_t`` — a
    one-item list holding the ``time.perf_counter`` of the last
    computation (0.0 forces one). Returns the ``_worst`` dict, or None
    inside the throttle window. Strided to at most ``max_kept`` steps per
    chain; recomputed at most every ``EWT_TELEMETRY_DIAG_S`` seconds
    (default 20, the first heartbeat always computes)."""
    import os
    import time

    now = time.perf_counter()
    try:
        interval = float(os.environ.get("EWT_TELEMETRY_DIAG_S", "20"))
    except ValueError:
        interval = 20.0
    if last_t[0] and now - last_t[0] < interval:
        return None
    last_t[0] = now
    c = np.transpose(np.asarray(block, dtype=np.float64), (1, 0, 2))
    stride = max(1, -(-c.shape[1] // max_kept))
    return summarize_chains(c[:, ::stride], param_names)["_worst"]
