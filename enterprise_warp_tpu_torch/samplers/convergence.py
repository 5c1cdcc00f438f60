"""Insertion-rank diagnostics of nested sampling (numpy).

Counterpart of the insertion-index helpers of
``enterprise_warp_tpu/samplers/convergence.py`` (Fowlie, Handley & Su
2020, batched form): when the constrained kernel truly samples the prior
above L*, each replacement's rank among the surviving live points is
uniform, and a KS distance against the discrete uniform tells a broken
kernel from a healthy one.
"""

from __future__ import annotations

import numpy as np


def insertion_rank_ks(ranks, nmax):
    """One-sample KS distance of insertion ranks against the discrete
    uniform on ``{0..nmax}``; ranks are midpoint-mapped to (0, 1) before
    the continuous KS fold. None for an empty rank set."""
    r = np.asarray(ranks, dtype=np.float64).ravel()
    n = r.size
    if n == 0:
        return None
    r = np.sort((r + 0.5) / (float(nmax) + 1.0))
    i = np.arange(n, dtype=np.float64)
    return float(np.max(np.maximum(r - i / n, (i + 1.0) / n - r)))


def insertion_rank_pass(ks, n, crit=1.95, n_eff=None):
    """Gate one KS distance: pass iff ``ks * sqrt(n_eff) <= crit``.
    ``n_eff`` (default ``n``) is the dependence-corrected sample size
    (:func:`insertion_rank_neff`); crit 1.95 is the asymptotic
    Kolmogorov value at alpha ~ 0.001, lenient on purpose: the gate
    catches a broken kernel, not 5%-level fluctuations."""
    n_eff = max(int(n if n_eff is None else n_eff), 1)
    stat = float(ks) * n_eff ** 0.5
    return {"pass": bool(stat <= crit),
            "ks_sqrt_n": round(stat, 3), "crit": crit,
            "n_eff": n_eff}


def insertion_rank_neff(n, nlive, kbatch):
    """Effective independent-rank count for ``n`` pooled ranks: the
    replacements of one iteration are seeded with replacement from the
    ``M = nlive - kbatch`` survivors, so ``n`` scales by the expected
    fraction of distinct seeds, ``M (1 - exp(-K/M)) / K``, K = kbatch."""
    m = max(int(nlive) - int(kbatch), 1)
    k = max(int(kbatch), 1)
    distinct = m * (1.0 - np.exp(-k / m))
    return max(int(round(n * min(distinct / k, 1.0))), 1)
