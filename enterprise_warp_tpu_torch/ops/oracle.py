# ewt: allow-precision module — the dense float64 oracle every kernel
# path is held against: its whole point is float64
"""Dense float64 numpy oracle for likelihood-equivalence tests.

Counterpart of ``enterprise_warp_tpu/ops/oracle.py``: an independent
implementation of the marginalized GP likelihood of
``kernel.marginalized_loglike`` through an explicit (ntoa x ntoa)
covariance and a dense Cholesky — O(ntoa^3), test-sized data only. The
port's likelihood must match it at matched parameters. A timing-model
matrix with no columns, ``M`` of shape (ntoa, 0), gives the likelihood
without a marginalized timing model (the sampled-TM path).
"""

from __future__ import annotations

import numpy as np


def oracle_loglike(residuals, toaerrs, ndiag, M, T, b):
    """Dense-covariance marginalized log-likelihood.

    Parameters are *unwhitened*: ``ndiag`` is the white-noise variance per
    TOA (s^2), ``T`` the raw noise-basis matrix, ``b`` the raw coefficient
    prior variances, ``M`` the raw timing-model matrix.

    Returns lnL up to the same additive constant convention as the kernel
    *plus* the whitening constant: kernel_lnL == oracle_lnL + sum ln sigma^2
    ... specifically ``kernel == oracle + 2 sum ln sigma + tm_norm`` — the
    caller should compare *differences* of lnL across parameter points, which
    are constant-free, and absolute values via the helper below.
    """
    r = np.asarray(residuals, np.float64)
    C = np.diag(np.asarray(ndiag, np.float64))
    T = np.asarray(T, np.float64)
    b = np.asarray(b, np.float64)
    M = np.asarray(M, np.float64)
    C = C + (T * b[None, :]) @ T.T

    Lc = np.linalg.cholesky(C)
    # r^T C^-1 r and ln|C|
    ur = np.linalg.solve(Lc, r)
    UM = np.linalg.solve(Lc, M)
    logdet_c = 2.0 * np.sum(np.log(np.diag(Lc)))

    A = UM.T @ UM                       # M^T C^-1 M
    y = UM.T @ ur                       # M^T C^-1 r
    La = np.linalg.cholesky(A)
    z = np.linalg.solve(La, y)
    logdet_a = 2.0 * np.sum(np.log(np.diag(La)))

    quad = ur @ ur - z @ z
    return -0.5 * (quad + logdet_c + logdet_a)


def kernel_constant_offset(toaerrs, M):
    """The theta-independent constant by which the kernel's lnL exceeds
    :func:`oracle_loglike`: ``kernel = oracle + offset``.

    Whitening shifts ``-1/2 ln|C|`` by ``+ sum ln sigma`` and the kernel's
    normalized-M convention shifts ``-1/2 ln|A|`` by ``+ sum ln s_m`` with
    ``s_m`` the norms of the sigma-whitened TM columns (the quadratic forms
    are invariant).
    """
    sigma = np.asarray(toaerrs, np.float64)
    Mw = np.asarray(M, np.float64) / sigma[:, None]
    norms = np.linalg.norm(Mw, axis=0)
    return np.sum(np.log(sigma)) + np.sum(np.log(norms))
