"""Design matrices for rank-reduced Gaussian processes.

Conventions follow the reference stack so posteriors are comparable
(Enterprise's ``createfourierdesignmatrix_red/dm/chromatic``, consumed by the
reference at ``enterprise_warp/enterprise_models.py:190-254``):

- Fourier frequencies ``f_k = k / Tspan`` for ``k = 1..nmodes``;
- columns interleaved as [sin f1, cos f1, sin f2, cos f2, ...];
- DM basis scales rows by ``(fref / nu)^2``; chromatic by ``(fref/nu)^idx``
  with ``idx`` possibly a sampled parameter (applied dynamically in-kernel).

These builders run host-side in float64 (numpy); the likelihood layer decides
the on-device dtype.
"""
# ewt: allow-precision module — build-time basis construction is
# host f64 END TO END: frequencies span ~1e-9..1e-7 Hz against
# ~1e9 s TOAs, and sin/cos of (2 pi f t) needs the f64 mantissa to
# keep phase; the likelihood layer owns any downcast


from __future__ import annotations

import numpy as np


def fourier_design(toas: np.ndarray, nmodes: int, Tspan: float):
    """Fourier GP design matrix.

    Parameters
    ----------
    toas : (ntoa,) seconds (any fixed offset is irrelevant up to phase)
    nmodes : number of frequencies
    Tspan : observation span in seconds setting the frequency grid

    Returns
    -------
    F : (ntoa, 2 * nmodes) float64, [sin f1, cos f1, sin f2, cos f2, ...]
    freqs : (nmodes,) Hz
    """
    toas = np.asarray(toas, dtype=np.float64)
    freqs = np.arange(1, nmodes + 1, dtype=np.float64) / Tspan
    arg = 2.0 * np.pi * toas[:, None] * freqs[None, :]
    F = np.empty((len(toas), 2 * nmodes), dtype=np.float64)
    F[:, 0::2] = np.sin(arg)
    F[:, 1::2] = np.cos(arg)
    return F, freqs


def dm_scaling(radio_freqs_mhz: np.ndarray, fref_mhz: float = 1400.0):
    """Per-TOA row scaling for the DM GP basis: (fref/nu)^2."""
    nu = np.asarray(radio_freqs_mhz, dtype=np.float64)
    return (fref_mhz / nu) ** 2


def chromatic_scaling(radio_freqs_mhz: np.ndarray, idx: float,
                      fref_mhz: float = 1400.0):
    """Per-TOA row scaling (fref/nu)^idx for a *fixed* chromatic index."""
    nu = np.asarray(radio_freqs_mhz, dtype=np.float64)
    return (fref_mhz / nu) ** idx


def log_freq_ratio(radio_freqs_mhz: np.ndarray, fref_mhz: float = 1400.0):
    """log(fref/nu) — the in-kernel dynamic chromatic scaling is
    ``exp(idx * log_freq_ratio)`` with sampled ``idx``."""
    nu = np.asarray(radio_freqs_mhz, dtype=np.float64)
    return np.log(fref_mhz / nu)


def quantization_matrix(toas: np.ndarray, dt: float = 10.0,
                        mask: np.ndarray | None = None):
    """Epoch quantization matrix for ECORR.

    Groups TOAs closer than ``dt`` seconds into observation epochs (the
    structure Enterprise's ``EcorrKernelNoise`` builds internally, consumed by
    the reference at ``enterprise_models.py:133-146``). Only epochs with >= 2
    TOAs carry a column: a singleton epoch's ECORR is degenerate with EQUAD.

    Returns U of shape (ntoa, nepoch) with 0/1 indicator columns
    (possibly nepoch == 0). ``mask`` restricts to a TOA subset (per-backend
    ECORR).
    """
    toas = np.asarray(toas, dtype=np.float64)
    n = len(toas)
    sel = np.ones(n, dtype=bool) if mask is None else np.asarray(mask, bool)
    idx = np.nonzero(sel)[0]
    if len(idx) == 0:
        return np.zeros((n, 0))
    order = idx[np.argsort(toas[idx], kind="stable")]
    cols = []
    start = 0
    st = toas[order]
    for i in range(1, len(order) + 1):
        if i == len(order) or st[i] - st[i - 1] > dt:
            group = order[start:i]
            if len(group) >= 2:
                col = np.zeros(n)
                col[group] = 1.0
                cols.append(col)
            start = i
    if not cols:
        return np.zeros((n, 0))
    return np.stack(cols, axis=1)
