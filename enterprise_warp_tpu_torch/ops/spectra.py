"""Power-spectral-density models -> Fourier-coefficient prior variances.

Counterpart of ``enterprise_warp_tpu/ops/spectra.py`` on tensors with an
explicit leading walker axis: hyper-parameters arrive as ``(W,)`` tensors
(one value per walker) and each function returns ``(W, 2*nmodes)``
variances. Formula conventions match Enterprise (``utils.powerlaw``), the
broken power law of Goncharov, Zhu & Thrane 2019, and
``gp_priors.free_spectrum``. Every PSD is evaluated in log space with one
final clamped ``exp`` — the reference's exponent guard, kept so the two
packages agree at prior corners.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as const

_LOG_PHI_MIN = math.log(1e-36)
_LOG_PHI_MAX = math.log(1e35)
_LN10 = math.log(10.0)


def _repeat_modes(phi_modes):
    """(W, nmodes) mode variances -> (W, 2*nmodes) interleaved sin/cos."""
    return torch.repeat_interleave(phi_modes, 2, dim=-1)


def _exp_clamped(log_phi):
    return torch.exp(torch.clamp(log_phi, _LOG_PHI_MIN, _LOG_PHI_MAX))


def powerlaw_psd(f, df, log10_A, gamma):
    """Power-law red-noise prior variance per Fourier mode:
    ``A^2 / (12 pi^2) * fyr^(gamma-3) * f^(-gamma) * df``."""
    log10_A = log10_A[..., None]
    gamma = gamma[..., None]
    log_phi = (2.0 * log10_A * _LN10 - math.log(12.0 * math.pi ** 2)
               + (gamma - 3.0) * math.log(const.fyr)
               - gamma * torch.log(f) + torch.log(df))
    return _repeat_modes(_exp_clamped(log_phi))


def broken_powerlaw_psd(f, df, log10_A, gamma, fc):
    """Broken power law; ``fc < 0`` is read as log10(fc)."""
    log10_A, gamma, fc = log10_A[..., None], gamma[..., None], fc[..., None]
    fc = torch.where(fc < 0, 10.0 ** fc, fc)
    log_phi = (2.0 * log10_A * _LN10 - math.log(12.0 * math.pi ** 2)
               - 3.0 * math.log(const.fyr)
               - gamma * (torch.log(f + fc) - math.log(const.fyr))
               + torch.log(df))
    return _repeat_modes(_exp_clamped(log_phi))


def free_spectrum_psd(f, df, log10_rho):
    """Free spectrum: rho_k^2 per mode; ``log10_rho`` is (W, nmodes)."""
    del f, df
    return _repeat_modes(_exp_clamped(2.0 * log10_rho * _LN10))


def df_from_freqs(freqs):
    """Grid spacing including the DC gap (numpy, build time)."""
    f = np.asarray(freqs)
    return np.diff(np.concatenate(([0.0], f)))
