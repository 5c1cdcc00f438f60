"""Noise injection and fake-dataset generation.

Counterpart of the part of ``enterprise_warp_tpu/sim/noise.py`` that the
array fixtures need (numpy, built on the port's own ``Pulsar``,
``ParFile``, ``fourier_design`` and ``df_from_freqs``): the power-law PSD
``red_psd``, white-noise and Fourier-basis process injection, and
libstempo-style fake pulsars and arrays. For a seed, every array equals
the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np

from .. import constants as const
from ..io.par import ParFile
from ..io.pulsar import Pulsar
from ..ops import fourier_design
from ..ops.spectra import df_from_freqs


def red_psd(f, log10_A, gamma):
    """One-sided power-law PSD in s^3 (the reference's libstempo_warp
    convention)."""
    A2 = 10.0 ** (2.0 * np.asarray(log10_A))
    return (A2 / (12.0 * np.pi ** 2) * const.fyr ** (gamma - 3.0)
            * np.asarray(f) ** -gamma)


def inject_white(psr: Pulsar, efac=None, equad_log10=None, flag=None,
                 rng=None):
    """Add per-backend white noise to ``psr.residuals``. ``efac`` and
    ``equad_log10`` map backend value -> parameter (or are scalars for a
    global term)."""
    rng = rng or np.random.default_rng(0)
    n = len(psr)
    sig2 = np.zeros(n)
    if np.isscalar(efac) or efac is None:
        e = 1.0 if efac is None else float(efac)
        sig2 += (e ** 2 - 0.0) * psr.toaerrs ** 2
    else:
        masks = psr.backend_masks(flag)
        for k, v in efac.items():
            sig2 += (float(v) ** 2) * psr.toaerrs ** 2 * masks[k]
    if equad_log10 is not None:
        if np.isscalar(equad_log10):
            sig2 += 10.0 ** (2 * float(equad_log10))
        else:
            masks = psr.backend_masks(flag)
            for k, v in equad_log10.items():
                sig2 += 10.0 ** (2 * float(v)) * masks[k]
    noise = rng.standard_normal(n) * np.sqrt(sig2)
    psr.residuals = psr.residuals + noise
    return noise


def inject_basis_process(psr: Pulsar, log10_A, gamma, components=30,
                         chromatic_idx=0.0, fref=1400.0, rng=None,
                         Tspan=None, return_coeffs=False):
    """Inject a stationary red process through its Fourier representation:
    coefficients ``a_k ~ N(0, phi_k)`` with the per-mode variance the
    likelihood assigns, scaled by ``(fref/nu)^chromatic_idx`` (DM: 2)."""
    rng = rng or np.random.default_rng(0)
    Tspan = Tspan or psr.Tspan
    F, freqs = fourier_design(psr.toas - psr.toas.min(), components, Tspan)
    df = df_from_freqs(freqs)
    phi = np.repeat(red_psd(freqs, log10_A, gamma) * df, 2)
    coeffs = rng.standard_normal(2 * components) * np.sqrt(phi)
    sig = F @ coeffs
    if chromatic_idx:
        sig = sig * (fref / psr.freqs) ** chromatic_idx
    psr.residuals = psr.residuals + sig
    return (sig, coeffs) if return_coeffs else sig


def make_fake_pulsar(name="J0000+0000", ntoa=200, cadence_days=14.0,
                     toaerr_us=1.0, start_mjd=55000.0, freqs_mhz=1400.0,
                     backends=("SIM",), raj=1.0, decj=-0.5, seed=0):
    """A barycentric fake pulsar (libstempo ``fakepulsar`` + ``make_ideal``):
    zero residuals, regular cadence, optional multi-backend structure, a
    quadratic spin-down design matrix."""
    rng = np.random.default_rng(seed)
    mjd = start_mjd + np.arange(ntoa) * cadence_days \
        + rng.uniform(-0.1, 0.1, ntoa)
    toas = mjd * const.day
    nu = (np.full(ntoa, float(freqs_mhz))
          if np.isscalar(freqs_mhz)
          else rng.choice(np.asarray(freqs_mhz), ntoa))
    backend = rng.choice(np.asarray(backends, dtype=object), ntoa)
    sigma = np.full(ntoa, toaerr_us * 1e-6)
    t0 = toas - toas.mean()
    M = np.stack([np.ones(ntoa), t0 / t0.std(),
                  (t0 / t0.std()) ** 2], axis=1)
    pos = np.array([np.cos(decj) * np.cos(raj),
                    np.cos(decj) * np.sin(raj), np.sin(decj)])
    flags = {"f": backend.copy(), "group": backend.copy(),
             "B": backend.copy()}
    par = ParFile()
    par.name = name
    par.raj, par.decj = raj, decj
    par.f0, par.pepoch = 100.0, start_mjd
    return Pulsar(
        name=name, toas=toas, toas_rel=toas - toas[0],
        residuals=np.zeros(ntoa), toaerrs=sigma, freqs=nu, pos=pos,
        Mmat=M, Mmat_labels=["OFFSET", "F0", "F1"], flags=flags,
        backend_flags=backend, raj=raj, decj=decj, phase_connected=True,
        par=par)


def make_fake_pta(npsr=10, ntoa=200, toaerr_us=1.0, seed=0, **kw):
    """A sky-scattered fake PTA: ``npsr`` fake pulsars at uniform sky
    positions."""
    rng = np.random.default_rng(seed)
    psrs = []
    for i in range(npsr):
        raj = rng.uniform(0, 2 * np.pi)
        decj = np.arcsin(rng.uniform(-1, 1))
        psrs.append(make_fake_pulsar(
            name=f"J{i:04d}+{i:04d}", ntoa=ntoa, toaerr_us=toaerr_us,
            raj=raj, decj=decj, seed=seed + 1000 + i, **kw))
    return psrs
