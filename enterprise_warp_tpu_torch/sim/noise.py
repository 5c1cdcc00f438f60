"""Noise injection and fake-dataset generation.

Counterpart of ``enterprise_warp_tpu/sim/noise.py`` (numpy, built on the
port's own ``Pulsar``, ``ParFile``, ``fourier_design`` and
``df_from_freqs``), the native replacement of the reference's
``libstempo_warp``: the PSD formulas (``red_psd``, ``dm_psd``,
``red_v1_psd``, ``lorenzian_red_psd``), the per-backend PSD export and
plot, white-noise and Fourier-basis process injection, the
PAL2-noise-dict-driven ``add_noise`` with its backend-flag-convention
detection, and libstempo-style fake pulsars and arrays. For a seed, every
array equals the reference's bit for bit: the same numpy draws in the
same order.
"""

from __future__ import annotations

import numpy as np

from .. import constants as const
from ..io.par import ParFile
from ..io.pulsar import Pulsar
from ..ops import fourier_design
from ..ops.spectra import df_from_freqs

_FLAG_CONVENTIONS = ("group", "f", "g", "sys", "be", "B")


def red_psd(f, log10_A, gamma):
    """One-sided power-law PSD in s^3 (the reference's libstempo_warp
    convention)."""
    A2 = 10.0 ** (2.0 * np.asarray(log10_A))
    return (A2 / (12.0 * np.pi ** 2) * const.fyr ** (gamma - 3.0)
            * np.asarray(f) ** -gamma)


def dm_psd(f, log10_A, gamma):
    """DM-noise PSD (the same shape; the chromatic scaling is applied per
    TOA)."""
    return red_psd(f, log10_A, gamma)


def red_v1_psd(f, log10_A, gamma, fc):
    """Power-law PSD with a low-frequency turnover at ``fc`` Hz, the
    reference's v1 convention: ``A^2/(12 pi^2) fyr^(gamma-3)
    (f+fc)^-gamma``."""
    A2 = 10.0 ** (2.0 * np.asarray(log10_A))
    return (A2 / (12.0 * np.pi ** 2) * const.fyr ** (gamma - 3.0)
            * (np.asarray(f) + fc) ** -gamma)


def lorenzian_red_psd(f, P, fc, alpha):
    """Lorentzian red-noise PSD ``P / (1 + (f/fc)^2)^(alpha/2)``: flat
    below the corner frequency ``fc``, power law ``-alpha`` above."""
    return P / (1.0 + (np.asarray(f) / fc) ** 2) ** (alpha / 2.0)


def added_noise_psd_to_vector(added_noise_psd_params, param="efac"):
    """Per-backend dict -> ``(values, backends)`` vectors for white-noise
    re-injection."""
    vals, bckds = [], []
    for backend, entry in added_noise_psd_params.items():
        if isinstance(entry, dict) and param in entry:
            vals.append(entry[param])
            bckds.append(backend)
    return vals, bckds


def plot_noise_psd_from_dict(psr, psd_params, backends, ff, ax=None):
    """Overlay per-backend white-noise levels, the red-noise PSD
    (power law by ``A``/``gamma`` or Lorentzian by ``P``/``fc``/``alpha``)
    and the DM-noise PSD at the pulsar's highest observing frequency.
    Needs matplotlib, which is imported here and nowhere else."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as exc:
        raise ImportError("plot_noise_psd_from_dict needs matplotlib, "
                          "which is not installed") from exc

    if ax is None:
        _, ax = plt.subplots()
    ff = np.asarray(ff)
    for backend in backends:
        wpsd = psd_params[backend]["rms_toaerr"] * 1e-6
        ax.loglog(ff, np.repeat(wpsd, len(ff)),
                  label=f"RMS white noise in {backend}")
    red = psd_params.get("red")
    if red:
        if "A" in red:
            ax.loglog(ff, red_psd(ff, np.log10(red["A"]), red["gamma"]),
                      label=(f"Red noise, lgA="
                             f"{np.log10(red['A']):.2f}, "
                             f"gamma={red['gamma']:.2f}"))
        elif "P" in red:
            ax.loglog(ff, lorenzian_red_psd(ff, red["P"], red["fc"],
                                            red["alpha"]),
                      label=(f"Red noise, lgP={np.log10(red['P']):.2f},"
                             f" alpha={red['alpha']:.2f}"))
    dm = psd_params.get("dm")
    if dm and "A" in dm:
        # the timing perturbation of DM noise scales as nu^-2: at the
        # highest observing frequency the chromatic factor is
        # (1400 MHz / nu_max)^2
        numax = float(np.max(psr.freqs))
        scale = (1400.0 / numax) ** 2
        ax.loglog(ff, scale ** 2 * dm_psd(ff, np.log10(dm["A"]),
                                          dm["gamma"]),
                  label=(f"DM noise at {numax:.0f} MHz, "
                         f"lgA={np.log10(dm['A']):.2f}, "
                         f"gamma={dm['gamma']:.2f}"))
    ax.set_xlabel("Frequency [Hz]")
    ax.set_ylabel("PSD [s^3]")
    ax.legend(fontsize=7)
    return ax


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


def _detect_flag_convention(psr: Pulsar, noise_dict: dict):
    """The TOA flag whose values appear in the noise-dict keys."""
    for flag in _FLAG_CONVENTIONS:
        vals = psr.flagvals(flag)
        if vals and any(any(v in key for key in noise_dict) for v in vals):
            return flag, vals
    return None, []


def add_noise(psr: Pulsar, noise_dict: dict, components=30, seed=0,
              inc_efac=True, inc_equad=True, inc_red=True, inc_dm=True):
    """Inject the noise a PAL2-format noise dict describes into
    ``psr.residuals``: per-backend efac/equad matched by flag convention,
    then ``components``-mode red and DM processes, all drawn from
    ``np.random.default_rng(seed)`` in the reference's order."""
    rng = np.random.default_rng(seed)
    flag, vals = _detect_flag_convention(psr, noise_dict)

    efac, equad = {}, {}
    for key, val in noise_dict.items():
        for v in vals:
            if v in key and "efac" in key:
                efac[v] = val
            elif v in key and "equad" in key:
                equad[v] = val
    unused = [v for v in vals if v not in efac and v not in equad]
    if unused:
        from ..utils.logging import get_logger
        get_logger("ewt.sim").warning(
            "backends with no noise-dict entry: %s", unused)

    if inc_efac and efac:
        inject_white(psr, efac=efac, flag=flag, rng=rng)
    elif inc_efac:
        inject_white(psr, efac=1.0, rng=rng)
    if inc_equad and equad:
        inject_white(psr, efac=0.0, equad_log10=equad, flag=flag, rng=rng)

    def find(suffix_a, suffix_b):
        a = [v for k, v in noise_dict.items() if k.endswith(suffix_a)]
        b = [v for k, v in noise_dict.items() if k.endswith(suffix_b)]
        return (a[0], b[0]) if a and b else (None, None)

    if inc_red:
        lgA, gam = find("red_noise_log10_A", "red_noise_gamma")
        if lgA is not None:
            inject_basis_process(psr, lgA, gam, components=components,
                                 rng=rng)
    if inc_dm:
        lgA, gam = find("dm_gp_log10_A", "dm_gp_gamma")
        if lgA is not None:
            inject_basis_process(psr, lgA, gam, components=components,
                                 chromatic_idx=2.0, rng=rng)
    return psr


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
