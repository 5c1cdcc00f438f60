"""Linearized timing model: phase prediction, residuals, design matrix.

Natively replaces the timing-solution capability the reference consumes from
tempo2 (the ``Pulsar(par, tim)`` construction at
``enterprise_warp/enterprise_warp.py:382`` and the ML
reconstruction bridge in ``tempo2_warp.py``). The GP-marginalized likelihood
only needs (a) residuals and (b) the *linearized* design matrix ``M`` whose
coefficients it marginalizes analytically with an (improper) flat prior —
sign/scale conventions of the columns are therefore irrelevant after the
column normalization applied downstream.

Columns built (for parameters with fit flag 1 in the .par, offset always):
offset, F0, F1, F2, DM, DM1, DM2 (nu^-2 chromatic), RAJ, DECJ, PMRA, PMDEC
(annual Roemer derivatives), PX (parallax shape), and one indicator column per
fitted JUMP.
"""

from __future__ import annotations

import numpy as np

from .. import constants as const
from . import bary
from .par import ParFile
from .tim import TimFile


def compute_delays(par: ParFile, tim: TimFile):
    """Total propagation delay per TOA (s) and the observatory SSB positions.

    Returns ``(delay, obs_pos_au, barycentric)`` where ``barycentric`` flags
    that all sites were pseudo-sites at the SSB (simulated data) and no
    spatial corrections were applied.
    """
    mjd = tim.mjd
    sites = [str(s).lower() for s in tim.sites]
    all_bary = all(s in bary.BARYCENTRIC_SITES for s in sites)

    dt_yr = ((tim.mjd_int - par.dmepoch) * const.day + tim.sec) / const.yr
    delay = bary.dm_delay(tim.freqs, par.dm, par.dm1, par.dm2, dt_yr)

    # JUMPs are constant offsets applied to matching TOAs
    for jmp in par.jumps:
        mask = _jump_mask(tim, jmp)
        if mask.any():
            delay = delay - jmp.value * mask

    if all_bary:
        return delay, None, True

    obs = bary.observatory_ssb_position(mjd, tim.sites)
    delay = delay - bary.roemer_delay(obs, par.pos)
    delay = delay + bary.shapiro_delay_sun(obs, par.pos)
    delay = delay - bary.tt_minus_tdb(mjd)
    return delay, obs, False


def _jump_mask(tim: TimFile, jmp) -> np.ndarray:
    """Boolean TOA mask for one JUMP's (flag, flagval) selector."""
    vals = tim.flags.get(jmp.flag)
    if vals is None:
        return np.zeros(len(tim), dtype=bool)
    return np.asarray([v == jmp.flagval for v in vals], dtype=bool)


def phase_residuals(par: ParFile, tim: TimFile, delay: np.ndarray):
    """Phase-connected timing residuals (s) and a connection-quality flag.

    Emission-time phase is evaluated with the par-file spin solution; pulse
    numbers come from rounding. Connection is deemed reliable when the spread
    of fractional phase is well under one turn — true for simulated
    barycentric data, false for real observatory data under the approximate
    ephemeris (see ``bary`` module docstring).
    """
    dt = (tim.mjd_int - par.pepoch) * const.day + tim.sec - delay
    phase = dt * (par.f0 + dt * (par.f1 / 2.0 + dt * par.f2 / 6.0))
    n = np.round(phase)
    frac = phase - n
    res = frac / par.f0
    # quality: weighted spread of fractional phase
    ok = bool(np.ptp(frac) < 0.5)
    return res - np.average(res), ok


def design_matrix(par: ParFile, tim: TimFile, obs_pos_au=None):
    """Linearized timing-model design matrix.

    Returns ``(M, labels)`` with ``M`` of shape (ntoa, nparam). Columns are
    *not* normalized here; the likelihood layer normalizes and marginalizes.
    """
    ntoa = len(tim)
    dt = (tim.mjd_int - par.pepoch) * const.day + tim.sec
    cols, labels = [np.ones(ntoa)], ["OFFSET"]

    def add(name, col):
        cols.append(np.asarray(col, dtype=np.float64))
        labels.append(name)

    if par.fitted("F0"):
        add("F0", -dt / par.f0)
    if par.fitted("F1"):
        add("F1", -0.5 * dt ** 2 / par.f0)
    if par.fitted("F2"):
        add("F2", -dt ** 3 / (6.0 * par.f0))

    nu2 = 1.0 / tim.freqs ** 2
    dt_dm_yr = ((tim.mjd_int - par.dmepoch) * const.day + tim.sec) / const.yr
    if par.fitted("DM"):
        add("DM", const.DM_DELAY_CONST * nu2)
    if par.fitted("DM1"):
        add("DM1", const.DM_DELAY_CONST * nu2 * dt_dm_yr)
    if par.fitted("DM2"):
        add("DM2", 0.5 * const.DM_DELAY_CONST * nu2 * dt_dm_yr ** 2)

    if obs_pos_au is not None:
        ca, sa = np.cos(par.raj), np.sin(par.raj)
        cd, sd = np.cos(par.decj), np.sin(par.decj)
        dn_dra = np.array([-cd * sa, cd * ca, 0.0])
        dn_ddec = np.array([-sd * ca, -sd * sa, cd])
        r_dot_dra = obs_pos_au @ dn_dra * const.AU_light_s
        r_dot_ddec = obs_pos_au @ dn_ddec * const.AU_light_s
        dt_pos_yr = ((tim.mjd_int - par.posepoch) * const.day + tim.sec) \
            / const.yr
        if par.fitted("RAJ"):
            add("RAJ", r_dot_dra)
        if par.fitted("DECJ"):
            add("DECJ", r_dot_ddec)
        if par.fitted("PMRA"):
            add("PMRA", r_dot_dra * dt_pos_yr)
        if par.fitted("PMDEC"):
            add("PMDEC", r_dot_ddec * dt_pos_yr)
        if par.fitted("PX"):
            n = np.asarray(par.pos)
            r2 = np.sum(obs_pos_au ** 2, axis=-1)
            rn = obs_pos_au @ n
            add("PX", 0.5 * (r2 - rn ** 2) * const.AU_light_s)
    else:
        # barycentric/simulated data: spatial columns reduce to annual
        # harmonics only if positions were available; fit flags on position
        # parameters are ignored (documented approximation)
        pass

    for k, jmp in enumerate(par.jumps):
        if jmp.fit:
            mask = _jump_mask(tim, jmp)
            if mask.any():
                add(f"JUMP{k}_{jmp.flag}_{jmp.flagval}",
                    mask.astype(np.float64))

    M = np.stack(cols, axis=1)
    return M, labels
