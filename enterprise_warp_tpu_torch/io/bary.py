"""Approximate solar-system barycentering (native tempo2 replacement, v1).

The reference delegates barycentering to the tempo2 C++ binary
(``enterprise_warp/tempo2_warp.py:28-41``) with JPL ephemerides
(DE436, ``enterprise_warp.py:227-229``). No ephemeris tables exist in this
environment, so this module implements a fully analytic approximation:

- Earth heliocentric position from the low-precision solar formulas of the
  Astronomical Almanac (mean longitude + equation-of-center), ~1e-4 AU;
- Sun-to-SSB offset from mean Keplerian elements of the four giant planets
  (the dominant ~2.5 light-second term is Jupiter's), ~few-ms delay accuracy;
- TT->TDB Einstein delay from the dominant annual term;
- observatory geocentric offset via an embedded site table + GMST rotation;
- solar-system Shapiro delay (logarithmic term, Sun only);
- dispersion delay from the par-file DM polynomial.

Accuracy budget: delays are good to ~10 ms absolute. That is far coarser than
tempo2 (ns) — residuals for *real* observatory data therefore cannot be
phase-connected here and the Pulsar loader falls back to synthesizing
residuals (see ``pulsar.py``). Simulated/barycentric datasets (site ``AXIS``,
``@``, ``bat`` — e.g. the shipped ``fake_psr_0``) bypass these corrections and
phase-connect exactly. Documented as approximation #1 per SURVEY.md §7.3.
"""

from __future__ import annotations

import math

import numpy as np

from .. import constants as const

# Geocentric ITRF positions (m) of the observatories appearing in PTA data.
# Values are the standard tempo2 observatory coordinates (public).
OBSERVATORIES = {
    "pks": (-4554231.5, 2816759.1, -3454036.3),     # Parkes
    "parkes": (-4554231.5, 2816759.1, -3454036.3),
    "7": (-4554231.5, 2816759.1, -3454036.3),
    "gbt": (882589.65, -4924872.32, 3943729.348),    # Green Bank
    "1": (882589.65, -4924872.32, 3943729.348),
    "ao": (2390490.0, -5564764.0, 1994727.0),        # Arecibo
    "3": (2390490.0, -5564764.0, 1994727.0),
    "arecibo": (2390490.0, -5564764.0, 1994727.0),
    "jb": (3822626.04, -154105.65, 5086486.04),      # Jodrell Bank
    "8": (3822626.04, -154105.65, 5086486.04),
    "eff": (4033949.5, 486989.4, 4900430.8),         # Effelsberg
    "g": (4033949.5, 486989.4, 4900430.8),
    "ncy": (4324165.81, 165927.11, 4670132.83),      # Nancay
    "f": (4324165.81, 165927.11, 4670132.83),
    "wsrt": (3828445.659, 445223.600, 5064921.5677), # Westerbork
    "i": (3828445.659, 445223.600, 5064921.5677),
    "mk": (5109360.133, 2006852.586, -3238948.127),  # MeerKAT
    "meerkat": (5109360.133, 2006852.586, -3238948.127),
    "chime": (-2059166.313, -3621302.972, 4814304.113),
}

# Sites treated as "already at the solar-system barycenter" (simulated data).
BARYCENTRIC_SITES = {"axis", "@", "bat", "ssb", "coe", "stl"}

# Mean Keplerian elements at J2000 for the giant planets (Standish tables):
# a [AU], e, I [deg], mean longitude L [deg] and its rate [deg/century],
# longitude of perihelion [deg], longitude of ascending node [deg],
# inverse mass ratio M_sun/m_planet.
_GIANTS = [
    # a, e, I, L0, Ldot, varpi, Omega, Msun/m
    (5.20288700, 0.04838624, 1.30439695, 34.39644051, 3034.74612775,
     14.72847983, 100.47390909, 1047.3486),
    (9.53667594, 0.05386179, 2.48599187, 49.95424423, 1222.49362201,
     92.59887831, 113.66242448, 3497.898),
    (19.18916464, 0.04725744, 0.77263783, 313.23810451, 428.48202785,
     170.95427630, 74.01692503, 22902.98),
    (30.06992276, 0.00859048, 1.77004347, -55.12002969, 218.45945325,
     44.96476227, 131.78422574, 19412.24),
]

_EARTH_MOON_INV_MASS = 328900.56


def _rot_ecl_to_eq(x, y, z):
    """Rotate ecliptic J2000 coordinates to equatorial."""
    ce, se = math.cos(const.ECL_OBLIQUITY), math.sin(const.ECL_OBLIQUITY)
    return x, ce * y - se * z, se * y + ce * z


def _kepler_solve(M, e):
    """Solve Kepler's equation E - e sin E = M (vectorized Newton)."""
    E = M + e * np.sin(M)
    for _ in range(6):
        E = E - (E - e * np.sin(E) - M) / (1.0 - e * np.cos(E))
    return E


def _planet_helio_eq(elem, t_cy):
    """Heliocentric equatorial position (AU) of a planet from mean elements."""
    a, e, I, L0, Ldot, varpi, Omega, _ = elem
    L = np.deg2rad(L0 + Ldot * t_cy)
    w = math.radians(varpi - Omega)
    Om = math.radians(Omega)
    inc = math.radians(I)
    M = np.mod(L - math.radians(varpi), 2 * np.pi)
    E = _kepler_solve(M, e)
    xp = a * (np.cos(E) - e)
    yp = a * math.sqrt(1 - e * e) * np.sin(E)
    cw, sw = math.cos(w), math.sin(w)
    cO, sO = math.cos(Om), math.sin(Om)
    ci, si = math.cos(inc), math.sin(inc)
    x = (cw * cO - sw * sO * ci) * xp + (-sw * cO - cw * sO * ci) * yp
    y = (cw * sO + sw * cO * ci) * xp + (-sw * sO + cw * cO * ci) * yp
    z = (sw * si) * xp + (cw * si) * yp
    return _rot_ecl_to_eq(x, y, z)


def earth_ssb_position(mjd):
    """Barycentric equatorial position of the geocenter, in AU.

    ``mjd`` is an array of (TT) MJDs; returns shape (n, 3).
    """
    mjd = np.asarray(mjd, dtype=np.float64)
    n = mjd - const.MJD_J2000  # days from J2000
    t_cy = n / 36525.0

    # --- Earth heliocentric from low-precision solar position -------------
    L = np.deg2rad(np.mod(280.460 + 0.9856474 * n, 360.0))
    g = np.deg2rad(np.mod(357.528 + 0.9856003 * n, 360.0))
    lam = L + np.deg2rad(1.915) * np.sin(g) + np.deg2rad(0.020) * np.sin(2 * g)
    R = 1.00014 - 0.01671 * np.cos(g) - 0.00014 * np.cos(2 * g)
    # geocentric Sun (ecliptic) -> Earth heliocentric is the negative
    sx, sy, sz = R * np.cos(lam), R * np.sin(lam), np.zeros_like(lam)
    ex, ey, ez = _rot_ecl_to_eq(-sx, -sy, -sz)
    earth_helio = np.stack([ex, ey, ez], axis=-1)

    # --- Sun barycentric offset from the giant planets --------------------
    sun_ssb = np.zeros_like(earth_helio)
    for elem in _GIANTS:
        px, py, pz = _planet_helio_eq(elem, t_cy)
        inv_m = elem[-1]
        sun_ssb[:, 0] -= px / inv_m
        sun_ssb[:, 1] -= py / inv_m
        sun_ssb[:, 2] -= pz / inv_m
    # Earth-Moon barycenter's own (small) contribution
    sun_ssb -= earth_helio / _EARTH_MOON_INV_MASS

    return earth_helio + sun_ssb


def observatory_itrf(site: str):
    key = site.lower()
    if key in OBSERVATORIES:
        return np.array(OBSERVATORIES[key], dtype=np.float64)
    return None


def gmst_radians(mjd_ut):
    """Greenwich mean sidereal time (radians) from UT MJD (approximate)."""
    d = np.asarray(mjd_ut, dtype=np.float64) - const.MJD_J2000
    gmst_deg = 280.46061837 + 360.98564736629 * d
    return np.deg2rad(np.mod(gmst_deg, 360.0))


def observatory_ssb_position(mjd, sites):
    """Barycentric equatorial position (AU) of each observatory.

    Unknown sites fall back to the geocenter; TOAs at barycentric
    pseudo-sites (mixed-site .tim files) get the zero vector so no Roemer/
    Shapiro correction applies to them.
    """
    earth = earth_ssb_position(mjd)
    pos = earth.copy()
    theta = gmst_radians(mjd)
    ct, st = np.cos(theta), np.sin(theta)
    for i, site in enumerate(sites):
        s = str(site).lower()
        if s in BARYCENTRIC_SITES:
            pos[i, :] = 0.0
            continue
        xyz = observatory_itrf(s)
        if xyz is None:
            continue
        # rotate ITRF -> celestial by GMST about the z axis
        x = ct[i] * xyz[0] - st[i] * xyz[1]
        y = st[i] * xyz[0] + ct[i] * xyz[1]
        pos[i, 0] += x / const.AU
        pos[i, 1] += y / const.AU
        pos[i, 2] += xyz[2] / const.AU
    return pos


def tt_minus_tdb(mjd):
    """TT-TDB in seconds (dominant annual term; ~|1.7 ms| amplitude)."""
    n = np.asarray(mjd, dtype=np.float64) - const.MJD_J2000
    g = np.deg2rad(np.mod(357.528 + 0.9856003 * n, 360.0))
    return -1.657e-3 * np.sin(g + 0.01671 * np.sin(g))


def roemer_delay(obs_pos_au, psr_pos):
    """Roemer delay r_obs . n_psr / c, seconds (positive = early arrival)."""
    n = np.asarray(psr_pos, dtype=np.float64)
    return obs_pos_au @ n * const.AU_light_s


def shapiro_delay_sun(obs_pos_au, psr_pos):
    """Solar Shapiro delay, seconds."""
    two_gm_c3 = 9.8509819e-6  # 2 G M_sun / c^3, seconds
    n = np.asarray(psr_pos, dtype=np.float64)
    r = np.linalg.norm(obs_pos_au, axis=-1)
    cos_theta = (obs_pos_au @ n) / np.maximum(r, 1e-12)
    return -two_gm_c3 * np.log(np.maximum(1.0 + cos_theta, 1e-9))


def dm_delay(freqs_mhz, dm, dm1=0.0, dm2=0.0, dt_yr=None):
    """Dispersion delay in seconds. ``dt_yr`` is (t - DMEPOCH) in years."""
    dm_t = dm
    if dt_yr is not None:
        dm_t = dm + dm1 * dt_yr + 0.5 * dm2 * dt_yr ** 2
    return const.DM_DELAY_CONST * dm_t / np.asarray(freqs_mhz) ** 2
