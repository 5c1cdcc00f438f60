"""Physical and timing constants.

Values match the conventions used by the reference stack (Enterprise's
``enterprise.constants``, cited from ``enterprise_warp/enterprise_models.py:553-563``
where ``const.fyr`` normalizes power-law PSDs) so that parameter posteriors are
directly comparable.
"""

import math

# --- time ---------------------------------------------------------------
day = 86400.0                      # seconds
yr = 365.25 * day                  # Julian year, seconds
fyr = 1.0 / yr                     # 1/yr in Hz — PSD reference frequency

# Modified Julian Date epoch offsets
MJD_J2000 = 51544.5                # MJD of J2000.0 epoch

# --- astronomy ----------------------------------------------------------
c = 299792458.0                    # speed of light, m/s
AU = 149597870700.0                # astronomical unit, m
AU_light_s = AU / c                # light travel time over 1 AU, s (~499.005)

# dispersion constant: dt = DM * DM_K / nu^2 with nu in MHz, DM in pc/cm^3
# (tempo2 convention, 1/(2.41e-4) MHz^2 pc^-1 cm^3 s)
DM_K = 2.41e-4                     # MHz^-2 pc cm^-3 / s  (inverse sense below)
DM_DELAY_CONST = 1.0 / DM_K        # s MHz^2 / (pc cm^-3) ≈ 4149.38

# --- angles -------------------------------------------------------------
DEG2RAD = math.pi / 180.0
ARCSEC2RAD = DEG2RAD / 3600.0
MAS_PER_YR_TO_RAD_PER_S = ARCSEC2RAD / 1e3 / yr

# obliquity of the ecliptic at J2000 (IAU 2006), radians
ECL_OBLIQUITY = 84381.406 * ARCSEC2RAD
