"""tempo2 .par (pulsar ephemeris) file parser.

Self-contained replacement for the parsing capability the reference obtains
through tempo2/libstempo (see ``enterprise_warp/tempo2_warp.py``
and the ``Pulsar(par, tim, ...)`` call at
``enterprise_warp/enterprise_warp.py:382``).

The .par grammar is line-oriented: ``KEY value [fit] [uncertainty]`` with
whitespace separation. ``JUMP`` lines carry four operands:
``JUMP <-flag> <flagval> <value> <fit>``. Lines starting with ``#`` are
comments (the shipped PPTA par files carry temponest noise values in
``#TN...`` comments, which we expose separately for provenance).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .. import constants as const
from .errors import ParseError

# Parameters whose values are plain floats we care about for the timing model.
_FLOAT_KEYS = {
    "F0", "F1", "F2", "F3", "DM", "DM1", "DM2", "DM3",
    "PMRA", "PMDEC", "PX", "PEPOCH", "POSEPOCH", "DMEPOCH",
    "START", "FINISH", "TZRMJD", "TZRFRQ", "TRES", "NE_SW",
    "PB", "A1", "ECC", "T0", "OM",
}

# Keys we recognize beyond _FLOAT_KEYS: either handled explicitly below
# or common tempo2 bookkeeping stored raw without comment. Anything
# outside this vocabulary is *stored raw anyway* but warned about once
# per key (numerical-integrity plane: a typo'd key must not vanish
# silently).
_KNOWN_KEYS = _FLOAT_KEYS | {
    "PSRJ", "PSR", "PSRB", "RAJ", "DECJ", "TZRSITE", "UNITS", "EPHEM",
    "CLK", "JUMP", "NTOA", "NITS", "MODE", "EPHVER", "TIMEEPH",
    "T2CMETHOD", "CORRECT_TROPOSPHERE", "PLANET_SHAPIRO", "DILATEFREQ",
    "ELONG", "ELAT", "PMELONG", "PMELAT", "BINARY", "SINI", "M2",
    "OMDOT", "PBDOT", "XDOT", "EDOT", "FB0", "FB1", "TASC", "EPS1",
    "EPS2", "KOM", "KIN", "CHI2R", "SOLARN0", "DMMODEL", "DMOFF",
    "F4", "F5", "F6", "GLEP_1", "GLPH_1", "GLF0_1", "GLF1_1",
}

# once-per-process unknown-key warning registry (a 45-pulsar campaign
# must not emit 45 copies of the same warning)
_WARNED_KEYS: set = set()


def _warn_unknown_key(key, path, lineno):
    if key in _WARNED_KEYS:
        return
    _WARNED_KEYS.add(key)
    from ..utils.logging import get_logger
    get_logger("ewt.io.par").warning(
        "unknown .par key %r at %s:%d — stored raw, not interpreted "
        "(warned once per key)", key, path, lineno)

@dataclass
class Jump:
    """A phase/time jump applied to TOAs matching ``-flag flagval``.

    For the PPTA convention ``JUMP -<systemflag> 1 <value> <fit>`` the flag
    itself names the system and the flagval is the literal ``"1"``; both forms
    are stored uniformly as (flag, flagval).
    """
    flag: str
    flagval: str
    value: float
    fit: bool


@dataclass
class ParFile:
    """Parsed .par contents: typed timing parameters + raw key/value map."""

    name: str = ""
    raj: float = 0.0           # right ascension, radians
    decj: float = 0.0          # declination, radians
    f0: float = 1.0            # spin frequency, Hz
    f1: float = 0.0            # spin frequency derivative, s^-2
    f2: float = 0.0
    dm: float = 0.0            # dispersion measure, pc cm^-3
    dm1: float = 0.0
    dm2: float = 0.0
    pmra: float = 0.0          # proper motion in RA*cos(dec), mas/yr
    pmdec: float = 0.0         # proper motion in DEC, mas/yr
    px: float = 0.0            # parallax, mas
    pepoch: float = 0.0        # MJD
    posepoch: float = 0.0      # MJD
    dmepoch: float = 0.0       # MJD
    tzrmjd: float = 0.0
    tzrfrq: float = 0.0
    tzrsite: str = ""
    units: str = "TCB"
    ephem: str = ""
    clk: str = ""
    jumps: list = field(default_factory=list)       # list[Jump]
    fit_flags: dict = field(default_factory=dict)   # KEY -> bool (fit requested)
    raw: dict = field(default_factory=dict)         # KEY -> raw string value
    tn_comments: dict = field(default_factory=dict) # '#TN...' provenance values

    @property
    def pos(self):
        """Unit vector to the pulsar in equatorial coordinates."""
        cd = math.cos(self.decj)
        return (
            cd * math.cos(self.raj),
            cd * math.sin(self.raj),
            math.sin(self.decj),
        )

    def fitted(self, key: str) -> bool:
        return self.fit_flags.get(key, False)


def _parse_hms(text: str) -> float:
    """'hh:mm:ss.sss' right ascension -> radians."""
    parts = text.split(":")
    h = float(parts[0])
    m = float(parts[1]) if len(parts) > 1 else 0.0
    s = float(parts[2]) if len(parts) > 2 else 0.0
    hours = h + m / 60.0 + s / 3600.0
    return hours * (math.pi / 12.0)


def _parse_dms(text: str) -> float:
    """'[-]dd:mm:ss.sss' declination -> radians."""
    neg = text.lstrip().startswith("-")
    parts = text.lstrip("+-").split(":")
    d = float(parts[0])
    m = float(parts[1]) if len(parts) > 1 else 0.0
    s = float(parts[2]) if len(parts) > 2 else 0.0
    deg = d + m / 60.0 + s / 3600.0
    return (-deg if neg else deg) * const.DEG2RAD


def parse_par(path: str) -> ParFile:
    """Parse a tempo2 .par file into a :class:`ParFile`.

    Validated against the two shipped reference fixtures
    (``examples/data/J1832-0836.par``, ``examples/data/fake_psr_0.par``).

    Malformed or truncated lines raise a typed :class:`ParseError`
    carrying ``path:lineno`` provenance (never a bare ``ValueError``
    from float conversion at arbitrary depth); unknown-but-well-formed
    keys are stored raw and warned about once per key.
    """
    pf = ParFile()
    with open(path) as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                # PPTA par files stash temponest noise estimates in comments
                toks = line.lstrip("#").split()
                if toks and toks[0].startswith("TN"):
                    if toks[0] in ("TNEF", "TNEQ") and len(toks) >= 4:
                        try:
                            pf.tn_comments[f"{toks[0]}:{toks[2]}"] = \
                                float(toks[3])
                        except ValueError as exc:
                            raise ParseError(
                                path, lineno, line,
                                f"non-numeric {toks[0]} comment value "
                                f"{toks[3]!r}") from exc
                    elif len(toks) >= 2:
                        try:
                            pf.tn_comments[toks[0]] = float(toks[1])
                        except ValueError:
                            pf.tn_comments[toks[0]] = toks[1]
                continue
            toks = line.split()
            key = toks[0].upper()
            if key == "JUMP":
                if len(toks) < 4:
                    raise ParseError(
                        path, lineno, line,
                        "truncated JUMP line (need "
                        "JUMP <-flag> <flagval> <value> [fit])")
                flag = toks[1].lstrip("-")
                flagval = toks[2]
                try:
                    value = float(toks[3])
                except ValueError as exc:
                    raise ParseError(
                        path, lineno, line,
                        f"non-numeric JUMP value {toks[3]!r}") from exc
                fit = len(toks) >= 5 and toks[4] == "1"
                pf.jumps.append(Jump(flag, flagval, value, fit))
                continue
            if len(toks) < 2:
                raise ParseError(path, lineno, line,
                                 f"key {key!r} carries no value "
                                 "(truncated line)")
            val = toks[1]
            pf.raw[key] = val
            fit = len(toks) >= 3 and toks[2] == "1"
            pf.fit_flags[key] = fit
            try:
                if key == "PSRJ" or key == "PSR":
                    pf.name = val
                elif key == "RAJ":
                    pf.raj = _parse_hms(val)
                elif key == "DECJ":
                    pf.decj = _parse_dms(val)
                elif key in _FLOAT_KEYS:
                    attr = key.lower()
                    if hasattr(pf, attr):
                        setattr(pf, attr, float(val))
                elif key == "TZRSITE":
                    pf.tzrsite = val
                elif key == "UNITS":
                    pf.units = val
                elif key == "EPHEM":
                    pf.ephem = val
                elif key == "CLK":
                    pf.clk = val
                elif key not in _KNOWN_KEYS:
                    _warn_unknown_key(key, path, lineno)
            except (ValueError, IndexError) as exc:
                raise ParseError(
                    path, lineno, line,
                    f"malformed value {val!r} for key {key!r}: "
                    f"{exc}") from exc
    if pf.posepoch == 0.0:
        pf.posepoch = pf.pepoch
    if pf.dmepoch == 0.0:
        pf.dmepoch = pf.pepoch
    return pf
