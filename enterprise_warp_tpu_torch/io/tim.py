"""tempo2 .tim (TOA) file parser.

Replaces the TOA-ingestion capability the reference gets from
tempo2/libstempo. Handles the tempo2 ``FORMAT 1`` grammar used by the shipped
fixtures (``examples/data/*.tim``): one TOA per line,

    <archive-name> <freq MHz> <MJD> <uncertainty us> <site> [-flag value]...

plus ``FORMAT``/``MODE`` headers, ``INCLUDE`` directives, and ``C``/``#``
comment lines, with two engines: the native C++ core (``native.py``) by
default, and this module's Python engine as its fallback and oracle.

Precision note: a TOA written with 17 fractional MJD digits
carries more precision than one float64 (86400 s x 1e-16 rounds to ~0.5 us at
MJD ~5e4). TOAs are therefore stored two-part — integer MJD plus float64
seconds-within-day — and only differenced against a reference epoch when the
float64 second-scale arrays for the likelihood are built (ns-level accuracy,
far below the ~1 us TOA uncertainties).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

from .errors import ParseError

# non-TOA directive heads tempo2 .tim files may carry besides
# FORMAT/MODE/INCLUDE (skipped with a once-per-head warning rather
# than misread as a truncated TOA line)
_DIRECTIVE_HEADS = {"EFAC", "EQUAD", "EMAX", "EMIN", "EFLOOR", "TIME",
                    "SKIP", "NOSKIP", "END", "TRACK", "PHASE", "JUMP",
                    "SIGMA", "FMIN", "FMAX"}
_WARNED_HEADS: set = set()
# after a newline, a line the walk skips before reading tokens: blank, a
# '#', 'C ' or 'CN ' comment, a FORMAT or MODE header (case-folded only
# where str.upper() agrees, so no line the walk reads is taken for one);
# and a line that may be an INCLUDE. Each begins with the newline, so the
# search jumps from line to line
_SKIPPED_LINE = re.compile(
    r"\n[^\S\n]*(?:(?=\n)|\Z|#|CN? [^\n]*\S|(?i:format|mode)(?=\s|\Z))")
_INCLUDE_LINE = re.compile(r"\n[^\S\n]*(?i:include)(?=\s|\Z)")


def _is_flag(tok: str) -> bool:
    """A '-x' token introduces a flag unless it parses as a number."""
    if not tok.startswith("-") or len(tok) < 2:
        return False
    nxt = tok[1]
    return not (nxt.isdigit() or nxt == ".")


@dataclass
class TimFile:
    """Parsed .tim contents (arrays aligned on the TOA axis)."""

    names: np.ndarray = None        # archive name per TOA (str)
    freqs: np.ndarray = None        # radio frequency, MHz (f64)
    mjd_int: np.ndarray = None      # integer MJD (i64)
    sec: np.ndarray = None          # seconds within day (f64)
    errs: np.ndarray = None         # TOA uncertainty, microseconds (f64)
    sites: np.ndarray = None        # observatory code per TOA (str)
    flags: dict = field(default_factory=dict)  # flag -> np.ndarray[str] ('' = absent)

    def __len__(self):
        return len(self.freqs)

    @property
    def mjd(self) -> np.ndarray:
        """Approximate single-float MJD (display/plotting only)."""
        return self.mjd_int + self.sec / 86400.0


def _split_mjd(text: str):
    """Split an MJD string into (int day, float seconds-of-day) losslessly.

    Non-finite values (a corrupted file's ``nan``/``inf`` TOA) parse to
    ``(0, non-finite seconds)`` instead of raising — they must REACH
    the ingestion audit (``resilience/integrity.py``), which can then
    quarantine the pulsar or drop the row under a repair policy; a
    parser hard-fail here would make the row unrepairable."""
    try:
        if "." in text:
            ip, fp = text.split(".", 1)
            return int(ip), float("0." + fp) * 86400.0
        return int(text), 0.0
    except ValueError:
        v = float(text)           # ParseError provenance added by caller
        if not np.isfinite(v):
            return 0, v
        return int(v), (v - int(v)) * 86400.0


def _looks_like_toa(toks):
    """A short line "looks like" a truncated TOA when any field past
    the head parses as a number; an all-word line is a directive."""
    for t in toks[1:]:
        try:
            float(t)
            return True
        except ValueError:
            continue
    return False


def _check_toa_line(toks, p, lineno, s):
    """Grammar check for one non-directive .tim line: returns True for
    a valid TOA row, False for a skippable directive (known heads, or
    unknown word-only lines — warned once per head, never fatal:
    production datasets carry site-local annotations), raises a typed
    :class:`ParseError` for truncated/malformed TOA rows."""
    head = toks[0].upper()
    if len(toks) < 5:
        if head not in _DIRECTIVE_HEADS and _looks_like_toa(toks):
            raise ParseError(
                p, lineno, s,
                f"truncated TOA line ({len(toks)} token(s), need "
                "<name> <freq> <MJD> <err> <site>)")
        if head not in _WARNED_HEADS:
            _WARNED_HEADS.add(head)
            from ..utils.logging import get_logger
            get_logger("ewt.io.tim").warning(
                "uninterpreted .tim directive %r at %s:%d "
                "(warned once per directive)", head, p, lineno)
        return False
    try:
        float(toks[1])
        _split_mjd(toks[2])
        float(toks[3])
    except (ValueError, IndexError) as exc:
        raise ParseError(p, lineno, s,
                         f"malformed TOA fields: {exc}") from exc
    return True


def _walk_tim(path, depth=0):
    """The .tim line walk (comment skip, ``FORMAT``/``MODE``,
    ``INCLUDE`` recursion, depth-16 cycle guard): yields
    ``(path, lineno, toks, stripped_line)`` for every candidate
    TOA/directive line."""
    if depth > 16:
        raise ValueError(
            f"INCLUDE nesting deeper than 16 at {path} "
            "(cyclic include?)")
    base = os.path.dirname(path)
    with open(path) as fh:
        for lineno, line in enumerate(fh, start=1):
            s = line.strip()
            if not s or s.startswith(("#", "C ", "CN ")):
                continue
            toks = s.split()
            head = toks[0].upper()
            if head in ("FORMAT", "MODE"):
                continue
            if head == "INCLUDE" and len(toks) >= 2:
                inc = toks[1]
                if not os.path.isabs(inc):
                    inc = os.path.join(base, inc)
                yield from _walk_tim(inc, depth + 1)
                continue
            yield path, lineno, toks, s


def _validate_grammar(path):
    """The typed-ParseError grammar check, without building arrays, over a
    file the native core parsed (its reader skips lines it cannot read)."""
    for p, lineno, toks, s in _walk_tim(path):
        _check_toa_line(toks, p, lineno, s)


def _walk_matches_native(path, n_native):
    """:func:`_grammar_matches_native` through the line walk, INCLUDEs
    followed."""
    n = 0
    for _, _, toks, _ in _walk_tim(path):
        if len(toks) < 5:
            return False
        n += 1
    return n == n_native


def _grammar_matches_native(path, n_native):
    """Cheap gate after a native parse: every candidate line TOA-shaped
    (>= 5 tokens) and as many as the rows the core returned means it
    skipped nothing, and the per-field typed walk is not needed. A short
    line or a count mismatch returns False.

    The core reads only candidate lines of five or more tokens, so its
    rows equal the candidate lines exactly when none was short: the lines
    of the file less those the walk skips (two regular-expression passes)
    are counted against them. A file that may hold an ``INCLUDE`` takes
    the walk, which follows it."""
    with open(path) as fh:
        text = "\n" + fh.read()
    if _INCLUDE_LINE.search(text):
        return _walk_matches_native(path, n_native)
    return text.count("\n") - len(_SKIPPED_LINE.findall(text)) == n_native


def parse_tim(path: str, engine: str = "auto") -> TimFile:
    """Parse a tempo2 FORMAT-1 .tim file (recursing into INCLUDEs).

    ``engine``: 'auto' takes the native C++ core (``native.py``, built on
    first use) and falls back to this module's Python engine, which stays
    the behavioural oracle; 'python' forces the Python engine. A native
    parse error re-parses through the Python engine, so the caller gets
    its typed ``ParseError`` with file:line provenance.
    """
    if engine not in ("auto", "python"):
        raise ValueError(f"unknown engine {engine!r}: use 'auto' "
                         "(native with Python fallback) or 'python'")
    if engine == "auto":
        from ..native import parse_tim_native
        try:
            parsed = parse_tim_native(path)
        except ValueError:
            parsed = None
        if parsed is not None:
            if not _grammar_matches_native(path, len(parsed[0])):
                _validate_grammar(path)
            freqs, mjd_i, sec, errs, names, sites, flags = parsed
            tf = TimFile(
                names=np.array(names, dtype=object),
                freqs=freqs, mjd_int=mjd_i, sec=sec, errs=errs,
                sites=np.array(sites, dtype=object))
            tf.flags.update(flags)
            return tf

    names, freqs, mjd_i, secs, errs, sites = [], [], [], [], [], []
    flag_rows: list[dict] = []

    for p, lineno, toks, s in _walk_tim(path):
        if not _check_toa_line(toks, p, lineno, s):
            continue              # skippable directive
        names.append(toks[0])
        freqs.append(float(toks[1]))
        di, sec = _split_mjd(toks[2])
        mjd_i.append(di)
        secs.append(sec)
        errs.append(float(toks[3]))
        sites.append(toks[4])
        row = {}
        i = 5
        while i < len(toks):
            if _is_flag(toks[i]):
                flag = toks[i][1:]
                if i + 1 < len(toks) and not _is_flag(toks[i + 1]):
                    row[flag] = toks[i + 1]
                    i += 2
                else:
                    row[flag] = "1"
                    i += 1
            else:
                i += 1
        flag_rows.append(row)

    tf = TimFile(
        names=np.array(names, dtype=object),
        freqs=np.array(freqs, dtype=np.float64),
        mjd_int=np.array(mjd_i, dtype=np.int64),
        sec=np.array(secs, dtype=np.float64),
        errs=np.array(errs, dtype=np.float64),
        sites=np.array(sites, dtype=object),
    )
    all_flags = sorted({k for row in flag_rows for k in row})
    for k in all_flags:
        tf.flags[k] = np.array([row.get(k, "") for row in flag_rows],
                               dtype=object)
    return tf
