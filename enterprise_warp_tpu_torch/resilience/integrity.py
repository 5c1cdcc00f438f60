"""Ingestion audit: the data-quality quarantine gate of the
numerical-integrity plane (``io.pulsar.load_pulsar`` calls it).

:func:`audit_tim` runs a typed data-quality audit over a parsed ``.tim``
(non-finite TOAs/uncertainties, zero/negative/absurd uncertainties,
duplicate epochs, non-monotonic epochs, empty backend labels) and
produces a per-pulsar :class:`DataQualityReport`. Hard findings raise a
typed :class:`DataQuarantine` under the default ``repair="none"``
policy, or become drop-row repairs with provenance under
``repair="drop"``; soft findings are logged either way.

A copy of the audit subset of the reference package's
``resilience/integrity.py``; the kernel health words and escalation
ladder are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


__all__ = ["Finding", "DataQualityReport", "DataQuarantine",
           "audit_tim", "emit_report", "emit_psr_quarantined",
           "parse_error_report", "REPAIR_POLICIES", "EXIT_QUARANTINED"]

#: CLI exit status for a quarantined pulsar (data or kernel health):
#: distinct from EXIT_DEMOTED (75, "restart me") — 76 means "this
#: pulsar is out; do NOT retry it, continue with the survivors".
EXIT_QUARANTINED = 76

REPAIR_POLICIES = ("none", "drop")

#: uncertainty sanity ceiling, microseconds: a TOA claiming an error
#: beyond this is a unit mistake (seconds written as microseconds) or
#: corruption, not a measurement
ABSURD_ERR_US = 1.0e5


# ------------------------------------------------------------------ #
#  data-quality audit                                                 #
# ------------------------------------------------------------------ #

@dataclass
class Finding:
    """One audit finding. ``severity`` is ``"hard"`` (blocks the build
    unless repaired away) or ``"soft"`` (recorded, never blocking);
    ``rows`` holds a bounded sample of offending TOA indices."""

    code: str
    severity: str
    count: int
    detail: str
    rows: list = field(default_factory=list)
    repaired: bool = False

    def to_dict(self):
        return {"code": self.code, "severity": self.severity,
                "count": int(self.count), "detail": self.detail,
                "repaired": bool(self.repaired),
                "rows": [int(r) for r in self.rows[:16]]}


@dataclass
class DataQualityReport:
    """Per-pulsar ingestion-audit verdict + repair provenance."""

    psr: str
    source: str = ""
    findings: list = field(default_factory=list)   # list[Finding]
    repairs: list = field(default_factory=list)    # list[dict]
    ntoa_in: int = 0
    ntoa_kept: int = 0
    repair_policy: str = "none"

    @property
    def hard(self):
        return [f for f in self.findings if f.severity == "hard"]

    @property
    def soft(self):
        return [f for f in self.findings if f.severity == "soft"]

    @property
    def verdict(self) -> str:
        """``clean`` / ``soft`` / ``repaired`` / ``quarantine``: hard
        findings quarantine unless every one was repaired away (and a
        fully-dropped dataset is a quarantine, never a repair)."""
        if any(not f.repaired for f in self.hard) \
                or (self.hard and self.ntoa_kept == 0):
            return "quarantine"
        if self.repairs:
            return "repaired"
        return "soft" if self.findings else "clean"

    def token(self) -> str:
        """Short digest of the audit outcome for fingerprint folding
        (``models.build`` / ``topology_fingerprint``): a repaired
        dataset must key fresh executables, a clean one must not
        perturb existing keys."""
        if self.verdict == "clean":
            return "clean"
        import hashlib
        h = hashlib.sha256()
        for f in sorted(self.findings, key=lambda f: f.code):
            h.update(f"{f.code}:{f.severity}:{f.count};".encode())
        for r in self.repairs:
            h.update(f"r:{r.get('action')}:{r.get('code')}:"
                     f"{sorted(r.get('rows', []))};".encode())
        h.update(f"kept={self.ntoa_kept}/{self.ntoa_in};".encode())
        return f"{self.verdict}:{h.hexdigest()[:12]}"

    def to_dict(self):
        return {"psr": self.psr, "source": self.source,
                "verdict": self.verdict,
                "ntoa_in": int(self.ntoa_in),
                "ntoa_kept": int(self.ntoa_kept),
                "repair_policy": self.repair_policy,
                "findings": [f.to_dict() for f in self.findings],
                "repairs": self.repairs}


class DataQuarantine(RuntimeError):
    """A pulsar failed the ingestion audit hard and no repair policy
    claimed the damage: the dataset must not enter a build."""

    def __init__(self, report: DataQualityReport):
        self.report = report
        self.psr = report.psr
        hard = ", ".join(f"{f.code} x{f.count}" for f in report.hard)
        super().__init__(
            f"pulsar {report.psr!r} quarantined at ingestion "
            f"({hard}; source {report.source}); pass repair='drop' to "
            "drop the offending rows with provenance, or fix the data")


def audit_tim(tim, psr_name: str, source: str = "",
              repair: str = "none"):
    """Typed data-quality audit of a parsed :class:`~.io.tim.TimFile`.

    Returns ``(tim, report)`` — with ``repair="drop"``, a repaired
    TimFile (offending rows dropped, epochs sorted) and the repair
    provenance; with the default ``repair="none"`` the TimFile is
    returned untouched and hard findings are left for the caller to
    quarantine on. Never raises itself — the quarantine decision
    belongs to the ingestion gate (``io.pulsar.load_pulsar``)."""
    if repair not in REPAIR_POLICIES:
        raise ValueError(f"unknown repair policy {repair!r} "
                         f"(one of {REPAIR_POLICIES})")
    n = len(tim)
    rep = DataQualityReport(psr=psr_name, source=source, ntoa_in=n,
                            ntoa_kept=n, repair_policy=repair)

    mjd = np.asarray(tim.mjd_int, dtype=np.float64) \
        + np.asarray(tim.sec, dtype=np.float64) / 86400.0
    errs = np.asarray(tim.errs, dtype=np.float64)
    freqs = np.asarray(tim.freqs, dtype=np.float64)

    def _add(code, severity, mask_or_rows, detail):
        rows = (np.nonzero(mask_or_rows)[0]
                if (isinstance(mask_or_rows, np.ndarray)
                    and mask_or_rows.dtype == bool)
                else np.asarray(mask_or_rows, dtype=np.int64))
        if rows.size == 0:
            return None
        f = Finding(code=code, severity=severity, count=int(rows.size),
                    detail=detail, rows=list(rows[:16]))
        rep.findings.append(f)
        return rows

    drop = np.zeros(n, dtype=bool)

    bad_toa = ~np.isfinite(mjd)
    rows = _add("nonfinite_toa", "hard", bad_toa,
                "non-finite TOA epoch(s)")
    if rows is not None:
        drop |= bad_toa
    bad_freq = ~np.isfinite(freqs)
    rows = _add("nonfinite_freq", "hard", bad_freq,
                "non-finite radio frequency(ies)")
    if rows is not None:
        drop |= bad_freq
    bad_err = ~np.isfinite(errs)
    rows = _add("nonfinite_err", "hard", bad_err,
                "non-finite TOA uncertainty(ies)")
    if rows is not None:
        drop |= bad_err
    with np.errstate(invalid="ignore"):
        nonpos = np.isfinite(errs) & (errs <= 0.0)
        absurd = np.isfinite(errs) & (errs > ABSURD_ERR_US)
    rows = _add("nonpositive_err", "hard", nonpos,
                "zero/negative TOA uncertainty(ies) — whitening "
                "would divide by zero")
    if rows is not None:
        drop |= nonpos
    rows = _add("absurd_err", "hard", absurd,
                f"TOA uncertainty beyond {ABSURD_ERR_US:g} us "
                "(unit mistake or corruption)")
    if rows is not None:
        drop |= absurd

    # soft findings (computed over the rows that would survive a drop
    # repair, so a repaired file is re-judged on its surviving rows;
    # row indices are mapped back to ORIGINAL file coordinates — the
    # provenance must point at lines someone can fix)
    keep_idx = np.nonzero(~drop)[0]
    keep_mjd = mjd[~drop]
    if keep_mjd.size > 1:
        diffs = np.diff(keep_mjd)
        nonmono = keep_idx[np.nonzero(diffs < 0)[0] + 1]
        _add("nonmonotonic_toas", "soft", nonmono,
             "TOA epochs out of order (sorted under repair='drop'; "
             "bases are epoch-order-sensitive only through provenance)")
        dup = keep_idx[np.nonzero(diffs == 0)[0] + 1]
        _add("duplicate_epoch", "soft", dup,
             "duplicate TOA epoch(s) (legal for simultaneous "
             "multi-band observations; recorded for provenance)")
    empty_backend = np.asarray(
        [not str(s) for s in np.asarray(tim.sites, dtype=object)],
        dtype=bool)
    for flag in ("group", "f", "be", "sys", "g"):
        vals = tim.flags.get(flag)
        if vals is not None:
            empty_backend = np.asarray(
                [not str(v) for v in vals], dtype=bool)
            break
    _add("empty_backend", "soft", empty_backend,
         "TOA(s) with an empty backend label — backend selections "
         "will fall through to the observatory code")

    if repair == "drop":
        if drop.any():
            # drop-row repair with provenance
            dropped_codes = sorted(f.code for f in rep.hard)
            tim = _drop_rows(tim, drop)
            rep.ntoa_kept = len(tim)
            rep.repairs.append({
                "action": "drop_rows",
                "code": ",".join(dropped_codes),
                "rows": [int(r) for r in np.nonzero(drop)[0]],
                "dropped": int(drop.sum())})
            for f in rep.hard:
                if rep.ntoa_kept > 0:
                    f.repaired = True
        # sort repair for out-of-order epochs (post-drop view)
        mjd2 = np.asarray(tim.mjd_int, dtype=np.float64) \
            + np.asarray(tim.sec, dtype=np.float64) / 86400.0
        if mjd2.size > 1 and np.any(np.diff(mjd2) < 0):
            order = np.argsort(mjd2, kind="stable")
            tim = _reorder(tim, order)
            rep.repairs.append({"action": "sort_epochs",
                                "code": "nonmonotonic_toas",
                                "rows": [], "dropped": 0})
            for f in rep.findings:
                if f.code == "nonmonotonic_toas":
                    f.repaired = True
    return tim, rep


def _reorder(tim, order):
    from ..io.tim import TimFile
    out = TimFile(
        names=np.asarray(tim.names, dtype=object)[order],
        freqs=np.asarray(tim.freqs)[order],
        mjd_int=np.asarray(tim.mjd_int)[order],
        sec=np.asarray(tim.sec)[order],
        errs=np.asarray(tim.errs)[order],
        sites=np.asarray(tim.sites, dtype=object)[order])
    for k, v in tim.flags.items():
        out.flags[k] = np.asarray(v, dtype=object)[order]
    return out


def _drop_rows(tim, drop_mask):
    return _reorder(tim, np.nonzero(~np.asarray(drop_mask))[0])


def parse_error_report(psr: str, source: str, exc) -> DataQualityReport:
    """The quarantine-verdict report for a typed parse failure — the
    ONE record shape the directory loader and the paramfile array
    loop both fold into ``quarantined.json`` / quarantine events."""
    return DataQualityReport(
        psr=psr, source=source,
        findings=[Finding(code="parse_error", severity="hard",
                          count=1, detail=str(exc))])


def emit_report(rep: DataQualityReport):
    """One warning log line per audit finding (the reference package
    also emits counters and typed events; the port has no telemetry
    plane yet). A clean report logs nothing."""
    if not rep.findings:
        return
    from ..utils.logging import get_logger

    log = get_logger("ewt.integrity")
    for f in rep.findings:
        log.warning("data quality [%s] %s: %s x%d (%s)%s", rep.psr,
                    f.severity, f.code, f.count, f.detail,
                    " — repaired" if f.repaired else "")


def emit_psr_quarantined(psr: str, cause: str, where: str,
                         stats: dict | None = None):
    """Log one pulsar leaving the array, alone. ``where`` names the
    layer that pulled the trigger (``ingestion`` / ``campaign``)."""
    del stats
    from ..utils.logging import get_logger

    get_logger("ewt.integrity").error(
        "pulsar %s QUARANTINED at %s (%s) — survivors continue",
        psr, where, cause)
