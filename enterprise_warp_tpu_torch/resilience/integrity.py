"""The numerical-integrity plane: the ingestion audit, the kernel health
word and the per-pulsar escalation ladder.

Counterpart of ``enterprise_warp_tpu/resilience/integrity.py``:

- **ingestion gate** — :func:`audit_tim` runs a typed data-quality audit
  over a parsed ``.tim`` (non-finite TOAs/uncertainties, zero/negative/
  absurd uncertainties, duplicate epochs, non-monotonic epochs, empty
  backend labels) and produces a per-pulsar :class:`DataQualityReport`;
  ``io.pulsar.load_pulsar`` calls it. Hard findings raise
  :class:`DataQuarantine` under the default ``repair="none"`` policy, or
  become drop-row repairs with provenance under ``repair="drop"``; every
  finding becomes a ``data_quality`` event and a warning. Fault site
  ``data.audit`` (kind ``nonfinite``) plants a hard finding.
- **health words** — the mixed solve chain (``ops/kernel.py``) returns,
  with ``with_health=True``, a float64 ``(3,)`` word per walker:
  ``[HW_JITTER]`` a jittered or identity factor was substituted,
  ``[HW_DIVERGE]`` refinement diverged and the preconditioner solution
  was kept, ``[HW_LOGCOND]`` log10 of the equilibration diagonal's
  dynamic range. Words join by :func:`health_join` (elementwise max).
- **escalation ladder** — :class:`HealthLedger` folds each block's
  health counts (accumulated on the device inside the PT block and read
  in the block's snapshot) into a monotone ladder (:data:`LADDER`):
  ``observe`` (a ``kernel_health`` event) -> ``reeval`` (a float64
  re-evaluation of committed walkers) -> ``classic`` (the classic chain
  with its preconditioner kernel for every evaluation,
  ``EWT_PALLAS_MEGA=0``; the reference's ``EWT_PALLAS=0`` would put a
  card run on plain versions) -> ``quarantine``
  (:class:`PulsarQuarantine`: the pulsar leaves the array alone). Healthy
  blocks walk it back down. Fault sites ``kernel.health`` and
  ``psr.quarantine`` drive the rungs.

  Across processes: the sharded joint likelihood's health twin
  (``parallel/pta.py``) returns the same ``(npsr, 3)`` words as the
  unsharded one, summed into place on the evaluation's one collective,
  so every rank folds the same words into its ledgers and takes the same
  ladder decision (a demotion on one rank alone would leave the others
  waiting in the next collective).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

# the health word's layout is the solve chain's
from ..ops.kernel import HW_DIVERGE, HW_JITTER, HW_LOGCOND
from ..ops.kernel import HW_WIDTH as HEALTH_WIDTH


__all__ = ["Finding", "DataQualityReport", "DataQuarantine",
           "PulsarQuarantine", "audit_tim", "emit_report",
           "emit_psr_quarantined", "parse_error_report", "REPAIR_POLICIES",
           "EXIT_QUARANTINED", "HW_JITTER", "HW_DIVERGE", "HW_LOGCOND",
           "HEALTH_WIDTH", "health_zero", "health_join", "LADDER",
           "HealthLedger"]

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

    # fault site data.audit: a planted hard finding
    from . import faults
    spec = faults.fire("data.audit", psr=str(psr_name), source=str(source))
    if spec is not None and spec.kind == "nonfinite":
        rep.findings.append(Finding(
            code="injected_audit_fault", severity="hard", count=1,
            detail="fault plan planted a hard audit failure at site "
                   "data.audit"))

    if repair == "drop":
        if drop.any():
            # drop-row repair with provenance; an injected audit fault is
            # not row-addressable and stays unrepaired (quarantine)
            dropped_codes = sorted(f.code for f in rep.hard
                                   if f.code != "injected_audit_fault")
            tim = _drop_rows(tim, drop)
            rep.ntoa_kept = len(tim)
            rep.repairs.append({
                "action": "drop_rows",
                "code": ",".join(dropped_codes),
                "rows": [int(r) for r in np.nonzero(drop)[0]],
                "dropped": int(drop.sum())})
            for f in rep.hard:
                if rep.ntoa_kept > 0 and f.code != "injected_audit_fault":
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
    """Telemetry for one audit report: ``data_quality{code=}`` counters, a
    ``data_quality`` event per finding (inside a run scope) and a warning
    per finding. A clean report emits nothing."""
    if not rep.findings:
        return
    from ..utils import telemetry
    from ..utils.logging import get_logger
    log = get_logger("ewt.integrity")
    reg = telemetry.registry()
    rec = telemetry.active_recorder()
    for f in rep.findings:
        reg.counter("data_quality", code=f.code).inc(f.count)
        log.warning("data quality [%s] %s: %s x%d (%s)%s", rep.psr,
                    f.severity, f.code, f.count, f.detail,
                    " — repaired" if f.repaired else "")
        if rec is not None:
            rec.event("data_quality", psr=rep.psr, code=f.code,
                      severity=f.severity, count=int(f.count),
                      repaired=bool(f.repaired), source=rep.source,
                      detail=f.detail)
    if rec is not None and rep.repairs:
        rec.flush()


def emit_psr_quarantined(psr: str, cause: str, where: str,
                         stats: dict | None = None):
    """The ``psr_quarantined`` event, counter and flight-recorder record:
    one pulsar leaving the array, alone. ``where`` names the layer that
    pulled the trigger (``ingestion`` / ``sampler`` / ``campaign``)."""
    from ..utils import telemetry
    from ..utils.flightrec import flight_recorder
    from ..utils.logging import get_logger
    telemetry.registry().counter("psr_quarantined", where=where).inc()
    flight_recorder().record("psr_quarantined", psr=psr, cause=cause,
                             where=where)
    get_logger("ewt.integrity").error(
        "pulsar %s QUARANTINED at %s (%s) — survivors continue",
        psr, where, cause)
    rec = telemetry.active_recorder()
    if rec is not None:
        clean = {k: v for k, v in (stats or {}).items()
                 if isinstance(v, (str, int, float, bool))
                 and k not in ("psr", "cause", "where")}
        rec.event("psr_quarantined", psr=psr, cause=cause, where=where,
                  **clean)
        rec.flush()


class PulsarQuarantine(RuntimeError):
    """The health ladder's terminal rung: this pulsar's likelihood is
    numerically untrustworthy and it leaves the array alone."""

    def __init__(self, psr: str, cause: str, stats: dict | None = None):
        self.psr = psr
        self.cause = cause
        self.stats = dict(stats or {})
        super().__init__(
            f"pulsar {psr!r} quarantined ({cause}): kernel health ladder "
            f"exhausted — stats {self.stats}")


# ------------------------------------------------------------------ #
#  health words                                                       #
# ------------------------------------------------------------------ #

def health_zero(batch=(), device="cpu"):
    """A clean health word (float64 zeros of shape ``batch + (3,)``)."""
    import torch
    return torch.zeros(tuple(batch) + (HEALTH_WIDTH,), dtype=torch.float64,
                       device=device)


def health_join(a, b):
    """Join two health words: elementwise max (bits OR, the condition
    proxy takes the worst)."""
    import torch
    return torch.maximum(a, b)


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


#: the escalation rungs in order; strikes index into this ladder
LADDER = ("observe", "reeval", "classic", "quarantine")


class HealthLedger:
    """Host-side fold of one pulsar's block health counts and the
    escalation ladder (the reference's class).

    :meth:`update` takes a block's ``(n_evals, n_jitter, n_diverge,
    max_logcond)``, judges it against ``EWT_HEALTH_JITTER_FRAC`` (default
    0.25 of the block's evaluations engaging a jittered factor),
    ``EWT_HEALTH_LOGCOND_MAX`` (default 14.0) and any refinement
    divergence, walks the strike ladder (healthy blocks walk it down) and
    returns the action to take now: None or one of :data:`LADDER`. The
    ledger decides; the sampler acts."""

    def __init__(self, psr: str = "?", jitter_frac=None, logcond_max=None):
        self.psr = psr
        self.jitter_frac = (_env_float("EWT_HEALTH_JITTER_FRAC", 0.25)
                            if jitter_frac is None else float(jitter_frac))
        self.logcond_max = (_env_float("EWT_HEALTH_LOGCOND_MAX", 14.0)
                            if logcond_max is None else float(logcond_max))
        self.strikes = 0
        self.blocks = 0
        self.tripped_blocks = 0
        self.n_evals = 0
        self.n_jitter = 0
        self.n_diverge = 0
        self.max_logcond = 0.0
        self.reeval_verdicts: list = []

    def tripped(self, n_evals, n_jitter, n_diverge, max_logcond):
        if n_evals <= 0:
            return False
        return (n_jitter / n_evals >= self.jitter_frac
                or n_diverge > 0
                or max_logcond >= self.logcond_max)

    def update(self, n_evals, n_jitter, n_diverge, max_logcond):
        """Fold one block; returns the escalation action or None."""
        n_evals = int(n_evals)
        self.blocks += 1
        self.n_evals += n_evals
        self.n_jitter += int(n_jitter)
        self.n_diverge += int(n_diverge)
        self.max_logcond = max(self.max_logcond, float(max_logcond))
        if not self.tripped(n_evals, n_jitter, n_diverge, max_logcond):
            self.strikes = max(self.strikes - 1, 0)
            return None
        self.tripped_blocks += 1
        self.strikes += 1
        return LADDER[min(self.strikes, len(LADDER)) - 1]

    def note_reeval(self, agreed: bool, max_abs_diff: float):
        """Record the float64 re-evaluation verdict of the ``reeval``
        rung (the ladder keeps walking either way)."""
        self.reeval_verdicts.append({"agreed": bool(agreed),
                                     "max_abs_diff": float(max_abs_diff)})

    def stats(self):
        return {"psr": self.psr, "blocks": self.blocks,
                "tripped_blocks": self.tripped_blocks,
                "strikes": self.strikes, "n_evals": int(self.n_evals),
                "n_jitter": int(self.n_jitter),
                "n_diverge": int(self.n_diverge),
                "max_logcond": round(float(self.max_logcond), 3)}
