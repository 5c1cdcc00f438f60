"""Pulsar container: the frozen per-pulsar dataset the likelihood consumes.

Equivalent in role to Enterprise's ``Pulsar`` object as used by the reference
(``enterprise_warp/enterprise_warp.py:382,409`` and the
selection machinery in ``enterprise_models.py:576-663``), but designed as a
plain immutable container of numpy arrays that is *lowered* into static torch
arrays by the model-construction layer. The reference's runtime
selection-function factory (``enterprise_models.py:576-642``) is replaced by
precomputed boolean masks derived from TOA flags.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field

import numpy as np

from .. import constants as const
from . import timing
from .par import ParFile, parse_par
from .tim import TimFile, parse_tim


@dataclass
class Pulsar:
    """Frozen per-pulsar dataset.

    ``toas`` are float64 seconds on the MJD scale (matching Enterprise's
    convention so Tspan arithmetic is directly comparable); ``toas_rel`` are
    higher-precision seconds relative to PEPOCH used to build bases.
    """

    name: str
    toas: np.ndarray            # (ntoa,) s, = MJD * 86400
    toas_rel: np.ndarray        # (ntoa,) s since PEPOCH (two-part precision)
    residuals: np.ndarray       # (ntoa,) s
    toaerrs: np.ndarray         # (ntoa,) s
    freqs: np.ndarray           # (ntoa,) MHz
    pos: np.ndarray             # (3,) unit vector
    Mmat: np.ndarray            # (ntoa, ntm) design matrix
    Mmat_labels: list
    flags: dict                 # flag name -> np.ndarray[str]
    backend_flags: np.ndarray   # (ntoa,) str
    raj: float = 0.0
    decj: float = 0.0
    phase_connected: bool = True
    # system/band-noise support (reference: psr.sys_flags/sys_flagvals)
    sys_flags: list = field(default_factory=list)
    sys_flagvals: list = field(default_factory=list)
    par: ParFile = None
    # ingestion-audit verdict (resilience/integrity.py): attached by
    # load_pulsar; None for archives/simulated pulsars that never
    # passed through the gate
    dq_report: object = None

    def __len__(self):
        return len(self.toas)

    @property
    def Tspan(self) -> float:
        return float(self.toas.max() - self.toas.min())

    def flagvals(self, flag: str):
        """The sorted distinct non-empty values of ``-flag``."""
        vals = self.flags.get(flag)
        if vals is None:
            return []
        return sorted({str(v) for v in vals if str(v)})

    def flag_mask(self, flag: str, value: str) -> np.ndarray:
        """Boolean TOA mask for ``-flag value`` (the selection primitive)."""
        vals = self.flags.get(flag)
        if vals is None:
            return np.zeros(len(self), dtype=bool)
        return np.asarray([v == value for v in vals], dtype=bool)

    def backend_masks(self, flag: str | None = None) -> dict:
        """Dict of backend name -> TOA mask.

        With ``flag=None`` uses the precomputed ``backend_flags`` ('f' flag
        convention, Enterprise's ``by_backend``); otherwise selects on the
        named flag ('group', 'B', 'sys', ... — the conventions enumerated at
        ``enterprise_warp/libstempo_warp.py:60-75``).
        """
        if flag is None:
            vals = self.backend_flags
        else:
            vals = self.flags.get(flag)
            if vals is None:
                raise KeyError(f"pulsar {self.name} has no '-{flag}' flag")
        out = {}
        for v in sorted({str(x) for x in vals}):
            out[v] = np.asarray([str(x) == v for x in vals], dtype=bool)
        return out

    # ---- archive round-trip (replaces the reference's pulsar pickles,
    # ---- enterprise_warp.py:350-360) ------------------------------------
    def save_npz(self, path: str):
        np.savez_compressed(
            path,
            name=self.name, toas=self.toas, toas_rel=self.toas_rel,
            residuals=self.residuals, toaerrs=self.toaerrs, freqs=self.freqs,
            pos=self.pos, Mmat=self.Mmat,
            Mmat_labels=np.array(self.Mmat_labels, dtype=object),
            backend_flags=self.backend_flags.astype(str),
            raj=self.raj, decj=self.decj,
            phase_connected=self.phase_connected,
            flag_names=np.array(sorted(self.flags), dtype=object),
            **{f"flag_{k}": v.astype(str) for k, v in self.flags.items()},
        )

    @classmethod
    def load_npz(cls, path: str) -> "Pulsar":
        z = np.load(path, allow_pickle=True)
        flags = {str(k): z[f"flag_{k}"].astype(object)
                 for k in z["flag_names"]}
        return cls(
            name=str(z["name"]), toas=z["toas"], toas_rel=z["toas_rel"],
            residuals=z["residuals"], toaerrs=z["toaerrs"], freqs=z["freqs"],
            pos=z["pos"], Mmat=z["Mmat"],
            Mmat_labels=list(z["Mmat_labels"]),
            flags=flags, backend_flags=z["backend_flags"].astype(object),
            raj=float(z["raj"]), decj=float(z["decj"]),
            phase_connected=bool(z["phase_connected"]),
        )


def _backend_flag_values(tim: TimFile) -> np.ndarray:
    """Backend label per TOA for the ``by_backend`` selection.

    Preference order: '-group' (the PPTA per-system convention the
    reference's shipped noisefiles use), then '-f', '-be', '-sys', else the
    observatory code. The flag conventions enumerated at
    ``enterprise_warp/libstempo_warp.py:60-75``.
    """
    for flag in ("group", "f", "be", "sys", "g"):
        vals = tim.flags.get(flag)
        if vals is not None and all(str(v) for v in vals):
            return vals
    return tim.sites


def load_pulsar(parfile: str, timfile: str, repair: str = "none",
                audit: bool = True) -> Pulsar:
    """Build a :class:`Pulsar` from a .par/.tim pair.

    For real observatory data under the approximate ephemeris, residuals
    cannot be phase-connected; they are then set to zero with
    ``phase_connected=False`` and callers may inject simulated residuals
    (``enterprise_warp_tpu.sim``) to obtain an analysis-grade dataset.

    **Ingestion gate** (numerical-integrity plane,
    ``resilience/integrity.py``): the parsed TOAs pass a typed
    data-quality audit before anything is built. Hard findings
    (non-finite TOAs/uncertainties, zero/negative/absurd
    uncertainties, malformed files) raise a typed
    :class:`~..resilience.integrity.DataQuarantine` under the default
    ``repair="none"`` policy; ``repair="drop"`` drops the offending
    rows with provenance instead. Soft findings (out-of-order or
    duplicate epochs, empty backend labels) are recorded as
    ``data_quality`` events either way. The audit verdict rides the
    returned pulsar as ``psr.dq_report`` and is folded into the build/
    topology fingerprints, so a repaired dataset keys fresh compiled
    executables. ``audit=False`` bypasses the gate (trusted archives).
    """
    from ..resilience import integrity

    par = parse_par(parfile)
    tim = parse_tim(timfile)

    report = None
    if audit:
        tim, report = integrity.audit_tim(
            tim, psr_name=par.name or os.path.basename(parfile),
            source=os.path.basename(timfile), repair=repair)
        integrity.emit_report(report)
        if report.verdict == "quarantine":
            raise integrity.DataQuarantine(report)

    delay, obs_pos, is_bary = timing.compute_delays(par, tim)
    res, ok = timing.phase_residuals(par, tim, delay)
    if not ok:
        res = np.zeros(len(tim))
    M, labels = timing.design_matrix(par, tim, obs_pos_au=obs_pos)

    return Pulsar(
        name=par.name or os.path.basename(parfile).split(".")[0],
        toas=tim.mjd_int * const.day + tim.sec,
        toas_rel=(tim.mjd_int - par.pepoch) * const.day + tim.sec,
        residuals=res,
        toaerrs=tim.errs * 1e-6,
        freqs=tim.freqs,
        pos=np.asarray(par.pos, dtype=np.float64),
        Mmat=M,
        Mmat_labels=labels,
        flags=tim.flags,
        backend_flags=_backend_flag_values(tim),
        raj=par.raj,
        decj=par.decj,
        phase_connected=ok,
        par=par,
        dq_report=report,
    )


def load_pulsars_from_dir(datadir: str, psrlist=None,
                          repair: str = "none",
                          on_quarantine: str = "raise",
                          quarantined=None) -> list:
    """Load all .par/.tim pairs in a directory (sorted), as the reference
    does at ``enterprise_warp.py:350-373``; ``psrlist`` filters by name.

    ``on_quarantine`` — graceful array degradation: ``"raise"``
    (default) propagates the first typed
    :class:`~..resilience.integrity.DataQuarantine`; ``"skip"`` drops
    the quarantined pulsar ALONE (typed ``psr_quarantined`` event +
    counter) and keeps loading the survivors. Pass a list as
    ``quarantined`` to collect ``(name, report_dict)`` pairs for the
    caller's honesty field (``quarantined_pulsars`` in final results).
    """
    from ..resilience import integrity

    if on_quarantine not in ("raise", "skip"):
        raise ValueError(
            f"unknown on_quarantine policy {on_quarantine!r} "
            "(one of 'raise', 'skip')")
    pars = sorted(glob.glob(os.path.join(datadir, "*.par")))
    tims = sorted(glob.glob(os.path.join(datadir, "*.tim")))
    if len(pars) != len(tims):
        raise ValueError(
            f"unequal .par ({len(pars)}) and .tim ({len(tims)}) counts in "
            f"{datadir}")

    def stem(path):
        return os.path.splitext(os.path.basename(path))[0]

    mismatched = [(p, t) for p, t in zip(pars, tims) if stem(p) != stem(t)]
    if mismatched:
        raise ValueError(
            f".par/.tim basenames do not pair up in {datadir}: "
            + ", ".join(f"{os.path.basename(p)} vs {os.path.basename(t)}"
                        for p, t in mismatched[:5]))
    from .errors import ParseError
    out = []
    for p, t in zip(pars, tims):
        if psrlist is not None and stem(p) not in psrlist:
            # cheap pre-filter on the file stem; confirm on the parsed name
            # below only when the stem was not already a match
            if parse_par(p).name not in psrlist:
                continue
        try:
            out.append(load_pulsar(p, t, repair=repair))
        except integrity.DataQuarantine as q:
            if on_quarantine == "raise":
                raise
            integrity.emit_psr_quarantined(
                q.psr, cause="data_quarantine", where="ingestion",
                stats={"verdict": q.report.verdict,
                       "source": q.report.source})
            if quarantined is not None:
                quarantined.append((q.psr, q.report.to_dict()))
        except ParseError as exc:
            # malformed file: same gate, typed as a parse-level hard
            # finding so the array can degrade gracefully too
            rep = integrity.parse_error_report(
                stem(p), os.path.basename(t), exc)
            if on_quarantine == "raise":
                raise integrity.DataQuarantine(rep) from exc
            integrity.emit_psr_quarantined(
                rep.psr, cause=f"parse_error: {exc}", where="ingestion")
            if quarantined is not None:
                quarantined.append((rep.psr, rep.to_dict()))
    return out

