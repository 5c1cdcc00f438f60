# ewt: allow-precision module — ORF matrices in float64: the angle
# cosines near 1 cancel in float32
"""Overlap reduction functions: cross-pulsar spatial correlation matrices.

Counterpart of ``enterprise_warp_tpu/parallel/orf.py`` (numpy, a copy):
the ORF options of the ``gwb`` term (Hellings-Downs, its zero-auto-term
variant ``hd_noauto``, dipole, monopole) as static (Npsr, Npsr) matrices
computed once from the pulsars' sky positions. The joint likelihood
(``parallel/pta.py``) couples pulsars through them per GW frequency.
"""

from __future__ import annotations

import numpy as np

# Small diagonal regularizer for rank-deficient ORFs: the monopole matrix is
# rank 1 and the dipole matrix rank 3, so with >3 pulsars their per-frequency
# phi blocks are singular without it.
_DIAG_JITTER = 1.0e-6


def _cos_angles(pos: np.ndarray) -> np.ndarray:
    """cos(angular separation) for all pulsar pairs. pos: (Npsr, 3) units."""
    c = pos @ pos.T
    return np.clip(c, -1.0, 1.0)


def hd_matrix(pos: np.ndarray, auto: bool = True) -> np.ndarray:
    """Hellings-Downs correlation matrix (float64: angle cosines near 1
    cancel in float32). ``auto=False`` is ``hd_noauto``: zero on the
    diagonal so only cross-correlations inform the fit."""
    c = _cos_angles(np.asarray(pos, dtype=np.float64))
    x = (1.0 - c) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        lnx = np.where(x > 0, np.log(np.where(x > 0, x, 1.0)), 0.0)
    orf = 1.5 * x * lnx - 0.25 * x + 0.5
    np.fill_diagonal(orf, 1.0 if auto else 0.0)
    return orf


def dipole_matrix(pos: np.ndarray) -> np.ndarray:
    orf = _cos_angles(np.asarray(pos, dtype=np.float64)).copy()
    np.fill_diagonal(orf, 1.0 + _DIAG_JITTER)
    return orf


def monopole_matrix(pos: np.ndarray) -> np.ndarray:
    n = len(pos)
    return np.ones((n, n)) + _DIAG_JITTER * np.eye(n)


def orf_matrix(name, pos) -> np.ndarray:
    """Dispatch by the CommonTerm.orf vocabulary."""
    if name == "hd":
        return hd_matrix(pos, auto=True)
    if name == "hd_noauto":
        return hd_matrix(pos, auto=False)
    if name == "dipole":
        return dipole_matrix(pos)
    if name == "monopole":
        return monopole_matrix(pos)
    raise ValueError(f"unknown ORF '{name}'")


def is_positive_definite(name: str) -> bool:
    """Whether the ORF matrix is safely Cholesky-able. ``hd_noauto`` is
    indefinite by construction (zero diagonal); the joint likelihood
    inverts its per-frequency blocks by a clamped eigendecomposition."""
    return name != "hd_noauto"


def is_low_rank(name: str) -> bool:
    """Whether the ORF matrix is rank-deficient up to the diagonal jitter
    (monopole: rank 1; dipole: rank 3). Their inverses span ~1/jitter =
    1e6 in scale, beyond a float32-preconditioned solve of the GW Schur
    system, so the joint likelihood factors that system in float64."""
    return name in ("monopole", "dipole")
