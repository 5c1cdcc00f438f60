"""Term specs: the declarative IR between model vocabulary and the kernel.

The reference's model methods return live Enterprise signal objects that are
summed and closed over mutable state
(``enterprise_warp/enterprise_models.py``). Here each method
emits one of these frozen specs; ``build.py`` lowers a spec list into static
arrays + pure parameter maps for the jit'd kernel. This separation is what
makes the whole model jit-compilable once and batchable.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .priors import Parameter


@dataclass
class WhiteTerm:
    """efac / equad / ecorr over a backend selection.

    ``masks`` maps selection value -> boolean TOA mask; ``params`` aligns
    with sorted mask keys. For ecorr the mask set is lowered to quantized
    epoch columns at build time.
    """
    kind: str                      # 'efac' | 'equad' | 'ecorr'
    masks: dict                    # selection value -> (ntoa,) bool
    params: list                   # [Parameter] aligned with sorted(masks)


@dataclass
class BasisTerm:
    """A rank-reduced GP term: static basis + parametrized PSD.

    ``psd`` in {'powerlaw', 'turnover', 'free_spectrum'}; ``params`` are the
    PSD hyper-parameters in canonical order (log10_A, gamma[, fc]) or the
    log10_rho vector for a free spectrum. ``row_scale`` statically scales
    rows (DM: (fref/nu)^2; fixed-index chromatic). ``dynamic_idx`` is the
    sampled chromatic index Parameter, applied in-kernel as
    ``exp(idx * log_nu_ratio)``. ``coeff_sigma2`` instead marks a
    fixed-prior deterministic-systematics basis (BayesEphem), whose
    coefficients are marginalized analytically with those prior variances.
    """
    name: str                      # signal name, e.g. 'red_noise', 'dm_gp'
    F: np.ndarray                  # (ntoa, ncol)
    freqs: np.ndarray = None       # (nmodes,) Hz
    df: np.ndarray = None          # (nmodes,)
    psd: str = "powerlaw"
    params: list = field(default_factory=list)
    row_scale: np.ndarray = None
    dynamic_idx: Parameter = None
    log_nu_ratio: np.ndarray = None
    coeff_sigma2: np.ndarray = None


@dataclass
class DeterministicTerm:
    """A parametrized deterministic delay ``D @ c`` with sampled
    coefficients (no marginalization): the sampled BayesEphem variant —
    the reference samples ``jup_orb_elements``/frame/mass parameters
    through the vector-prior expansion at ``bilby_warp.py:80-84``.
    ``D`` holds PHYSICAL (unnormalized) columns so the priors keep their
    physical meaning; rows are whitened at build time. The delay is
    subtracted from the residuals inside the kernel."""
    name: str
    D: np.ndarray                  # (ntoa, k) physical columns
    params: list                   # [Parameter] aligned with columns


@dataclass
class CommonTerm:
    """A spatially-correlated common signal (GWB / CPL).

    Single-pulsar builds treat it as a BasisTerm with shared parameter
    names; the joint PTA likelihood couples pulsars through ``orf``.
    ``orf`` in {None, 'hd', 'hd_noauto', 'dipole', 'monopole'} (None =
    common spectrum, no spatial correlation).
    """
    name: str
    nmodes: int
    psd: str
    params: list
    orf: str = None


class TermList(list):
    """Terms of one model for one pulsar, with the pulsar attached."""

    def __init__(self, psr=None, terms=()):
        super().__init__(terms)
        self.psr = psr

    def all_params(self):
        out = []
        seen = set()
        for t in self:
            plist = list(t.params)
            if isinstance(t, BasisTerm) and t.dynamic_idx is not None:
                plist.append(t.dynamic_idx)
            for p in plist:
                if p is not None and p.name not in seen:
                    seen.add(p.name)
                    out.append(p)
        return out
