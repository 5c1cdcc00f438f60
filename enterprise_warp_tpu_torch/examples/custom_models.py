"""The custom-noise-model plugin contract, by example, for the port.

Counterpart of ``examples/custom_models.py``, built from the port's own
classes: subclass ``StandardModels``, extend ``self.priors`` (each key
becomes a paramfile option automatically), and add methods whose names
become noise-model-JSON vocabulary. Use from ``examples/`` with::

    python -m enterprise_warp_tpu_torch.cli \
        --prfile example_params/custom_hypermodel.dat \
        --custom_models_py ../enterprise_warp_tpu_torch/examples/custom_models.py \
        --custom_models CustomModels

Two custom terms are defined:

- ``dm_dip``: a DM exponential dip with fixed epoch/timescale from the
  option string ``"<t0_mjd>_<tau_days>"`` and its amplitude marginalized
  analytically;
- ``spin_noise_bpl``: broken-power-law spin noise (Goncharov+ 2019).
"""

import numpy as np

from enterprise_warp_tpu_torch import constants as const
from enterprise_warp_tpu_torch.models import StandardModels
from enterprise_warp_tpu_torch.models.terms import BasisTerm
from enterprise_warp_tpu_torch.ops import dm_scaling


class CustomModels(StandardModels):
    """StandardModels + a DM event term and a broken-power-law variant."""

    def __init__(self, psr=None, params=None):
        super().__init__(psr=psr, params=params)
        self.priors.update({
            "dmdip_sigma": 1.0e-5,     # prior std of the dip amplitude, s
        })

    def dm_dip(self, option="55700_30"):
        """DM exponential dip: amplitude * exp(-(t-t0)/tau) * (fref/nu)^2
        for t >= t0, amplitude marginalized under a zero-mean Gaussian
        prior of std ``dmdip_sigma`` (paramfile-overridable)."""
        t0_mjd, tau_days = (float(x) for x in option.split("_"))
        t = self.psr.toas / const.day
        shape = np.where(t >= t0_mjd,
                         np.exp(-(t - t0_mjd) / tau_days), 0.0)
        col = shape * dm_scaling(self.psr.freqs, self.params.fref)
        norm = np.linalg.norm(col)
        if norm == 0:
            raise ValueError(
                f"{self.psr.name}: no TOAs after dip epoch {t0_mjd}")
        sigma = float(getattr(self.params, "dmdip_sigma", 1.0e-5))
        return BasisTerm(f"dmdip_{option}", (col / norm)[:, None],
                         coeff_sigma2=np.array([sigma ** 2 * norm ** 2]))

    def spin_noise_bpl(self, option="30_nfreqs"):
        """Broken-power-law achromatic red noise ('turnover' PSD adds the
        corner-frequency parameter with the ``sn_fc`` prior)."""
        option = "turnover" if option in ("", "default") \
            else f"turnover_{option}"
        return self.spin_noise(option)
