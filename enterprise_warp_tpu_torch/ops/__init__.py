"""Numerical kernels: Fourier/quantization bases (numpy, build time), PSDs,
and the walker-batched marginalized likelihood with its two CUDA
megakernels (``kernel.py``, ``megakernel.py``, ``csrc/megakernel.cu``)."""

from .fourier import (chromatic_scaling, dm_scaling, fourier_design,
                      quantization_matrix)
from .kernel import marginalized_loglike, whiten_inputs
from .spectra import broken_powerlaw_psd, free_spectrum_psd, powerlaw_psd

__all__ = [
    "fourier_design", "dm_scaling", "chromatic_scaling",
    "quantization_matrix", "powerlaw_psd", "broken_powerlaw_psd",
    "free_spectrum_psd", "marginalized_loglike", "whiten_inputs",
]
