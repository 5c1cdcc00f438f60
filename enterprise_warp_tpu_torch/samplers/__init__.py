"""Samplers (counterpart of ``enterprise_warp_tpu/samplers``): the adaptive
PT-MCMC of the paramfile path."""

from .ptmcmc import PTSampler, run_ptmcmc

__all__ = ["PTSampler", "run_ptmcmc"]
