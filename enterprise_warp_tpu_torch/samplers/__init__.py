"""Samplers (counterpart of ``enterprise_warp_tpu/samplers``): the adaptive
PT-MCMC of the paramfile path with its product-space hypermodel, the
gradient samplers (HMC with its ADVI warm start), batched nested
sampling and the CEM/AMIS Gaussian warm start."""

from .cem import fit_cem
from .hmc import HMCSampler, HMCState, run_hmc
from .hypermodel import HyperModelLikelihood
from .nested import run_nested
from .ptmcmc import PTSampler, run_ptmcmc
from .vi import fit_advi

__all__ = ["PTSampler", "run_ptmcmc", "HMCSampler", "HMCState", "run_hmc",
           "fit_advi", "fit_cem", "HyperModelLikelihood", "run_nested"]
