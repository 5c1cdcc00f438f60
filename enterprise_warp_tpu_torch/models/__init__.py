"""Noise-model vocabulary and model construction (counterpart of
``enterprise_warp_tpu/models``): model methods emit term specs, and
``build`` lowers a TermList + a Pulsar into one walker-batched likelihood."""

from .build import PulsarLikelihood, build_pulsar_likelihood
from .priors import Constant, LinearExp, Normal, Parameter, Uniform
from .standard import StandardModels
from .terms import (BasisTerm, CommonTerm, DeterministicTerm, TermList,
                    WhiteTerm)

__all__ = [
    "Uniform", "Normal", "LinearExp", "Constant", "Parameter",
    "WhiteTerm", "BasisTerm", "CommonTerm", "DeterministicTerm",
    "TermList", "StandardModels", "build_pulsar_likelihood",
    "PulsarLikelihood",
]
