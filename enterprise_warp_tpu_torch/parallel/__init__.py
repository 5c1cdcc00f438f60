"""The joint multi-pulsar likelihood (counterpart of
``enterprise_warp_tpu/parallel`` without the device mesh): the ORF
matrices and the correlated-GWB joint likelihood, batched over walkers
on one card."""

from .orf import (dipole_matrix, hd_matrix, is_low_rank,
                  is_positive_definite, monopole_matrix, orf_matrix)
from .pta import PTALikelihood, build_pta_likelihood

__all__ = ["hd_matrix", "dipole_matrix", "monopole_matrix", "orf_matrix",
           "is_positive_definite", "is_low_rank", "PTALikelihood",
           "build_pta_likelihood"]
