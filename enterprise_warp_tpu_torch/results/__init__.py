"""Post-processing over the output-directory contract.

Counterpart of ``enterprise_warp_tpu/results``: chain loading with
burn-in, noise files, Bayes factors from product-space model indices,
credible levels, corner/trace plots, covariance collection and
Bilby-style result-JSON runs — plain numpy over the on-disk layout
(``pars.txt`` + ``chain_1.txt`` + ``cov.npy`` per pulsar directory), so
chains from either package round-trip. The frequentist optimal
statistic (``optstat.py``) rebuilds the array's terms and runs in torch
on the card; the noise reconstruction is a later slice of the port.
"""

from .bilbylike import BilbyWarpResult  # noqa: F401
from .core import (EnterpriseWarpResult, estimate_from_distribution,  # noqa: F401
                   make_noise_files, parse_commandline,
                   suitable_estimator)
