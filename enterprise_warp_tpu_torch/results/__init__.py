"""Post-processing over the output-directory contract.

Counterpart of ``enterprise_warp_tpu/results``: chain loading with
burn-in, noise files, Bayes factors from product-space model indices,
credible levels, corner/trace plots, covariance collection and
Bilby-style result-JSON runs — plain numpy over the on-disk layout
(``pars.txt`` + ``chain_1.txt`` + ``cov.npy`` per pulsar directory), so
chains from either package round-trip. The frequentist optimal
statistic (``optstat.py``) and the GP noise reconstruction
(``reconstruct.py``, the tempo2 ``general2`` bridge) rebuild the model's
terms and run in float64 torch on the card.
"""

from .bilbylike import BilbyWarpResult  # noqa: F401
from .core import (EnterpriseWarpResult, estimate_from_distribution,  # noqa: F401
                   make_noise_files, parse_commandline,
                   suitable_estimator)
from .optstat import OptimalStatisticResult, OptimalStatisticWarp  # noqa: F401
from .reconstruct import (NoiseReconstructor,  # noqa: F401
                          get_tempo2_prediction)
