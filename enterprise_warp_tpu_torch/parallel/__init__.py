"""The joint multi-pulsar likelihood and its pulsar axis across processes
(counterpart of ``enterprise_warp_tpu/parallel``): the ORF matrices, the
correlated-GWB joint likelihood batched over walkers, and the process
group and shard layouts of ``distributed.py``."""

from .distributed import (ShardLayout, device_stamp, init_distributed,
                          is_primary, make_mesh, primary_only)
from .orf import (dipole_matrix, hd_matrix, is_low_rank,
                  is_positive_definite, monopole_matrix, orf_matrix)
from .pta import PTALikelihood, build_pta_likelihood


def make_psr_mesh(npsr, n_devices=None, device=None):
    """The pulsar-axis layout of ``npsr`` pulsars over the process group
    (``n_devices`` caps its width)."""
    return make_mesh(npsr, axis="psr", device=device, width=n_devices)


def make_chain_mesh(n_devices=None, device=None):
    """The walker-axis layout over the process group (``n_devices`` caps
    its width): ``PTSampler(mesh=...)`` evaluates each rank's share of
    the walkers. The likelihood builders ignore a ``chain`` layout."""
    from .distributed import process_count
    n = process_count() if n_devices is None else int(n_devices)
    return make_mesh(max(n, 1), axis="chain", device=device, width=n)


__all__ = ["hd_matrix", "dipole_matrix", "monopole_matrix", "orf_matrix",
           "is_positive_definite", "is_low_rank", "PTALikelihood",
           "build_pta_likelihood", "ShardLayout", "device_stamp",
           "init_distributed", "is_primary", "make_mesh", "primary_only",
           "make_psr_mesh", "make_chain_mesh"]
