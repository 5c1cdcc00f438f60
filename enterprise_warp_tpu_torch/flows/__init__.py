"""Amortized posteriors: normalizing-flow surrogates in torch.

Counterpart of ``enterprise_warp_tpu/flows``. A coupling flow
(:mod:`.coupling`) trained by maximum likelihood on sampler draws
(:mod:`.train`) becomes a durable artifact (:class:`.model.FlowPosterior`)
that serves posterior queries behind ``ServeDriver``, ships with an
exact-likelihood importance-sampling audit (:mod:`.rescore`), and powers
the MH-corrected ``flow`` proposal family of ``samplers/ptmcmc.py``.
"""

from .coupling import (FlowSpec, flow_forward, flow_inverse, flow_log_prob,
                       flow_sample_logq, init_flow)
from .model import FlowPosterior, FlowServeModel
from .rescore import rescore_flow
from .train import fit_flow

__all__ = [
    "FlowSpec", "init_flow", "flow_forward", "flow_inverse",
    "flow_log_prob", "flow_sample_logq", "fit_flow",
    "FlowPosterior", "FlowServeModel", "rescore_flow",
]
