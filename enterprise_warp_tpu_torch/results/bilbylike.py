"""Result-JSON (nested-sampling) post-processing.

Counterpart of ``enterprise_warp_tpu/results/bilbylike.py``: the same
pipeline run over ``<label>_result.json`` files written by a nested
sampler (Bilby-compatible schema: ``posterior`` dict of per-parameter
sample lists, ``log_evidence``, ``parameter_labels``), with the posterior
standing in for the MCMC chain.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .core import EnterpriseWarpResult


class BilbyWarpResult(EnterpriseWarpResult):

    def find_result_file(self, psr_dir):
        d = os.path.join(self.outdir_all, psr_dir)
        if not os.path.isdir(d):
            return None
        cands = sorted(f for f in os.listdir(d)
                       if f.endswith("_result.json"))
        return os.path.join(d, cands[0]) if cands else None

    def load_chains(self, psr_dir):
        """Posterior samples from the result JSON, shaped like a chain.

        The 4 diagnostic columns are zeros (no PTMCMC diagnostics in a
        nested run); burn-in does not apply to weighted-resampled
        posteriors, so none is taken.
        """
        path = self.find_result_file(psr_dir)
        if path is None:
            return None
        with open(path) as fh:
            result = json.load(fh)
        pars = result.get("parameter_labels") \
            or list(result["posterior"].keys())
        post = result["posterior"]
        chain = np.stack([np.asarray(post[p], dtype=np.float64)
                          for p in pars], axis=1)
        self.last_result = result
        diag = np.zeros((len(chain), 4))
        return chain, diag, pars

    def _print_logbf(self, psr_dir, chain, pars):
        """Nested runs carry evidences directly."""
        r = getattr(self, "last_result", None)
        if r is None:
            return None
        from ..utils.logging import get_logger
        get_logger("ewt.results").info(
            "%s: log_evidence = %.3f +- %.3f", psr_dir,
            r["log_evidence"], r["log_evidence_err"])
        return r["log_evidence"]
