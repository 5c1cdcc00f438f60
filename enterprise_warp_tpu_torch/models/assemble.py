"""Assemble per-model likelihoods from parsed configuration.

Counterpart of ``enterprise_warp_tpu/models/assemble.py``: for every
``{N}`` model section, dispatch each pulsar's noise-term dict (or the
``universal`` fallback) plus ``common_signals`` through the noise-model
object's method vocabulary by name, then build the walker-batched
likelihood: a :class:`PulsarLikelihood` for one pulsar, the joint
``parallel.build_pta_likelihood`` when a common signal is spatially
correlated, else a :class:`MultiPulsarLikelihood` (the uncorrelated sum).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import F64
from ..config.modeldict import get_noise_dict
from .build import PulsarLikelihood, build_pulsar_likelihood
from .prior_mixin import PriorMixin
from .terms import CommonTerm, TermList


class MultiPulsarLikelihood(PriorMixin):
    """Sum of per-pulsar likelihoods over one global parameter vector.

    Uncorrelated models and common-spectrum (no-ORF) signals: each member
    is evaluated on its slice of the global theta and the lnL are summed.
    Shared names (a common term's) collapse to one parameter. Every member
    must live on the same device.
    """

    def __init__(self, pulsar_likes):
        self.pulsar_likes = pulsar_likes
        devices = {torch.device(pl.device) for pl in pulsar_likes}
        if len(devices) != 1:
            raise ValueError(f"members on several devices: "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()
        self.params = []
        seen = {}
        for pl in pulsar_likes:
            for p in pl.params:
                if p.name not in seen:
                    seen[p.name] = len(self.params)
                    self.params.append(p)
        self.param_names = [p.name for p in self.params]
        self.ndim = len(self.params)
        self._index_maps = [
            torch.tensor([seen[p.name] for p in pl.params],
                         dtype=torch.long, device=self.device)
            for pl in pulsar_likes]
        # members' white-noise pair metadata in the global indexing
        self.noise_pairs = [
            (seen[pl.param_names[i]], seen[pl.param_names[j]], s2)
            for pl in pulsar_likes
            for (i, j, s2) in (getattr(pl, "noise_pairs", None) or [])]

    as_theta = PulsarLikelihood.as_theta

    def loglike_batch(self, theta):
        """lnL at ``(W, ndim)`` points -> ``(W,)`` float64."""
        theta = self.as_theta(theta)
        out = torch.zeros(theta.shape[0], dtype=F64, device=self.device)
        for pl, idx in zip(self.pulsar_likes, self._index_maps):
            out = out + pl.loglike_batch(theta.index_select(1, idx))
        return out


def build_terms_for_model(params_model, psrs, noise_model_obj,
                          nfreqs_logs=None):
    """Per-pulsar TermLists for one model section; ``nfreqs_logs``
    collects ``(psr_name, nfreqs_log)`` provenance pairs."""
    termlists = []
    common_signals = getattr(params_model, "common_signals", {}) or {}
    noisemodel = getattr(params_model, "noisemodel", {}) or {}
    universal = getattr(params_model, "universal", {}) or {}
    for psr in psrs:
        model = noise_model_obj(psr=psr, params=params_model)
        terms = TermList(psr)
        for term_name, option in common_signals.items():
            res = getattr(model, term_name)(option=option)
            terms.extend(res if isinstance(res, list) else [res])
        psr_dict = noisemodel.get(psr.name, universal)
        for term_name, option in psr_dict.items():
            res = getattr(model, term_name)(option=option)
            terms.extend(res if isinstance(res, list) else [res])
        termlists.append(terms)
        if nfreqs_logs is not None:
            nfreqs_logs.append((psr.name, list(model.nfreqs_log)))
    return termlists


def write_nfreqs_files(output_dir, nfreqs_logs):
    """Per-selection Fourier-mode-count provenance files, one
    ``flag;value;n`` line per file (the reference's ``*_nfreqs.txt``)."""
    paths = []
    for psr_name, entries in nfreqs_logs:
        for flag, flagval, nfreqs in entries:
            if flag in ("no selection", None, "-"):
                fname, line = "no_selection", f"no selection;-;{nfreqs}\n"
            else:
                safe = f"{flag.lstrip('-')}_{flagval}"
                fname = f"{psr_name}_{safe}"
                line = f"{flag};{flagval};{nfreqs}\n"
            path = os.path.join(output_dir, fname + "_nfreqs.txt")
            with open(path, "w") as fh:
                fh.write(line)
            paths.append(path)
    return paths


def has_correlated_common(termlists) -> bool:
    return any(isinstance(t, CommonTerm) and t.orf is not None
               for tl in termlists for t in tl)


def init_model_likelihoods(params, gram_mode="split", write_pars=True,
                           device="cuda"):
    """``{model_id: likelihood}``: one pulsar, the correlated joint
    likelihood, or the uncorrelated sum; ``tm: sampled`` in a model
    section samples each pulsar's timing model (not with a correlated
    common term, as in the reference)."""
    likes = {}
    for ii, pm in params.models.items():
        tm_opt = getattr(pm, "tm", "default") or "default"
        if tm_opt not in ("default", "sampled"):
            raise NotImplementedError(
                f"tm: {pm.tm} — 'default' (marginalized linear timing "
                "model) and 'sampled' (per-column tmparams offsets, the "
                "reference expansion at bilby_warp.py:85-91) are "
                "implemented; the reference's 'ridge_regression' option "
                "is broken upstream (enterprise_warp.py:453-459)")
        tm_mode = "sampled" if tm_opt == "sampled" else "marginalized"
        nfreqs_logs = []
        termlists = build_terms_for_model(pm, params.psrs,
                                          params.noise_model_obj,
                                          nfreqs_logs=nfreqs_logs)
        fixed = None
        if getattr(pm, "noisefiles", None):
            fixed = get_noise_dict([p.name for p in params.psrs],
                                   params._resolve(pm.noisefiles))
        if tm_mode == "sampled" and len(params.psrs) > 1 and \
                has_correlated_common(termlists):
            raise NotImplementedError(
                "tm: sampled is per-pulsar; combine it with the "
                "correlated joint fit by sampling single pulsars first "
                "(the reference has no sampled-TM joint fit either)")
        if len(params.psrs) == 1:
            like = build_pulsar_likelihood(params.psrs[0], termlists[0],
                                           fixed_values=fixed,
                                           gram_mode=gram_mode, tm=tm_mode,
                                           device=device)
        elif has_correlated_common(termlists):
            from ..parallel import build_pta_likelihood
            like = build_pta_likelihood(params.psrs, termlists,
                                        fixed_values=fixed,
                                        gram_mode=gram_mode, device=device)
        else:
            like = MultiPulsarLikelihood([
                build_pulsar_likelihood(p, tl, fixed_values=fixed,
                                        gram_mode=gram_mode, tm=tm_mode,
                                        device=device)
                for p, tl in zip(params.psrs, termlists)])
        likes[ii] = like
        if write_pars and getattr(params, "output_dir", None) and \
                (params.opts is None
                 or getattr(params.opts, "mpi_regime", 0) != 2):
            np.savetxt(os.path.join(params.output_dir, "pars.txt"),
                       like.param_names, fmt="%s")
            write_nfreqs_files(params.output_dir, nfreqs_logs)
    return likes
