"""Assemble per-model likelihoods from parsed configuration.

Counterpart of the single-pulsar branch of
``enterprise_warp_tpu/models/assemble.py:init_model_likelihoods``: for every
``{N}`` model section, dispatch the pulsar's noise-term dict (or the
``universal`` fallback) plus ``common_signals`` through the noise-model
object's method vocabulary by name, then build the walker-batched
likelihood. Multi-pulsar models (uncorrelated products and the joint
correlated kernel) are a later slice of the port.
"""

from __future__ import annotations

import os

import numpy as np

from ..config.modeldict import get_noise_dict
from .build import build_pulsar_likelihood
from .terms import TermList


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


def init_model_likelihoods(params, gram_mode="split", write_pars=True,
                           device="cuda"):
    """``{model_id: likelihood}`` for a single-pulsar run; ``tm:
    sampled`` in a model section samples its timing model."""
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
        if len(params.psrs) != 1:
            raise NotImplementedError(
                "multi-pulsar models are a later slice of the port (see "
                "ROADMAP.md); run one pulsar with --num")
        nfreqs_logs = []
        termlists = build_terms_for_model(pm, params.psrs,
                                          params.noise_model_obj,
                                          nfreqs_logs=nfreqs_logs)
        fixed = None
        if getattr(pm, "noisefiles", None):
            fixed = get_noise_dict([p.name for p in params.psrs],
                                   params._resolve(pm.noisefiles))
        like = build_pulsar_likelihood(params.psrs[0], termlists[0],
                                       fixed_values=fixed,
                                       gram_mode=gram_mode, tm=tm_mode,
                                       device=device)
        likes[ii] = like
        if write_pars and getattr(params, "output_dir", None) and \
                (params.opts is None
                 or getattr(params.opts, "mpi_regime", 0) != 2):
            np.savetxt(os.path.join(params.output_dir, "pars.txt"),
                       like.param_names, fmt="%s")
            write_nfreqs_files(params.output_dir, nfreqs_logs)
    return likes
