"""Noise-model JSON dispatch and PAL2 noisefile reading.

Schema (reference ``enterprise_warp.py:272-311`` and the shipped examples in
``examples/example_noisemodels/``): a JSON object with

- ``model_name``: short label used in output-directory naming;
- ``universal``: fallback per-pulsar term dict ``{noise_term: option}``;
- ``common_signals``: terms shared by all pulsars (e.g. ``{"gwb":
  "hd_vary_gamma"}``);
- one ``{noise_term: option}`` dict per pulsar name.
"""

from __future__ import annotations

import ast
import glob
import json
import os


def read_json_dict(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def parse_extra_model_terms(text: str) -> dict:
    """Safely parse the ``--extra_model_terms`` CLI dict string.

    The reference ``eval()``s this (``enterprise_warp.py:285,305-306``);
    here it is ``ast.literal_eval`` with a type check.
    """
    try:
        out = ast.literal_eval(text)
    except (ValueError, SyntaxError) as exc:
        raise ValueError(
            f"--extra_model_terms is not a Python dict literal: {exc}")
    if not isinstance(out, dict):
        raise ValueError("--extra_model_terms must be a dict literal")
    return out


def merge_two_noise_model_dicts(base: dict, extra: dict) -> dict:
    """Merge per-pulsar extra terms into a noise-model dict (reference
    ``enterprise_warp.py:591-606``): extra terms are added to each named
    pulsar's term dict, creating the pulsar entry if needed."""
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in base.items()}
    for psr, terms in extra.items():
        if psr in out and isinstance(out[psr], dict):
            out[psr].update(terms)
        else:
            out[psr] = dict(terms)
    return out


_EQUAD_ALIASES = ("log10_equad", "log10_tnequad", "log10_t2equad")


def get_noise_dict(psrlist, noisefiles: str) -> dict:
    """Read PAL2-format noisefiles ``<dir>/<psr>_noise.json`` for the given
    pulsars into one flat ``{param_name: value}`` dict (reference
    ``enterprise_warp.py:543-557``). Equad naming aliases are normalized to
    ``log10_equad``."""
    out = {}
    for name in psrlist:
        path = os.path.join(noisefiles, f"{name}_noise.json")
        matches = glob.glob(path)
        if not matches:
            from ..utils.logging import get_logger
            get_logger("ewt.config").warning(
                "no noisefile for %s in %s", name, noisefiles)
            continue
        with open(matches[0]) as fh:
            d = json.load(fh)
        for key, val in d.items():
            for alias in _EQUAD_ALIASES[1:]:
                if alias in key:
                    key = key.replace(alias, "log10_equad")
            out[key] = val
    return out
