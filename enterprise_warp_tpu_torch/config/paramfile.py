"""The paramfile DSL: ``Params`` and the run CLI options.

Faithful reimplementation of the reference's config system
(``enterprise_warp/enterprise_warp.py:24-311,313-435``):
line-oriented ``key: value`` with ``#`` comments, ``{N}`` model-section
separators, a typed schema (``label_attr_map``) extended dynamically by the
noise-model object's priors and the chosen sampler's default kwargs,
CLI overrides that also mutate the output label, per-model noise-model JSON
dispatch, and the output-directory naming contract
``out/<model_names>_<paramfile_label>/<num>_<psrname>/``.

Documented divergences: relative paths in a paramfile resolve against the
paramfile's own directory (the reference resolves against the CWD);
``--extra_model_terms`` is parsed with ``ast.literal_eval`` instead of
``eval``; the pulsar-archive format is ``.npz`` via ``Pulsar.save_npz``
(plus pickled lists of Pulsar objects) instead of Enterprise pickles.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import warnings

import numpy as np

from ..io.pulsar import Pulsar, load_pulsar
from .modeldict import (merge_two_noise_model_dicts, parse_extra_model_terms,
                        read_json_dict)

# Native sampler registry with default kwargs — stands in for the Bilby
# sampler-kwargs harvest (reference ``enterprise_warp.py:156-167``).
# External Bilby samplers map onto the native kernels: nested samplers run
# on the nested-sampling kernel, MCMC names on the adaptive PTMCMC kernel.
# The torch port runs the ptmcmcsampler and hmc branches so far (cli.py).
IMPLEMENTED_SAMPLERS = {
    "ptmcmcsampler": dict(nsamp=1000000, SCAMweight=30, AMweight=15,
                          DEweight=50, IndWeight=0, CGWeight=0,
                          KDEWeight=0, NSWeight=0, ntemps=1,
                          writeHotChains=False,
                          covUpdate=1000, burn=10000, thin=10,
                          advi_init=False, advi_steps=800,
                          anneal_init=False),
    # nested samplers share the native blocked device-resident
    # implementation (samplers/nested.py). 0 = auto: kbatch ->
    # nlive//5, nsteps -> kernel-matched eval budget. block_iters:
    # -1 = default block length (EWT_NESTED_BLOCK / 16), 0 = the seed
    # per-iteration hatch path. kernel: "slice" (whitened slice,
    # default) or "walk" (seed Gaussian+DE).
    "dynesty": dict(nlive=500, dlogz=0.1, kbatch=0, nsteps=0,
                    block_iters=-1, kernel="slice"),
    "nestle": dict(nlive=500, dlogz=0.1, kbatch=0, nsteps=0,
                   block_iters=-1, kernel="slice"),
    "pymultinest": dict(nlive=500, dlogz=0.1, kbatch=0, nsteps=0,
                        block_iters=-1, kernel="slice"),
    "pypolychord": dict(nlive=500, dlogz=0.1, kbatch=0, nsteps=0,
                        block_iters=-1, kernel="slice"),
    "ultranest": dict(nlive=500, dlogz=0.1, kbatch=0, nsteps=0,
                      block_iters=-1, kernel="slice"),
    "emcee": dict(nwalkers=64, nsteps=10000),
    "ptemcee": dict(nwalkers=64, nsteps=10000, ntemps=4),
    # native gradient-based sampler (no reference counterpart: the
    # Enterprise likelihood is a black-box numpy callback; ours is a
    # differentiable function)
    "hmc": dict(nsamp=10000, nchains=64, n_leapfrog=16, warmup=1000,
                target_accept=0.8),
}


def parse_commandline(argv=None):
    """The run CLI (reference ``enterprise_warp.py:24-71``)."""
    parser = argparse.ArgumentParser(
        description="enterprise_warp_tpu run options")
    parser.add_argument("-n", "--num", type=int, default=0,
                        help="Pulsar number")
    parser.add_argument("-p", "--prfile", type=str, required=True,
                        help="Parameter file")
    parser.add_argument("-d", "--drop", type=int, default=0,
                        help="Drop pulsar with index --num in a full-PTA "
                             "run (jackknife)")
    parser.add_argument("-c", "--clearcache", type=int, default=0,
                        help="Clear the pulsar cache for this run")
    parser.add_argument("-m", "--mpi_regime", type=int, default=0,
                        help="Filesystem staging regime (0 normal, 1 "
                             "prepare-only, 2 no filesystem writes); kept "
                             "for CLI compatibility — the native samplers "
                             "need no staging")
    parser.add_argument("-w", "--wipe_old_output", type=int, default=0,
                        help="Wipe the output directory before the run")
    parser.add_argument("-x", "--extra_model_terms", type=str, default=None,
                        help="Extra noise terms dict, e.g. "
                             "\"{'J0437-4715': {'system_noise': "
                             "'CPSR2_20CM'}}\"")
    return parser.parse_args(argv)


class ModelParams:
    """Per-model parameter container for product-space model selection
    (reference ``enterprise_warp.py:73-88``)."""

    def __init__(self, model_id):
        self.model_id = model_id
        self.model_name = "Untitled"


class Params:
    """Parse a paramfile into run configuration + loaded pulsars."""

    def __init__(self, input_file_name, opts=None, custom_models_obj=None,
                 init_pulsars=True):
        from ..models.standard import StandardModels

        self.input_file_name = input_file_name
        self._basedir = os.path.dirname(os.path.abspath(input_file_name))
        self.opts = opts
        self.psrs = []
        self.Tspan = None
        self.custom_models_obj = custom_models_obj
        self.noise_model_obj = (custom_models_obj if custom_models_obj
                                else StandardModels)
        self.sampler_kwargs = {}
        self.label_attr_map = {
            "paramfile_label:": ["paramfile_label", str],
            "datadir:": ["datadir", str],
            "out:": ["out", str],
            "overwrite:": ["overwrite", str],
            "array_analysis:": ["array_analysis", str],
            "noisefiles:": ["noisefiles", str],
            "noise_model_file:": ["noise_model_file", str],
            "sampler:": ["sampler", str],
            "nsamp:": ["nsamp", int],
            "setupsamp:": ["setupsamp", bool],
            "mcmc_covm_csv:": ["mcmc_covm_csv", str],
            "psrlist:": ["psrlist", str],
            "ssephem:": ["ssephem", str],
            "clock:": ["clock", str],
            "AMweight:": ["AMweight", int],
            "DMweight:": ["DMweight", int],
            "SCAMweight:": ["SCAMweight", int],
            "tm:": ["tm", str],
            "fref:": ["fref", float],
            # serving-layer admission + SLO config (docs/serving.md):
            # whitespace-separated key=value tokens, parsed by
            # serve.admission.parse_serve_config — e.g.
            # ``serve: max_queue=64 tenant_quota=8 weight.gold=4
            # slo_p95_ms=250 slo_success=0.99 slo_p95_ms.gold=100
            # slo_window=256`` (the slo_* keys declare per-tenant
            # objectives for serve/slo.py:SLOEngine;
            # docs/serving.md#slo)
            "serve:": ["serve", str],
            # amortized-posterior serving (docs/flows.md): trained
            # flow artifacts registered as first-class serve models —
            # whitespace-separated NAME=PATH[:MODE] tokens, MODE in
            # {sample, log_prob} (default sample)
            "flow_models:": ["flow_models", str],
            # numerical-integrity plane (docs/resilience.md): the
            # ingestion-gate repair policy ('none' quarantines on hard
            # findings, 'drop' drops offending rows with provenance)
            # and the array-degradation policy ('raise' aborts on the
            # first quarantined pulsar, 'skip' continues with the
            # surviving array + a quarantined.json honesty artifact)
            "data_repair:": ["data_repair", str],
            "on_quarantine:": ["on_quarantine", str],
        }
        self.label_attr_map.update(
            self.noise_model_obj().get_label_attr_map())

        self.model_ids = []
        self.models = {}
        model_id = None

        with open(input_file_name) as fh:
            for line in fh:
                if not line.strip():
                    continue
                between = line[line.find("{") + 1:line.find("}")]
                if line.find("{") >= 0 and between.isdigit():
                    model_id = int(between)
                    self.create_model(model_id)
                    continue
                if line.lstrip()[0] == "#":
                    continue
                row = line.split()
                label, data = row[0], row[1:]
                if label not in self.label_attr_map:
                    # sampler kwargs are schema-extended after 'sampler:'
                    warnings.warn(f"unknown paramfile key {label!r} "
                                  "ignored")
                    continue
                attr = self.label_attr_map[label][0]
                dtypes = self.label_attr_map[label][1:]
                if len(dtypes) == 1 and len(data) > 1:
                    dtypes = [dtypes[0]] * len(data)
                values = [self._convert(d, t)
                          for d, t in zip(data, dtypes)]

                if attr == "sampler":
                    self._harvest_sampler_kwargs(data[0])

                target = (self.__dict__ if model_id is None
                          else self.models[model_id].__dict__)
                target[attr] = values if len(values) > 1 else values[0]

        if not self.models:
            self.create_model(0)
        if "out" not in self.__dict__:
            self.out = "out/"
        self.label = os.path.basename(os.path.normpath(self.out))
        self.override_params_using_opts()
        self.set_default_params()
        self.read_modeldicts()
        self.update_sampler_kwargs()
        if init_pulsars:
            self.init_pulsars()
            self.clone_all_params_to_models()

    # ------------------------------------------------------------------ #
    @staticmethod
    def _convert(text, dtype):
        if dtype is bool:
            return text in ("True", "true", "1")
        return dtype(text)

    def _resolve(self, path):
        """Resolve an input path: CWD first (reference behavior), then the
        paramfile's directory, then its parent (so the shipped example
        paramfiles work from anywhere)."""
        if os.path.isabs(path):
            return path
        for base in (os.getcwd(), self._basedir,
                     os.path.dirname(self._basedir)):
            cand = os.path.join(base, path)
            if os.path.exists(cand):
                return cand
        return path

    def _harvest_sampler_kwargs(self, name):
        if name not in IMPLEMENTED_SAMPLERS:
            raise ValueError(
                f"Unknown sampler: {name}\nKnown samplers: "
                + ", ".join(IMPLEMENTED_SAMPLERS))
        self.sampler_kwargs = dict(IMPLEMENTED_SAMPLERS[name])
        # device-mesh knobs shared by every sampler branch (cli.py):
        # ``psr_shard`` shards the joint likelihood's pulsar axis
        # (docs/scaling.md), ``chain_shard`` the PT walker batch
        # (docs/performance.md). 0 = off, 1 = all devices, N = first N.
        self.sampler_kwargs.setdefault("psr_shard", 0)
        self.sampler_kwargs.setdefault("chain_shard", 0)
        for key, val in self.sampler_kwargs.items():
            self.label_attr_map[key + ":"] = [key, type(val)]

    def create_model(self, model_id):
        self.model_ids.append(model_id)
        self.models[model_id] = ModelParams(model_id)

    def override_params_using_opts(self):
        """CLI overrides for per-model keys; mutates the label (reference
        ``enterprise_warp.py:187-201``)."""
        if self.opts is None:
            return
        for key in self.models:
            for opt, val in vars(self.opts).items():
                if opt in self.models[key].__dict__ and val is not None:
                    self.models[key].__dict__[opt] = val
                    self.label += f"_{opt}_{val}"
                    from ..utils.logging import get_logger
                    get_logger("ewt.config").info(
                        "Model %s: overriding %s = %s", key, opt,
                        val)

    def set_default_params(self):
        """Defaults (reference ``enterprise_warp.py:221-270``)."""
        d = self.__dict__
        d.setdefault("ssephem", "DE436")
        d.setdefault("clock", None)
        d.setdefault("setupsamp", False)
        d.setdefault("tm", "default")
        d.setdefault("inc_events", True)
        d.setdefault("fref", 1400.0)
        d.setdefault("overwrite", "False")
        d.setdefault("array_analysis", "False")
        d.setdefault("data_repair", "none")
        d.setdefault("on_quarantine", "raise")
        d.setdefault("sampler", "ptmcmcsampler")
        d.setdefault("paramfile_label",
                     os.path.splitext(
                         os.path.basename(self.input_file_name))[0])
        if "psrlist" in d and isinstance(self.psrlist, str):
            self.psrlist = list(np.loadtxt(self._resolve(self.psrlist),
                                           dtype=str, ndmin=1))
        else:
            d.setdefault("psrlist", [])
        d.setdefault("psrcachefile", None)
        if "mcmc_covm_csv" in d and \
                os.path.isfile(self._resolve(self.mcmc_covm_csv)):
            import pandas as pd
            d["mcmc_covm"] = pd.read_csv(self._resolve(self.mcmc_covm_csv),
                                         index_col=0)
        else:
            d["mcmc_covm"] = None
        # priors default from the noise-model object (reference :257-263)
        for key, val in self.noise_model_obj().priors.items():
            d.setdefault(key, val)
        for mkey in self.models:
            self.models[mkey].modeldict = {}

    def read_modeldicts(self):
        """Per-model noise-model JSON (reference ``:272-311``)."""
        extra = None
        if self.opts is not None and \
                getattr(self.opts, "extra_model_terms", None):
            extra = parse_extra_model_terms(self.opts.extra_model_terms)

        def load_into(target):
            nm = read_json_dict(self._resolve(target.noise_model_file))
            target.common_signals = nm.pop("common_signals", {})
            target.model_name = nm.pop("model_name", "Untitled")
            target.universal = nm.pop("universal", {})
            target.noisemodel = nm
            return target

        if "noise_model_file" in self.__dict__:
            load_into(self)
            if extra:
                self.noisemodel = merge_two_noise_model_dicts(
                    self.noisemodel, extra)
        for mkey in self.models:
            if "noise_model_file" in self.models[mkey].__dict__:
                load_into(self.models[mkey])
                # extra terms apply to a single model, or to model 1 of two
                # (reference :301-306)
                if extra and (len(self.models) == 1
                              or (len(self.models) == 2 and mkey == 1)):
                    self.models[mkey].noisemodel = \
                        merge_two_noise_model_dicts(
                            self.models[mkey].noisemodel, extra)
        self.label_models = "_".join(
            self.models[m].model_name for m in self.models)

    def update_sampler_kwargs(self):
        for key in self.sampler_kwargs:
            if key in self.__dict__:
                self.sampler_kwargs[key] = self.__dict__[key]

    # ------------------------------------------------------------------ #
    def init_pulsars(self):
        """Load pulsars and derive the output directory (reference
        ``enterprise_warp.py:313-435``)."""
        datadir = self._resolve(self.datadir)

        if datadir.endswith(".pkl"):
            with open(datadir, "rb") as fh:
                pkl = pickle.load(fh)
            pairs = [(p.name, p) for p in pkl]
        elif datadir.endswith(".npz"):
            psr = Pulsar.load_npz(datadir)
            pairs = [(psr.name, psr)]
        elif os.path.isdir(datadir) and glob_nonempty(datadir,
                                                      "*.psr.npz"):
            import glob as _glob
            files = sorted(_glob.glob(os.path.join(datadir, "*.psr.npz")))
            loaded = [Pulsar.load_npz(f) for f in files]
            pairs = [(p.name, p) for p in loaded]
        else:
            import glob as _glob
            parfiles = sorted(_glob.glob(os.path.join(datadir, "*.par")))
            timfiles = sorted(_glob.glob(os.path.join(datadir, "*.tim")))
            if len(parfiles) != len(timfiles):
                raise ValueError(
                    "there should be the same number of .par and .tim "
                    f"files in {datadir} (found {len(parfiles)} vs "
                    f"{len(timfiles)})")
            pairs = [(os.path.basename(p).split("_")[0].split(".")[0],
                      (p, t)) for p, t in zip(parfiles, timfiles)]

        def realize(entry):
            return entry if isinstance(entry, Pulsar) \
                else load_pulsar(*entry, repair=str(self.data_repair))

        array_mode = str(self.array_analysis) == "True"
        skip_quarantined = array_mode \
            and str(self.on_quarantine) == "skip"
        self.quarantined_pulsars = []
        # output stays CWD-relative (reference behavior; never resolved
        # into the read-only data/paramfile tree)
        prefix = os.path.join(self.out,
                              f"{self.label_models}_{self.paramfile_label}")
        if array_mode:
            self.output_dir = prefix + "/"
            for num, (pname, entry) in enumerate(pairs):
                if self.psrlist and pname not in self.psrlist:
                    continue
                if self.opts is not None and \
                        getattr(self.opts, "drop", 0) and \
                        getattr(self.opts, "num", None) == num:
                    from ..utils.logging import get_logger
                    get_logger("ewt.config").info(
                        "Dropping pulsar %s (jackknife)", pname)
                    self.output_dir = os.path.join(
                        prefix, f"{num}_{pname}") + "/"
                    continue
                if skip_quarantined:
                    # graceful array degradation (numerical-integrity
                    # plane): a quarantined pulsar fails ALONE; the
                    # run continues with the survivors and carries an
                    # explicit honesty record (quarantined.json +
                    # psr_quarantined events)
                    from ..io.errors import ParseError
                    from ..resilience import integrity
                    try:
                        self.psrs.append(realize(entry))
                    except integrity.DataQuarantine as q:
                        integrity.emit_psr_quarantined(
                            q.psr, cause="data_quarantine",
                            where="ingestion",
                            stats={"verdict": q.report.verdict,
                                   "source": q.report.source})
                        self.quarantined_pulsars.append(
                            (q.psr, q.report.to_dict()))
                    except ParseError as exc:
                        src = (os.path.basename(str(entry[1]))
                               if isinstance(entry, tuple) else "")
                        rep = integrity.parse_error_report(
                            pname, src, exc)
                        integrity.emit_psr_quarantined(
                            pname, cause=f"parse_error: {exc}",
                            where="ingestion")
                        self.quarantined_pulsars.append(
                            (pname, rep.to_dict()))
                else:
                    self.psrs.append(realize(entry))
            if not self.psrs:
                raise ValueError(
                    f"every pulsar in {datadir} was quarantined at "
                    "ingestion — nothing left to analyze")
            tmin = min(p.toas.min() for p in self.psrs)
            tmax = max(p.toas.max() for p in self.psrs)
            self.Tspan = float(tmax - tmin)
        else:
            num = getattr(self.opts, "num", 0) if self.opts is not None \
                else 0
            if num >= len(pairs):
                raise IndexError(
                    f"--num {num} out of range: {len(pairs)} pulsars")
            pname, entry = pairs[num]
            psr = realize(entry)
            self.psrs = [psr]
            self.Tspan = psr.Tspan
            self.output_dir = os.path.join(
                prefix, f"{num}_{psr.name}") + "/"

        if self.opts is None or getattr(self.opts, "mpi_regime", 0) != 2:
            # every process of a group shares the output directory; only
            # the primary wipes it or writes into it
            from ..parallel.distributed import is_primary
            primary = is_primary()
            if primary and os.path.exists(self.output_dir) \
                    and self.opts is not None \
                    and bool(getattr(self.opts, "wipe_old_output", 0)):
                warnings.warn(
                    f"removing everything in {self.output_dir}")
                shutil.rmtree(self.output_dir)
            os.makedirs(self.output_dir, exist_ok=True)
            # honesty artifact (numerical-integrity plane): any result
            # computed from this output dir must carry the pulsars the
            # ingestion gate removed from the array
            if self.quarantined_pulsars and primary:
                from ..io.writers import atomic_write_json
                atomic_write_json(
                    os.path.join(self.output_dir, "quarantined.json"),
                    {"quarantined_pulsars":
                         [n for n, _ in self.quarantined_pulsars],
                     "reports": {n: r for n, r
                                 in self.quarantined_pulsars}})

    def clone_all_params_to_models(self):
        for key, val in list(self.__dict__.items()):
            for m in self.models:
                if key not in ("models",):
                    self.models[m].__dict__.setdefault(key, val)
        # model-section keys must win over globals
        for m in self.models:
            self.models[m].Tspan = self.Tspan
            self.models[m].psrs = self.psrs


def glob_nonempty(directory, pattern):
    import glob as _glob
    return bool(_glob.glob(os.path.join(directory, pattern)))
