# ewt: allow-no-print module — the run command's user-facing lines
# (rank, set-up, the joint chain's float64 check) are its stdout
"""Run CLI: ``python -m enterprise_warp_tpu_torch.cli --prfile <paramfile>
--num N``.

Counterpart of ``enterprise_warp_tpu/cli.py``: parse the paramfile, load
pulsar ``--num`` (or every pulsar of the data directory with
``array_analysis: True``), build the walker-batched likelihoods on the
card and dispatch on the sampler, as the reference does: the adaptive
PT-MCMC for ``ptmcmcsampler`` (over the product-space hypermodel of all
models when the paramfile has two or more) and for ``emcee``/``ptemcee``
(``nsteps``, ``ntemps``, ``nwalkers`` chains), HMC with its ADVI warm start for
``hmc``, and nested sampling for every Bilby nested name (``dynesty``,
``nestle``, ``pymultinest``, ``pypolychord``, ``ultranest``), on the first
model. Each writes the reference's output-directory contract, so
``python -m enterprise_warp_tpu_torch.results`` post-processes the run.

The run plane: the samplers run inside one ``run_scope`` on the output
directory keyed by the paramfile's hash (``events.jsonl``; the lineage of
a re-entry comes from ``EWT_PARENT_RUN_ID``/``EWT_LINEAGE_REASON`` or the
stream's tail), a SIGTERM stops the run cleanly at a block boundary, a
pulsar quarantined by the health ladder exits 76 with
``quarantined.json``, and a demotion past the last in-process rung prints
it and exits 75 with the checkpoint on disk. The reference's bottom rung
re-executes the CLI on the CPU; the port never moves a card run to the
host, so it always takes the reference's ``EWT_DEMOTION_EXEC=0`` branch.

Processes: the CLI first joins the process group of the ``EWT_*``
environment contract (``parallel/distributed.py``; a no-op without it)
and prints ``distributed: process i/N``. ``psr_shard: N`` (``1``: every
process) shards a multi-pulsar joint likelihood's pulsar axis over
``min(N, world)`` ranks; ``chain_shard`` splits the PT walker batch's
evaluations over the ranks (the PT branch only; HMC and nested sampling
note it and run unsharded). With both set the pulsar axis takes the
group and ``chain_shard`` is noted and ignored. Only process 0 writes
run outputs.

``serve``: ``main(["serve", "-p", <paramfile>, ...])`` runs the serving
layer's CLI (``serve/cli.py:serve_main``) on the same ``device``.
"""

from __future__ import annotations

import argparse
import importlib.util
import logging
import os
import sys

_log = logging.getLogger(__name__)
# a joint chain's largest lnL against the dense float64 oracle at the same
# point: the reference's class for the Schur path (tests/test_parallel.py),
# |dlnL| <= JOINT_ATOL + JOINT_RTOL |lnL|
JOINT_ATOL, JOINT_RTOL = 5e-2, 1e-7


def import_custom_models(py_path: str, class_name: str):
    """Dynamic import of a user model file (custom-models contract)."""
    spec = importlib.util.spec_from_file_location("custom_models_module",
                                                  py_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, class_name)


def _parser():
    parser = argparse.ArgumentParser(
        description="enterprise_warp_tpu_torch run")
    parser.add_argument("-n", "--num", type=int, default=0)
    parser.add_argument("-p", "--prfile", type=str, required=True)
    parser.add_argument("-d", "--drop", type=int, default=0)
    parser.add_argument("-c", "--clearcache", type=int, default=0)
    parser.add_argument("-m", "--mpi_regime", type=int, default=0)
    parser.add_argument("-w", "--wipe_old_output", type=int, default=0)
    parser.add_argument("-x", "--extra_model_terms", type=str,
                        default=None)
    parser.add_argument("--custom_models_py", type=str, default=None)
    parser.add_argument("--custom_models", type=str, default=None)
    parser.add_argument("--gram_mode", type=str, default="split",
                        choices=("split", "f32", "f64"))
    return parser


def main(argv=None, device="cuda"):
    """Run one paramfile; returns the process exit status. ``device``
    selects where the likelihood and the sampler run (the card unless the
    caller asks for the CPU)."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "serve":
        from .serve.cli import serve_main
        return serve_main(argv[1:], device=device)
    opts = _parser().parse_args(argv)

    from . import resolve_device
    from .config import Params
    from .io.errors import ParseError
    from .models.assemble import init_model_likelihoods
    from .resilience.integrity import EXIT_QUARANTINED, DataQuarantine

    device = resolve_device(device)
    # the process group of the EWT_* contract (a no-op for one process)
    from .parallel.distributed import init_distributed
    from .utils.profiling import monotonic
    pidx, pcnt = init_distributed(device=device)
    if pcnt > 1:
        print(f"distributed: process {pidx}/{pcnt}, "
              f"single-writer={'yes' if pidx == 0 else 'no'}")
        if device.type == "cuda":
            import torch
            device = torch.device(
                f"cuda:{pidx % torch.cuda.device_count()}")
            torch.cuda.set_device(device)
    custom = None
    if opts.custom_models_py and opts.custom_models:
        custom = import_custom_models(opts.custom_models_py,
                                      opts.custom_models)
    t0 = monotonic()
    try:
        params = Params(opts.prfile, opts=opts, custom_models_obj=custom,
                        init_pulsars=False)
        t_par = monotonic()
        params.init_pulsars()
        params.clone_all_params_to_models()
    except DataQuarantine as q:
        print(f"data quarantine: {q}", file=sys.stderr)
        return EXIT_QUARANTINED
    except ParseError as exc:
        print(f"malformed input file: {exc}", file=sys.stderr)
        return EXIT_QUARANTINED
    mesh = psr_mesh(params, pcnt, device)
    t_psr = monotonic()
    likes = init_model_likelihoods(params, gram_mode=opts.gram_mode,
                                   device=device, mesh=mesh)
    from .native import load as native_core
    setup = dict(paramfile_s=t_par - t0, pulsars_s=t_psr - t_par,
                 likelihood_s=monotonic() - t_psr,
                 npsr=len(params.psrs),
                 tim_engine="native" if native_core() else "python")
    _log.info("set-up: paramfile %.3f s, %d pulsars parsed in %.3f s "
              "(%s TIM engine), likelihood built in %.3f s",
              setup["paramfile_s"], setup["npsr"], setup["pulsars_s"],
              setup["tim_engine"], setup["likelihood_s"],
              extra={"setup_stats": setup})
    if params.setupsamp or opts.mpi_regime == 1:
        print("Preparations for the sampling are complete "
              "(setup-only mode)")
        return 0
    import hashlib

    from .resilience.integrity import PulsarQuarantine
    from .resilience.supervisor import (EXIT_DEMOTED, PlatformDemotion,
                                        install_graceful_sigterm)
    from .utils import telemetry
    with open(opts.prfile, "rb") as fh:
        config_hash = hashlib.sha256(fh.read()).hexdigest()[:16]
    install_graceful_sigterm()
    try:
        with telemetry.run_scope(params.output_dir, sampler=params.sampler,
                                 config_hash=config_hash,
                                 prfile=os.path.abspath(opts.prfile),
                                 label=getattr(params, "label", None)):
            _run_samplers(params, likes, not bool(opts.wipe_old_output),
                          device, psr_sharded=mesh is not None)
    except PulsarQuarantine as q:
        # the health ladder's last rung: this pulsar is out (76: do not
        # restart it); the record merges with earlier quarantines, and
        # every rank reaches it, so the primary alone writes it
        print(f"pulsar quarantine: {q}", file=sys.stderr)
        if pidx == 0:
            _record_quarantine(params.output_dir, q)
        return EXIT_QUARANTINED
    except PlatformDemotion as d:
        # every in-process rung is applied by the samplers; past them the
        # run restarts from its checkpoint in a fresh process (75)
        print(f"platform demotion: {d}", file=sys.stderr)
        return EXIT_DEMOTED
    return 0


def _record_quarantine(output_dir, q):
    """Merge a sampler-time quarantine into ``quarantined.json``."""
    import json

    from .io.writers import atomic_write_json
    qpath = os.path.join(output_dir, "quarantined.json")
    record = {"quarantined_pulsars": [q.psr],
              "reports": {q.psr: {"cause": q.cause, "stats": q.stats}}}
    try:
        with open(qpath) as fh:
            prev = json.load(fh)
        record["reports"] = {**prev.get("reports", {}), **record["reports"]}
        record["quarantined_pulsars"] = sorted(
            set(prev.get("quarantined_pulsars", [])) | {q.psr})
    except (OSError, ValueError):
        pass
    atomic_write_json(qpath, record)


def psr_mesh(params, world, device):
    """The pulsar-axis layout the paramfile's ``psr_shard`` asks for
    (``N``: ``min(N, world)`` ranks, ``1``: every rank), or None: one
    rank, a one-pulsar run (noted), or no knob."""
    ps = params.sampler_kwargs.get("psr_shard")
    if not ps:
        return None
    if len(params.psrs) < 2:
        print("note: psr_shard needs a multi-pulsar joint model; "
              "single-pulsar run stays unsharded")
        return None
    want = world if int(ps) == 1 else min(int(ps), world)
    if want < 2:
        return None
    from .parallel import make_psr_mesh
    mesh = make_psr_mesh(len(params.psrs), n_devices=want, device=device)
    print(f"pulsar-axis sharding: joint likelihood over {mesh.nshard} "
          f"of {world} processes")
    return mesh


def chain_mesh(params, psr_sharded):
    """The walker-axis layout the paramfile's ``chain_shard`` asks for,
    or None (the knob unset, a sampler other than PT, which is noted, the
    pulsar axis already holding the group, or one rank)."""
    cs = params.sampler_kwargs.get("chain_shard")
    if not cs:
        return None
    if params.sampler not in ("ptmcmcsampler", "emcee", "ptemcee"):
        print(f"note: chain_shard applies to the PT-MCMC branch only; "
              f"sampler '{params.sampler}' runs unsharded")
        return None
    if psr_sharded:
        print("note: psr_shard holds the process group; chain_shard is "
              "ignored")
        return None
    from .parallel.distributed import process_count
    world = process_count()
    want = world if int(cs) == 1 else min(int(cs), world)
    if want < 2:
        return None
    from .parallel import make_chain_mesh
    print(f"chain-axis sharding: walker evaluations over {want} of "
          f"{world} processes")
    return make_chain_mesh(want)


def _run_samplers(params, likes, resume, device, psr_sharded=False):
    """Dispatch on the paramfile's sampler (module docstring)."""
    from .parallel.distributed import is_primary
    from .samplers import (HyperModelLikelihood, run_hmc, run_nested,
                           run_ptmcmc)
    first_id = min(likes)
    like = likes[first_id]
    kw = params.sampler_kwargs
    mesh = chain_mesh(params, psr_sharded)
    if params.sampler == "ptmcmcsampler":
        if len(likes) >= 2:
            like = HyperModelLikelihood(likes)
        nsamp = int(getattr(params, "nsamp", kw.get("nsamp", 1000000)))
        run_ptmcmc(like, params.output_dir, nsamp, params=params,
                   resume=resume, mesh=mesh)
        if is_primary():
            check_joint_chain(params, like, device)
    elif params.sampler == "hmc":
        if len(likes) > 1:
            print("note: HMC has no gradient for the discrete nmodel index; "
                  "using model 0 (use ptmcmcsampler for product-space "
                  "selection)")
        nsamp = int(getattr(params, "nsamp", kw.get("nsamp", 10000)))
        run_hmc(like, params.output_dir, nsamp, params=params, resume=resume)
    elif params.sampler in ("emcee", "ptemcee"):
        if len(likes) >= 2:
            like = HyperModelLikelihood(likes)
        run_ptmcmc(like, params.output_dir, int(kw.get("nsteps", 10000)),
                   params=params, resume=resume,
                   ntemps=int(kw.get("ntemps", 1)),
                   nchains=int(kw.get("nwalkers", 64)), mesh=mesh)
        if is_primary():
            check_joint_chain(params, like, device)
    else:
        if len(likes) > 1:
            print(f"note: nested sampling uses model {first_id}; run "
                  "per-model for evidences (reference Bilby branch "
                  "behavior)")
        run_nested(like, outdir=params.output_dir, label=params.label,
                   nlive=int(kw.get("nlive", 500)),
                   dlogz=float(kw.get("dlogz", 0.1)), resume=resume,
                   **nested_knobs(kw))


def check_joint_chain(params, like, device):
    """Re-score a joint PT chain's largest lnL with the dense float64
    oracle at the same point. A float32 Schur path can lock a chain on a
    corner where it lies far above float64 (the reference's does; the
    port's float64 Gram and redo of near-singular pairs, ``parallel/
    pta.py:CORNER_C``, remove the corners measured); a run whose chain
    lies outside the class there logs a warning. Returns ``(lnl,
    lnl_f64)`` at that row, or None where ``like`` is not a float32 joint
    likelihood or the chain has no finite lnL."""
    import numpy as np

    from .models.assemble import init_model_likelihoods
    from .parallel import PTALikelihood
    if not isinstance(like, PTALikelihood) or like.gram_mode == "f64":
        return None
    chain = np.loadtxt(os.path.join(params.output_dir, "chain_1.txt"),
                       ndmin=2)
    # rows: [theta..., lnpost, lnlike, accept_rate, pt_accept_rate]
    lnl = chain[:, like.ndim + 1] if chain.size else chain[:, :0]
    if not np.isfinite(lnl).any():
        return None
    top = int(np.argmax(np.where(np.isfinite(lnl), lnl, -np.inf)))
    oracles = init_model_likelihoods(params, gram_mode="f64",
                                     write_pars=False, device=device)
    ref = float(oracles[min(oracles)].loglike_batch(
        chain[top:top + 1, :like.ndim])[0])
    if abs(lnl[top] - ref) <= JOINT_ATOL + JOINT_RTOL * abs(ref):
        _log.info("the chain's largest lnL %.8g (row %d) lies %.6g from the "
                  "float64 oracle's %.8g at the same point, within the "
                  "class", lnl[top], top, lnl[top] - ref, ref)
    else:
        _log.warning(
            "the chain's largest lnL %.8g (row %d) lies %.6g from the "
            "float64 oracle's %.8g at the same point: the float32 Schur "
            "path has locked the chain on a corner; discard this posterior "
            "or rerun with --gram_mode f64",
            lnl[top], top, lnl[top] - ref, ref)
    return float(lnl[top]), ref


def nested_knobs(kw):
    """The paramfile's nested-sampler knobs to forward, as the reference's
    CLI forwards them: ``kbatch`` and ``nsteps`` when positive (0 =
    auto), ``block_iters`` when not negative (-1, the default, keeps the
    sampler's block length; 0 asks for the per-iteration path, which
    the port runs as the blocked walk one iteration a block), and
    ``kernel`` only when it is not the default ``slice``."""
    nkw = {}
    for key in ("kbatch", "nsteps"):
        if int(kw.get(key, 0) or 0) > 0:
            nkw[key] = int(kw[key])
    if int(kw.get("block_iters", -1)) >= 0:
        nkw["block_iters"] = int(kw["block_iters"])
    if kw.get("kernel") and kw["kernel"] != "slice":
        nkw["kernel"] = str(kw["kernel"])
    return nkw

if __name__ == "__main__":
    sys.exit(main())
