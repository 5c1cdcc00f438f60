# ewt: allow-no-print module — the serve subcommand's report and its
# JSON summary line are its stdout
"""``python -m enterprise_warp_tpu_torch.cli serve ...`` — the serve
driver CLI.

Counterpart of ``enterprise_warp_tpu/serve/cli.py``, with the same
arguments and the same summary JSON line. Builds the paramfile's model
topologies once (on the card unless the caller passes ``device="cpu"``),
registers them with a :class:`~enterprise_warp_tpu_torch.serve.driver.
ServeDriver`, optionally pre-warms the AOT bucket set, then serves a
request trace (a JSON file, or a seeded synthetic multi-tenant trace) and
prints one summary JSON line.

Trace file schema: a JSON list of requests, in arrival order::

    [{"tenant": "t0", "model": "0", "thetas": [[...], ...]}, ...]

``"n_theta": k`` may replace ``"thetas"`` — the driver draws ``k``
prior samples instead (seeded). ``"model"`` defaults to the first
registered model. Optional per-entry fields: ``"rid"`` (a stable
request id) and ``"deadline_ms"`` (shed at pack time when exceeded).

Adversity contract: a trace entry the admission layer rejects
(malformed thetas, queue full, over quota) is COUNTED and skipped, never
fatal — the summary line carries the shed accounting. A demotion past
the port's last in-process rung checkpoints the unfinished queue
(``<root>/state.npz`` integrity generations) and exits 75 (EX_TEMPFAIL);
an external supervisor restarts with ``--resume`` to drain the restored
queue on the kernels.

Trained flow surrogates: ``--flow NAME=PATH[:MODE]`` (repeatable) and
the paramfile's ``flow_models:`` (the same tokens) register
``FlowPosterior.load(PATH).serve_view(MODE, NAME)`` beside the
paramfile's models, on the same device; ``MODE`` is ``sample`` (the
default: a request row is a base draw, a result row the posterior draw
and its log q) or ``log_prob``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

__all__ = ["serve_main", "build_serve_models", "synthetic_trace",
           "load_trace"]

def build_serve_models(prfile, gram_mode="split", device="cuda"):
    """``({model_key: likelihood}, params)`` for a paramfile's topologies
    (the same builds the sampling CLI would run), on ``device``."""
    from ..config import Params
    from ..models.assemble import init_model_likelihoods

    params = Params(prfile, opts=None)
    likes = init_model_likelihoods(params, gram_mode=gram_mode,
                                   write_pars=False, device=device)
    return {str(k): v for k, v in likes.items()}, params


def synthetic_trace(models, n_requests, tenants=4, max_theta=8,
                    seed=0):
    """A seeded bursty multi-tenant request trace: requests arrive in
    tenant bursts (each tenant submits a run of consecutive jobs, the
    realistic shape for per-pulsar noise-posterior sweeps), with
    theta batches drawn from the model prior."""
    rng = np.random.default_rng(seed)
    names = sorted(models)
    trace = []
    remaining = int(n_requests)
    while remaining > 0:
        tenant = f"tenant{rng.integers(tenants)}"
        burst = int(min(remaining, 1 + rng.integers(6)))
        for _ in range(burst):
            model = names[int(rng.integers(len(names)))]
            like = models[model]
            n = int(1 + rng.integers(max_theta))
            trace.append({"tenant": tenant, "model": model,
                          "thetas": np.asarray(
                              like.sample_prior(rng, n),
                              dtype=np.float64)})
        remaining -= burst
    return trace


def load_trace(path, models, seed=0):
    """Parse a trace file (see module docstring) into submit specs."""
    with open(path) as fh:
        raw = json.load(fh)
    rng = np.random.default_rng(seed)
    default_model = sorted(models)[0]
    out = []
    for i, r in enumerate(raw):
        model = str(r.get("model", default_model))
        if model not in models:
            raise KeyError(f"trace entry {i} names unregistered "
                           f"model {model!r}")
        if "thetas" in r:
            thetas = np.asarray(r["thetas"], dtype=np.float64)
        else:
            thetas = np.asarray(models[model].sample_prior(
                rng, int(r.get("n_theta", 1))), dtype=np.float64)
        spec = {"tenant": str(r.get("tenant", "tenant0")),
                "model": model, "thetas": thetas}
        if r.get("rid") is not None:
            spec["rid"] = str(r["rid"])
        if r.get("deadline_ms") is not None:
            spec["deadline_ms"] = float(r["deadline_ms"])
        out.append(spec)
    return out


def serve_main(argv=None, device="cuda"):
    """Serve a paramfile's topologies; returns the exit status. The
    models run on ``device`` (the card unless the caller asks for the
    CPU)."""
    import argparse

    from .. import resolve_device
    from ..utils.compilecache import enable_compilation_cache
    enable_compilation_cache()

    ap = argparse.ArgumentParser(
        prog="enterprise_warp_tpu_torch.cli serve",
        description="multi-tenant batched serving of paramfile "
                    "model topologies")
    ap.add_argument("-p", "--prfile", required=True,
                    help="paramfile naming the model topologies")
    ap.add_argument("-o", "--out", default=None,
                    help="serve root dir (default: <paramfile "
                         "output_dir>/serve)")
    ap.add_argument("--requests", default=None,
                    help="JSON trace file (default: synthetic trace)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the unfinished request queue from "
                         "the serve root's checkpoint instead of "
                         "submitting a trace (restart after a "
                         "demotion/preemption exit)")
    ap.add_argument("--synthetic", type=int, default=32,
                    help="synthetic trace size when --requests is "
                         "not given (default 32)")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--max-theta", type=int, default=8,
                    help="max prior draws per synthetic job")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated batch bucket edges "
                         "(default EWT_SERVE_BUCKETS or 1,2,...,64)")
    ap.add_argument("--warm", action="store_true",
                    help="warm each model's executable before serving "
                         "(fresh-replica warm start)")
    ap.add_argument("--gram_mode", default="split",
                    choices=("split", "f32", "f64"))
    ap.add_argument("--flow", action="append", default=[],
                    metavar="NAME=PATH[:MODE]",
                    help="register a trained flow artifact "
                         "(flows/model.py .npz) as serve model NAME; "
                         "MODE is 'sample' (default: one request row "
                         "= one base draw, result row = posterior "
                         "draw + log q) or 'log_prob'. Repeatable; "
                         "the paramfile key 'flow_models:' takes the "
                         "same NAME=PATH[:MODE] tokens")
    opts = ap.parse_args(argv)

    device = resolve_device(device)
    models, params = build_serve_models(opts.prfile,
                                        gram_mode=opts.gram_mode,
                                        device=device)
    flow_specs = list(opts.flow)
    pf_flows = getattr(params, "flow_models", None)
    if pf_flows:
        flow_specs += ([str(t) for t in pf_flows]
                       if isinstance(pf_flows, (list, tuple))
                       else str(pf_flows).split())
    for spec_str in flow_specs:
        name, _, rhs = spec_str.partition("=")
        if not name or not rhs:
            raise ValueError(f"--flow expects NAME=PATH[:MODE], got "
                             f"{spec_str!r}")
        path, _, mode = rhs.partition(":")
        from ..flows.model import FlowPosterior
        models[name] = FlowPosterior.load(path, device=device).serve_view(
            mode or "sample", name=name)
    root = opts.out or os.path.join(params.output_dir, "serve")
    buckets = None
    if opts.buckets:
        buckets = tuple(sorted({int(x) for x in
                                opts.buckets.split(",") if x.strip()}))

    from ..resilience.supervisor import EXIT_DEMOTED, PlatformDemotion
    from .admission import Rejection, parse_serve_config
    from .driver import ServeDriver
    serve_cfg = parse_serve_config(getattr(params, "serve", None))
    try:
        with ServeDriver(root, buckets=buckets,
                         prfile=os.path.abspath(opts.prfile),
                         **serve_cfg) as driver:
            for name, like in models.items():
                driver.register(name, like)
            if opts.warm:
                walls = driver.warm()
                print(f"# warmed "
                      f"{sum(len(w) for w in walls.values())} "
                      "executables", file=sys.stderr)
            if opts.resume:
                n = driver.restore()
                print(f"# restored {n} unfinished request(s)",
                      file=sys.stderr)
            else:
                if opts.requests:
                    trace = load_trace(opts.requests, models,
                                       seed=opts.seed)
                else:
                    trace = synthetic_trace(models, opts.synthetic,
                                            tenants=opts.tenants,
                                            max_theta=opts.max_theta,
                                            seed=opts.seed)
                for spec in trace:
                    try:
                        driver.submit(spec["tenant"], spec["model"],
                                      spec["thetas"],
                                      rid=spec.get("rid"),
                                      deadline_ms=spec.get(
                                          "deadline_ms"))
                    except Rejection as rej:
                        # typed admission rejection: counted by the
                        # driver (serve_rejected event + summary
                        # accounting), the trace keeps flowing
                        print(f"# rejected {rej.rid} "
                              f"({rej.reason})", file=sys.stderr)
            summary = driver.run()
    except PlatformDemotion as d:
        # the driver requeued + checkpointed the unfinished work
        # before this crossed the process boundary; hand the restart
        # to the external supervisor (EX_TEMPFAIL contract)
        print(json.dumps({"demoted": str(d.to_level or "restart"),
                          "root": os.path.abspath(root),
                          "resume": "serve --resume"}))
        return EXIT_DEMOTED
    summary["root"] = os.path.abspath(root)
    print(json.dumps(summary))
    # a poison quarantine exiting 0 is the contract (the poison
    # failed alone, by design); an INFRA failure — dropped requests,
    # or quarantines caused by dispatch errors — must not
    return 0 if (summary["dropped_requests"] == 0
                 and summary["dispatch_error_quarantines"] == 0) \
        else 1


if __name__ == "__main__":
    sys.exit(serve_main())
