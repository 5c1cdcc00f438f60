"""Convergence-gated sampling and the insertion-rank diagnostics (numpy).

Counterpart of ``enterprise_warp_tpu/samplers/convergence.py``:

- :func:`sample_to_convergence` drives a :class:`~.ptmcmc.PTSampler` in
  blocks until the worst-parameter split-R-hat and multi-chain ESS of the
  post-burn cold chains pass, with the reference's knobs (``check_every``,
  ``check_growth``, ``diag_max_kept``, ``block_size``, ``on_check``,
  ``resume``) and its resume repair of the chain files and checkpoint;
  :func:`chains_from_file` reads a reference-format chain back as
  ``(nchains, nsteps, ndim)``;
- the insertion-rank helpers of nested sampling (Fowlie, Handley & Su
  2020, batched form): when the constrained kernel truly samples the
  prior above L*, each replacement's rank among the surviving live
  points is uniform, and a KS distance against the discrete uniform
  tells a broken kernel from a healthy one.

:func:`sample_to_convergence` opens the run's event stream
(``utils/telemetry.py``): the sampler's block heartbeats join it, and each
check adds a ``phase="convergence_check"`` heartbeat whose ``diag_mode``
says how it was decided. The streaming gate is the reference's
(``EWT_STREAMING_DIAG``, on by default): a check reads the sampler's
streaming ledger (``utils/devicemetrics.py``) first and skips the exact
fold of the chains where that already fails; every streaming pass is
confirmed by the exact estimators.
"""

from __future__ import annotations

import glob
import os
import time
from dataclasses import dataclass

import numpy as np

from ..io.writers import checkpoint_replace, resolve_checkpoint
from ..parallel.distributed import from_primary, is_primary
from ..utils import telemetry
from ..utils.diagnostics import summarize_chains
from ..utils.logging import get_logger

_log = get_logger("ewt.convergence")


@dataclass
class ConvergenceReport:
    converged: bool
    steps: int
    wall_s: float            # total sampling wall-clock
    steady_wall_s: float     # wall-clock excluding the first call's blocks
    rhat_max: float
    ess_min: float
    summary: dict            # per-parameter diagnostics
    chains: np.ndarray       # (nchains, nkept, ndim) post-burn cold chains


def insertion_rank_ks(ranks, nmax):
    """One-sample KS distance of insertion ranks against the discrete
    uniform on ``{0..nmax}``; ranks are midpoint-mapped to (0, 1) before
    the continuous KS fold. None for an empty rank set."""
    r = np.asarray(ranks, dtype=np.float64).ravel()
    n = r.size
    if n == 0:
        return None
    r = np.sort((r + 0.5) / (float(nmax) + 1.0))
    i = np.arange(n, dtype=np.float64)
    return float(np.max(np.maximum(r - i / n, (i + 1.0) / n - r)))


def insertion_rank_pass(ks, n, crit=1.95, n_eff=None):
    """Gate one KS distance: pass iff ``ks * sqrt(n_eff) <= crit``.
    ``n_eff`` (default ``n``) is the dependence-corrected sample size
    (:func:`insertion_rank_neff`); crit 1.95 is the asymptotic
    Kolmogorov value at alpha ~ 0.001, lenient on purpose: the gate
    catches a broken kernel, not 5%-level fluctuations."""
    n_eff = max(int(n if n_eff is None else n_eff), 1)
    stat = float(ks) * n_eff ** 0.5
    return {"pass": bool(stat <= crit),
            "ks_sqrt_n": round(stat, 3), "crit": crit,
            "n_eff": n_eff}


def insertion_rank_neff(n, nlive, kbatch):
    """Effective independent-rank count for ``n`` pooled ranks: the
    replacements of one iteration are seeded with replacement from the
    ``M = nlive - kbatch`` survivors, so ``n`` scales by the expected
    fraction of distinct seeds, ``M (1 - exp(-K/M)) / K``, K = kbatch."""
    m = max(int(nlive) - int(kbatch), 1)
    k = max(int(kbatch), 1)
    distinct = m * (1.0 - np.exp(-k / m))
    return max(int(round(n * min(distinct / k, 1.0))), 1)


def chains_from_file(chain_path, nchains, ndim, burn_frac=0.25):
    """Reshape the reference-format interleaved chain file into
    (nchains, nsteps, ndim), dropping the burn-in fraction and the 4
    trailing diagnostic columns."""
    raw = np.loadtxt(chain_path, ndmin=2)
    nsteps = raw.shape[0] // nchains
    c = raw[:nsteps * nchains, :ndim].reshape(nsteps, nchains, ndim)
    c = np.transpose(c, (1, 0, 2))
    keep = int(nsteps * (1.0 - burn_frac))
    return c[:, nsteps - keep:]


def _robust_loadtxt(path):
    """Chain-file load tolerating a partial final line (a kill mid-append):
    rows that fail float parsing, by token count or by a token cut
    mid-write ('1.2e', '-'), are dropped wherever they sit. Returns
    ``(array, dropped_any)``. Clean files go through the native reader
    (``native.read_table_native``)."""
    from ..native import read_table_native
    clean = read_table_native(str(path))
    if clean is not None:
        return clean, False
    try:
        return np.loadtxt(path, ndmin=2), False
    except ValueError:
        rows = []
        with open(path) as fh:
            for ln in fh:
                try:
                    vals = [float(t) for t in ln.split()]
                except ValueError:
                    continue
                if vals:
                    rows.append(vals)
        if not rows:
            return np.empty((0, 0)), True
        ncol = len(rows[0])
        return np.array([r for r in rows if len(r) == ncol],
                        ndmin=2), True


def _chains_from_blocks(blocks, burn_frac):
    """Post-burn (nchains, nkept, ndim) chains from the float32 cold blocks
    collected by :meth:`PTSampler.sample`."""
    c = np.concatenate(blocks, axis=0)        # (nsteps, nchains, ndim)
    nsteps = c.shape[0]
    keep = int(nsteps * (1.0 - burn_frac))
    return np.transpose(c[nsteps - keep:], (1, 0, 2))


def _rewind_diag(z, nsteps):
    """The streaming ledger's checkpoint keys (``diag_*``) rewound with
    the step counter to ``nsteps``: its per-block entries cut back where
    ``nsteps`` falls on a block boundary, else the ledger dropped (the
    gate then checks exactly); the run-cumulative histogram and family
    matrices have no per-block entries and are always dropped. Left as
    they were, the re-sampled steps would fold twice and the ledger would
    never again cover exactly the sampled steps."""
    if "diag_counts" not in z:
        return z
    cum = np.cumsum(np.asarray(z["diag_counts"]))
    keep = int(np.searchsorted(cum, nsteps, side="left")) + 1
    aligned = keep <= len(cum) and cum[keep - 1] == nsteps
    for k in [k for k in z if k.startswith("diag_")]:
        if aligned and k in ("diag_counts", "diag_mean", "diag_m2",
                             "diag_min", "diag_max"):
            z[k] = z[k][:keep]
        else:
            del z[k]
    return z


def _resume_blocks(sampler, verbose):
    """The resume repair of an interrupted run: the chain rows the
    checkpoint accounts for, as one collected block, with the checkpoint
    counter rewound where the file holds fewer complete steps, and the
    chain files (the hot rungs' too) cut back to that step. Returns
    ``(blocks, steps)``; no blocks where there is nothing to resume. The
    primary reads and repairs the files; every other rank takes its
    blocks and step from it (:func:`~..parallel.distributed.from_primary`)
    and reads no file the primary may be writing."""
    return from_primary(lambda: _resume_repair(sampler, verbose))


def _resume_repair(sampler, verbose):
    """:func:`_resume_blocks` on the process that reads the files."""
    chain_path = os.path.join(sampler.outdir, "chain_1.txt")
    ckpt = resolve_checkpoint(sampler._ckpt_path, what="pt checkpoint")
    if ckpt is None or not os.path.exists(chain_path):
        return [], 0
    raw, dropped = _robust_loadtxt(chain_path)
    ckpt_step = int(np.load(ckpt)["step"])
    nsteps = min(raw.shape[0] // sampler.nchains, ckpt_step)
    if nsteps <= 0:
        return [], 0
    if nsteps < ckpt_step:
        # dropped or partial lines left fewer complete rows than the
        # checkpointed step: the walker state is a valid Markov state at
        # any step label, so relabel it and keep rows == steps * nchains
        _log.info("resume: chain file holds %d complete steps < checkpoint "
                  "step %d; rewinding checkpoint counter", nsteps, ckpt_step)
        z = _rewind_diag(dict(np.load(ckpt)), nsteps)
        z["step"] = nsteps
        if is_primary():
            tmp = sampler._ckpt_path + ".tmp.npz"
            np.savez(tmp, **z)
            checkpoint_replace(tmp, sampler._ckpt_path)
    truncated = nsteps * sampler.nchains < raw.shape[0]
    raw = raw[:nsteps * sampler.nchains]
    # the resumed sampler appends: stale rows past the checkpoint or a
    # partial line would shift every later block
    if (dropped or truncated) and is_primary():
        tmp = chain_path + ".tmp"
        np.savetxt(tmp, raw)
        os.replace(tmp, chain_path)
    for hp in glob.glob(os.path.join(sampler.outdir, "chain_*.txt")):
        if os.path.basename(hp) == "chain_1.txt":
            continue
        hraw, hdrop = _robust_loadtxt(hp)
        keep = nsteps * sampler.nchains
        if (hdrop or hraw.shape[0] != keep) and is_primary():
            tmp = hp + ".tmp"
            np.savetxt(tmp, hraw[:keep])
            os.replace(tmp, hp)
    if verbose:
        _log.info("resuming at step %d", nsteps)
    c = raw[:, :sampler.ndim]
    return [c.reshape(nsteps, sampler.nchains,
                      sampler.ndim).astype(np.float32)], nsteps


def sample_to_convergence(sampler, target_ess=1000.0, rhat_max=1.01,
                          check_every=2000, max_steps=200_000,
                          burn_frac=0.25, verbose=True, block_size=None,
                          resume=False, on_check=None,
                          diag_max_kept=2000, check_growth=1.0):
    """Drive ``sampler`` (a :class:`~.ptmcmc.PTSampler`) until the
    worst-parameter split-R-hat is at most ``rhat_max`` and the
    multi-chain ESS at least ``target_ess`` on the cold chains after
    ``burn_frac``, or ``max_steps`` is reached.

    The cold chains accumulate in memory (float32 blocks through the
    sampler's ``collect`` hook), and each check runs the diagnostics on
    them strided down to at most ``diag_max_kept`` steps per chain:
    split-R-hat is invariant under thinning, and the Geyer ESS of a
    thinned chain is a lower bound on the total, so the gate can
    overshoot but never falsely pass. ``check_growth > 1`` spaces the
    checks geometrically (the next after ``max(check_every, steps *
    (check_growth - 1))`` more steps, rounded up to whole
    ``block_size`` blocks). ``on_check(steps, wall_s, steady_wall_s)`` is
    called after every check.

    With ``resume=True`` an interrupted run continues from the sampler's
    output directory: the chain rows the checkpoint accounts for are read
    once into the block list (the checkpoint counter rewound where the
    file holds fewer, the chain files cut back to it), and sampling picks
    up from the checkpoint. The driver samples unthinned.

    The streaming gate (``EWT_STREAMING_DIAG``, on by default): where the
    sampler's ``diag_ledger`` covers exactly the sampled steps, a check
    reads its streaming split-R-hat and moment ESS and, where both are
    present and either fails, records a ``diag_mode="stream"`` check and
    skips the exact fold of the chains; anything else falls through to
    the exact estimators (``diag_mode="exact"``), so a streaming pass is
    always confirmed exactly before the function returns converged.
    ``EWT_STREAMING_DIAG=0`` checks exactly everywhere. Each check emits
    a ``convergence_check`` heartbeat. Returns a
    :class:`ConvergenceReport`; both clocks cover this call's sampling
    loop only, ``steady_wall_s`` without its first call to the
    sampler."""
    with telemetry.run_scope(
            sampler.outdir, sampler="convergence",
            target_ess=float(target_ess), rhat_max=float(rhat_max),
            max_steps=int(max_steps)) as rec:
        return _drive(sampler, target_ess, rhat_max, check_every,
                      max_steps, burn_frac, verbose, block_size, resume,
                      on_check, diag_max_kept, check_growth, rec)


def _drive(sampler, target_ess, rhat_max, check_every, max_steps,
           burn_frac, verbose, block_size, resume, on_check, diag_max_kept,
           check_growth, rec):
    """:func:`sample_to_convergence` inside its run scope."""
    block_size = block_size or min(check_every, 500)
    blocks, steps = _resume_blocks(sampler, verbose) if resume else ([], 0)

    def _diag(chains):
        stride = max(1, -(-chains.shape[1] // diag_max_kept))
        return summarize_chains(chains[:, ::stride],
                                sampler.like.param_names)

    def _worst_floats(s):
        # an R-hat that cannot be computed is +inf, an ESS 0
        rh, es = s["_worst"]["rhat"], s["_worst"]["ess"]
        return (np.inf if rh is None else rh,
                0.0 if es is None else es)

    def _beat(mode, rhat, ess):
        rec.heartbeat(phase="convergence_check", step=int(steps),
                      diag_mode=mode, rhat=rhat, ess=ess,
                      wall_s=round(time.perf_counter() - t_start, 2),
                      bubble_s=round(getattr(sampler, "bubble_total_s",
                                             0.0), 3),
                      host_sync_s=round(getattr(sampler,
                                                "host_sync_total_s", 0.0),
                                        3))

    use_stream = os.environ.get("EWT_STREAMING_DIAG", "1") != "0"
    t_start = time.perf_counter()
    t_after_first = None
    while steps < max_steps:
        todo = max(check_every, int(steps * (check_growth - 1.0)))
        todo = -(-todo // block_size) * block_size
        sampler.sample(min(steps + todo, max_steps), resume=steps > 0,
                       verbose=False, block_size=block_size, collect=blocks)
        if t_after_first is None:
            t_after_first = time.perf_counter()
        steps = min(steps + todo, max_steps)
        led = getattr(sampler, "diag_ledger", None) if use_stream else None
        stream = (led.worst(burn_frac) if led is not None and len(led)
                  and led.total_steps == steps else None)
        if stream is not None and stream["rhat"] is not None \
                and stream["ess"] is not None \
                and (stream["rhat"] > rhat_max
                     or stream["ess"] < target_ess):
            # a definite streaming failure: no exact fold this check
            _beat("stream", stream["rhat"], stream["ess"])
            if verbose:
                _log.info("step %d: rhat_max=%.4f ess_min=%.0f (streaming)",
                          steps, stream["rhat"], stream["ess"])
            if on_check is not None:
                on_check(steps, time.perf_counter() - t_start,
                         time.perf_counter() - t_after_first)
            continue
        chains = _chains_from_blocks(blocks, burn_frac)
        s = _diag(chains)
        rh, es = _worst_floats(s)
        _beat("exact", s["_worst"]["rhat"], s["_worst"]["ess"])
        if verbose:
            _log.info("step %d: rhat_max=%.4f ess_min=%.0f", steps, rh, es)
        if on_check is not None:
            on_check(steps, time.perf_counter() - t_start,
                     time.perf_counter() - t_after_first)
        if rh <= rhat_max and es >= target_ess:
            now = time.perf_counter()
            return ConvergenceReport(
                converged=True, steps=steps, wall_s=now - t_start,
                steady_wall_s=now - t_after_first, rhat_max=rh,
                ess_min=es, summary=s, chains=chains)
    chains = _chains_from_blocks(blocks, burn_frac)
    s = _diag(chains)
    rh, es = _worst_floats(s)
    now = time.perf_counter()
    return ConvergenceReport(
        converged=False, steps=steps, wall_s=now - t_start,
        steady_wall_s=now - (t_after_first or t_start), rhat_max=rh,
        ess_min=es, summary=s, chains=chains)
