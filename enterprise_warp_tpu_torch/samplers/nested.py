"""Batched nested sampling (evidence + posterior) on the likelihood's device.

Counterpart of ``enterprise_warp_tpu/samplers/nested.py``, the native
replacement for the nested samplers the reference reaches through Bilby
(dynesty, nestle, ...). Instead of one live-point replacement per
iteration, the ``kbatch`` worst points are deleted together and refilled
by constrained exploration seeded from random survivors, so every
likelihood call is one batch of ``kbatch`` walkers.

Blocked device residency
------------------------
``block_iters`` iterations form one block: a Python loop over tensors on
the likelihood's device (the reference's ``lax.scan``). The live set,
lnL, the walk scale and the evidence accumulator ``(lnz, ln_x)`` stay
float64 tensors on that device; the floor test, the masks, the sort and
the refill stay there too, and nothing inside a block reads a value back
to the host. The host sees the state once per block, at the commit: one
device-to-host copy of the block's dead points and traces
(``devicestate.host_snapshot``), after which the previous block's host
work (checkpoint, log line) has already run behind the enqueued block
(``devicestate.HostPipeline``). Termination is a block-boundary check on
the per-iteration ``dlogz`` trace; blocks align to an absolute iteration
grid, so kill-and-resume reproduces the uninterrupted run bit for bit.

Randomness comes from one explicit ``torch.Generator`` on the
likelihood's device, seeded from ``seed``; its state goes into the
checkpoint. The reference's threefry streams are not reproduced.

The constrained kernels are the whitened slice sampler (``slice``, the
default: hit-and-run with shrinkage in the live set's covariance frame)
and the Gaussian + differential-evolution random walk (``walk``); both
carry the white-noise budget slide as a 25% mixture component when the
likelihood has ``noise_pairs`` and every prior is Uniform.

Evidence bookkeeping treats a batch of K deletions as K sequential ones
(live counts N, N-1, ..., N-K+1). The result is written as a Bilby-style
``<label>_result.json`` (read by ``results.BilbyWarpResult``) plus
``<label>_nested.npz``.

The reference's per-iteration path (``block_iters: 0`` or
``EWT_NESTED_BLOCK=0``: one walk-kernel iteration per call and one host
read per iteration) gives the blocked walk's dead-point ledger bit for
bit, so the port accepts those switches and runs the blocked walk one
iteration a block.

The run plane, as the reference's: each run is a ``run_scope`` on the
output directory (a ``heartbeat`` per block, a ``checkpoint`` per
checkpoint write, a closing heartbeat), each dispatch goes through
``BlockSupervisor("nested.iteration")`` (its breaker writes the last
committed block's checkpoint first; :func:`run_nested` applies in-process
demotions and resumes), the fault sites ``nested.iteration``,
``nested.ckpt`` and ``nested.nonfinite``, the flight recorder (a
non-finite dead point is an anomaly) and a SIGTERM stops the run at a
block boundary with its checkpoint written.

The device diagnostics plane, as the reference's
(``utils/devicemetrics.py``; off with ``EWT_DEVICE_DIAG=0`` or
``EWT_TELEMETRY=0``, and, as in the reference, not on the per-iteration
path): each block also stacks the walk-scale and first-draw acceptance
traces, read in the block's one snapshot, for the ``scale_min``,
``scale_max``, ``budget_exhaust_frac`` and ``first_accept_frac`` heartbeat
keys and the ``walk_scale``/``budget_exhaust_frac`` gauges.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from .. import F64
from ..io.writers import (atomic_write_json, checkpoint_replace,
                          remove_checkpoint, resolve_checkpoint)
from ..models.build import params_fingerprint
from ..parallel.distributed import from_primary, is_primary
from ..resilience import faults
from ..resilience.supervisor import (BlockSupervisor, PlatformDemotion,
                                     apply_demotion, preemption_requested)
from ..utils import devicemetrics, profiling, telemetry
from ..utils.flightrec import flight_recorder
from ..utils.logging import EvalRateMeter, get_logger
from .convergence import (insertion_rank_ks, insertion_rank_neff,
                          insertion_rank_pass)
from .devicestate import HostPipeline, host_snapshot

_log = get_logger("ewt.nested")

#: NS iterations per block: one host sync per block
DEFAULT_BLOCK_ITERS = 16

# set once the per-iteration switch has been logged (once a process)
_PERITER_NOTED = []

#: eval rounds per slice update (the shrink budget): rounds group into
#: complete, reversible slice transitions — see ``slice_kernel``
_SLICE_SHRINK_BUDGET = 4



def _device(like):
    return torch.device(getattr(like, "device", "cpu"))


def _uniform_bounds(like):
    """``(lo, hi)`` float64 tensors on the likelihood's device when every
    prior is Uniform, else None."""
    from ..models.priors import Uniform
    if not all(type(p.prior) is Uniform for p in like.params):
        return None
    dev = _device(like)
    return (torch.tensor([p.prior.lo for p in like.params], dtype=F64,
                         device=dev),
            torch.tensor([p.prior.hi for p in like.params], dtype=F64,
                         device=dev))


def slide_effective(like, slide_moves=None):
    """Whether the budget-slide move will actually run: it needs the
    likelihood's (efac, equad) pair metadata AND all-Uniform priors (the
    walk lives in the unit cube). ``slide_moves=False`` turns it off."""
    avail = bool(list(getattr(like, "noise_pairs", None) or [])) \
        and _uniform_bounds(like) is not None
    if slide_moves is None:
        return avail
    return bool(slide_moves) and avail


def _resolve_block_iters(block_iters):
    """An explicit ``block_iters`` wins; otherwise ``EWT_NESTED_BLOCK``
    sets it; default :data:`DEFAULT_BLOCK_ITERS`."""
    if block_iters is not None:
        return int(block_iters)
    env = os.environ.get("EWT_NESTED_BLOCK")
    if env is not None and env.strip() != "":
        return int(env)
    return DEFAULT_BLOCK_ITERS


def _rand(gen, *shape):
    return torch.rand(shape, generator=gen, dtype=F64, device=gen.device)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, dtype=F64, device=gen.device)


def _randint(gen, lo, hi, n):
    return torch.randint(lo, hi, (n,), generator=gen, device=gen.device)


def _make_iteration(like, nlive, kbatch, nsteps, slide_moves=None,
                    kernel="slice"):
    """One NS iteration on device tensors: delete the ``kbatch`` worst,
    refill by constrained exploration from random survivors.

    Returns ``iteration(u, lnl, gen, scale, lnz, ln_x)`` ->
    ``(u, lnl, scale, lnz, ln_x, dead_u, dead_lnl, acc, delta, ranks,
    lnx0, first)``, the reference's ``extras=True`` signature with the
    generator ``gen`` in place of the key: ``ranks`` is each replacement's
    rank among the surviving live points (the insertion-rank diagnostic),
    ``lnx0`` the iteration-entry ln X, ``acc``/``first`` the kernel's
    acceptance rates that drive the on-device scale adaptation."""
    dev = _device(like)
    nd = like.ndim

    use_slide = slide_effective(like, slide_moves)
    if use_slide:
        pairs = list(like.noise_pairs)
        lo, hi = _uniform_bounds(like)
        sl_i = torch.tensor([p[0] for p in pairs], device=dev)
        sl_j = torch.tensor([p[1] for p in pairs], device=dev)
        sl_s2 = torch.tensor([p[2] for p in pairs], dtype=F64, device=dev)
        sl_lo, sl_span = lo, hi - lo
        n_pairs = len(pairs)

    def slide(x0, gen):
        """u-space budget slide, per walker: theta -> (v, q') at fixed
        total white variance v -> back to u. Returns (proposed u, log
        measure correction log(e/e'), in-box flag)."""
        K = x0.shape[0]
        th = sl_lo + sl_span * x0
        b = _randint(gen, 0, n_pairs, K)
        ie, iq, s2 = sl_i[b][:, None], sl_j[b][:, None], sl_s2[b]
        e = th.gather(1, ie)[:, 0]
        q = th.gather(1, iq)[:, 0]
        v = e * e * s2 + 10.0 ** (2.0 * q)
        upper = torch.minimum(sl_lo[iq[:, 0]] + sl_span[iq[:, 0]],
                              0.5 * torch.log10(v) - 1e-9)
        lo_q = torch.minimum(sl_lo[iq[:, 0]], upper - 1e-9)
        q_new = lo_q + (upper - lo_q) * _rand(gen, K)
        e_new = torch.sqrt(torch.clamp((v - 10.0 ** (2.0 * q_new)) / s2,
                                       min=0.0))
        th = th.scatter(1, ie, e_new[:, None]).scatter(1, iq, q_new[:, None])
        qc = torch.log(torch.clamp(e, min=1e-300)) \
            - torch.log(torch.clamp(e_new, min=1e-300))
        u_new = (th - sl_lo) / sl_span
        inbox = torch.all((u_new > 0.0) & (u_new < 1.0), dim=1)
        return u_new, qc, inbox

    def loglike(u):
        return like.loglike_batch(like.from_unit(u))

    def walk_kernel(u, walk_u, walk_lnl, gen, scale, lstar):
        """Scaled-Gaussian + DE-difference random walk with cube
        reflection, ``nsteps`` batched rounds under the hard floor."""
        K = walk_u.shape[0]
        sig = torch.std(u, dim=0, correction=0) + 1e-7
        nacc = torch.zeros((), dtype=F64, device=dev)
        for _ in range(nsteps):
            gauss = walk_u + scale * sig * _randn(gen, K, nd)
            # DE-difference move: the difference of two random live
            # points carries the constrained region's own correlations
            ia, ib = _randint(gen, 0, nlive, K), _randint(gen, 0, nlive, K)
            de = walk_u + (0.7 * scale) * (u[ia] - u[ib])
            prop = torch.where((_rand(gen, K) < 0.5)[:, None], de, gauss)
            # reflect into the unit cube
            prop = 1.0 - torch.abs(1.0 - torch.abs(prop))
            prop = torch.clamp(prop, 1e-12, 1.0 - 1e-12)
            qcorr = torch.zeros(K, dtype=F64, device=dev)
            supp = torch.ones(K, dtype=torch.bool, device=dev)
            pick = torch.zeros(K, dtype=torch.bool, device=dev)
            if use_slide:
                s_prop, s_qc, s_in = slide(walk_u, gen)
                # the move-type choice must not depend on the state: an
                # out-of-box slide is a rejection, not a fallback
                pick = _rand(gen, K) < 0.25
                prop = torch.where(pick[:, None], s_prop, prop)
                qcorr = torch.where(pick, s_qc, qcorr)
                supp = torch.where(pick, s_in, supp)
            lnl_p = loglike(prop)
            ok = supp & (lnl_p > lstar) & (torch.log(_rand(gen, K)) < qcorr)
            walk_u = torch.where(ok[:, None], prop, walk_u)
            walk_lnl = torch.where(ok, lnl_p, walk_lnl)
            # scale feedback from the symmetric moves only
            sym = ~pick
            nacc = nacc + torch.sum(ok & sym).to(F64) \
                / torch.clamp(torch.sum(sym), min=1).to(F64)
        return walk_u, walk_lnl, nacc / nsteps, nacc / nsteps

    def slice_kernel(u, walk_u, walk_lnl, gen, scale, lstar):
        """Whitened slice sampler: hit-and-run with Neal shrinkage in the
        live set's Cholesky frame. Rounds group into complete updates of
        ``_SLICE_SHRINK_BUDGET`` eval rounds: a walker that accepts
        freezes until the update window closes, one that exhausts the
        budget stays at its anchor ("at most S shrinkage draws, else
        stay" is reversible). Every round is one batched likelihood call
        for all walkers (frozen lanes ride along masked), so
        ``it * kbatch * nsteps`` is the exact eval count. A walker picked
        by the 25% slide lottery spends its window on one slide MH
        proposal."""
        K = walk_u.shape[0]
        mu = torch.mean(u, dim=0)
        dc = u - mu
        C = (dc.T @ dc) / (nlive - 1)
        C = C + (1e-12 + 1e-6 * torch.mean(torch.diagonal(C))) \
            * torch.eye(nd, dtype=F64, device=dev)
        L = torch.linalg.cholesky_ex(C)[0]
        x0, lnl0 = walk_u, walk_lnl
        zero = torch.zeros((), dtype=F64, device=dev)
        acc_evt, first_evt, upd_cnt = zero, zero, zero
        no_pick = torch.zeros(K, dtype=torch.bool, device=dev)
        for i in range(nsteps):
            is_reset = i % _SLICE_SHRINK_BUDGET == 0
            pick = no_pick
            if is_reset:
                # update boundary: a fresh direction and bracket for
                # every lane, everyone unfrozen, the slide lottery drawn
                dirn = (_randn(gen, K, nd) @ L.T) * scale
                r = _rand(gen, K)
                t_lo, t_hi = -r, 1.0 - r
                frozen = no_pick
                if use_slide:
                    pick = _rand(gen, K) < 0.25
                    s_prop, s_qc, s_in = slide(x0, gen)
            t = t_lo + (t_hi - t_lo) * _rand(gen, K)
            prop = x0 + t[:, None] * dirn
            incube = torch.all((prop > 0.0) & (prop < 1.0), dim=1)
            if use_slide and is_reset:
                prop = torch.where(pick[:, None], s_prop, prop)
            # clip only what the likelihood sees: an out-of-cube draw is
            # already a rejection through ``incube``
            lnl_p = loglike(torch.clamp(prop, 1e-12, 1.0 - 1e-12))
            ok = incube & (lnl_p > lstar)
            if use_slide and is_reset:
                ok_slide = s_in & (lnl_p > lstar) & (
                    torch.log(_rand(gen, K)) < s_qc)
                ok = torch.where(pick, ok_slide, ok)
            active = ~frozen
            ok = ok & active
            x0 = torch.where(ok[:, None], prop, x0)
            lnl0 = torch.where(ok, lnl_p, lnl0)
            frozen = frozen | pick | ok
            shrink = active & ~pick & ~ok
            t_lo = torch.where(shrink & (t < 0.0), t, t_lo)
            t_hi = torch.where(shrink & (t >= 0.0), t, t_hi)
            # bracket-scale feedback from the slice updates only
            n_ok = torch.sum(ok & ~pick).to(F64)
            acc_evt = acc_evt + n_ok
            if is_reset:
                first_evt = first_evt + n_ok
                upd_cnt = upd_cnt + torch.sum(active & ~pick).to(F64)
        denom = torch.clamp(upd_cnt, min=1.0)
        return x0, lnl0, acc_evt / denom, first_evt / denom

    kern = walk_kernel if kernel == "walk" else slice_kernel

    # per-batch shrinkage bookkeeping (a batch of K deletions == K
    # sequential deletions at live counts N..N-K+1)
    counts = nlive - torch.arange(kbatch, dtype=F64, device=dev)
    dlnx_per = 1.0 / counts
    lnx_offsets = torch.cat([torch.zeros(1, dtype=F64, device=dev),
                             torch.cumsum(dlnx_per, 0)[:-1]])
    log_dlnx = torch.log(dlnx_per)
    dlnx_batch = torch.sum(dlnx_per)
    log_nlive = math.log(nlive)

    def iteration(u, lnl, gen, scale, lnz, ln_x):
        order = torch.argsort(lnl, stable=True)
        u = u[order]
        lnl = lnl[order]
        lstar = lnl[kbatch - 1]            # hard floor for replacements
        dead_u = u[:kbatch]
        dead_lnl = lnl[:kbatch]
        lnx0 = ln_x
        batch_lw = dead_lnl + (ln_x - lnx_offsets) + log_dlnx
        lnz = torch.logsumexp(torch.cat([lnz.reshape(1), batch_lw]), 0)
        ln_x = ln_x - dlnx_batch

        seed_idx = _randint(gen, kbatch, nlive, kbatch)
        walk_u, walk_lnl, acc, first = kern(u, u[seed_idx], lnl[seed_idx],
                                            gen, scale, lstar)
        # insertion rank of each replacement among the nlive - kbatch
        # survivors: uniform when the kernel samples the constrained prior
        ranks = torch.sum(lnl[kbatch:][None, :] < walk_lnl[:, None], dim=1)
        u = torch.cat([walk_u, u[kbatch:]])
        lnl = torch.cat([walk_lnl, lnl[kbatch:]])
        # termination statistic from the post-refill live set
        lnz_live = torch.logsumexp(lnl, 0) - log_nlive + ln_x
        delta = torch.logaddexp(lnz, lnz_live) - lnz
        if kernel == "walk":
            # toward ~40% acceptance
            scale = torch.where(acc < 0.15, scale * 0.7,
                                torch.where(acc > 0.6, scale * 1.3, scale))
            scale = torch.clamp(scale, 1e-3, 2.0)
        else:
            # shrink when updates exhaust their budget too often, grow
            # when the first draw usually lands inside the slice
            scale = torch.where(acc < 0.75, scale * 0.7,
                                torch.where(first > 0.5, scale * 1.3,
                                            scale))
            scale = torch.clamp(scale, 1e-3, 10.0)
        return (u, lnl, scale, lnz, ln_x, dead_u, dead_lnl, acc, delta,
                ranks, lnx0, first)

    return iteration


def _make_block(like, nlive, kbatch, nsteps, slide_moves=None,
                kernel="slice", diag=False):
    """``block(u, lnl, gen, scale, lnz, ln_x, todo)``: ``todo`` iterations
    on the device; returns the carried state ``(u, lnl, scale, lnz,
    ln_x)`` and the stacked per-iteration outputs (the dead-point ring
    ``dead_u`` (todo, kbatch, ndim), ``dead_lnl``, and the ``acc``,
    ``delta``, ``ranks``, ``lnx0`` traces). ``diag`` (the device
    diagnostics plane) also stacks the walk-scale and first-draw
    acceptance traces ``scale_tr``/``first_tr``, values each iteration
    already returns."""
    it_fn = _make_iteration(like, nlive, kbatch, nsteps,
                            slide_moves=slide_moves, kernel=kernel)
    names = ("dead_u", "dead_lnl", "acc", "delta", "ranks", "lnx0")
    if diag:
        names += ("scale_tr", "first_tr")

    def block(u, lnl, gen, scale, lnz, ln_x, todo):
        ys = []
        for _ in range(todo):
            (u, lnl, scale, lnz, ln_x, du, dl, acc, delta, ranks, lnx0,
             first) = it_fn(u, lnl, gen, scale, lnz, ln_x)
            ys.append((du, dl, acc, delta, ranks, lnx0)
                      + ((scale, first) if diag else ()))
        cols = [torch.stack(c) for c in zip(*ys)]
        return (u, lnl, scale, lnz, ln_x), dict(zip(names, cols))

    return block


def _diag_heartbeat(snap, accs, kernel):
    """The plane's heartbeat keys from one block's traces (host math on
    the snapshot), the gauges set: the walk scale's range, and for the
    slice kernel the shrink-budget exhaustion fraction (``1 - acc``, its
    completed-update rate) and the first-draw acceptance."""
    sc, fi = snap["scale_tr"], snap["first_tr"]
    hb = dict(scale_min=round(float(sc.min()), 4),
              scale_max=round(float(sc.max()), 4))
    if kernel == "slice":
        hb["budget_exhaust_frac"] = round(float(np.mean(1.0 - accs)), 4)
        hb["first_accept_frac"] = round(float(fi.mean()), 4)
    reg = telemetry.registry()
    reg.gauge("walk_scale").set(float(sc[-1]))
    if kernel == "slice":
        reg.gauge("budget_exhaust_frac").set(hb["budget_exhaust_frac"])
    return hb


def run_nested(like, outdir=None, **kw):
    """Nested sampling over a walker-batched likelihood (``loglike_batch``
    on ``(W, ndim)`` float64 tensors, ``from_unit``, ``params``,
    ``ndim``, ``device``); keyword arguments as :func:`_run_nested_impl`.

    Returns a dict with ``log_evidence``, ``log_evidence_err``,
    ``posterior_samples`` (equal-weight), ``samples``/``log_weights``
    (the dead points), ``insertion_rank`` (the pooled KS verdict, blocked
    path), ``dispatch_stats`` (blocks and host syncs per iteration) and
    ``dispatch_timing``, and writes ``<label>_result.json`` and
    ``<label>_nested.npz`` into ``outdir``.

    Checkpoint/resume: at block boundaries, every ``checkpoint_every``
    iterations, the full state (live points, dead ledger, evidence
    accumulator, generator state, walk scale) goes to
    ``<label>_nested_ckpt.npz``; with ``resume=True`` a compatible
    checkpoint continues the run with the same random stream. A
    checkpoint from another geometry (``nlive``, ``kbatch``, ``nsteps``,
    ``block_iters``, ``kernel``, the model) starts fresh. It is removed
    when the run converges.

    A circuit-breaker :class:`PlatformDemotion` is re-entered here in
    process for the ``mega -> classic`` rung (resuming from the
    checkpoint) and propagated at the bottom."""
    while True:
        try:
            return _run_nested_impl(like, outdir=outdir, **kw)
        except PlatformDemotion as d:
            if not apply_demotion(d):
                raise
            _log.warning("re-entering the nested run on the %s path "
                         "(resume from checkpoint)", d.to_level)
            kw["resume"] = True


def _run_nested_impl(like, outdir=None, nlive=500, dlogz=0.1, nsteps=None,
                     kbatch=None, seed=0, max_iter=100000, verbose=True,
                     label="result", resume=True, checkpoint_every=50,
                     slide_moves=None, block_iters=None, kernel=None):
    """One attempt of :func:`run_nested`: ``block_iters`` (or
    ``EWT_NESTED_BLOCK``) 0, the reference's per-iteration path, runs the
    blocked walk one iteration a block (module docstring)."""
    block_iters = _resolve_block_iters(block_iters)
    diag = devicemetrics.enabled() and block_iters > 0
    if block_iters <= 0:
        if not _PERITER_NOTED:
            _PERITER_NOTED.append(True)
            _log.info("block_iters 0 (the per-iteration path): the blocked "
                      "walk one iteration a block, the same dead points")
        if kernel not in (None, "walk"):
            _log.warning("kernel=%r ignored: the per-iteration path always "
                         "runs the walk kernel", kernel)
        block_iters, kernel = 1, "walk"
    kernel = kernel or "slice"
    if kernel not in ("slice", "walk"):
        raise ValueError(f"unknown nested kernel {kernel!r} "
                         "(use 'slice' or 'walk')")
    if nsteps is None:
        # the walk keeps the seed budget; the slice kernel needs ~1.5*ndim
        # complete updates to decorrelate a replacement from its seed, at
        # _SLICE_SHRINK_BUDGET eval rounds per update
        nsteps = 25 if kernel == "walk" else \
            _SLICE_SHRINK_BUDGET * max(8, int(np.ceil(1.5 * like.ndim)))
    return _run_nested_blocked(
        like, outdir=outdir, nlive=nlive, dlogz=dlogz, nsteps=nsteps,
        kbatch=kbatch, seed=seed, max_iter=max_iter, verbose=verbose,
        label=label, resume=resume, checkpoint_every=checkpoint_every,
        slide_moves=slide_moves, block_iters=block_iters, kernel=kernel,
        diag=diag)


def _ckpt_load_compatible(ckpt_path, want):
    """The checkpoint's fields iff its identity matches ``want``, else
    None (a stale checkpoint of another configuration must not be
    resumed: its live points, shrinkage schedule and random stream would
    all be wrong)."""
    with np.load(ckpt_path, allow_pickle=False) as z:
        for k, v in want.items():
            if k not in z.files or str(z[k]) != str(v):
                _log.warning(
                    "NS checkpoint incompatible (%s: %s != %s); "
                    "starting fresh", k,
                    z[k] if k in z.files else "missing", v)
                return None
        return {k: z[k] for k in z.files}


def _fresh_live(like, nlive, gen):
    """The initial live set: ``nlive`` uniform draws in the unit cube and
    their lnL, re-drawing non-finite starters (up to 20 rounds, each one
    batched call over the whole set). Returns ``(u, lnl, redraws)``."""
    u = _rand(gen, nlive, like.ndim)
    lnl = like.loglike_batch(like.from_unit(u))
    redraws = 0
    for _ in range(20):
        bad = ~torch.isfinite(lnl)
        if not bool(torch.any(bad)):
            break
        u2 = _rand(gen, nlive, like.ndim)
        u = torch.where(bad[:, None], u2, u)
        lnl = like.loglike_batch(like.from_unit(u))
        redraws += 1
    return u, lnl, redraws


def _run_nested_blocked(like, outdir, nlive, dlogz, nsteps, kbatch, seed,
                        max_iter, verbose, label, resume, checkpoint_every,
                        slide_moves, block_iters, kernel, diag=False):
    """The blocked, device-resident hot loop (module docstring); ``diag``
    arms the diagnostics plane's traces."""
    nd = like.ndim
    kbatch = kbatch or max(1, nlive // 5)
    dev = _device(like)
    ckpt_path = None
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
        ckpt_path = os.path.join(outdir, f"{label}_nested_ckpt.npz")

    counts = nlive - np.arange(kbatch)
    dlnx_per = 1.0 / counts
    lnx_offsets = np.concatenate([[0.0], np.cumsum(dlnx_per)[:-1]])
    slide_eff = slide_effective(like, slide_moves)

    # the block geometry, the generator's device type and the model join
    # the checkpoint identity
    want = dict(nlive=nlive, kbatch=kbatch, seed=seed, ndim=nd,
                nsteps=nsteps, block_iters=block_iters, kernel=kernel,
                slide=int(slide_eff), params_fp=params_fingerprint(like),
                rng=dev.type)
    z = None
    if resume and ckpt_path is not None:
        # the primary reads; every rank resumes from what it read
        def read():
            resolved = resolve_checkpoint(ckpt_path,
                                          what="nested checkpoint")
            return None if resolved is None \
                else _ckpt_load_compatible(resolved, want)
        z = from_primary(read)
    gen = torch.Generator(device=dev)
    ks_blocks = []
    n_dispatch = n_sync = 0
    fresh_calls = 0
    if z is not None:
        u = torch.as_tensor(z["u"], dtype=F64, device=dev)
        lnl = torch.as_tensor(z["lnl"], dtype=F64, device=dev)
        gen.set_state(torch.as_tensor(z["rng_state"], dtype=torch.uint8))
        scale, ln_x, lnz = float(z["scale"]), float(z["ln_x"]), \
            float(z["lnz"])
        it = int(z["it"])
        dead_u = [z["dead_u"]] if len(z["dead_u"]) else []
        dead_lnl = [z["dead_lnl"]] if len(z["dead_lnl"]) else []
        dead_lnx = [z["dead_lnx"]] if len(z["dead_lnx"]) else []
        dead_dlnx = [z["dead_dlnx"]] if len(z["dead_dlnx"]) else []
        ranks_all = [z["ranks"]] if len(z["ranks"]) else []
        # scheduling provenance stays cumulative across resumes
        ks_blocks = [float(v) for v in z["ks_blocks"]]
        n_dispatch, n_sync = int(z["n_dispatch"]), int(z["n_sync"])
        if verbose:
            _log.info("NS resuming from iteration %d (block_iters=%d, "
                      "kernel=%s)", it, block_iters, kernel)
    else:
        gen.manual_seed(int(seed))
        u, lnl, redraws = _fresh_live(like, nlive, gen)
        fresh_calls = 1 + redraws
        dead_u, dead_lnl, dead_lnx, dead_dlnx, ranks_all = [], [], [], [], []
        ln_x, scale, it, lnz = 0.0, 0.5, 0, -np.inf
    ckpt_dispatch, it0 = n_dispatch, it
    scale_d, lnz_d, lnx_d = (torch.tensor(v, dtype=F64, device=dev)
                             for v in (scale, lnz, ln_x))
    block = _make_block(like, nlive, kbatch, nsteps,
                        slide_moves=slide_moves, kernel=kernel, diag=diag)

    def _write_ckpt(state, n_led, it_now, nd_now, ns_now, n_ks):
        """One block-boundary checkpoint (host snapshot arrays and the
        ledger up to ``n_led`` blocks), atomic and durable; the primary
        process's alone."""
        if ckpt_path is None or not is_primary():
            return
        tmp = ckpt_path[:-len(".npz")] + ".tmp.npz"

        def cat(parts, empty):
            return np.concatenate(parts[:n_led]) if n_led else empty
        np.savez(
            tmp, u=state["u"], lnl=state["lnl"],
            rng_state=state["rng_state"], scale=state["scale"],
            ln_x=state["ln_x"], lnz=state["lnz"], it=it_now,
            n_dispatch=nd_now, n_sync=ns_now,
            ks_blocks=np.asarray(ks_blocks[:n_ks], dtype=np.float64),
            dead_u=cat(dead_u, np.zeros((0, nd))),
            dead_lnl=cat(dead_lnl, np.zeros(0)),
            dead_lnx=cat(dead_lnx, np.zeros(0)),
            dead_dlnx=cat(dead_dlnx, np.zeros(0)),
            ranks=cat(ranks_all, np.zeros(0, dtype=np.int64)), **want)
        checkpoint_replace(tmp, ckpt_path)
        # kill-after-durable-checkpoint injection boundary
        faults.fire("nested.ckpt", path=ckpt_path, iteration=int(it_now))

    pipe = HostPipeline()
    # the breaker's resume point: the last committed block, written after
    # the pending host work drains
    last_commit = {}

    def _breaker_checkpoint():
        pipe.flush()
        if last_commit:
            _write_ckpt(**last_commit)

    supervisor = BlockSupervisor("nested.iteration",
                                 on_checkpoint=_breaker_checkpoint)
    g_sync = telemetry.registry().gauge("host_sync_wall_s")
    g_bubble = telemetry.registry().gauge("block_bubble_s")
    last_ckpt_it = it
    converged = False
    nmax = nlive - kbatch           # insertion-rank support: {0..nmax}
    t_loop = time.perf_counter()
    sync_total_s = 0.0
    t_ready = None
    with telemetry.run_scope(outdir, sampler="nested", label=label,
                             nlive=int(nlive), kbatch=int(kbatch),
                             nsteps=int(nsteps), ndim=int(nd),
                             dlogz=float(dlogz),
                             block_iters=int(block_iters),
                             kernel=str(kernel),
                             param_names=list(like.param_names)) as rec:
        meter = EvalRateMeter(initial_total=it * kbatch * nsteps)
        try:
            while it < max_iter and not converged:
                if preemption_requested():
                    _log.warning("preemption requested: stopping at "
                                 "iteration %d", it)
                    break
                # blocks align to the absolute iteration grid, so a resume
                # from a mid-grid checkpoint first runs a partial block
                todo = min(block_iters - (it % block_iters), max_iter - it)
                t0 = time.perf_counter()
                last_bubble_s = 0.0
                if t_ready is not None:
                    last_bubble_s = t0 - t_ready
                    g_bubble.set(last_bubble_s)
                with profiling.span("ns.dispatch", it=it, iters=todo):
                    (u, lnl, scale_d, lnz_d, lnx_d), ys = supervisor.call(
                        lambda: block(u, lnl, gen, scale_d, lnz_d, lnx_d,
                                      todo),
                        gen=gen, iteration_idx=int(it),
                        block_iters=int(todo))
                rng_state = gen.get_state().numpy()
                n_dispatch += 1
                # the card is busy with this block: the previous block's
                # host work runs in the gap
                pipe.run_pending()
                # ---- commit: the one host sync per block ------------- #
                t1 = time.perf_counter()
                leaves = dict(u=u, lnl=lnl, scale=scale_d, lnz=lnz_d,
                              ln_x=lnx_d, **ys)
                with profiling.span("ns.commit", it=it, iters=todo):
                    snap = supervisor.call(lambda: host_snapshot(leaves),
                                           retryable=False,
                                           site="nested.commit",
                                           iteration=int(it))
                n_sync += 1
                t2 = t_ready = time.perf_counter()
                sync_total_s += t2 - t1
                g_sync.set(t2 - t1)
                du = snap["dead_u"].reshape(-1, nd)
                dl = snap["dead_lnl"].reshape(-1)
                rk = snap["ranks"].reshape(-1)
                dead_u.append(du)
                dead_lnl.append(dl)
                dead_lnx.append((snap["lnx0"][:, None]
                                 - lnx_offsets[None, :]).reshape(-1))
                dead_dlnx.append(np.tile(dlnx_per, todo))
                ranks_all.append(rk)
                _escalate_nonfinite_dead(du, dl, outdir, it)
                lnz, ln_x = float(snap["lnz"]), float(snap["ln_x"])
                scale = float(snap["scale"])
                it += todo
                meter.add(todo * kbatch * nsteps)
                # termination at the block boundary: the run would have
                # stopped at the first crossing; the extra iterations of
                # the block are valid ones that only tighten the estimate
                deltas, accs = snap["delta"], snap["acc"]
                converged = bool(np.any(deltas < dlogz))
                profiling.capture_tick()
                flight_recorder().note_state(
                    sampler="nested", outdir=outdir, iteration=it, lnz=lnz,
                    scale=scale, block_iters=int(block_iters))
                ks = insertion_rank_ks(rk, nmax)
                if ks is not None:
                    ks_blocks.append(ks)
                due_ckpt = (it - last_ckpt_it >= checkpoint_every
                            or it >= max_iter or converged)
                if due_ckpt:
                    last_ckpt_it = it
                stats = dict(iteration=it, iters=todo, block_s=t2 - t0,
                             sync_s=t2 - t1, evals=todo * kbatch * nsteps,
                             walkers=kbatch, lnz=lnz,
                             dlogz=float(deltas[-1]),
                             accept=float(accs[-1]), scale=scale, ks=ks)
                state = dict(u=snap["u"], lnl=snap["lnl"],
                             rng_state=rng_state, scale=snap["scale"],
                             ln_x=snap["ln_x"], lnz=snap["lnz"])
                last_commit.clear()
                last_commit.update(state=state, n_led=len(dead_u),
                                   it_now=it, nd_now=n_dispatch,
                                   ns_now=n_sync, n_ks=len(ks_blocks))
                hb = None
                if rec.enabled:
                    hb = dict(iteration=it, lnz=round(lnz, 3),
                              dlogz=round(stats["dlogz"], 4),
                              accept=round(stats["accept"], 3),
                              scale=round(scale, 4),
                              evals_per_s=round(meter.window_rate(), 1),
                              evals_total=int(meter.total),
                              host_sync_wall_s=round(t2 - t1, 4),
                              block_bubble_s=round(last_bubble_s, 4))
                    if ks is not None:
                        hb["insertion_ks"] = round(ks, 4)
                        telemetry.registry().gauge("insertion_ks").set(
                            float(ks))
                    mem = profiling.memory_watermark(dev)
                    if mem is not None:
                        hb.update(mem)
                    rss = profiling.host_rss_bytes()
                    if rss is not None:
                        hb["rss_bytes"] = rss
                    routes = telemetry.route_summary()
                    if routes:
                        hb["pallas_path"] = routes
                    if diag:
                        hb.update(_diag_heartbeat(snap, accs, kernel))

                def _host_work(commit=dict(last_commit), due_ckpt=due_ckpt,
                               stats=stats, hb=hb):
                    with profiling.span("ns.host_work",
                                        it=commit["it_now"]):
                        _host_files(commit, due_ckpt)
                    if hb is not None:
                        rec.heartbeat(**hb)
                    if verbose:
                        _log.info(
                            "NS it=%d lnZ=%.3f dlogz=%.4f acc=%.2f "
                            "scale=%.3f ks=%.3f evals/s=%.1f",
                            stats["iteration"], stats["lnz"],
                            stats["dlogz"], stats["accept"], stats["scale"],
                            stats["ks"] if stats["ks"] is not None
                            else float("nan"),
                            stats["evals"] / stats["block_s"],
                            extra={"nested_stats": stats})

                def _host_files(commit, due_ckpt):
                    if due_ckpt:
                        _write_ckpt(**commit)
                        rec.checkpoint(iteration=commit["it_now"])
                pipe.defer(_host_work)
        finally:
            # the last block's checkpoint and log line land before the
            # caller reads the directory
            pipe.flush()
        rec.heartbeat(iteration=it, lnz=round(lnz, 3),
                      converged=bool(converged),
                      evals_per_s=round(meter.rate(), 1),
                      evals_total=int(meter.total))
    loop_s = time.perf_counter() - t_loop

    # a converged run's checkpoint is removed; one stopped early (a
    # preemption) keeps its last block resumable
    if converged and ckpt_path is not None and is_primary():
        remove_checkpoint(ckpt_path)
    elif not converged and it > last_ckpt_it and last_commit:
        _write_ckpt(**last_commit)

    rk_pooled = (np.concatenate(ranks_all) if ranks_all
                 else np.zeros(0, dtype=np.int64))
    ks_pooled = insertion_rank_ks(rk_pooled, nmax)
    insertion = None
    if ks_pooled is not None:
        insertion = dict(
            ks_pooled=round(ks_pooled, 5),
            ks_block_worst=round(max(ks_blocks), 5) if ks_blocks else None,
            n=int(rk_pooled.size), n_blocks=len(ks_blocks),
            **insertion_rank_pass(
                ks_pooled, rk_pooled.size,
                n_eff=insertion_rank_neff(rk_pooled.size, nlive, kbatch)))
    nb = max(n_dispatch - ckpt_dispatch, 1)
    its = max(it, 1)
    result = _finalize(
        like, outdir, label, seed, nlive, kbatch, nsteps, it, converged,
        u, lnl, ln_x, dead_u, dead_lnl, dead_lnx, dead_dlnx,
        slide_eff=slide_eff,
        # deterministic scheduling provenance (cumulative across resumes)
        dispatch_stats=dict(
            dispatches=n_dispatch, host_syncs=n_sync, iterations=it,
            block_iters=block_iters,
            dispatches_per_iteration=round(n_dispatch / its, 4),
            host_syncs_per_iteration=round(n_sync / its, 4)),
        # this run's wall clock: returned, never written
        dispatch_timing=dict(
            loop_wall_s=loop_s, host_sync_wall_s=sync_total_s,
            sync_wall_per_block_s=sync_total_s / nb,
            blocks=n_dispatch - ckpt_dispatch, fresh_live_calls=fresh_calls,
            evals=meter.total - it0 * kbatch * nsteps,
            walker_evals_per_s=meter.rate()),
        insertion_rank=insertion, block_iters=block_iters, kernel=kernel)
    if verbose:
        _log.info("NS done: it=%d lnZ=%.4f +- %.4f converged=%s",
                  it, result["log_evidence"], result["log_evidence_err"],
                  converged, extra={"nested_summary": dict(
                      result["dispatch_stats"], **result["dispatch_timing"],
                      converged=converged, nsteps=nsteps, kbatch=kbatch,
                      nlive=nlive)})
    return result


def _escalate_nonfinite_dead(du, dl, outdir, it):
    """Non-finite dead points (the likelihoods map NaN to -inf, so the test
    is ~isfinite): live points are redrawn or walked to finite lnL, so any
    such point means a bad evaluation leaked into the evidence. Counted
    (``nonfinite_eval{where=nested}``), recorded and dumped once. Fault
    site ``nested.nonfinite`` plants one (on this check's copy; the ledger
    is left as it is)."""
    spec = faults.fire("nested.nonfinite", iteration=int(it))
    if spec is not None and spec.kind == "nonfinite":
        dl = dl.copy()
        dl[0] = np.nan
    bad = ~np.isfinite(dl)
    nbad = int(bad.sum())
    if not nbad:
        return
    _log.warning("NS iteration block at %d: %d non-finite dead points, "
                 "first at u=%s", it, nbad, du[bad][0].tolist())
    telemetry.registry().counter("nonfinite_eval", where="nested").inc(nbad)
    fr = flight_recorder()
    fr.record("nonfinite_eval", where="nested", count=nbad, iteration=it)
    fr.anomaly("nonfinite_eval", run_dir=outdir,
               once_key=f"nonfinite_eval:{outdir}", iteration=it,
               n_bad=nbad, bad_u=du[bad][:8], bad_lnl=dl[bad][:8])


def _finalize(like, outdir, label, seed, nlive, kbatch, nsteps, it,
              converged, u, lnl, ln_x, dead_u, dead_lnl, dead_lnx,
              dead_dlnx, slide_eff, dispatch_stats, insertion_rank,
              block_iters=0, kernel="walk", dispatch_timing=None):
    """Run epilogue: fold the remaining live points, compute evidence,
    weights and posterior, write the Bilby-style result."""
    u = np.asarray(u.cpu() if torch.is_tensor(u) else u)
    lnl = np.asarray(lnl.cpu() if torch.is_tensor(lnl) else lnl)
    order = np.argsort(lnl, kind="stable")
    dead_u = dead_u + [u[order]]
    dead_lnl = dead_lnl + [lnl[order]]
    dead_lnx = dead_lnx + [np.full(nlive, ln_x)]
    dead_dlnx = dead_dlnx + [np.full(nlive, 1.0 / nlive)]

    samples_u = np.concatenate(dead_u)
    lnl_all = np.concatenate(dead_lnl)
    lnx_all = np.concatenate(dead_lnx)
    # weight_i = L_i * X_i * dlnx_i
    logw = lnl_all + lnx_all + np.log(np.concatenate(dead_dlnx))
    lnz = _logsumexp(logw)
    logw_norm = logw - lnz
    # sandwich error estimate: information H / nlive
    h = float(np.sum(np.exp(logw_norm) * (lnl_all - lnz)))
    lnz_err = float(np.sqrt(max(h, 0.0) / nlive))

    theta_all = like.from_unit(torch.as_tensor(
        samples_u, dtype=F64, device=_device(like))).cpu().numpy()

    # equal-weight posterior resampling
    rng = np.random.default_rng(seed)
    w = np.exp(logw_norm - logw_norm.max())
    w /= w.sum()
    neff = int(1.0 / np.sum(w ** 2))
    idx = rng.choice(len(w), size=max(neff, 100), p=w)
    posterior = theta_all[idx]

    # the written result holds only sampling-determined fields, so
    # kill-and-resume reproduces it byte for byte
    insertion_written = None
    if insertion_rank is not None:
        insertion_written = {
            k: insertion_rank[k]
            for k in ("ks_pooled", "n", "n_eff", "pass", "ks_sqrt_n",
                      "crit")
            if k in insertion_rank}
    result = dict(
        label=label,
        converged=bool(converged),
        log_evidence=float(lnz),
        log_evidence_err=lnz_err,
        log_noise_evidence=float("nan"),
        sampler="enterprise_warp_tpu_torch.nested",
        slide_moves_effective=slide_eff,
        block_iters=int(block_iters),
        kernel=kernel,
        insertion_rank=insertion_written,
        parameter_labels=list(like.param_names),
        posterior={n: posterior[:, i].tolist()
                   for i, n in enumerate(like.param_names)},
        num_iterations=it,
        num_likelihood_evaluations=int((it * kbatch * nsteps) + nlive),
    )
    if outdir is not None and is_primary():
        os.makedirs(outdir, exist_ok=True)
        atomic_write_json(os.path.join(outdir, f"{label}_result.json"),
                          result, indent=None)
        np.savez(os.path.join(outdir, f"{label}_nested.npz"),
                 samples=theta_all, log_weights=logw_norm,
                 log_likelihoods=lnl_all)
    result["samples"] = theta_all
    result["log_weights"] = logw_norm
    result["posterior_samples"] = posterior
    # wall-clock provenance of this run: returned, never written
    result["dispatch_stats"] = dispatch_stats
    result["dispatch_timing"] = dispatch_timing
    result["insertion_rank"] = insertion_rank
    return result


def _logsumexp(x):
    x = np.asarray(x, dtype=np.float64)
    m = np.max(x)
    return float(m + np.log(np.sum(np.exp(x - m))))
