"""Adaptive parallel-tempering MCMC over a walker-batched likelihood.

Counterpart of ``enterprise_warp_tpu/samplers/ptmcmc.py`` for the paramfile
path: W = ntemps x nchains walkers advance together, each step evaluating
the likelihood once for all walkers, with the reference's jump families
(``_FAM_NAMES`` order, the order of every per-family counter)

- SCAM: single-component adaptive Metropolis along one eigendirection of
  the adapted covariance,
- AM: full adaptive-Metropolis jump from that covariance,
- DE: differential evolution from a history ring of cold walkers,
- prior draw: one random dimension redrawn from its prior, with the
  Metropolis-Hastings asymmetry correction,
- ind: independence draws from a Gaussian fitted to the cold walkers
  (inflated by ``ind_inflate``),
- cg: conditional Gibbs, a ``cg_k``-subset redrawn from that Gaussian's
  exact conditional given the other coordinates,
- kde: a ``cg_k``-subset redrawn from a kernel-density estimate over the
  block-frozen cold cloud,
- ns: the noise-budget slide along one backend's (efac, equad)
  degeneracy curve (where the likelihood has ``noise_pairs``),

each written as a plain function of explicit draws (:func:`propose_ind`,
:func:`propose_cg`, :func:`propose_kde`, :func:`propose_ns`) that returns
the proposal and its exact MH correction. A family with zero weight draws
nothing, so the stream of the others is unchanged. Parallel-tempering
swaps every ``swap_every`` steps with swap-rate ladder adaptation, and
covariance/eigen adaptation plus the ensemble fits between blocks of
``cov_update`` steps. The reference's ``lax.scan`` block is a Python step
loop here; every per-step quantity stays on the likelihood's device and
the host reads one snapshot per block.

On-disk contract (the reference's, so ``python -m
enterprise_warp_tpu.results`` reads a port run unchanged): ``chain_1.txt``
rows are ``[theta..., lnpost, lnlike, accept_rate, pt_accept_rate]`` in
``%.18e``; ``pars.txt`` lists the parameters; ``cov.npy`` holds the jump
covariance; ``state.npz`` (positions, generator state, adaptation state)
provides resume; with ``writeHotChains`` each tempered rung appends its
own ``chain_<T>.txt`` (the ladder is then pinned). Randomness comes from
one explicit ``torch.Generator`` on the likelihood's device; the
reference's threefry streams are not reproduced.

Warm starts, as the reference's: ``anneal_init`` (an SMC-style tempered
bridge 64 -> 2 with multinomial resampling, :meth:`PTSampler.anneal_init`)
and ``advi_init`` (a variational fit whose draws seed the walkers,
``init_x``), both skipped on resume.

The run plane, as the reference's (``utils/telemetry.py``,
``resilience/``): :meth:`PTSampler.sample` runs in a ``run_scope`` on the
output directory (``events.jsonl``: ``run_start``, one ``heartbeat`` and
one ``checkpoint`` per block, ``run_end``); each block goes through
``BlockSupervisor("pt.dispatch")`` (watchdog, retry, demotion, applied in
process by :func:`run_ptmcmc`); the fault sites ``pt.dispatch``,
``pt.ckpt``, ``pt.chain``, ``pt.nonfinite``, ``kernel.health`` and
``psr.quarantine``; a SIGTERM stops the run at a block boundary. Every
per-step count the reference accumulates inside its scan (non-finite
evaluations, the health words' jitter/divergence counts and condition
proxy) accumulates on the device here and is read in the block's one
snapshot. A walker that the likelihood kernel's route rejects
(``ops/megakernel.py:schur_reject``, a chosen NaN of the port) is counted
apart, as ``schur_rejected``, and never as a non-finite evaluation. The
health plane (``EWT_KERNEL_HEALTH``) is armed by default only where no
megakernel route is possible (on the card it needs an explicit
``EWT_KERNEL_HEALTH=1`` and pins the classic chain and its preconditioner
kernel), and walks ``observe -> reeval -> classic -> quarantine``.

The device diagnostics plane, as the reference's
(``utils/devicemetrics.py``; on by default, off with ``EWT_DEVICE_DIAG=0``
or ``EWT_TELEMETRY=0``): each block folds its cold rows, already on the
device, into per-chain moments, extrema and fixed-bin histograms, and
counts each rung's proposals and acceptances by family, all after the
step loop and inside the block's one snapshot (no launch inside a step,
no added host synchronisation; the chain is the same bit for bit with the
plane off). The host keeps the streaming ``MomentLedger`` (split-R-hat
and batch-means ESS at block cadence, the ``diag_*`` keys of
``state.npz``), and each block adds the ``rhat_stream``/``ess_stream``
heartbeat keys, the per-rung gauges, a ``mixing`` event and
``mixing_stats.json``.

Processes (``parallel/distributed.py``): every file write goes through
``is_primary()`` (the chain files, ``pars.txt``, ``cov.npy``,
``mask_stats.json``, ``mixing_stats.json`` and the checkpoint); a
secondary rank streams only its own ``events.<i>.jsonl``. The chain axis
(``mesh=``, a ``chain`` :class:`~..parallel.distributed.ShardLayout`) is
an evaluation split: every rank holds the same replicated state, seed and
proposals, evaluates its ``W / nshard`` walkers, and one ``all_gather``
per evaluation assembles the lnL (and the health words with it). The mesh
plane (``devicemetrics.mesh_enabled()`` and a likelihood with
``_eval_mesh_batch`` and ``mesh_layout``, the sharded joint likelihood):
the per-shard attribution lanes come home on the evaluation's own
collective, are summed on the device over the block and read in its one
snapshot, and each block folds them into a ``MeshStatsLedger``: the
``shard_skew``/``collective_wall_ms``/``straggler_index`` gauges and
heartbeat keys, a ``mesh_stats`` event and ``mesh_stats.json`` (rank
``i``: ``mesh_stats.<i>.json``). It adds no collective and no host
synchronisation to a step.

Not ported (``NotImplementedError``): the ``flow`` proposal family.
"""

from __future__ import annotations

import glob
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .. import F64
from ..io.writers import (atomic_write_json, checkpoint_exists,
                          checkpoint_replace, resolve_checkpoint,
                          write_table)
from ..parallel.distributed import (all_gather_rows, from_primary,
                                    is_primary)
from ..resilience import faults
from ..resilience.supervisor import (BlockSupervisor, PlatformDemotion,
                                     apply_demotion, pin_classic,
                                     preemption_requested)
from ..utils import devicemetrics, profiling, telemetry
from ..utils.diagnostics import cache_hit_summary, throttled_block_worst
from ..utils.flightrec import flight_recorder
from ..utils.logging import EvalRateMeter, get_logger
from .devicestate import chain_slice, host_snapshot
from .evalproto import BLOCK_COMMON

_log = get_logger("ewt.ptmcmc")

_HISTORY = 1000     # DE history ring length
#: the proposal-family order of every per-family counter (jump_probs,
#: fam_accept/fam_propose), the reference's
_FAM_NAMES = ("scam", "am", "de", "pd", "ind", "cg", "kde", "ns", "flow")
_NFAM = len(_FAM_NAMES)
_IND, _CG, _KDE, _NS = 4, 5, 6, 7


@dataclass
class PTState:
    x: torch.Tensor        # (W, ndim) positions
    lnl: torch.Tensor      # (W,)
    lnp: torch.Tensor      # (W,)
    key: np.ndarray        # generator state (uint8)
    cov: np.ndarray        # (ndim, ndim) adapted jump covariance
    history: torch.Tensor  # (_HISTORY, ndim) DE buffer (cold walkers)
    hist_len: int
    step: int
    accepted: torch.Tensor       # (W,) cumulative acceptances
    swaps_accepted: np.ndarray   # (ntemps-1,) per-rung accepted swaps
    swaps_proposed: np.ndarray   # (ntemps-1,) per-rung proposed swaps
    ladder: np.ndarray     # (ntemps,) current temperature ladder


def _temperature_ladder(ntemps, tmax=None):
    if ntemps == 1:
        return np.ones(1)
    c = (tmax ** (1.0 / (ntemps - 1))) if tmax else 1.7
    return c ** np.arange(ntemps)


def block_classes(param_blocks):
    """Per-dimension ``update_mask`` class from the likelihood's parameter
    blocks: 0 one pulsar's block (site), 1 the coupling-only common
    block, 2 a full recompute."""
    pb = param_blocks
    return torch.where(pb >= 0, 0, torch.where(pb == BLOCK_COMMON, 1, 2))


def subset_class(param_blocks, blk_cls, S):
    """Class of each (W, k) subset: maskable only when all its dimensions
    lie in one block, then that block's class; else a full recompute."""
    b_s = param_blocks[S]
    same = torch.all(b_s == b_s[:, :1], dim=1)
    return torch.where(same, blk_cls[S[:, 0]], 2)


# ---------------- the ensemble families, as functions of their draws ---- #
def draw_subsets(cg_rows, group_frac, u_grp, j, perm_u):
    """(W, k) coordinate subsets of the cg and kde families: the
    correlation block ``cg_rows[j]`` where ``u_grp < group_frac``, else a
    uniform random k-subset (the first k of the argsort of the uniforms
    ``perm_u``, (W, ndim))."""
    k = cg_rows.shape[1]
    rand_s = torch.argsort(perm_u, dim=1)[:, :k]
    return torch.where((u_grp < group_frac)[:, None], cg_rows[j], rand_s)


def propose_ind(mean, L, z):
    """Independence draw ``mean + L z`` from the ensemble-fitted Gaussian
    (``L`` the inflated covariance's Cholesky factor, ``z`` (W, ndim))."""
    return mean[None, :] + z @ L.T


def ind_qc(x, prop, mean, iL):
    """The independence family's MH correction log q(x) - log q(x'): the
    Gaussian is the same both ways, so its log-determinant cancels."""
    dx_old = (x - mean[None, :]) @ iL.T
    dx_new = (prop - mean[None, :]) @ iL.T
    return 0.5 * (torch.sum(dx_new ** 2, dim=-1)
                  - torch.sum(dx_old ** 2, dim=-1))


def propose_cg(x, mean, lam, S, z):
    """Conditional Gibbs: redraw the subset ``S`` (W, k) from the fitted
    Gaussian's exact conditional given the other coordinates,
    ``x_S | x_rest ~ N(mean_S - Lam_SS^-1 b, Lam_SS^-1)`` with ``b =
    Lam_{S,rest} (x_rest - mean_rest)``, through the Cholesky factor of
    ``Lam_SS`` (``Lam`` the precision, ``z`` (W, k) standard normals).
    Returns ``(prop, qc)``: the conditional's parameters depend only on the
    unchanged coordinates, so the correction is the two draws' quadratic
    forms."""
    d = x - mean[None, :]
    lam_rows = lam[S]                                      # (W, k, nd)
    lam_ss = torch.gather(lam_rows, 2, S[:, None, :].expand(-1, S.shape[1],
                                                           -1))
    d_s = torch.gather(d, 1, S)
    b = (lam_rows @ d[:, :, None] - lam_ss @ d_s[:, :, None])[..., 0]
    Lk = torch.linalg.cholesky_ex(lam_ss)[0]
    LkT = Lk.transpose(1, 2)
    u1 = torch.linalg.solve_triangular(Lk, b[:, :, None], upper=False)
    m = mean[S] - torch.linalg.solve_triangular(LkT, u1, upper=True)[..., 0]
    xs = m + torch.linalg.solve_triangular(LkT, z[:, :, None],
                                           upper=True)[..., 0]
    r_old = (LkT @ (torch.gather(x, 1, S) - m)[:, :, None])[..., 0]
    qc = 0.5 * (torch.sum(z ** 2, dim=-1) - torch.sum(r_old ** 2, dim=-1))
    return x.scatter(1, S, xs), qc


def kde_logq(v, S, pts, bw):
    """Log density of the subset values ``v`` (W, k) under the product-
    Gaussian KDE of the cloud ``pts`` (n, ndim) on the coordinates ``S``
    (W, k), bandwidths ``bw`` (ndim,)."""
    p_s = pts.T[S]                                         # (W, k, n)
    bw_s = bw[S]
    d = (v[:, :, None] - p_s) / bw_s[:, :, None]
    return (torch.logsumexp(-0.5 * torch.sum(d * d, dim=1), dim=1)
            - math.log(pts.shape[0]) - torch.sum(torch.log(bw_s), dim=1))


def propose_kde(x, pts, bw, S, m, z):
    """KDE subset independence: the subset ``S`` takes cloud point
    ``m``'s values plus ``bw * z`` (``z`` (W, k)); the correction is the
    mixture density at the old and the new subset values."""
    xs = pts[m[:, None], S] + bw[S] * z
    qc = kde_logq(torch.gather(x, 1, S), S, pts, bw) \
        - kde_logq(xs, S, pts, bw)
    return x.scatter(1, S, xs), qc


def propose_ns(x, pairs, b, u_glob, z, u_f):
    """The noise-budget slide: redraw the equad share f of backend pair
    ``b``'s total white variance ``v = efac^2 s2 + 10^(2 equad)`` with v
    held fixed, globally (equad uniform over its reachable prior range,
    where ``u_glob < 0.5``, from the uniform ``u_f``) or locally (a
    logit-normal step of 0.8 ``z``). ``pairs``: the tensors ``(ie, iq,
    s2, qlo, qhi)`` of the likelihood's ``noise_pairs`` and the equad
    priors. Returns ``(prop, qc, ie)``; a global move from a state the
    reverse draw cannot reach is rejected (``qc = -inf``)."""
    p_ie, p_iq, p_s2, p_qlo, p_qhi = pairs
    ie, iq, s2 = p_ie[b], p_iq[b], p_s2[b]
    qlo, qhi = p_qlo[b], p_qhi[b]
    e = torch.gather(x, 1, ie[:, None])[:, 0]
    q = torch.gather(x, 1, iq[:, None])[:, 0]
    Q2 = 10.0 ** (2.0 * q)
    v = e * e * s2 + Q2
    f_old = torch.clamp(Q2 / v, 1e-15, 1.0 - 1e-12)
    upper = torch.minimum(qhi, 0.5 * torch.log10(v) - 1e-6)
    lo = torch.minimum(qlo, upper - 1e-6)
    glob_ok = (qlo < upper) & (q >= lo) & (q <= upper)
    q_glob = lo + (upper - lo) * u_f
    f_glob = torch.clamp(10.0 ** (2.0 * q_glob) / v, 1e-15, 1.0 - 1e-12)
    u_loc = torch.logit(f_old) + 0.8 * z
    f_loc = torch.clamp(torch.sigmoid(u_loc), 1e-15, 1.0 - 1e-12)
    is_glob = u_glob < 0.5
    f = torch.where(is_glob, f_glob, f_loc)
    e_new = torch.sqrt((1.0 - f) * v / s2)
    q_new = 0.5 * torch.log10(f * v)
    qc_glob = torch.log(torch.clamp(e, min=1e-30)) \
        - torch.log(torch.clamp(e_new, min=1e-30))
    qc_glob = torch.where(glob_ok, qc_glob,
                          torch.full_like(qc_glob, -math.inf))
    qc_loc = 0.5 * torch.log1p(-f) - 0.5 * torch.log1p(-f_old)
    qc = torch.where(is_glob, qc_glob, qc_loc)
    prop = x.scatter(1, ie[:, None], e_new[:, None]) \
        .scatter(1, iq[:, None], q_new[:, None])
    return prop, qc, ie


class _ChainSplit:
    """The chain axis's evaluation split of a likelihood: each rank
    evaluates its contiguous ``W / nshard`` walkers and one
    ``all_gather`` assembles the (W,) lnL (the health twin's lnL and
    words packed into the same gathered rows). Every other attribute is
    the likelihood's."""

    def __init__(self, like, mesh, W):
        self._like = like
        self._group = mesh.group
        self._rows = chain_slice(mesh, W)
        self.loglike_batch = self._split
        if hasattr(like, "_eval_health_batch"):
            self._eval_health_batch = self._split_health

    def __getattr__(self, name):
        return getattr(self._like, name)

    def _split(self, x):
        return all_gather_rows(self._like.loglike_batch(x[self._rows]),
                               self._group)

    def _split_health(self, x):
        lnl, hw = self._like._eval_health_batch(x[self._rows])
        rows = torch.cat([lnl[:, None].to(F64),
                          hw.reshape(len(lnl), -1).to(F64)], dim=1)
        g = all_gather_rows(rows, self._group)
        return g[:, 0], g[:, 1:].reshape((g.shape[0],) + hw.shape[1:])


class PTSampler:
    """Adaptive PT-MCMC over a likelihood providing ``loglike_batch``
    ((W, ndim) tensor -> (W,)), ``log_prior``, ``log_prior_dims``,
    ``from_unit``, ``sample_prior`` and ``params``/``param_names``/``ndim``
    (a :class:`~..models.build.PulsarLikelihood`)."""

    def __init__(self, like, outdir, ntemps=2, nchains=8, seed=0,
                 scam_weight=30, am_weight=15, de_weight=50,
                 prior_weight=10, cov_update=1000, swap_every=10,
                 tmax=None, init_cov=None, burn=0, adapt_ladder=True,
                 ladder_t0=1000.0, swap_target=0.25,
                 write_hot_chains=False, init_x=None,
                 ind_weight=0, ind_inflate=1.4,
                 cg_weight=0, cg_k=3, cg_group_frac=0.5,
                 kde_weight=0, kde_bw=None, ns_weight=0,
                 flow=None, flow_weight=0, device=None, mesh=None):
        if flow is not None or flow_weight:
            raise NotImplementedError(
                "the flow proposal family is not ported yet (ROADMAP.md, "
                "Queue 1: serving and flows)")
        self.ntemps = int(ntemps)
        self.nchains = int(nchains)
        self.W = self.ntemps * self.nchains
        # the chain axis: each rank evaluates its share of the walkers
        if mesh is not None and getattr(mesh, "axis", None) == "chain" \
                and mesh.nshard > 1:
            like = _ChainSplit(like, mesh, self.W)
        self.like = like
        self.outdir = outdir
        self.ndim = like.ndim
        self.device = torch.device(device if device is not None else
                                   getattr(like, "device", "cpu"))
        # the noise-budget slide needs the likelihood's (efac, equad)
        # pairs, and each pair's equad prior bounds for its global branch
        self._ns_pairs = list(getattr(like, "noise_pairs", None) or [])
        if not self._ns_pairs:
            ns_weight = 0
        self._ns_qb = []
        for _, iq, _ in self._ns_pairs:
            pr = like.params[iq].prior
            self._ns_qb.append((float(getattr(pr, "lo", -10.0)),
                                float(getattr(pr, "hi", -5.0))))
        weights = np.array([scam_weight, am_weight, de_weight,
                            prior_weight, ind_weight, cg_weight,
                            kde_weight, ns_weight, 0], float)
        self.jump_probs = weights / weights.sum()
        # a uniform that rounds above the cumulative sum's last entry
        # selects the last family that has weight
        self._last_fam = int(np.flatnonzero(self.jump_probs)[-1])
        self.ind_inflate = float(ind_inflate)
        self.cg_k = int(min(max(cg_k, 1), self.ndim))
        self.cg_group_frac = float(cg_group_frac)
        self.kde_bw = kde_bw        # None: Silverman's factor for cg_k dims
        self.cov_update = cov_update
        self.swap_every = swap_every
        self.burn = burn     # steps before covariance adaptation engages
        self.seed = seed
        self.init_ladder = _temperature_ladder(self.ntemps, tmax)
        self.ladder_t0 = float(ladder_t0)
        self.swap_target = float(swap_target)
        self.write_hot = bool(write_hot_chains)
        # hot-chain files are named by rung temperature, which only a
        # static ladder keeps meaningful: writeHotChains pins it
        self.adapt_ladder = adapt_ladder and not self.write_hot
        self.init_cov = init_cov
        # an optional warm start (e.g. ADVI posterior draws): rows are
        # cycled over the walkers; non-finite starters are re-drawn from
        # the prior as any others
        self.init_x = None if init_x is None else np.atleast_2d(
            np.asarray(init_x, dtype=float))
        self._anneal_state = None
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        # per-family cold-rung counters (this process only, not checkpointed)
        self.fam_accept = np.zeros(_NFAM)
        self.fam_propose = np.zeros(_NFAM)
        # update_mask emission: where the likelihood sorts its parameters
        # into blocks (``like.param_blocks``, samplers/evalproto.py), each
        # cold proposal is counted by the block class it touched [site,
        # common, full] into mask_stats.json. The prior draw (one
        # dimension), the subsets of cg and kde (maskable when all their
        # dimensions share one block) and the noise slide (one backend's
        # pair) can stay inside a block; the dense families touch all.
        self.use_maskstats = getattr(like, "param_blocks", None) is not None
        self.mask_counts = np.zeros(3)
        # (step, chain file sizes) of this sampler's last committed block
        self._committed = None
        # the run plane: supervised dispatch (its breaker drains the
        # pending block write first), the block-boundary gauges, and the
        # kernel-health ledgers, one per pulsar
        self._pending = None
        self._supervisor = BlockSupervisor("pt.dispatch",
                                           on_checkpoint=self._drain)
        self._last_sync_s = self._last_bubble_s = 0.0
        self.host_sync_total_s = self.bubble_total_s = 0.0
        self._t_ready = None
        self._g_sync = telemetry.registry().gauge("host_sync_wall_s")
        self._g_bubble = telemetry.registry().gauge("block_bubble_s")
        # the device diagnostics plane: the streaming ledger of the cold
        # chains, the run-cumulative histograms and the per-rung family
        # attribution, folded from each block's snapshot
        self.diag_ledger = (devicemetrics.MomentLedger(self.nchains,
                                                       self.ndim)
                            if devicemetrics.enabled() else None)
        self._hist_lo, self._hist_span = devicemetrics.hist_bounds(
            like.params)
        # the grid on the device once, here: a copy to the device inside
        # a block would be a host synchronisation the plane does not add
        self._hist_grid = (self._tensor(self._hist_lo),
                           self._tensor(self._hist_span))
        self.diag_hist = np.zeros((self.ndim, devicemetrics.DEFAULT_NBINS))
        self.fam_rung_accept = np.zeros((self.ntemps, _NFAM))
        self.fam_rung_propose = np.zeros((self.ntemps, _NFAM))
        self.health = None
        health_env = os.environ.get("EWT_KERNEL_HEALTH")
        if health_env is None:
            from ..ops.routes import _mega_enabled
            arm = not (self.device.type == "cuda" and _mega_enabled())
        else:
            arm = health_env != "0"
        if telemetry.enabled() and arm \
                and hasattr(like, "_eval_health_batch"):
            from ..resilience.integrity import HealthLedger
            names = list(getattr(like, "health_psr_names", None) or ["?"])
            self._health_psrs = names
            self.health = [HealthLedger(psr=n) for n in names]
        # the mesh plane: a sharded joint likelihood's attribution lanes
        self.mesh_stats = None
        if devicemetrics.mesh_enabled() \
                and hasattr(like, "_eval_mesh_batch") \
                and getattr(like, "mesh_layout", None):
            self.mesh_stats = devicemetrics.MeshStatsLedger(like.mesh_layout)
        os.makedirs(outdir, exist_ok=True)

    # ---------------- initialization / resume -------------------------- #
    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=F64, device=self.device)

    def _fresh_state(self):
        if self._anneal_state is not None:
            # one-shot: a later fresh start re-anneals or draws anew
            st, self._anneal_state = self._anneal_state, None
            return st
        rng = np.random.default_rng(self.seed)
        x0 = self.like.sample_prior(rng, self.W)
        if self.init_x is not None:
            reps = int(np.ceil(self.W / len(self.init_x)))
            x0 = np.tile(self.init_x, (reps, 1))[:self.W]
        lnl = self._loglike(self._tensor(x0)).cpu().numpy()
        # re-draw walkers that landed on a non-finite corner: each one is
        # a counted nonfinite_eval, and exhausting the redraws is an
        # anomaly dump
        fr = flight_recorder()
        for _ in range(20):
            bad = ~np.isfinite(lnl)
            if not bad.any():
                break
            telemetry.registry().counter(
                "nonfinite_eval", where="init").inc(int(bad.sum()))
            fr.record("nonfinite_eval", where="init", count=int(bad.sum()))
            x0[bad] = self.like.sample_prior(rng, int(bad.sum()))
            lnl = self._loglike(self._tensor(x0)).cpu().numpy()
        else:
            bad = ~np.isfinite(lnl)
            if bad.any():
                _log.warning("%d walkers start at non-finite lnl after 20 "
                             "prior redraws", int(bad.sum()))
                fr.anomaly("nonfinite_init", run_dir=self.outdir,
                           once_key=f"nonfinite_init:{self.outdir}",
                           n_bad=int(bad.sum()), bad_theta=x0[bad][:8],
                           bad_lnl=lnl[bad][:8])
        x = self._tensor(x0)
        lnp = self.like.log_prior(x)
        cov = self.init_cov if self.init_cov is not None else \
            np.diag(self._prior_scales() ** 2 * 0.01)
        self.gen.manual_seed(int(self.seed))
        return PTState(x=x, lnl=self._tensor(lnl), lnp=lnp,
                       key=self.gen.get_state().numpy(), cov=cov,
                       history=x[:1].repeat(_HISTORY, 1), hist_len=1,
                       step=0,
                       accepted=torch.zeros(self.W, dtype=F64,
                                            device=self.device),
                       swaps_accepted=np.zeros(self.ntemps - 1),
                       swaps_proposed=np.zeros(self.ntemps - 1),
                       ladder=self.init_ladder.copy())

    def _loglike(self, x):
        """lnL at ``x`` outside the block: through the health twin when
        the plane is armed, so that every evaluation of the run takes the
        classic chain it pins."""
        if self.health is not None:
            return self.like._eval_health_batch(x)[0]
        return self.like.loglike_batch(x)

    def _prior_scales(self):
        scales = np.ones(self.ndim)
        for i, p in enumerate(self.like.params):
            pr = p.prior
            if hasattr(pr, "lo"):
                scales[i] = (pr.hi - pr.lo)
            elif hasattr(pr, "sigma"):
                scales[i] = pr.sigma
        return scales

    @property
    def _ckpt_path(self):
        return os.path.join(self.outdir, "state.npz")

    @staticmethod
    def _ckpt_arrays(st, snap):
        """The checkpoint's arrays: the state's tensors from the block's
        host snapshot ``snap``, the host-side rest from ``st``."""
        return dict(x=snap["x"], lnl=snap["lnl"], lnp=snap["lnp"],
                    key=st.key.copy(), cov=st.cov.copy(),
                    history=snap["history"], hist_len=st.hist_len,
                    step=st.step, accepted=snap["accepted"],
                    swaps_accepted=st.swaps_accepted.copy(),
                    swaps_proposed=st.swaps_proposed.copy(),
                    ladder=st.ladder.copy())

    def _write_ckpt(self, arrays):
        """Atomic checkpoint of :meth:`_ckpt_arrays` with an integrity
        sidecar and the previous generation kept
        (``io.writers.checkpoint_replace``). Fault site ``pt.ckpt`` fires
        after the replace: a kill there is the clean boundary crash that
        resume is held against. Only the primary process writes."""
        if not is_primary():
            return
        tmp = self._ckpt_path + ".tmp.npz"
        np.savez(tmp, **arrays)
        checkpoint_replace(tmp, self._ckpt_path)
        faults.fire("pt.ckpt", path=self._ckpt_path,
                    step=int(arrays["step"]))

    def _read_ckpt(self):
        """The resolved checkpoint's arrays (None without one), read by
        the primary and shared with every rank
        (:func:`~..parallel.distributed.from_primary`)."""
        def read():
            ckpt = resolve_checkpoint(self._ckpt_path, what="pt checkpoint")
            if ckpt is None:
                return None
            with np.load(ckpt) as z:
                return {k: z[k] for k in z.files}
        return from_primary(read)

    def _load_state(self, z):
        """The state of the checkpoint arrays ``z``
        (:meth:`_read_ckpt`)."""
        sacc = np.atleast_1d(np.asarray(z["swaps_accepted"], dtype=float))
        sprop = np.atleast_1d(np.asarray(z["swaps_proposed"], dtype=float))
        if sacc.shape != (self.ntemps - 1,):
            sacc = np.zeros(self.ntemps - 1)
            sprop = np.zeros(self.ntemps - 1)
        ladder = (np.asarray(z["ladder"]) if "ladder" in z
                  else self.init_ladder.copy())
        key = np.asarray(z["key"], dtype=np.uint8)
        self.gen.set_state(torch.from_numpy(key.copy()))
        # the plane continues from the checkpointed statistics; the
        # cumulative histogram and family counts only where their shapes
        # match (a rewound checkpoint has none: convergence.py)
        if self.diag_ledger is not None and "diag_counts" in z:
            self.diag_ledger = devicemetrics.MomentLedger.from_state(
                self.nchains, self.ndim,
                {k: z[f"diag_{k}"] for k in
                 ("counts", "mean", "m2", "min", "max")})
            if "diag_hist" in z \
                    and z["diag_hist"].shape == self.diag_hist.shape:
                self.diag_hist = np.asarray(z["diag_hist"], dtype=float)
            if "diag_fam_acc" in z and z["diag_fam_acc"].shape \
                    == self.fam_rung_accept.shape:
                self.fam_rung_accept = np.asarray(z["diag_fam_acc"],
                                                  dtype=float)
                self.fam_rung_propose = np.asarray(z["diag_fam_prop"],
                                                   dtype=float)
        return PTState(x=self._tensor(z["x"]), lnl=self._tensor(z["lnl"]),
                       lnp=self._tensor(z["lnp"]), key=key, cov=z["cov"],
                       history=self._tensor(z["history"]),
                       hist_len=int(z["hist_len"]), step=int(z["step"]),
                       accepted=self._tensor(z["accepted"]),
                       swaps_accepted=sacc, swaps_proposed=sprop,
                       ladder=ladder)

    # ---------------- one block ---------------------------------------- #
    def _host_prep(self, st):
        """Per-block host math (float64 numpy, the reference's line for
        line): eigendecomposition and Cholesky factor of the adapted jump
        covariance, and, where an ensemble family has weight, the fits to
        the cold walkers' cloud. Returns ``(eigvecs, eigvals, chol,
        ind_mean, ind_L, ind_iL, lam, cg_rows, kde_pts, kde_bw)``."""
        cov = st.cov + 1e-12 * np.eye(self.ndim)
        eigvals, eigvecs = np.linalg.eigh(cov)
        eigvals = np.maximum(eigvals, 1e-16)
        chol = np.linalg.cholesky(cov)
        if self.jump_probs[4:].sum() > 0:
            # N(mean, inflate^2 cov) refit to the cold cloud; a degenerate
            # cloud (identical walkers, too few chains) keeps the adapted
            # covariance
            cold_x = st.x[:self.nchains].cpu().numpy()
            ind_mean = cold_x.mean(axis=0)
            ind_cov = cov
            if self.nchains > 2 * self.ndim:
                c = np.cov(cold_x.T) + 1e-12 * np.eye(self.ndim)
                if np.all(np.isfinite(c)) and \
                        np.linalg.eigvalsh(c)[0] > 0:
                    ind_cov = c
            ind_L = np.linalg.cholesky(self.ind_inflate ** 2 * ind_cov)
            ind_iL = np.linalg.inv(ind_L)
            # the uninflated precision for the conditional Gibbs family
            lam = np.linalg.inv(ind_cov)
            # correlation blocks: row j is dim j and its (cg_k - 1)
            # strongest |corr| partners, the dims that must move jointly
            sd = np.sqrt(np.diag(ind_cov))
            corr = np.abs(ind_cov / np.outer(sd, sd))
            cg_rows = np.argsort(-corr, axis=1)[:, :self.cg_k]
            # the block-frozen cloud, per-dim Silverman bandwidths
            kde_pts = cold_x.copy()
            if self.kde_bw is not None:
                bw_fac = float(self.kde_bw)
            else:
                k, n = self.cg_k, max(len(kde_pts), 2)
                bw_fac = (4.0 / (k + 2)) ** (1.0 / (k + 4)) \
                    * n ** (-1.0 / (k + 4))
            kde_bw = np.maximum(bw_fac * cold_x.std(axis=0), 1e-12)
        else:
            ind_mean = np.zeros(self.ndim)
            ind_L = ind_iL = lam = np.eye(self.ndim)
            cg_rows = np.tile(np.arange(self.cg_k), (self.ndim, 1))
            kde_pts = np.zeros((1, self.ndim))
            kde_bw = np.ones(self.ndim)
        return (eigvecs, eigvals, chol, ind_mean, ind_L, ind_iL, lam,
                cg_rows, kde_pts, kde_bw)

    def _run_block(self, st, todo, temps=None):
        """Advance ``st`` by ``todo`` steps at the ladder's temperatures
        (or at ``temps``, one per walker) through the supervisor, then
        escalate the block's non-finite and health counts; returns the
        block's emissions ``(x (todo, n, nd), lnl, lnp)`` as numpy, ``n``
        the cold rung's ``nchains`` walkers, or all ``W`` with
        ``writeHotChains``. The block's whole host snapshot stays in
        ``self._snap``."""
        snap = self._supervisor.call(
            lambda: self._advance(st, todo, temps), gen=self.gen,
            step=int(st.step), block_steps=int(todo))
        self._snap = snap
        spec = faults.fire("pt.nonfinite", step=int(st.step))
        if spec is not None and spec.kind == "nonfinite":
            # a planted bad evaluation: the escalation below sees one more
            # non-finite count (the chain itself is not touched)
            snap["nf"] = snap.get("nf", np.zeros(todo)).copy()
            snap["nf"][0] += 1
        if "nf" in snap:
            self._escalate_nonfinite(snap, st, todo)
        if self.health is not None and "h_n" in snap:
            self._fold_health(snap, st)
        if "mesh_attr" in snap:
            self._fold_mesh(snap, st)
        return snap["out_x"], snap["out_l"], snap["out_p"]

    def _advance(self, st, todo, temps=None):
        """The block itself (:meth:`_run_block`'s supervised thunk):
        ``todo`` steps on the device, then one host snapshot of
        everything the host reads this block. Mutates ``st`` only after
        the snapshot, so a retried block starts from the same state."""
        like, gen, dev = self.like, self.gen, self.device
        W, nd = self.W, self.ndim
        ntemps, nchains = self.ntemps, self.nchains
        nrec = W if self.write_hot else nchains
        prep = self._host_prep(st)
        eigvecs, eigvals, chol, ind_mean, ind_L, ind_iL, lam = (
            self._tensor(a) for a in prep[:7])
        cg_rows = torch.as_tensor(prep[7], dtype=torch.long, device=dev)
        kde_pts, kde_bw = self._tensor(prep[8]), self._tensor(prep[9])
        use_ind, use_cg, use_kde, use_ns = (
            bool(self.jump_probs[f] > 0) for f in (_IND, _CG, _KDE, _NS))
        if use_ns:
            ns_pairs = (
                torch.as_tensor([p[0] for p in self._ns_pairs], device=dev),
                torch.as_tensor([p[1] for p in self._ns_pairs], device=dev),
                self._tensor([p[2] for p in self._ns_pairs]),
                self._tensor([b[0] for b in self._ns_qb]),
                self._tensor([b[1] for b in self._ns_qb]))
        group_frac, kdims = self.cg_group_frac, self.cg_k
        temps = self._tensor(np.repeat(st.ladder, nchains) if temps is None
                             else temps)
        cum_p = self._tensor(np.cumsum(self.jump_probs))
        x, lnl, lnp, hist = st.x, st.lnl, st.lnp, st.history
        hist_len = st.hist_len
        acc = st.accepted
        sacc = torch.zeros(max(ntemps - 1, 1), dtype=F64, device=dev)
        out_x = torch.empty((todo, nrec, nd), dtype=F64, device=dev)
        out_l = torch.empty((todo, nrec), dtype=F64, device=dev)
        out_p = torch.empty((todo, nrec), dtype=F64, device=dev)
        mask_cls = []
        if self.use_maskstats:
            pb = torch.as_tensor(like.param_blocks, device=dev)
            blk_cls = block_classes(pb)
        n_swaps = 0
        am_scale = 2.38 / math.sqrt(nd)
        gamma_de = 2.38 / math.sqrt(2 * nd)
        # the reference's in-scan accumulators: non-finite evaluations per
        # step (telemetry on) and the health counts (health armed)
        emit_nf = telemetry.enabled()
        # per step: the proposals' lnL and lnprior and the kernel route's
        # chosen rejections (None off that route), kept by reference (no
        # launch a step) and folded into counts at the block's end
        nf_l, nf_p, nf_r = [], [], []
        emit_health = self.health is not None
        emit_mesh = self.mesh_stats is not None
        emit_diag = self.diag_ledger is not None
        t_block = time.perf_counter()
        # each step's family choices and acceptances kept by reference,
        # counted per rung and family at the block's end
        choices, accepts = [], []
        if emit_health:
            n_hpsr = len(self._health_psrs)
            h_jit = torch.zeros(n_hpsr, dtype=F64, device=dev)
            h_div = torch.zeros(n_hpsr, dtype=F64, device=dev)
            h_cond = torch.zeros(n_hpsr, dtype=F64, device=dev)

        if emit_mesh:
            m_attr = torch.zeros((self.mesh_stats.nshard,
                                  self.mesh_stats.attr_width),
                                 dtype=F64, device=dev)

        def rand(*shape):
            return torch.rand(shape, generator=gen, dtype=F64, device=dev)

        def randn(*shape):
            return torch.randn(shape, generator=gen, dtype=F64, device=dev)

        def randint(hi, n):
            return torch.randint(0, hi, (n,), generator=gen, device=dev)

        for step_idx in range(todo):
            # --- proposals: the classic four families, selected per walker
            z = randn(W, nd)
            am = x + (z @ chol.T) * am_scale
            j = randint(nd, W)
            scam = x + eigvecs[:, j].T * (torch.sqrt(eigvals[j])[:, None]
                                          * 2.38 * randn(W, 1))
            ia, ib = randint(hist_len, W), randint(hist_len, W)
            de = x + gamma_de * (hist[ia] - hist[ib])
            jp = randint(nd, W)
            onehot = torch.nn.functional.one_hot(jp, nd).to(F64)
            draws = like.from_unit(rand(W, nd))
            pd = x * (1.0 - onehot) + draws * onehot
            choice = torch.searchsorted(cum_p, rand(W)).clamp(
                max=self._last_fam)
            c = choice[:, None]
            prop = torch.where(c == 0, scam, torch.where(
                c == 1, am, torch.where(c == 2, de, pd)))
            # the ensemble families draw only where they have weight
            if use_ind:
                prop = torch.where(c == _IND, propose_ind(
                    ind_mean, ind_L, randn(W, nd)), prop)
            if use_cg:
                cg_S = draw_subsets(cg_rows, group_frac, rand(W),
                                    randint(nd, W), rand(W, nd))
                cg_prop, cg_qc = propose_cg(x, ind_mean, lam, cg_S,
                                            randn(W, kdims))
                prop = torch.where(c == _CG, cg_prop, prop)
            if use_kde:
                kde_S = draw_subsets(cg_rows, group_frac, rand(W),
                                     randint(nd, W), rand(W, nd))
                kde_prop, kde_qc = propose_kde(
                    x, kde_pts, kde_bw, kde_S, randint(kde_pts.shape[0], W),
                    randn(W, kdims))
                prop = torch.where(c == _KDE, kde_prop, prop)
            if use_ns:
                ns_prop, ns_qc, ns_ie = propose_ns(
                    x, ns_pairs, randint(len(self._ns_pairs), W), rand(W),
                    randn(W), rand(W))
                prop = torch.where(c == _NS, ns_prop, prop)

            lnp_new = like.log_prior(prop)
            if emit_mesh:
                # the attribution lanes ride the evaluation's collective;
                # summed on the device, read in the block's snapshot
                lnl_new, hw, at = like._eval_mesh_batch(
                    prop, with_health=emit_health)
                m_attr = m_attr + at.sum(dim=0)
            elif emit_health:
                lnl_new, hw = like._eval_health_batch(prop)
            else:
                lnl_new = like.loglike_batch(prop)
            if emit_health:
                hwv = hw if hw.ndim == 3 else hw[:, None, :]
                h_jit = h_jit + torch.sum(hwv[:, :, 0] > 0.5, dim=0)
                h_div = h_div + torch.sum(hwv[:, :, 1] > 0.5, dim=0)
                h_cond = torch.maximum(h_cond,
                                       torch.amax(hwv[:, :, 2], dim=0))
            if emit_nf:
                nf_l.append(lnl_new)
                nf_p.append(lnp_new)
                rej = getattr(like, "last_reject", None)
                nf_r.append(rej if rej is not None and rej.shape == (W,)
                            else None)
            lnl_new = torch.where(torch.isneginf(lnp_new), -math.inf,
                                  lnl_new)
            # prior-draw asymmetry: q(x'|x) is the redrawn dimension's
            # prior density
            lpd_old = torch.sum(like.log_prior_dims(x) * onehot, dim=-1)
            lpd_new = torch.sum(like.log_prior_dims(prop) * onehot, dim=-1)
            qcorr = torch.where(choice == 3, lpd_old - lpd_new,
                                torch.zeros_like(lpd_old))
            if use_ind:
                qcorr = torch.where(choice == _IND,
                                    ind_qc(x, prop, ind_mean, ind_iL), qcorr)
            if use_cg:
                qcorr = torch.where(choice == _CG, cg_qc, qcorr)
            if use_kde:
                qcorr = torch.where(choice == _KDE, kde_qc, qcorr)
            if use_ns:
                qcorr = torch.where(choice == _NS, ns_qc, qcorr)
            log_ratio = (lnp_new - lnp) + (lnl_new - lnl) / temps + qcorr
            accept = torch.log(rand(W)) < log_ratio
            x = torch.where(accept[:, None], prop, x)
            lnl = torch.where(accept, lnl_new, lnl)
            lnp = torch.where(accept, lnp_new, lnp)
            acc = acc + accept
            choices.append(choice)
            accepts.append(accept)
            if self.use_maskstats:
                cls = torch.where(choice == 3, blk_cls[jp], 2)
                if use_cg:
                    cls = torch.where(choice == _CG,
                                      subset_class(pb, blk_cls, cg_S), cls)
                if use_kde:
                    cls = torch.where(choice == _KDE,
                                      subset_class(pb, blk_cls, kde_S), cls)
                if use_ns:
                    # a slide pair is one backend's two white parameters:
                    # its efac dimension's block
                    cls = torch.where(choice == _NS, blk_cls[ns_ie], cls)
                mask_cls.append(cls[:nchains])

            # --- parallel-tempering swaps every swap_every steps ------
            if ntemps > 1 and step_idx % self.swap_every \
                    == self.swap_every - 1:
                xt = x.reshape(ntemps, nchains, nd).clone()
                lt = lnl.reshape(ntemps, nchains).clone()
                pt = lnp.reshape(ntemps, nchains).clone()
                tl = temps.reshape(ntemps, nchains)
                usw = rand(ntemps - 1, nchains)
                for i in range(ntemps - 1):
                    beta_diff = 1.0 / tl[i] - 1.0 / tl[i + 1]
                    sw = torch.log(usw[i]) < beta_diff * (lt[i + 1] - lt[i])
                    swc = sw[:, None]
                    xi = torch.where(swc, xt[i + 1], xt[i])
                    xj = torch.where(swc, xt[i], xt[i + 1])
                    li = torch.where(sw, lt[i + 1], lt[i])
                    lj = torch.where(sw, lt[i], lt[i + 1])
                    pi = torch.where(sw, pt[i + 1], pt[i])
                    pj = torch.where(sw, pt[i], pt[i + 1])
                    xt[i], xt[i + 1] = xi, xj
                    lt[i], lt[i + 1] = li, lj
                    pt[i], pt[i + 1] = pi, pj
                    sacc[i] += sw.sum()
                x, lnl, lnp = (xt.reshape(W, nd), lt.reshape(W),
                               pt.reshape(W))
                n_swaps += 1

            # --- DE history ring: one cold walker per step ------------
            hist = hist.clone() if step_idx == 0 else hist
            hist[(hist_len + step_idx) % _HISTORY] = x[step_idx % nchains]
            out_x[step_idx] = x[:nrec]
            out_l[step_idx] = lnl[:nrec]
            out_p[step_idx] = lnp[:nrec]

        # the block's one host sync: emissions, final state, counters
        leaves = dict(out_x=out_x, out_l=out_l, out_p=out_p, x=x, lnl=lnl,
                      lnp=lnp, history=hist, accepted=acc, sacc=sacc,
                      **self._fam_fold(choices, accepts))
        if emit_nf:
            # a non-finite lnL at a finite-prior point, or a NaN prior (lnL
            # + NaN is NaN); the kernel route's rejections counted apart
            lnp_s = torch.stack(nf_p)
            bad = ~torch.isfinite(torch.stack(nf_l) + lnp_s) \
                & ~torch.isneginf(lnp_s)
            no_rej = torch.zeros(W, dtype=torch.bool, device=dev)
            rej_s = torch.stack([no_rej if r is None else r for r in nf_r])
            leaves.update(nf=torch.sum(bad & ~rej_s, dim=1),
                          rej=torch.sum(bad & rej_s, dim=1))
        if emit_health:
            leaves.update(h_jit=h_jit, h_div=h_div, h_cond=h_cond)
        if emit_mesh:
            leaves["mesh_attr"] = m_attr
        if mask_cls:
            # the cold proposals by block class [site, common, full]
            cls = torch.stack(mask_cls).reshape(-1)
            leaves["mask_counts"] = torch.zeros(3, dtype=F64, device=dev) \
                .index_add(0, cls, torch.ones(cls.numel(), dtype=F64,
                                              device=dev))
        if emit_diag:
            leaves.update(zip(
                ("diag_mean", "diag_m2", "diag_min", "diag_max", "diag_hist"),
                devicemetrics.block_moments(out_x[:, :nchains],
                                            *self._hist_grid)))
        t_sync = time.perf_counter()
        snap = host_snapshot(leaves)
        self._last_sync_s = time.perf_counter() - t_sync
        self.host_sync_total_s += self._last_sync_s
        self._g_sync.set(self._last_sync_s)
        if emit_health:
            snap["h_n"] = float(W * todo)
        if emit_mesh:
            snap["mesh_wall_s"] = time.perf_counter() - t_block
        st.x, st.lnl, st.lnp, st.history = x, lnl, lnp, hist
        st.accepted = acc
        st.hist_len = int(min(st.hist_len + todo, _HISTORY))
        st.step += todo
        st.key = gen.get_state().numpy()
        if ntemps > 1:
            st.swaps_accepted = st.swaps_accepted + snap["sacc"]
            st.swaps_proposed = st.swaps_proposed + n_swaps * nchains
        # the cold rung's row feeds the per-process counters, the whole
        # matrix the plane's per-rung rates
        self.fam_accept += snap["fam_a"][0]
        self.fam_propose += snap["fam_p"][0]
        if mask_cls:
            self.mask_counts += snap["mask_counts"]
        if emit_diag:
            self.diag_ledger.append_block(
                todo, snap["diag_mean"], snap["diag_m2"], snap["diag_min"],
                snap["diag_max"])
            self.diag_hist += snap["diag_hist"]
            self.fam_rung_accept += snap["fam_a"]
            self.fam_rung_propose += snap["fam_p"]
        return snap

    def _fam_fold(self, choices, accepts):
        """Each rung's proposals (``fam_p``) and acceptances (``fam_a``)
        by family, (ntemps, nfam), from one block's per-step ``choices``
        and ``accepts`` (W,): a few launches a block, none in a step,
        and no host synchronisation (``index_add``; ``bincount`` reads
        its maximum back)."""
        dev = choices[0].device
        rung = torch.arange(self.W, device=dev) // self.nchains
        cell = (rung[None, :] * _NFAM + torch.stack(choices)).reshape(-1)
        acc = torch.stack(accepts).to(F64).reshape(-1)
        zero = torch.zeros(self.ntemps * _NFAM, dtype=F64, device=dev)
        shape = (self.ntemps, _NFAM)
        return dict(fam_a=zero.index_add(0, cell, acc).reshape(shape),
                    fam_p=zero.index_add(0, cell, torch.ones_like(acc))
                    .reshape(shape))

    def _reset_diag(self):
        """Clear the plane's accumulators (a fresh start, or the end of
        ``anneal_init``: the ledger describes only the measured chain)."""
        if self.diag_ledger is not None:
            self.diag_ledger = devicemetrics.MomentLedger(self.nchains,
                                                          self.ndim)
        self.diag_hist = np.zeros_like(self.diag_hist)
        self.fam_rung_accept = np.zeros((self.ntemps, _NFAM))
        self.fam_rung_propose = np.zeros((self.ntemps, _NFAM))

    def _diag_ckpt(self):
        """The plane's ``diag_*`` checkpoint keys (none before a block)."""
        if self.diag_ledger is None or not len(self.diag_ledger):
            return {}
        out = {f"diag_{k}": v
               for k, v in self.diag_ledger.state_dict().items()}
        out["diag_hist"] = self.diag_hist.copy()
        out["diag_fam_acc"] = self.fam_rung_accept.copy()
        out["diag_fam_prop"] = self.fam_rung_propose.copy()
        return out

    def _escalate_nonfinite(self, snap, st, todo):
        """Count the block's non-finite evaluations (and, apart, the
        kernel route's rejections); on the first with non-finite ones,
        dump the scene once: the walkers whose state went non-finite, the
        per-step counts, the generator state and the position."""
        rej = int(snap["rej"].sum()) if "rej" in snap else 0
        if rej:
            telemetry.registry().counter("schur_rejected",
                                         where="block").inc(rej)
        total = int(snap["nf"].sum())
        if total == 0:
            return
        telemetry.registry().counter("nonfinite_eval",
                                     where="block").inc(total)
        fr = flight_recorder()
        fr.record("nonfinite_eval", where="block", count=total,
                  step=int(st.step))
        x, lnl, lnp = snap["x"], snap["lnl"], snap["lnp"]
        bad = ~np.isfinite(lnl) | ~np.isfinite(lnp)
        fr.anomaly("nonfinite_eval", run_dir=self.outdir,
                   once_key=f"nonfinite_eval:{self.outdir}",
                   step=int(st.step), block_steps=int(todo),
                   n_bad_evals=total, nf_per_step=snap["nf"][:256],
                   rng_key=np.asarray(st.key),
                   bad_walker_idx=np.nonzero(bad)[0][:8],
                   bad_theta=x[bad][:8], bad_lnl=lnl[bad][:8],
                   bad_lnp=lnp[bad][:8])

    def _fold_health(self, snap, st):
        """Fold one block's health counts into each pulsar's ledger and
        act on the most escalated verdict: ``observe`` a
        ``kernel_health`` event; ``reeval`` also a float64 re-evaluation
        of up to 8 committed cold walkers, its verdict recorded;
        ``classic`` also pins the classic chain with its preconditioner
        kernel for every evaluation (``EWT_PALLAS_MEGA=0``, never a plain
        version); ``quarantine`` raises
        :class:`~..resilience.integrity.PulsarQuarantine` for that pulsar
        alone. Fault site ``kernel.health`` (kind ``nonfinite``) plants a
        near-singular pulsar 0: every evaluation jittered at log10
        condition 99."""
        from ..resilience.integrity import (LADDER, PulsarQuarantine,
                                            emit_psr_quarantined)
        n = float(snap["h_n"])
        jit_c = np.atleast_1d(snap["h_jit"]).astype(float)
        div_c = np.atleast_1d(snap["h_div"]).astype(float)
        cond = np.atleast_1d(snap["h_cond"]).astype(float)
        spec = faults.fire("kernel.health", step=int(st.step),
                           psr=self._health_psrs[0])
        if spec is not None and spec.kind == "nonfinite":
            jit_c = jit_c.copy()
            jit_c[0] = n
            cond = cond.copy()
            cond[0] = 99.0
        reg = telemetry.registry()
        if int(jit_c.sum()):
            reg.counter("jitter_engaged", where="pt.block").inc(
                int(jit_c.sum()))
        if int(div_c.sum()):
            reg.counter("refine_diverged", where="pt.block").inc(
                int(div_c.sum()))
        # every pulsar walks its own ladder; the most escalated one acts
        worst, action = None, None
        for i, led in enumerate(self.health):
            act = led.update(n, jit_c[i], div_c[i], cond[i])
            if act is not None and (action is None or LADDER.index(act)
                                    > LADDER.index(action)):
                worst, action = i, act
        if action is None:
            return
        led = self.health[worst]
        psr = self._health_psrs[worst]
        stats = dict(led.stats(), psr=psr,
                     block_jitter_frac=round(jit_c[worst] / max(n, 1.0), 4),
                     block_logcond=round(float(cond[worst]), 2))
        reeval = None
        if action == "reeval":
            fn = getattr(self.like, "_eval_f64_batch", None)
            if fn is not None:
                sub = snap["x"][:min(self.nchains, 8)]
                ref = fn(sub).cpu().numpy()
                got = snap["lnl"][:len(sub)]
                finite = np.isfinite(ref) & np.isfinite(got)
                diff = (float(np.max(np.abs(ref - got)[finite]))
                        if finite.any() else float("inf"))
                led.note_reeval(diff < 0.1, diff)
                reeval = {"agreed": diff < 0.1,
                          "max_abs_diff": round(diff, 6)}
        if action == "classic":
            pin_classic()
        _log.warning("kernel health tripped at step %d: action=%s psr=%s "
                     "%s", int(st.step), action, psr, stats)
        flight_recorder().record("kernel_health", action=action, psr=psr,
                                 **{k: v for k, v in stats.items()
                                    if k != "psr"})
        rec = telemetry.active_recorder()
        if rec is not None:
            ev = dict(stats)
            if reeval is not None:
                ev["reeval_agreed"] = reeval["agreed"]
                ev["reeval_max_abs_diff"] = reeval["max_abs_diff"]
            rec.event("kernel_health", action=action, step=int(st.step),
                      **ev)
            rec.flush()
        if action == "quarantine":
            faults.fire("psr.quarantine", psr=psr)
            self.like.quarantined = True
            emit_psr_quarantined(psr, cause="kernel_health",
                                 where="sampler", stats=stats)
            raise PulsarQuarantine(psr, "kernel_health", stats)

    def _fold_mesh(self, snap, st):
        """Fold one block's attribution table into the mesh ledger
        (``devicemetrics.MeshStatsLedger``) with the block's measured
        wall, set the ``shard_skew``, ``collective_wall_ms`` and
        ``straggler_index{host=}`` gauges, and emit the ``mesh_stats``
        event and this process's ``mesh_stats`` sidecar."""
        with profiling.span("pt.mesh_fold", step=int(st.step)):
            gauges = self.mesh_stats.fold(snap["mesh_attr"],
                                          snap["mesh_wall_s"])
            reg = telemetry.registry()
            reg.gauge("shard_skew").set(gauges["shard_skew"])
            reg.gauge("collective_wall_ms").set(gauges["collective_wall_ms"])
            reg.gauge("straggler_index",
                      host=str(gauges["straggler_host"])).set(
                float(gauges["straggler_index"]))
            rec = telemetry.active_recorder()
            if rec is not None:
                payload = self.mesh_stats.snapshot()
                rec.event("mesh_stats", step=int(st.step), **payload)
                if getattr(rec, "run_dir", None):
                    devicemetrics.write_mesh_stats(rec.run_dir, payload)

    def anneal_init(self, schedule=None, steps_per=100, resample=True,
                    ess_frac=0.5, verbose=True):
        """SMC-style tempered initialization of the walker ensemble.

        Runs the ensemble through a decreasing likelihood-temperature
        schedule (every walker at the same temperature per stage; by
        default geometric, 64 -> 2), adapting the jump covariance from
        each stage's emissions and resampling the walkers (multinomial,
        from ``np.random.default_rng(seed + 7)``) where the incremental
        importance weights toward the next temperature fall below
        ``ess_frac`` of the ensemble in effective size; the final
        ensemble becomes :meth:`sample`'s fresh start. No chain rows are
        written; the counters and the step count are reset so the
        measurement starts clean. A no-op where a checkpoint exists (a
        resumed run must not re-anneal). Meant for one rung
        (``ntemps == 1``); a PT ladder is a bridge of its own."""
        if from_primary(lambda: checkpoint_exists(self._ckpt_path)):
            return None
        if schedule is None:
            schedule = (64.0, 32.0, 16.0, 8.0, 4.0, 2.0)
        rng = np.random.default_rng(self.seed + 7)
        st = self._fresh_state()
        for i, T in enumerate(schedule):
            cold, _, _ = self._run_block(st, int(steps_per),
                                         temps=np.full(self.W, float(T)))
            flat = cold[:, :self.nchains].reshape(-1, self.ndim)
            if flat.shape[0] > 10:
                st.cov = 0.5 * st.cov + 0.5 * np.cov(flat.T)
            next_T = schedule[i + 1] if i + 1 < len(schedule) else 1.0
            if resample:
                lw = (1.0 / next_T - 1.0 / T) * st.lnl.cpu().numpy()
                lw -= lw.max()
                w = np.exp(lw)
                w /= w.sum()
                ess = 1.0 / np.sum(w ** 2)
                if ess < ess_frac * self.W:
                    idx = torch.as_tensor(rng.choice(self.W, self.W, p=w),
                                          device=self.device)
                    st.x, st.lnl, st.lnp = st.x[idx], st.lnl[idx], \
                        st.lnp[idx]
                if verbose:
                    _log.info("anneal T=%g: acc_ess=%.0f/%d maxlnl=%.1f", T,
                              ess, self.W, float(st.lnl.max()))
        # the measurement starts here
        st.accepted = torch.zeros_like(st.accepted)
        st.swaps_accepted = np.zeros(self.ntemps - 1)
        st.swaps_proposed = np.zeros(self.ntemps - 1)
        st.step = 0
        self.fam_accept = np.zeros(_NFAM)
        self.fam_propose = np.zeros(_NFAM)
        self.mask_counts = np.zeros(3)
        self._reset_diag()
        self._anneal_state = st
        return st

    def _truncate_chain_to(self, step, thin, block_size):
        """Resume repair: cut every chain file (``chain_1.txt`` and the
        hot rungs' ``chain_<T>.txt``) back to the rows the checkpointed
        ``step`` accounts for (each committed block of ``b`` steps
        appended ``ceil(b / thin) * nchains`` rows to each file). Files
        this sampler wrote up to that very checkpoint, unchanged since,
        are left as they are: a driver that continues a run in the same
        process (:func:`~.convergence.sample_to_convergence`) does not
        re-read the chain at every call. Only the primary process
        writes."""
        if not is_primary() \
                or self._committed == (int(step), self._chain_sizes()):
            return
        B = max(int(block_size), 1)
        n_full, r = divmod(int(step), B)
        want = self.nchains * (n_full * (-(-B // thin)) + (-(-r // thin)))
        for path in sorted(glob.glob(os.path.join(self.outdir,
                                                  "chain_*.txt"))):
            with open(path) as fh:
                lines = [ln for ln in fh.read().splitlines()
                         if len(ln.split()) == self.ndim + 4]
            if len(lines) != want:
                _log.info("resume repair: truncating %s to %d rows "
                          "(had %d)", os.path.basename(path), want,
                          len(lines))
            with open(path, "w") as fh:
                fh.write("".join(ln + "\n" for ln in lines[:want]))

    def _chain_sizes(self):
        return {p: os.path.getsize(p) for p in
                glob.glob(os.path.join(self.outdir, "chain_*.txt"))}

    def _hot_tables(self, st, full_x, full_l, full_p, accepted):
        """``(path, rows)`` of one ``chain_<T>.txt`` per tempered rung,
        the cold file's columns taken rung-locally: the tempered lnpost
        (lnprior + lnlike / T), lnlike, the rung's acceptance rate, and
        the swap rate of the edge to the colder rung. A rung at T <= 1 (a
        degenerate ladder) is statistically the cold chain, and its file
        would collide with ``chain_1.txt``: it is skipped."""
        tables = []
        for k in range(1, self.ntemps):
            T_k = float(st.ladder[k])
            if T_k <= 1.0:
                continue
            sl = slice(k * self.nchains, (k + 1) * self.nchains)
            acc_k = float(np.mean(accepted[sl]) / max(st.step, 1))
            swap_k = (float(st.swaps_accepted[k - 1])
                      / max(st.swaps_proposed[k - 1], 1.0))
            nrow = full_x.shape[0] * self.nchains
            rows = np.concatenate([
                full_x[:, sl].reshape(-1, self.ndim),
                (full_p[:, sl] + full_l[:, sl] / T_k).reshape(-1, 1),
                full_l[:, sl].reshape(-1, 1), np.full((nrow, 1), acc_k),
                np.full((nrow, 1), swap_k)], axis=1)
            tables.append((os.path.join(self.outdir,
                                        f"chain_{T_k:.6g}.txt"), rows))
        return tables

    def _commit(self, tables, cov, mask_stats, ckpt, rec, heartbeat,
                mixing=None, mixing_stats=None):
        """Write one block's outputs in the order a resume relies on: the
        chain rows (fault site ``pt.chain`` after them), then ``cov.npy``
        and ``mask_stats.json``, then the checkpoint that accounts for the
        rows, and the block's ``checkpoint``, ``heartbeat`` and ``mixing``
        events, then ``mixing_stats.json``."""
        with profiling.span("pt.host_work", step=int(ckpt["step"])):
            self._commit_files(tables, cov, mask_stats, ckpt)
        rec.checkpoint(step=int(ckpt["step"]))
        if heartbeat is not None:
            rec.heartbeat(**heartbeat)
            if mixing is not None:
                rec.event("mixing", **mixing)
        if mixing_stats is not None and is_primary():
            atomic_write_json(os.path.join(self.outdir,
                                           "mixing_stats.json"),
                              mixing_stats)

    def _commit_files(self, tables, cov, mask_stats, ckpt):
        if not is_primary():
            return
        for path, rows in tables:
            write_table(path, rows, append=True)
        faults.fire("pt.chain", path=tables[0][0], step=int(ckpt["step"]))
        np.save(os.path.join(self.outdir, "cov.npy"), cov)
        if mask_stats is not None:
            atomic_write_json(os.path.join(self.outdir, "mask_stats.json"),
                              mask_stats)
        self._write_ckpt(ckpt)
        self._committed = (ckpt["step"], self._chain_sizes())

    def _drain(self):
        """Wait for the block write in flight (the breaker calls this
        before it demotes, so the last committed block is on disk)."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    # ---------------- public API --------------------------------------- #
    def sample(self, nsamp, resume=True, verbose=True, thin=1,
               block_size=None, collect=None):
        """Run ``nsamp`` total steps, appending the cold chain to
        ``chain_1.txt`` after every block. A block's files are written on
        a worker thread while the next block runs (the native writer
        releases the GIL), one block at a time and all of them before
        this returns. If ``collect`` is a list, each
        block's post-thin cold positions are also appended to it as
        float32 ``(steps // thin, nchains, ndim)`` arrays, so
        :func:`~.convergence.sample_to_convergence` need not re-parse the
        chain file.

        Telemetry: the run is a ``run_scope`` on the output directory
        (joined when a caller already opened one), with one ``heartbeat``
        and one ``checkpoint`` per block."""
        block_size = block_size or self.cov_update
        with telemetry.run_scope(
                self.outdir, sampler="ptmcmc", ndim=self.ndim,
                ntemps=self.ntemps, nchains=self.nchains, nsamp=int(nsamp),
                param_names=list(self.like.param_names)) as rec:
            return self._sample_impl(nsamp, resume, verbose, thin,
                                     block_size, collect, rec)

    def _sample_impl(self, nsamp, resume, verbose, thin, block_size,
                     collect, rec):
        ckpt = self._read_ckpt() if resume else None
        if ckpt is not None:
            st = self._load_state(ckpt)
            if verbose:
                _log.info("resuming from step %d", st.step)
            self._truncate_chain_to(st.step, thin, block_size)
        else:
            st = self._fresh_state()
            if st.step == 0:
                # no earlier sample() call's statistics on a reused sampler
                self._reset_diag()
            # a fresh run: truncate the cold chain and remove any stale
            # hot-rung file of an earlier run in the same directory
            if is_primary():
                open(os.path.join(self.outdir, "chain_1.txt"), "w").close()
                for path in glob.glob(os.path.join(self.outdir,
                                                   "chain_*.txt")):
                    if os.path.basename(path) != "chain_1.txt":
                        os.remove(path)
        chain_path = os.path.join(self.outdir, "chain_1.txt")
        if is_primary():
            np.savetxt(os.path.join(self.outdir, "pars.txt"),
                       self.like.param_names, fmt="%s")
        # evals_total stays cumulative across resumes; rates are this
        # session's
        meter = EvalRateMeter(initial_total=self.W * int(st.step))
        diag_t = [0.0]

        writer = ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self._t_ready = None
        try:
            while st.step < nsamp:
                if preemption_requested():
                    # the last block is committed (its write drains
                    # below); run_scope emits run_end(reason="preempted")
                    _log.warning("preemption requested: stopping at step "
                                 "%d after a final checkpoint", st.step)
                    break
                todo = int(min(block_size, nsamp - st.step))
                sacc_before = st.swaps_accepted.copy()
                sprop_before = st.swaps_proposed.copy()
                t0 = time.perf_counter()
                if self._t_ready is not None:
                    # host time between the last block's results landing
                    # and this block's first launch
                    self._last_bubble_s = t0 - self._t_ready
                    self.bubble_total_s += self._last_bubble_s
                    self._g_bubble.set(self._last_bubble_s)
                with profiling.span("pt.dispatch", step=int(st.step),
                                    steps=todo):
                    cold, cold_lnl, cold_lnp = self._run_block(st, todo)
                snap = self._snap
                self._t_ready = time.perf_counter()
                block_s = self._t_ready - t0
                profiling.capture_tick()
                flight_recorder().note_state(
                    sampler="ptmcmc", outdir=self.outdir, step=int(st.step),
                    block_steps=int(todo), rng_key=st.key.tolist())

                # --- swap-rate-targeted ladder adaptation -----------------
                if self.adapt_ladder and self.ntemps > 1:
                    dprop = st.swaps_proposed - sprop_before
                    dacc = st.swaps_accepted - sacc_before
                    if np.all(dprop > 0):
                        rate = dacc / dprop
                        kappa = self.ladder_t0 / (st.step + self.ladder_t0)
                        log_gap = np.log(np.diff(st.ladder))
                        log_gap += kappa * (rate - self.swap_target)
                        st.ladder = np.concatenate(
                            [[1.0], 1.0 + np.cumsum(np.exp(log_gap))])

                full_x = cold[::thin]
                full_l = cold_lnl[::thin]
                full_p = cold_lnp[::thin]
                cs = full_x[:, :self.nchains]
                cl = full_l[:, :self.nchains]
                cp = full_p[:, :self.nchains]
                # --- adapt covariance from recent cold samples ------------
                flat = cs.reshape(-1, self.ndim)
                if flat.shape[0] > 10 and st.step > self.burn:
                    new_cov = np.cov(flat.T)
                    if self.ndim == 1:
                        new_cov = new_cov.reshape(1, 1)
                    w = min(0.5, flat.shape[0] / max(st.step, 1))
                    st.cov = (1 - w) * st.cov + w * new_cov

                accepted = snap["accepted"]
                acc_rate = float(np.mean(accepted[:self.nchains])
                                 / max(st.step, 1))
                tot_prop = float(np.sum(st.swaps_proposed))
                swap_rate = (float(np.sum(st.swaps_accepted)) / tot_prop
                             if tot_prop else 0.0)
                nrow = cs.shape[0] * self.nchains
                rows = np.concatenate([
                    cs.reshape(-1, self.ndim), (cp + cl).reshape(-1, 1),
                    cl.reshape(-1, 1), np.full((nrow, 1), acc_rate),
                    np.full((nrow, 1), swap_rate)], axis=1)
                tables = [(chain_path, rows)]
                if self.write_hot:
                    tables += self._hot_tables(st, full_x, full_l, full_p,
                                               accepted)
                if collect is not None:
                    collect.append(cs.astype(np.float32))
                mask_stats = (cache_hit_summary(*self.mask_counts)
                              if self.use_maskstats else None)
                plane = self._mixing_plane(st, snap, rec)
                heartbeat = mixing = mixing_stats = None
                if rec.enabled:
                    meter.add(self.W * todo)
                    heartbeat = self._heartbeat(
                        st, nsamp, snap, cs, acc_rate, swap_rate, meter,
                        diag_t, plane)
                if self.diag_ledger is not None:
                    mixing = self._mixing_event(st, plane)
                    mixing_stats = self._mixing_stats(st, plane)
                ckpt = self._ckpt_arrays(st, snap)
                ckpt.update(self._diag_ckpt())
                self._drain()
                self._pending = writer.submit(
                    self._commit, tables, ckpt["cov"], mask_stats, ckpt,
                    rec, heartbeat, mixing, mixing_stats)
                stats = {"step": st.step, "steps": todo, "walkers": self.W,
                         "block_s": block_s,
                         "ms_per_step": 1e3 * block_s / todo,
                         "walker_evals_per_s": self.W * todo / block_s,
                         "accept": acc_rate, "swap": swap_rate}
                if verbose:
                    fam = " ".join(f"{n}={a / max(p, 1.0):.2f}" for n, a, p, w
                                   in zip(_FAM_NAMES, self.fam_accept,
                                          self.fam_propose, self.jump_probs)
                                   if w > 0)
                    _log.info("step %d/%d acc=%.3f swap=%.3f [%s] maxlnl=%.2f "
                              "ms/step=%.3f", st.step, nsamp, acc_rate,
                              swap_rate, fam, float(np.max(cold_lnl)),
                              stats["ms_per_step"],
                              extra={"block_stats": stats})
            self._drain()
        finally:
            writer.shutdown(wait=True)
        return st

    def _mixing_plane(self, st, snap, rec):
        """The block's per-rung rates and, with the diagnostics plane on,
        one streaming fold of the ledger (``summ``, the per-parameter
        summary, and ``worst``, its heartbeat figures); the gauges
        ``swap_rate``, ``rung_accept``, ``stream_rhat`` and
        ``stream_ess`` are set from them. None with telemetry off."""
        if not (rec.enabled or self.diag_ledger is not None):
            return None
        sacc, sprop = st.swaps_accepted, st.swaps_proposed
        plane = dict(
            accept_rung=[round(float(a), 4) for a in
                         snap["accepted"].reshape(self.ntemps, self.nchains)
                         .mean(axis=1) / max(st.step, 1)],
            swap_rung=[round(float(r), 4) for r in
                       sacc / np.maximum(sprop, 1.0)],
            summ=None, worst=None)
        if self.diag_ledger is not None:
            plane["summ"] = self.diag_ledger.param_summary()
            plane["worst"] = self.diag_ledger.worst(summary=plane["summ"])
        reg = telemetry.registry()
        for i, r in enumerate(plane["swap_rung"]):
            reg.gauge("swap_rate", edge=i).set(r)
        for i, a in enumerate(plane["accept_rung"]):
            reg.gauge("rung_accept", rung=i).set(a)
        devicemetrics.set_stream_gauges(plane["worst"])
        return plane

    def _fam_rung_rate(self):
        return np.round(self.fam_rung_accept
                        / np.maximum(self.fam_rung_propose, 1.0), 4).tolist()

    def _mixing_event(self, st, plane):
        """The ``mixing`` event's fields (the per-rung family matrices,
        too wide for a heartbeat)."""
        worst = plane["worst"] or {}
        return dict(step=int(st.step), accept_rung=plane["accept_rung"],
                    swap_rung=plane["swap_rung"],
                    fam_names=list(_FAM_NAMES),
                    fam_rung_rate=self._fam_rung_rate(),
                    fam_rung_propose=self.fam_rung_propose
                    .astype(np.int64).tolist(),
                    rhat_stream=worst.get("rhat"),
                    ess_stream=worst.get("ess"))

    def _mixing_stats(self, st, plane):
        """``mixing_stats.json``, the reference's: per parameter the
        streaming moments, R-hat and ESS (post-burn) and the
        run-cumulative histogram; the ladder, per-rung acceptance, per-edge
        swap rates and the per-rung family matrices."""
        summ = plane["summ"]
        rh, es = summ["rhat"], summ["ess"]
        per_param = {}
        for i, name in enumerate(self.like.param_names):
            per_param[name] = {
                "mean": round(float(summ["mean"][i]), 6),
                "std": round(float(summ["std"][i]), 6),
                "min": round(float(summ["min"][i]), 6),
                "max": round(float(summ["max"][i]), 6),
                "rhat_stream": (round(float(rh[i]), 5)
                                if rh is not None and np.isfinite(rh[i])
                                else None),
                "ess_stream": (round(float(es[i]), 1)
                               if es is not None and np.isfinite(es[i])
                               else None),
                "hist": [int(c) for c in self.diag_hist[i]],
                "hist_lo": round(float(self._hist_lo[i]), 6),
                "hist_hi": round(float(self._hist_lo[i]
                                       + self._hist_span[i]), 6),
            }
        return {"step": int(st.step),
                "steps_folded": self.diag_ledger.total_steps,
                "stream_burn_frac": devicemetrics.STREAM_BURN_FRAC,
                "cumulative_fields": ["hist", "fam_rung_rate",
                                      "fam_rung_propose"],
                "params": per_param,
                "ladder": [round(float(T), 4) for T in st.ladder],
                "accept_rung": plane["accept_rung"],
                "swap_rung": plane["swap_rung"],
                "fam_names": list(_FAM_NAMES),
                "fam_rung_rate": self._fam_rung_rate(),
                "fam_rung_propose": self.fam_rung_propose
                .astype(np.int64).tolist()}

    def _heartbeat(self, st, nsamp, snap, cs, acc_rate, swap_rate, meter,
                   diag_t, plane):
        """One block's heartbeat fields (the reference's, from the block's
        host snapshot: no device read)."""
        hb = dict(
            step=int(st.step), nsamp=int(nsamp), accept=round(acc_rate, 4),
            swap=round(swap_rate, 4), accept_rung=plane["accept_rung"],
            swap_rung=plane["swap_rung"],
            fam_accept={n: round(float(a / max(p, 1.0)), 4) for n, a, p in
                        zip(_FAM_NAMES, self.fam_accept, self.fam_propose)},
            ladder=[round(float(T), 4) for T in st.ladder],
            evals_per_s=round(meter.window_rate(), 1),
            evals_total=int(meter.total),
            cache_hit_rate=(cache_hit_summary(*self.mask_counts)
                            ["cache_hit_rate"] if self.use_maskstats
                            else 0.0),
            host_sync_wall_s=round(self._last_sync_s, 4),
            block_bubble_s=round(self._last_bubble_s, 4),
            max_lnl=round(float(np.max(snap["lnl"])), 3))
        if plane["worst"] is not None:
            hb["rhat_stream"] = plane["worst"]["rhat"]
            hb["ess_stream"] = plane["worst"]["ess"]
        if self.health is not None:
            hb["jitter_engaged"] = sum(led.n_jitter for led in self.health)
            hb["refine_diverged"] = sum(led.n_diverge
                                        for led in self.health)
            hb["kernel_cond"] = round(max(led.max_logcond
                                          for led in self.health), 3)
        if self.mesh_stats is not None and self.mesh_stats._blocks:
            ms = self.mesh_stats.snapshot()
            hb["shard_skew"] = round(ms["shard_skew"], 4)
            hb["collective_wall_ms"] = round(ms["collective_wall_ms"], 3)
            hb["straggler_index"] = ms["straggler_index"]
        mem = profiling.memory_watermark(self.device)
        if mem is not None:
            hb.update(mem)
        rss = profiling.host_rss_bytes()
        if rss is not None:
            hb["rss_bytes"] = rss
        routes = telemetry.route_summary()
        if routes:
            hb["pallas_path"] = routes
        worst = throttled_block_worst(cs, self.like.param_names, diag_t)
        if worst is not None:
            hb["rhat"] = worst["rhat"]
            hb["ess"] = worst["ess"]
        return hb


def sampler_options(params):
    """PTSampler options and ``thin`` from a parsed paramfile — the
    reference's ``run_ptmcmc`` reading (jump weights, ``covUpdate``,
    ``burn``, ``thin``, ``mcmc_covm``, ``ntemps``, ``Tmax``)."""
    skw = getattr(params, "sampler_kwargs", {})
    opts = dict(
        scam_weight=getattr(params, "SCAMweight", 30),
        am_weight=getattr(params, "AMweight", 15),
        de_weight=getattr(params, "DEweight", 50),
        prior_weight=getattr(params, "PriorDrawWeight", 10),
        ind_weight=getattr(params, "IndWeight", skw.get("IndWeight", 0)),
        cg_weight=getattr(params, "CGWeight", skw.get("CGWeight", 0)),
        kde_weight=getattr(params, "KDEWeight", skw.get("KDEWeight", 0)),
        ns_weight=getattr(params, "NSWeight", skw.get("NSWeight", 0)),
        cov_update=getattr(params, "covUpdate", 1000) or 1000,
        write_hot_chains=bool(getattr(params, "writeHotChains",
                                      skw.get("writeHotChains", False))),
        burn=int(getattr(params, "burn", skw.get("burn", 0)) or 0),
        ntemps=max(int(skw.get("ntemps", 2)), 1),
    )
    thin = int(getattr(params, "thin", skw.get("thin", 1)) or 1)
    if skw.get("Tmax") is not None:
        opts["tmax"] = float(skw["Tmax"])
    return opts, thin


def _knob(params, name):
    return getattr(params, name,
                   getattr(params, "sampler_kwargs", {}).get(name, False))


def run_ptmcmc(like, outdir, nsamp, params=None, resume=True, seed=0,
               verbose=True, **kw):
    """Convenience entry honouring the paramfile's sampler settings,
    the warm starts included (``advi_init``: a variational fit of
    ``advi_steps`` steps, 800 by default, seeds the walkers;
    ``anneal_init``: :meth:`PTSampler.anneal_init`; both skipped on
    resume); returns the sampler."""
    opts = dict(seed=seed)
    thin = 1
    if params is not None:
        popts, thin = sampler_options(params)
        opts.update(popts)
        covm = getattr(params, "mcmc_covm", None)
        if covm is not None:
            cov = _covm_from_csv(covm, like.param_names)
            if cov is not None:
                opts["init_cov"] = cov
        resuming = resume and from_primary(lambda: checkpoint_exists(
            os.path.join(outdir, "state.npz")))
        if _knob(params, "advi_init") and not resuming:
            from .vi import fit_advi
            if verbose:
                _log.info("advi_init: fitting variational warm start")
            skw = getattr(params, "sampler_kwargs", {})
            fit = fit_advi(like, steps=int(skw.get("advi_steps", 800)),
                           mc=8, seed=seed)
            opts["init_x"] = fit["samples"]
    opts.update(kw)
    # demotion re-entry: an in-process rung (mega -> classic) is applied
    # and the run resumes from its checkpoint; the bottom propagates
    while True:
        sampler = PTSampler(like, outdir, **opts)
        if params is not None and _knob(params, "anneal_init"):
            if verbose:
                _log.info("anneal_init: tempered warm start")
            sampler.anneal_init(verbose=verbose)
        try:
            sampler.sample(nsamp, resume=resume, verbose=verbose, thin=thin)
        except PlatformDemotion as d:
            if not apply_demotion(d):
                raise
            _log.warning("re-entering the PT run on the %s path (resume "
                         "from checkpoint)", d.to_level)
            resume = True
            continue
        return sampler


def _covm_from_csv(covm_df, param_names):
    """Initial jump covariance for ``param_names`` from a results-layer
    covariance table (a pandas DataFrame indexed by parameter name)."""
    have = [n for n in param_names if n in covm_df.columns]
    if not have:
        return None
    sub = covm_df.loc[have, have].to_numpy()
    full = np.diag(np.ones(len(param_names)))
    idx = [param_names.index(n) for n in have]
    for a, ia in enumerate(idx):
        for b, ib in enumerate(idx):
            full[ia, ib] = sub[a, b]
    return full
