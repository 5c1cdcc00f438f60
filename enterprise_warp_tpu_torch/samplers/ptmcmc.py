"""Adaptive parallel-tempering MCMC over a walker-batched likelihood.

Counterpart of ``enterprise_warp_tpu/samplers/ptmcmc.py`` for the paramfile
path: W = ntemps x nchains walkers advance together, each step evaluating
the likelihood once for all walkers, with the four classic jump families

- SCAM: single-component adaptive Metropolis along one eigendirection of
  the adapted covariance,
- AM: full adaptive-Metropolis jump from that covariance,
- DE: differential evolution from a history ring of cold walkers,
- prior draw: one random dimension redrawn from its prior, with the
  Metropolis-Hastings asymmetry correction,

parallel-tempering swaps every ``swap_every`` steps with swap-rate ladder
adaptation, and covariance/eigen adaptation between blocks of
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

Not ported (a paramfile that asks for them gets ``NotImplementedError``):
the ind/cg/kde/ns/flow proposal families.
"""

from __future__ import annotations

import glob
import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import F64
from ..io.writers import (atomic_write_json, checkpoint_exists,
                          checkpoint_replace, resolve_checkpoint,
                          write_table)
from ..utils.diagnostics import cache_hit_summary
from ..utils.logging import get_logger
from .evalproto import BLOCK_COMMON

_log = get_logger("ewt.ptmcmc")

_HISTORY = 1000     # DE history ring length
_FAM_NAMES = ("scam", "am", "de", "pd")
_NFAM = len(_FAM_NAMES)
_LATER = "is not ported yet (see ROADMAP.md)"


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
                 write_hot_chains=False, ind_weight=0, cg_weight=0,
                 kde_weight=0, ns_weight=0, init_x=None, device=None):
        for name, w in (("ind", ind_weight), ("cg", cg_weight),
                        ("kde", kde_weight), ("ns", ns_weight)):
            if w:
                raise NotImplementedError(
                    f"the {name} proposal family (weight {w}) {_LATER}")
        self.like = like
        self.outdir = outdir
        self.ntemps = int(ntemps)
        self.nchains = int(nchains)
        self.W = self.ntemps * self.nchains
        self.ndim = like.ndim
        self.device = torch.device(device if device is not None else
                                   getattr(like, "device", "cpu"))
        weights = np.array([scam_weight, am_weight, de_weight,
                            prior_weight], float)
        self.jump_probs = weights / weights.sum()
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
        # common, full] into mask_stats.json. Of the ported families only
        # the prior draw (one dimension) can stay inside a block.
        self.use_maskstats = getattr(like, "param_blocks", None) is not None
        self.mask_counts = np.zeros(3)
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
        lnl = self.like.loglike_batch(self._tensor(x0)).cpu().numpy()
        # re-draw walkers that landed on a non-finite corner
        for _ in range(20):
            bad = ~np.isfinite(lnl)
            if not bad.any():
                break
            x0[bad] = self.like.sample_prior(rng, int(bad.sum()))
            lnl = self.like.loglike_batch(self._tensor(x0)).cpu().numpy()
        else:
            if (~np.isfinite(lnl)).any():
                _log.warning("%d walkers start at non-finite lnl after 20 "
                             "prior redraws", int((~np.isfinite(lnl)).sum()))
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

    def _write_ckpt(self, st):
        """Atomic checkpoint with an integrity sidecar and the previous
        generation kept (``io.writers.checkpoint_replace``)."""
        tmp = self._ckpt_path + ".tmp.npz"
        np.savez(tmp, x=st.x.cpu().numpy(), lnl=st.lnl.cpu().numpy(),
                 lnp=st.lnp.cpu().numpy(), key=st.key, cov=st.cov,
                 history=st.history.cpu().numpy(), hist_len=st.hist_len,
                 step=st.step, accepted=st.accepted.cpu().numpy(),
                 swaps_accepted=st.swaps_accepted,
                 swaps_proposed=st.swaps_proposed, ladder=st.ladder)
        checkpoint_replace(tmp, self._ckpt_path)

    def _load_state(self, path):
        z = np.load(path)
        sacc = np.atleast_1d(np.asarray(z["swaps_accepted"], dtype=float))
        sprop = np.atleast_1d(np.asarray(z["swaps_proposed"], dtype=float))
        if sacc.shape != (self.ntemps - 1,):
            sacc = np.zeros(self.ntemps - 1)
            sprop = np.zeros(self.ntemps - 1)
        ladder = (np.asarray(z["ladder"]) if "ladder" in z.files
                  else self.init_ladder.copy())
        key = np.asarray(z["key"], dtype=np.uint8)
        self.gen.set_state(torch.from_numpy(key.copy()))
        return PTState(x=self._tensor(z["x"]), lnl=self._tensor(z["lnl"]),
                       lnp=self._tensor(z["lnp"]), key=key, cov=z["cov"],
                       history=self._tensor(z["history"]),
                       hist_len=int(z["hist_len"]), step=int(z["step"]),
                       accepted=self._tensor(z["accepted"]),
                       swaps_accepted=sacc, swaps_proposed=sprop,
                       ladder=ladder)

    # ---------------- one block ---------------------------------------- #
    def _host_prep(self, st):
        """Eigendecomposition and Cholesky factor of the adapted jump
        covariance (float64 numpy, once per block)."""
        cov = st.cov + 1e-12 * np.eye(self.ndim)
        eigvals, eigvecs = np.linalg.eigh(cov)
        eigvals = np.maximum(eigvals, 1e-16)
        chol = np.linalg.cholesky(cov)
        return self._tensor(eigvecs), self._tensor(eigvals), \
            self._tensor(chol)

    def _run_block(self, st, todo, temps=None):
        """Advance ``st`` by ``todo`` steps at the ladder's temperatures
        (or at ``temps``, one per walker); returns the block's emissions
        ``(x (todo, n, nd), lnl, lnp)`` as numpy, ``n`` the cold rung's
        ``nchains`` walkers, or all ``W`` with ``writeHotChains``."""
        like, gen, dev = self.like, self.gen, self.device
        W, nd = self.W, self.ndim
        ntemps, nchains = self.ntemps, self.nchains
        nrec = W if self.write_hot else nchains
        eigvecs, eigvals, chol = self._host_prep(st)
        temps = self._tensor(np.repeat(st.ladder, nchains) if temps is None
                             else temps)
        cum_p = self._tensor(np.cumsum(self.jump_probs))
        x, lnl, lnp, hist = st.x, st.lnl, st.lnp, st.history
        hist_len = st.hist_len
        acc = st.accepted
        sacc = torch.zeros(max(ntemps - 1, 1), dtype=F64, device=dev)
        fam_acc = torch.zeros(_NFAM, dtype=F64, device=dev)
        fam_prop = torch.zeros(_NFAM, dtype=F64, device=dev)
        out_x = torch.empty((todo, nrec, nd), dtype=F64, device=dev)
        out_l = torch.empty((todo, nrec), dtype=F64, device=dev)
        out_p = torch.empty((todo, nrec), dtype=F64, device=dev)
        mask_counts = torch.zeros(3, dtype=F64, device=dev)
        if self.use_maskstats:
            pb = torch.as_tensor(like.param_blocks, device=dev)
            # block id -> class: 0 one pulsar's block, 1 the coupling-only
            # common block, 2 a full recompute
            blk_cls = torch.where(pb >= 0, 0, torch.where(pb == BLOCK_COMMON,
                                                          1, 2))
        n_swaps = 0
        am_scale = 2.38 / math.sqrt(nd)
        gamma_de = 2.38 / math.sqrt(2 * nd)

        def rand(*shape):
            return torch.rand(shape, generator=gen, dtype=F64, device=dev)

        def randn(*shape):
            return torch.randn(shape, generator=gen, dtype=F64, device=dev)

        def randint(hi, n):
            return torch.randint(0, hi, (n,), generator=gen, device=dev)

        for step_idx in range(todo):
            # --- proposals (all four families, selected per walker) ---
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
            choice = torch.searchsorted(cum_p, rand(W)).clamp(max=_NFAM - 1)
            c = choice[:, None]
            prop = torch.where(c == 0, scam, torch.where(
                c == 1, am, torch.where(c == 2, de, pd)))

            lnp_new = like.log_prior(prop)
            lnl_new = like.loglike_batch(prop)
            lnl_new = torch.where(torch.isneginf(lnp_new),
                                  torch.full_like(lnl_new, -math.inf),
                                  lnl_new)
            # prior-draw asymmetry: q(x'|x) is the redrawn dimension's
            # prior density
            lpd_old = torch.sum(like.log_prior_dims(x) * onehot, dim=-1)
            lpd_new = torch.sum(like.log_prior_dims(prop) * onehot, dim=-1)
            qcorr = torch.where(choice == 3, lpd_old - lpd_new,
                                torch.zeros_like(lpd_old))
            log_ratio = (lnp_new - lnp) + (lnl_new - lnl) / temps + qcorr
            accept = torch.log(rand(W)) < log_ratio
            x = torch.where(accept[:, None], prop, x)
            lnl = torch.where(accept, lnl_new, lnl)
            lnp = torch.where(accept, lnp_new, lnp)
            acc = acc + accept
            cold_ch = choice[:nchains]
            fam_prop += torch.bincount(cold_ch, minlength=_NFAM).to(F64)
            fam_acc += torch.bincount(cold_ch, weights=accept[:nchains]
                                      .to(F64), minlength=_NFAM)
            if self.use_maskstats:
                cls = torch.where(choice == 3, blk_cls[jp], 2)
                mask_counts += torch.bincount(cls[:nchains], minlength=3)

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

        st.x, st.lnl, st.lnp, st.history = x, lnl, lnp, hist
        st.accepted = acc
        st.hist_len = int(min(st.hist_len + todo, _HISTORY))
        st.step += todo
        st.key = gen.get_state().numpy()
        if ntemps > 1:
            st.swaps_accepted = st.swaps_accepted + sacc.cpu().numpy()
            st.swaps_proposed = st.swaps_proposed + n_swaps * nchains
        self.fam_accept += fam_acc.cpu().numpy()
        self.fam_propose += fam_prop.cpu().numpy()
        self.mask_counts += mask_counts.cpu().numpy()
        return out_x.cpu().numpy(), out_l.cpu().numpy(), out_p.cpu().numpy()

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
        if checkpoint_exists(self._ckpt_path):
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
        self._anneal_state = st
        return st

    def _truncate_chain_to(self, step, thin, block_size):
        """Resume repair: cut every chain file (``chain_1.txt`` and the
        hot rungs' ``chain_<T>.txt``) back to the rows the checkpointed
        ``step`` accounts for (each committed block of ``b`` steps
        appended ``ceil(b / thin) * nchains`` rows to each file)."""
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

    def _write_hot(self, st, full_x, full_l, full_p, accepted):
        """One ``chain_<T>.txt`` per tempered rung, the cold file's
        columns taken rung-locally: the tempered lnpost (lnprior +
        lnlike / T), lnlike, the rung's acceptance rate, and the swap
        rate of the edge to the colder rung. A rung at T <= 1 (a
        degenerate ladder) is statistically the cold chain, and its file
        would collide with ``chain_1.txt``: it is skipped."""
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
            write_table(os.path.join(self.outdir, f"chain_{T_k:.6g}.txt"),
                        rows, append=True)

    # ---------------- public API --------------------------------------- #
    def sample(self, nsamp, resume=True, verbose=True, thin=1,
               block_size=None):
        """Run ``nsamp`` total steps, appending the cold chain to
        ``chain_1.txt`` after every block."""
        block_size = block_size or self.cov_update
        ckpt = resolve_checkpoint(self._ckpt_path) if resume else None
        if ckpt is not None:
            st = self._load_state(ckpt)
            if verbose:
                _log.info("resuming from step %d", st.step)
            self._truncate_chain_to(st.step, thin, block_size)
        else:
            st = self._fresh_state()
            # a fresh run: truncate the cold chain and remove any stale
            # hot-rung file of an earlier run in the same directory
            open(os.path.join(self.outdir, "chain_1.txt"), "w").close()
            for path in glob.glob(os.path.join(self.outdir, "chain_*.txt")):
                if os.path.basename(path) != "chain_1.txt":
                    os.remove(path)
        chain_path = os.path.join(self.outdir, "chain_1.txt")
        np.savetxt(os.path.join(self.outdir, "pars.txt"),
                   self.like.param_names, fmt="%s")

        while st.step < nsamp:
            todo = int(min(block_size, nsamp - st.step))
            sacc_before = st.swaps_accepted.copy()
            sprop_before = st.swaps_proposed.copy()
            t0 = time.perf_counter()
            cold, cold_lnl, cold_lnp = self._run_block(st, todo)
            block_s = time.perf_counter() - t0

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

            accepted = st.accepted.cpu().numpy()
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
            write_table(chain_path, rows, append=True)
            if self.write_hot:
                self._write_hot(st, full_x, full_l, full_p, accepted)
            np.save(os.path.join(self.outdir, "cov.npy"), st.cov)
            if self.use_maskstats:
                atomic_write_json(os.path.join(self.outdir,
                                               "mask_stats.json"),
                                  cache_hit_summary(*self.mask_counts))
            self._write_ckpt(st)
            stats = {"step": st.step, "steps": todo, "walkers": self.W,
                     "block_s": block_s,
                     "ms_per_step": 1e3 * block_s / todo,
                     "walker_evals_per_s": self.W * todo / block_s,
                     "accept": acc_rate, "swap": swap_rate}
            if verbose:
                fam = " ".join(f"{n}={a / max(p, 1.0):.2f}" for n, a, p in
                               zip(_FAM_NAMES, self.fam_accept,
                                   self.fam_propose))
                _log.info("step %d/%d acc=%.3f swap=%.3f [%s] maxlnl=%.2f "
                          "ms/step=%.3f", st.step, nsamp, acc_rate,
                          swap_rate, fam, float(np.max(cold_lnl)),
                          stats["ms_per_step"],
                          extra={"block_stats": stats})
        return st


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
        resuming = resume and checkpoint_exists(
            os.path.join(outdir, "state.npz"))
        if _knob(params, "advi_init") and not resuming:
            from .vi import fit_advi
            if verbose:
                _log.info("advi_init: fitting variational warm start")
            skw = getattr(params, "sampler_kwargs", {})
            fit = fit_advi(like, steps=int(skw.get("advi_steps", 800)),
                           mc=8, seed=seed)
            opts["init_x"] = fit["samples"]
    opts.update(kw)
    sampler = PTSampler(like, outdir, **opts)
    if params is not None and _knob(params, "anneal_init"):
        if verbose:
            _log.info("anneal_init: tempered warm start")
        sampler.anneal_init(verbose=verbose)
    sampler.sample(nsamp, resume=resume, verbose=verbose, thin=thin)
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
