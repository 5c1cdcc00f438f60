"""Gradient-based HMC with batched chains.

Counterpart of ``enterprise_warp_tpu/samplers/hmc.py``. Sampling runs in
the unconstrained z-space of ``samplers/transform.py`` (``theta =
from_unit(sigmoid(z))``), so bounded, normal and log-uniform priors all
work unmodified. Every leapfrog step advances all W chains through one
batched likelihood evaluation and one backward pass: chains are
independent, so the gradient of the summed log-density is each chain's
own gradient. On the card the evaluation is the likelihood megakernel and
the backward pass re-derives through the classic chain and its fused
preconditioner kernel (``ops/megakernel.py``, ``ops/cholfuse.py``).

Per step: momenta ``p0 ~ N(0, M)``, a per-chain step-size jitter, a
trajectory length drawn uniformly in ``[L/2, L]`` (shared across the
batch), the leapfrog, and the Metropolis test with the reference's NaN
and +inf rules and divergence count. Warmup adapts the step size by dual
averaging every step and sets a diagonal mass matrix from the warmup
positions at ``3 warmup / 4``, re-anchoring the dual averaging there.
The reference's ``lax.scan`` block is a Python step loop here; every
per-step quantity stays on the device and the host reads one snapshot
per block. Randomness comes from one explicit ``torch.Generator`` on the
likelihood's device; the reference's threefry streams are not reproduced.

On-disk contract (the reference's): ``chain_1.txt`` rows are
``[theta..., lnprior + lnlike, lnlike, accept_rate, 0.0]``, plus
``pars.txt`` and a ``state.npz`` checkpoint for resume.

Not ported (see ``ROADMAP.md``): the device-state/donation switch, the
supervisor and its demotion ladder, the flight recorder, the device
diagnostics plane, telemetry heartbeats and the sharded (mesh) leg.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import F64
from ..io.writers import (checkpoint_replace, resolve_checkpoint,
                          write_table)
from ..utils.logging import get_logger
from .transform import make_logp_z, value_and_grad

_log = get_logger("ewt.hmc")
_LATER = "is not ported yet (see ROADMAP.md)"

# dual-averaging constants (Hoffman & Gelman 2014, as in the reference)
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75


@dataclass
class HMCState:
    z: torch.Tensor        # (W, ndim) unconstrained positions
    key: np.ndarray        # generator state (uint8)
    log_eps: float         # log step size
    log_eps_bar: float     # dual-averaging smoothed iterate
    h_bar: float           # dual-averaging error accumulator
    mass: np.ndarray       # (ndim,) diagonal mass matrix
    step: int
    accepted: torch.Tensor  # (W,) cumulative acceptance probabilities
    divergences: int
    mu: float = 0.0        # dual-averaging anchor (re-centred when the
    da_iter: int = 0       # mass changes) and iterations since anchor
    ngrad: int = 0         # cumulative batched gradient evaluations


def leapfrog(vgrad, z, p, g, lp, lnl, eps_c, mass, n_steps):
    """``n_steps`` leapfrog steps of all chains from ``(z, p)`` with the
    gradient ``g`` at ``z``: per-chain step sizes ``eps_c`` (W, 1),
    diagonal ``mass`` (ndim,). ``vgrad(z) -> (lp, lnl, g)``. Returns
    ``(z, p, g, lp, lnl)`` at the end point."""
    for _ in range(n_steps):
        p = p + 0.5 * eps_c * g
        z = z + eps_c * p / mass
        lp, lnl, g = vgrad(z)
        p = p + 0.5 * eps_c * g
    return z, p, g, lp, lnl


class HMCSampler:
    """Batched-chain HMC over a likelihood providing ``loglike_batch``
    (differentiable, ``(W, ndim)`` -> ``(W,)``), ``from_unit``,
    ``log_prior``, ``params``/``param_names``/``ndim`` and ``device`` (a
    :class:`~..models.build.PulsarLikelihood`); the chains live on the
    likelihood's device.

    ``jitter_L`` draws the trajectory length uniformly in
    ``[n_leapfrog/2, n_leapfrog]`` each step; ``mass0``/``z0`` warm-start
    the diagonal mass (z-space precisions) and the positions ((W, ndim),
    or one (ndim,) point jittered per chain)."""

    def __init__(self, like, outdir, nchains=64, seed=0, n_leapfrog=16,
                 target_accept=0.8, warmup=1000, init_eps=0.1,
                 eps_jitter=0.1, jitter_L=True, mass0=None, z0=None):
        self.like = like
        self.outdir = outdir
        self.W = int(nchains)
        self.ndim = like.ndim
        self.n_leapfrog = int(n_leapfrog)
        self.jitter_L = bool(jitter_L)
        self.target_accept = float(target_accept)
        self.warmup = int(warmup)
        self.init_eps = float(init_eps)
        self.eps_jitter = float(eps_jitter)
        self.mass0 = None if mass0 is None else np.asarray(mass0, float)
        self.z0 = None if z0 is None else np.asarray(z0, float)
        self.seed = seed
        self.device = torch.device(getattr(like, "device", "cpu"))
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self._logp = make_logp_z(like)
        os.makedirs(outdir, exist_ok=True)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=F64, device=self.device)

    def vgrad(self, z):
        """``(lp, lnl, g)`` of all chains at ``z``; a non-finite gradient
        entry is zeroed so a chain at a -inf/NaN point still moves
        (momentum only) and can escape instead of freezing."""
        lp, lnl, g = value_and_grad(self._logp, z)
        return lp, lnl, torch.where(torch.isfinite(g), g,
                                    torch.zeros_like(g))

    def _logp_values(self, z):
        with torch.no_grad():
            return self._logp(self._tensor(z))[0].cpu().numpy()

    # ---------------- init / checkpoint -------------------------------- #
    def _fresh_state(self):
        rng = np.random.default_rng(self.seed)
        if self.z0 is not None:
            # warm start: ADVI draws (or a point jittered per chain)
            if self.z0.ndim == 2:
                z = np.array(self.z0[rng.integers(0, len(self.z0), self.W)])
            else:
                z = self.z0[None, :] + 0.1 * rng.standard_normal(
                    (self.W, self.ndim))
        else:
            # prior draws, mapped into z space
            u = np.clip(rng.uniform(size=(self.W, self.ndim)), 1e-6,
                        1 - 1e-6)
            z = np.log(u) - np.log1p(-u)
        # redraw any chain that landed on a non-finite corner
        for _ in range(20):
            bad = ~np.isfinite(self._logp_values(z))
            if not bad.any():
                break
            u = np.clip(rng.uniform(size=(int(bad.sum()), self.ndim)),
                        1e-6, 1 - 1e-6)
            z[bad] = np.log(u) - np.log1p(-u)
        mass = (np.ones(self.ndim) if self.mass0 is None
                else self.mass0.copy())
        self.gen.manual_seed(int(self.seed))
        return HMCState(z=self._tensor(z), key=self.gen.get_state().numpy(),
                        log_eps=math.log(self.init_eps),
                        log_eps_bar=math.log(self.init_eps), h_bar=0.0,
                        mass=mass, step=0,
                        accepted=torch.zeros(self.W, dtype=F64,
                                             device=self.device),
                        divergences=0, mu=math.log(10.0 * self.init_eps),
                        da_iter=0)

    @property
    def _ckpt_path(self):
        return os.path.join(self.outdir, "state.npz")

    def _save_state(self, st):
        tmp = self._ckpt_path + ".tmp.npz"
        np.savez(tmp, z=st.z.cpu().numpy(), key=st.key, log_eps=st.log_eps,
                 log_eps_bar=st.log_eps_bar, h_bar=st.h_bar, mass=st.mass,
                 step=st.step, accepted=st.accepted.cpu().numpy(),
                 divergences=st.divergences, mu=st.mu, da_iter=st.da_iter,
                 ngrad=st.ngrad)
        checkpoint_replace(tmp, self._ckpt_path)

    def _load_state(self, path):
        z = np.load(path)
        key = np.asarray(z["key"], dtype=np.uint8)
        self.gen.set_state(torch.from_numpy(key.copy()))
        return HMCState(z=self._tensor(z["z"]), key=key,
                        log_eps=float(z["log_eps"]),
                        log_eps_bar=float(z["log_eps_bar"]),
                        h_bar=float(z["h_bar"]), mass=z["mass"],
                        step=int(z["step"]),
                        accepted=self._tensor(z["accepted"]),
                        divergences=int(z["divergences"]),
                        mu=float(z["mu"]), da_iter=int(z["da_iter"]),
                        ngrad=int(z["ngrad"]) if "ngrad" in z.files else 0)

    def _truncate_chain_to(self, step):
        """Resume repair: a kill between the chain append and the state
        save leaves rows past the checkpoint; cut ``chain_1.txt`` back to
        the ``step * W`` rows the checkpoint accounts for."""
        path = os.path.join(self.outdir, "chain_1.txt")
        if not os.path.exists(path):
            return
        with open(path) as fh:
            lines = [ln for ln in fh.read().splitlines()
                     if len(ln.split()) == self.ndim + 4]
        want = int(step) * self.W
        if len(lines) != want:
            _log.info("resume repair: truncating chain_1.txt to %d rows "
                      "(had %d)", want, len(lines))
        with open(path, "w") as fh:
            fh.write("".join(ln + "\n" for ln in lines[:want]))

    # ---------------- one block ---------------------------------------- #
    def _run_block(self, st, todo, adapt):
        """Advance ``st`` by ``todo`` steps (dual averaging every step when
        ``adapt``); returns the block's positions (todo, W, ndim), lnL
        (todo, W) and mean acceptance probability, on the device."""
        W, nd, dev, gen = self.W, self.ndim, self.device, self.gen
        mass = self._tensor(st.mass)
        sqm = torch.sqrt(mass)
        l_min = max(1, self.n_leapfrog // 2)
        if self.jitter_L:
            lengths = torch.randint(l_min, self.n_leapfrog + 1, (todo,),
                                    generator=gen, device=dev).tolist()
        else:
            lengths = [self.n_leapfrog] * todo

        def scalar(v):
            return torch.tensor(v, dtype=F64, device=dev)

        log_eps, log_eps_bar = scalar(st.log_eps), scalar(st.log_eps_bar)
        h_bar, mu = scalar(st.h_bar), scalar(st.mu)
        z, acc = st.z, st.accepted
        ndiv = torch.zeros((), dtype=F64, device=dev)
        lp, lnl, g = self.vgrad(z)
        ngrad = 1                      # the block-entry gradient
        zs = torch.empty((todo, W, nd), dtype=F64, device=dev)
        lnls = torch.empty((todo, W), dtype=F64, device=dev)
        p_sum = torch.zeros((), dtype=F64, device=dev)
        for i, n_steps in enumerate(lengths):
            eps = torch.exp(log_eps)
            p0 = torch.randn((W, nd), generator=gen, dtype=F64,
                             device=dev) * sqm
            # per-chain step-size jitter de-synchronizes periodic orbits
            eps_c = eps * (1.0 + self.eps_jitter * (2.0 * torch.rand(
                (W, 1), generator=gen, dtype=F64, device=dev) - 1.0))
            z1, p1, g1, lp1, lnl1 = leapfrog(self.vgrad, z, p0, g, lp, lnl,
                                             eps_c, mass, n_steps)
            ngrad += n_steps
            ke0 = 0.5 * torch.sum(p0 * p0 / mass, dim=1)
            ke1 = 0.5 * torch.sum(p1 * p1 / mass, dim=1)
            log_ratio = (lp1 - ke1) - (lp - ke0)
            # NaN (-inf minus -inf) rejects; +inf must survive: it is the
            # escape of a chain stuck at lp = -inf to any finite point
            ninf = torch.full_like(log_ratio, -math.inf)
            log_ratio = torch.where(torch.isnan(log_ratio), ninf, log_ratio)
            log_ratio = torch.where(torch.isfinite(lp1), log_ratio, ninf)
            # divergence: energy error far beyond stochastic scale at a
            # finite end point (an -inf end point is an ordinary rejection)
            ndiv = ndiv + torch.sum((log_ratio < -50.0)
                                    & torch.isfinite(lp1))
            p_acc = torch.clamp(torch.exp(log_ratio), max=1.0)
            accept = torch.log(torch.rand(W, generator=gen, dtype=F64,
                                          device=dev)) < log_ratio
            z = torch.where(accept[:, None], z1, z)
            lp = torch.where(accept, lp1, lp)
            lnl = torch.where(accept, lnl1, lnl)
            g = torch.where(accept[:, None], g1, g)
            acc = acc + p_acc
            if adapt:
                t = float(st.da_iter + i) + 1.0
                h_bar = ((1.0 - 1.0 / (t + _T0)) * h_bar
                         + (self.target_accept - p_acc.mean()) / (t + _T0))
                log_eps = mu - math.sqrt(t) / _GAMMA * h_bar
                w = t ** (-_KAPPA)
                log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            zs[i] = z
            lnls[i] = lnl
            p_sum = p_sum + p_acc.mean()
        st.z, st.accepted = z, acc
        st.log_eps, st.log_eps_bar = float(log_eps), float(log_eps_bar)
        st.h_bar = float(h_bar)
        st.divergences += int(ndiv)
        st.ngrad += ngrad
        st.step += todo
        if adapt:
            st.da_iter += todo
        st.key = gen.get_state().numpy()
        return zs, lnls, float(p_sum) / todo

    # ---------------- public API --------------------------------------- #
    def sample(self, nsamp, resume=True, verbose=True, block_size=100):
        """Run ``nsamp`` total steps, appending every step's W chains to
        ``chain_1.txt`` after each block; returns the final state."""
        chain_path = os.path.join(self.outdir, "chain_1.txt")
        ckpt = resolve_checkpoint(self._ckpt_path) if resume else None
        if ckpt is not None:
            st = self._load_state(ckpt)
            if verbose:
                _log.info("resuming from step %d", st.step)
            self._truncate_chain_to(st.step)
        else:
            st = self._fresh_state()
            open(chain_path, "w").close()
        np.savetxt(os.path.join(self.outdir, "pars.txt"),
                   self.like.param_names, fmt="%s")

        warm_z = []
        mass_at = 3 * self.warmup // 4    # set the mass here; eps re-adapts
        while st.step < nsamp:
            todo = int(min(block_size, nsamp - st.step))
            # never straddle the warmup or mass boundaries in one block
            for edge in (mass_at, self.warmup):
                if st.step < edge:
                    todo = min(todo, edge - st.step)
            adapt = st.step < self.warmup
            ngrad0 = st.ngrad
            t0 = time.perf_counter()
            zs, lnls, mean_acc = self._run_block(st, todo, adapt)
            zs_np = zs.cpu().numpy()
            block_s = time.perf_counter() - t0

            if mass_at >= st.step > self.warmup // 4:
                # warmup positions for the diagonal mass
                warm_z.append(zs_np[::4].reshape(-1, self.ndim))
            if warm_z and st.step >= mass_at:
                st.mass = 1.0 / np.maximum(
                    np.var(np.concatenate(warm_z, axis=0), axis=0), 1e-12)
                warm_z.clear()
                # restart dual averaging under the new metric: re-anchor
                # mu 10x above the current step, zero the error sum,
                # restart the clock, forget the old-metric average
                st.mu = math.log(10.0) + st.log_eps
                st.h_bar = 0.0
                st.da_iter = 0
                st.log_eps_bar = st.log_eps
            if st.step == self.warmup:
                st.log_eps = st.log_eps_bar

            # --- chain rows (theta space, the reference's contract) ----- #
            with torch.no_grad():
                thetas = self.like.from_unit(
                    torch.sigmoid(zs.reshape(-1, self.ndim)))
                lnpri = self.like.log_prior(thetas).cpu().numpy()
            thetas = thetas.cpu().numpy()
            lnl_np = lnls.reshape(-1).cpu().numpy()
            acc_rate = float(st.accepted.mean()) / max(st.step, 1)
            rows = np.concatenate([
                thetas, (lnpri + lnl_np)[:, None], lnl_np[:, None],
                np.full((len(thetas), 1), acc_rate),
                np.zeros((len(thetas), 1))], axis=1)
            write_table(chain_path, rows, append=True)
            self._save_state(st)
            grads = st.ngrad - ngrad0
            stats = {"step": st.step, "steps": todo, "chains": self.W,
                     "grads": grads, "block_s": block_s,
                     "ms_per_step": 1e3 * block_s / todo,
                     "ms_per_grad": 1e3 * block_s / grads,
                     "grad_evals_per_s": grads / block_s,
                     "accept": mean_acc, "warmup": adapt}
            if verbose:
                _log.info("step %d/%d eps=%.4f acc=%.3f div=%d "
                          "ms/grad=%.3f", st.step, nsamp,
                          math.exp(st.log_eps), mean_acc, st.divergences,
                          stats["ms_per_grad"], extra={"hmc_stats": stats})
        return st


def run_hmc(like, outdir, nsamp, params=None, resume=True, seed=0,
            verbose=True, advi_init=True, **kw):
    """Convenience entry honouring the paramfile's sampler settings
    (``nchains``, ``n_leapfrog``, ``warmup``, ``target_accept``,
    ``advi_init``, ``jitter_L``); returns the sampler.

    ``advi_init`` (default on): fit a mean-field ADVI posterior first
    (1500 steps of 16 draws) and warm-start HMC from it — positions are
    ADVI draws and the diagonal mass is the ADVI precision — with the
    warmup shortened to ``max(200, min(400, nsamp // 10))`` unless the
    caller or the paramfile chose one. Skipped when resuming from a
    checkpoint."""
    opts = dict(seed=seed)
    skw = getattr(params, "sampler_kwargs", {}) if params is not None else {}
    for knob in ("device_state", "chain_shard", "psr_shard"):
        if skw.get(knob) or kw.get(knob):
            raise NotImplementedError(f"{knob} for HMC {_LATER}")
    if params is not None:
        opts.update(
            nchains=int(skw.get("nchains", 64)),
            n_leapfrog=int(skw.get("n_leapfrog", 16)),
            warmup=int(skw.get("warmup", 1000)),
            target_accept=float(skw.get("target_accept", 0.8)))
        if "advi_init" in skw:
            advi_init = bool(int(skw["advi_init"]))
        if "jitter_L" in skw:
            opts["jitter_L"] = bool(int(skw["jitter_L"]))
    opts.update(kw)
    resuming = resume and resolve_checkpoint(
        os.path.join(outdir, "state.npz")) is not None
    if advi_init and "mass0" not in opts and not resuming:
        from .vi import fit_advi
        fit = fit_advi(like, steps=1500, mc=16, seed=seed, verbose=verbose)
        sig2 = np.exp(2.0 * np.asarray(fit["z_log_sig"]))
        opts["mass0"] = 1.0 / np.maximum(sig2, 1e-12)
        mu = np.asarray(fit["z_mu"])
        rng = np.random.default_rng(seed)
        W = opts.get("nchains", 64)
        opts["z0"] = mu[None, :] + np.sqrt(sig2)[None, :] \
            * rng.standard_normal((W, len(mu)))
        # the metric is near-correct from the start: a short warmup only
        # settles the step size — unless the caller chose a warmup
        if "warmup" not in kw and "warmup" not in skw:
            opts["warmup"] = max(200, min(400, nsamp // 10))
    sampler = HMCSampler(like, outdir, **opts)
    sampler.sample(nsamp, resume=resume, verbose=verbose)
    return sampler
