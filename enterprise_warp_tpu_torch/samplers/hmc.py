# ewt: allow-precision module — positions, momenta, the mass matrix and the chain
# are float64: the package's sampler-state island
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

The chains' state stays on the device between blocks. The reference's
``device_state`` switch (``EWT_DEVICE_STATE``) is accepted; off, its seed
path's host round trip after every block gives the same chain bit for
bit, so the port keeps the state on the device either way.

The run plane, as the reference's: :meth:`HMCSampler.sample` runs in a
``run_scope`` (one ``heartbeat`` and one ``checkpoint`` per block), each
block goes through ``BlockSupervisor("hmc.dispatch")`` (demotions applied
in process by :func:`run_hmc`), the fault sites ``hmc.dispatch``,
``hmc.ckpt`` and ``hmc.nonfinite``, the flight recorder (divergences,
the position, a non-finite committed lnL), and a SIGTERM stops the run at
a block boundary.

The device diagnostics plane, as the reference's
(``utils/devicemetrics.py``; off with ``EWT_DEVICE_DIAG=0`` or
``EWT_TELEMETRY=0``): the leapfrog energy error of every trajectory with
a finite Metropolis log-ratio and the block's step-size extrema, folded
after the step loop from per-step values kept by reference and read in
the block's one host read (the ``energy_err_*`` and ``eps_min``/
``eps_max`` heartbeat keys), and the streaming ``MomentLedger`` over the
theta chains, fed from the rows the chain file gets anyway
(``rhat_stream``/``ess_stream``, the ``diag_*`` checkpoint keys).

Processes (``parallel/distributed.py``): a sharded joint likelihood
(``psr_shard``) reaches HMC through its gradient, summed over the group;
``chain_shard`` is the PT branch's alone. Only the primary process writes
the chain, ``pars.txt`` and the checkpoint.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import F64
from ..io.writers import (checkpoint_exists, checkpoint_replace,
                          resolve_checkpoint, write_table)
from ..parallel.distributed import from_primary, is_primary
from ..resilience import faults
from ..resilience.supervisor import (BlockSupervisor, PlatformDemotion,
                                     apply_demotion, preemption_requested)
from ..utils import devicemetrics, profiling, telemetry
from ..utils.diagnostics import throttled_block_worst
from ..utils.flightrec import flight_recorder
from ..utils.logging import EvalRateMeter, get_logger
from ..utils.profiling import monotonic
from .transform import make_logp_z, value_and_grad

_log = get_logger("ewt.hmc")
# set once a device_state-off request has been logged (once a process)
_STATE_NOTED = []

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
                 eps_jitter=0.1, jitter_L=True, mass0=None, z0=None,
                 device_state=None):
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
        if device_state is None:
            device_state = os.environ.get("EWT_DEVICE_STATE", "1") != "0"
        if not device_state and not _STATE_NOTED:
            _STATE_NOTED.append(True)
            _log.info("device_state off: the chains' state stays on the "
                      "device all the same (the same chain)")
        self._supervisor = BlockSupervisor("hmc.dispatch")
        self._last_sync_s = self._last_bubble_s = 0.0
        self._g_sync = telemetry.registry().gauge("host_sync_wall_s")
        self._g_bubble = telemetry.registry().gauge("block_bubble_s")
        # the diagnostics plane's streaming ledger over the theta chains
        self.diag_ledger = (devicemetrics.MomentLedger(self.W, self.ndim)
                            if devicemetrics.enabled() else None)
        self._diag_hb = {}
        os.makedirs(outdir, exist_ok=True)

    # ewt: allow-host-sync — uploads host state (a fresh start, a resume, the
    # mass matrix) at block boundaries
    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=F64, device=self.device)

    def vgrad(self, z):
        """``(lp, lnl, g)`` of all chains at ``z``; a non-finite gradient
        entry is zeroed so a chain at a -inf/NaN point still moves
        (momentum only) and can escape instead of freezing."""
        lp, lnl, g = value_and_grad(self._logp, z)
        return lp, lnl, torch.where(torch.isfinite(g), g,
                                    torch.zeros_like(g))

    # ewt: allow-host-sync — the initial-point search reads its log densities
    # on the host, before sampling
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

    # ewt: allow-host-sync — the checkpoint writes the chain state to disk at a
    # block boundary
    def _save_state(self, st):
        if not is_primary():
            return
        tmp = self._ckpt_path + ".tmp.npz"
        # the streaming ledger rides the checkpoint (``diag_*`` keys)
        diag = {}
        if self.diag_ledger is not None and len(self.diag_ledger):
            diag = {f"diag_{k}": v for k, v in
                    self.diag_ledger.state_dict().items()}
        np.savez(tmp, z=st.z.cpu().numpy(), key=st.key, log_eps=st.log_eps,
                 log_eps_bar=st.log_eps_bar, h_bar=st.h_bar, mass=st.mass,
                 step=st.step, accepted=st.accepted.cpu().numpy(),
                 divergences=st.divergences, mu=st.mu, da_iter=st.da_iter,
                 ngrad=st.ngrad, **diag)
        checkpoint_replace(tmp, self._ckpt_path)
        faults.fire("hmc.ckpt", path=self._ckpt_path, step=int(st.step))

    def _read_ckpt(self):
        """The resolved checkpoint's arrays (None without one), read by
        the primary and shared with every rank
        (:func:`~..parallel.distributed.from_primary`)."""
        def read():
            ckpt = resolve_checkpoint(self._ckpt_path,
                                      what="hmc checkpoint")
            if ckpt is None:
                return None
            with np.load(ckpt) as z:
                return {k: z[k] for k in z.files}
        return from_primary(read)

    def _load_state(self, z):
        """The state of the checkpoint arrays ``z``
        (:meth:`_read_ckpt`)."""
        key = np.asarray(z["key"], dtype=np.uint8)
        self.gen.set_state(torch.from_numpy(key.copy()))
        if self.diag_ledger is not None and "diag_counts" in z:
            self.diag_ledger = devicemetrics.MomentLedger.from_state(
                self.W, self.ndim,
                {k: z[f"diag_{k}"] for k in
                 ("counts", "mean", "m2", "min", "max")})
        return HMCState(z=self._tensor(z["z"]), key=key,
                        log_eps=float(z["log_eps"]),
                        log_eps_bar=float(z["log_eps_bar"]),
                        h_bar=float(z["h_bar"]), mass=z["mass"],
                        step=int(z["step"]),
                        accepted=self._tensor(z["accepted"]),
                        divergences=int(z["divergences"]),
                        mu=float(z["mu"]), da_iter=int(z["da_iter"]),
                        ngrad=int(z["ngrad"]) if "ngrad" in z else 0)

    def _truncate_chain_to(self, step):
        """Resume repair: a kill between the chain append and the state
        save leaves rows past the checkpoint; cut ``chain_1.txt`` back to
        the ``step * W`` rows the checkpoint accounts for."""
        path = os.path.join(self.outdir, "chain_1.txt")
        if not is_primary() or not os.path.exists(path):
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
            # ewt: allow-host-sync — the block's trajectory lengths are drawn
            # on the device and read once a block, before the leapfrog loop
            lengths = torch.randint(l_min, self.n_leapfrog + 1, (todo,),
                                    generator=gen, device=dev).tolist()
        else:
            lengths = [self.n_leapfrog] * todo

        # ewt: allow-host-sync — the step-size state goes up once a block
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
        # the diagnostics plane: each step's log-ratio and step size, kept
        # by reference and folded after the loop
        emit_diag = devicemetrics.enabled()
        d_ratio, d_logeps = [], []
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
            if emit_diag:
                d_ratio.append(log_ratio)
                d_logeps.append(log_eps)
            zs[i] = z
            lnls[i] = lnl
            p_sum = p_sum + p_acc.mean()
        reads = [log_eps, log_eps_bar, h_bar, ndiv, p_sum]
        if emit_diag:
            # the energy error over trajectories with a finite log-ratio
            # (an -inf end point is a prior-corner rejection, not an
            # integrator error) and the step size's extrema
            lr = torch.stack(d_ratio)
            fin = torch.isfinite(lr)
            dh = torch.where(fin, -lr, torch.zeros_like(lr))
            le = torch.stack(d_logeps)
            reads += [fin.sum().to(F64), dh.sum(), (dh * dh).sum(),
                      dh.abs().amax(), le.amin(), le.amax()]
        t_sync = monotonic()
        # the block's one host read
        # ewt: allow-host-sync — the block's one host read: the step-size
        # adaptation and the diagnostics
        vals = torch.stack(reads).cpu().tolist()
        log_eps, log_eps_bar, h_bar = vals[:3]
        ndiv, mean_acc = int(vals[3]), vals[4] / todo
        self._diag_hb = _energy_heartbeat(vals[5:]) if emit_diag else {}
        self._last_sync_s = monotonic() - t_sync
        self._g_sync.set(self._last_sync_s)
        st.z, st.accepted = z, acc
        st.log_eps, st.log_eps_bar = log_eps, log_eps_bar
        st.h_bar = h_bar
        st.divergences += ndiv
        st.ngrad += ngrad
        st.step += todo
        if adapt:
            st.da_iter += todo
        st.key = gen.get_state().numpy()
        return zs, lnls, mean_acc

    # ---------------- public API --------------------------------------- #
    def sample(self, nsamp, resume=True, verbose=True, block_size=100):
        """Run ``nsamp`` total steps, appending every step's W chains to
        ``chain_1.txt`` after each block; returns the final state. The run
        is a ``run_scope`` on the output directory, with one ``heartbeat``
        (step, eps, acceptance, divergences, gradient evaluations per
        second, worst R-hat/ESS) and one ``checkpoint`` per block."""
        with telemetry.run_scope(
                self.outdir, sampler="hmc", ndim=self.ndim, nchains=self.W,
                nsamp=int(nsamp), warmup=self.warmup,
                param_names=list(self.like.param_names)) as rec:
            return self._sample_impl(nsamp, resume, verbose, block_size,
                                     rec)

    def _sample_impl(self, nsamp, resume, verbose, block_size, rec):
        chain_path = os.path.join(self.outdir, "chain_1.txt")
        ckpt = self._read_ckpt() if resume else None
        if ckpt is not None:
            st = self._load_state(ckpt)
            if verbose:
                _log.info("resuming from step %d", st.step)
            self._truncate_chain_to(st.step)
        else:
            st = self._fresh_state()
            # no earlier sample() call's statistics on a reused sampler
            if self.diag_ledger is not None:
                self.diag_ledger = devicemetrics.MomentLedger(self.W,
                                                              self.ndim)
            if is_primary():
                open(chain_path, "w").close()
        if is_primary():
            np.savetxt(os.path.join(self.outdir, "pars.txt"),
                       self.like.param_names, fmt="%s")
        meter = EvalRateMeter(initial_total=self.W * int(st.ngrad))
        diag_t = [0.0]
        ndiv_seen = int(st.divergences)
        t_ready = None

        warm_z = []
        mass_at = 3 * self.warmup // 4    # set the mass here; eps re-adapts
        while st.step < nsamp:
            if preemption_requested():
                # the previous block's state is on disk; run_scope emits
                # run_end(reason="preempted")
                _log.warning("preemption requested: stopping at step %d "
                             "(checkpoint on disk)", st.step)
                break
            todo = int(min(block_size, nsamp - st.step))
            # never straddle the warmup or mass boundaries in one block
            for edge in (mass_at, self.warmup):
                if st.step < edge:
                    todo = min(todo, edge - st.step)
            adapt = st.step < self.warmup
            ngrad0 = st.ngrad
            t0 = monotonic()
            if t_ready is not None:
                self._last_bubble_s = t0 - t_ready
                self._g_bubble.set(self._last_bubble_s)
            with profiling.span("hmc.dispatch", steps=todo, adapt=adapt):
                zs, lnls, mean_acc = self._supervisor.call(
                    lambda: self._run_block(st, todo, adapt), gen=self.gen,
                    step=int(st.step), block_steps=int(todo))
                # ewt: allow-host-sync,collective-safety — the block's
                # positions come to the host once a block for the chain file;
                # every rank reads its own replicated block
                zs_np = zs.cpu().numpy()
            t_ready = monotonic()
            block_s = t_ready - t0
            profiling.capture_tick()
            if st.divergences > ndiv_seen:
                flight_recorder().record(
                    "divergence", step=int(st.step),
                    new=int(st.divergences - ndiv_seen),
                    total=int(st.divergences))
            ndiv_seen = st.divergences
            flight_recorder().note_state(
                sampler="hmc", outdir=self.outdir, step=int(st.step),
                divergences=int(st.divergences),
                eps=float(math.exp(st.log_eps)))

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
                # ewt: allow-host-sync,collective-safety — the block's chain
                # rows (log prior, theta, lnL) come to the host once a block
                # for the chain file; every rank reads its own
                lnpri = self.like.log_prior(thetas).cpu().numpy()
            # ewt: allow-host-sync,collective-safety — the block's chain rows
            # come to the host once a block for the chain file
            thetas = thetas.cpu().numpy()
            # ewt: allow-host-sync,collective-safety — the block's chain rows
            # come to the host once a block for the chain file
            lnl_np = lnls.reshape(-1).cpu().numpy()
            self._escalate_nonfinite(st, thetas, lnl_np)
            acc_rate = float(st.accepted.mean()) / max(st.step, 1)
            rows = np.concatenate([
                thetas, (lnpri + lnl_np)[:, None], lnl_np[:, None],
                np.full((len(thetas), 1), acc_rate),
                np.zeros((len(thetas), 1))], axis=1)
            if is_primary():
                write_table(chain_path, rows, append=True)
            if self.diag_ledger is not None:
                self.diag_ledger.append_samples(
                    thetas.reshape(todo, self.W, self.ndim))
            self._save_state(st)
            rec.checkpoint(step=int(st.step))
            grads = st.ngrad - ngrad0
            if rec.enabled:
                meter.add(self.W * grads)
                hb = dict(step=int(st.step), nsamp=int(nsamp),
                          accept=round(mean_acc, 4),
                          eps=round(float(math.exp(st.log_eps)), 6),
                          divergences=int(st.divergences),
                          evals_per_s=round(meter.window_rate(), 1),
                          evals_total=int(meter.total), cache_hit_rate=0.0,
                          host_sync_wall_s=round(self._last_sync_s, 4),
                          block_bubble_s=round(self._last_bubble_s, 4),
                          warmup=bool(adapt))
                hb.update(self._diag_hb)
                worst_stream = (self.diag_ledger.worst()
                                if self.diag_ledger is not None else None)
                if worst_stream is not None:
                    hb["rhat_stream"] = worst_stream["rhat"]
                    hb["ess_stream"] = worst_stream["ess"]
                    devicemetrics.set_stream_gauges(worst_stream)
                mem = profiling.memory_watermark(self.device)
                if mem is not None:
                    hb.update(mem)
                rss = profiling.host_rss_bytes()
                if rss is not None:
                    hb["rss_bytes"] = rss
                worst = throttled_block_worst(
                    thetas.reshape(todo, self.W, self.ndim),
                    self.like.param_names, diag_t)
                if worst is not None:
                    hb["rhat"] = worst["rhat"]
                    hb["ess"] = worst["ess"]
                rec.heartbeat(**hb)
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

    def _escalate_nonfinite(self, st, thetas, lnl_np):
        """A committed non-finite lnL is an anomaly (HMC accepts only
        finite end points, so the chain state itself went bad): count,
        record and dump once. Fault site ``hmc.nonfinite`` plants one (on
        the escalation's copy; the chain rows are left as they are)."""
        if faults.fire("hmc.nonfinite", step=int(st.step)) is not None:
            lnl_np = lnl_np.copy()
            lnl_np[0] = np.nan
        bad = ~np.isfinite(lnl_np)
        nbad = int(bad.sum())
        if not nbad:
            return
        telemetry.registry().counter("nonfinite_eval",
                                     where="hmc_block").inc(nbad)
        fr = flight_recorder()
        fr.record("nonfinite_eval", where="hmc_block", count=nbad,
                  step=int(st.step))
        fr.anomaly("nonfinite_eval", run_dir=self.outdir,
                   once_key=f"nonfinite_eval:{self.outdir}",
                   step=int(st.step), n_bad=nbad, bad_theta=thetas[bad][:8],
                   bad_lnl=lnl_np[bad][:8])


def _energy_heartbeat(vals):
    """The plane's heartbeat keys from the block's folded values ``(n,
    sum, sum of squares, max |dH|, min and max log step size)``."""
    e_n, e_sum, e_sq, e_max, le_min, le_max = vals
    hb = {}
    if e_n > 0:
        e_mean = e_sum / e_n
        hb["energy_err_mean"] = round(e_mean, 6)
        hb["energy_err_std"] = round(
            math.sqrt(max(e_sq / e_n - e_mean ** 2, 0.0)), 6)
        hb["energy_err_max"] = round(e_max, 4)
    if math.isfinite(le_min):
        hb["eps_min"] = round(math.exp(le_min), 6)
        hb["eps_max"] = round(math.exp(le_max), 6)
    return hb


def run_hmc(like, outdir, nsamp, params=None, resume=True, seed=0,
            verbose=True, advi_init=True, **kw):
    """Convenience entry honouring the paramfile's sampler settings
    (``nchains``, ``n_leapfrog``, ``warmup``, ``target_accept``,
    ``advi_init``, ``jitter_L``, ``device_state``); returns the sampler.

    ``advi_init`` (default on): fit a mean-field ADVI posterior first
    (1500 steps of 16 draws) and warm-start HMC from it — positions are
    ADVI draws and the diagonal mass is the ADVI precision — with the
    warmup shortened to ``max(200, min(400, nsamp // 10))`` unless the
    caller or the paramfile chose one. Skipped when resuming from a
    checkpoint."""
    opts = dict(seed=seed)
    skw = getattr(params, "sampler_kwargs", {}) if params is not None else {}
    if "device_state" in skw:
        opts["device_state"] = bool(int(skw["device_state"]))
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
    resuming = resume and from_primary(lambda: checkpoint_exists(
        os.path.join(outdir, "state.npz")))
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
    # demotion re-entry: an in-process rung (mega -> classic) is applied
    # and the run resumes from its checkpoint; the bottom propagates
    while True:
        sampler = HMCSampler(like, outdir, **opts)
        try:
            sampler.sample(nsamp, resume=resume, verbose=verbose)
        except PlatformDemotion as d:
            if not apply_demotion(d):
                raise
            _log.warning("re-entering the HMC run on the %s path (resume "
                         "from checkpoint)", d.to_level)
            resume = True
            continue
        return sampler
