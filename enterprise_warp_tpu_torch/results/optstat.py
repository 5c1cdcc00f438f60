"""The frequentist optimal statistic for a GWB, batched over draws.

Counterpart of ``enterprise_warp_tpu/results/optstat.py`` (the
cross-correlation estimator of Chamberlin et al. 2015):

    X_a = F_a^T P_a^-1 r_a          Z_a = F_a^T P_a^-1 F_a
    rho_ab = X_a^T phihat X_b / tr(Z_a phihat Z_b phihat)
    sig_ab = tr(Z_a phihat Z_b phihat)^(-1/2)
    A2_orf = sum_ab G_ab rho_ab / sig_ab^2 / sum_ab G_ab^2 / sig_ab^2
    SNR    = sum_ab G_ab rho_ab / sig_ab^2 / sqrt(sum_ab G_ab^2/sig_ab^2)

with ``P_a`` the pulsar's whole covariance at the drawn parameters
(white noise, its own processes and the GW auto term, the timing model
through large-variance columns) applied by the same Woodbury identity as
the likelihood, and ``phihat`` the unit-amplitude template spectrum. The
reference computes it outside any Pallas kernel, in float64; so does the
port: ``torch.linalg.cholesky``, ``torch.cholesky_solve`` and products,
on the card unless the caller asks for the CPU. The reference ``vmap``s
over draws and loops over pulsar pairs; here the draws are one batch
(``OS_CHUNK`` at a time) and the pair sums one batched product.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .. import F64, resolve_device
from ..models.build import (_resolve_params, basis_static, collect_params,
                            eval_block_phi, eval_nw, lower_terms,
                            white_static)
from ..ops.kernel import cholesky_nan, whiten_inputs
from ..ops.spectra import powerlaw_psd
from ..parallel.orf import orf_matrix
from ..parallel.pta import _TM_PHI
from ..utils.logging import get_logger
from .core import EnterpriseWarpResult

_log = get_logger("ewt.results")

_GAMMA_GW = 13.0 / 3.0
# draws per batch: a pulsar's whitened basis T w takes (draws, ntoa,
# nbasis) float64, 1.1 MB a draw at BASELINE config 3 (1000 TOAs, 143
# columns), so 128 draws hold 146 MB where 1000 would hold 1.1 GB
OS_CHUNK = 128


def os_inputs(psrs, termlists, fixed_values=None, gamma_gw=_GAMMA_GW,
              device="cuda"):
    """The statistic's static inputs on ``device``: ``(per_psr, phihat,
    sampled)``. ``per_psr`` holds, per pulsar, the white-noise and basis
    programs (``wb``, ``bb``), the whitened residuals ``r_w``, the basis
    ``T`` (its noise and GW columns, then the timing model's ``ntm``),
    the column scales ``cs2``, ``sigma2``, ``ntoa`` and the whitened GW
    columns ``F_w``; ``phihat`` is the unit-amplitude template spectrum."""
    t0 = min(p.toas.min() for p in psrs)
    t1 = max(p.toas.max() for p in psrs)
    lowered = [lower_terms(p, tl, common_grid=(t0, t1 - t0))
               for p, tl in zip(psrs, termlists)]
    all_params = []
    for wb, bb, _ in lowered:
        all_params.extend(collect_params(wb, bb))
    sampled, mapping = _resolve_params(all_params, fixed_values)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64,
                               device=device)

    per_psr = []
    freqs = df = None
    for (wb, bb, T_all), psr in zip(lowered, psrs):
        sigma = psr.toaerrs
        r_w, M_w, T_w, cs2, _ = whiten_inputs(psr.residuals, sigma,
                                              psr.Mmat, T_all)
        gw = [b for b in bb if b.orf is not None]
        if len(gw) != 1:
            raise ValueError(
                "optimal statistic requires exactly one correlated common "
                "term in the model (the gwb entry of common_signals)")
        gw = gw[0]
        freqs, df = gw.freqs, gw.df
        per_psr.append(dict(
            wb=white_static(wb, mapping, device),
            bb=basis_static(bb, mapping, device),
            r_w=dev(r_w), T=dev(np.concatenate([T_w, M_w], axis=1)),
            ntm=M_w.shape[1], cs2=dev(cs2), sigma2=dev(sigma ** 2),
            ntoa=len(psr), F_w=dev(T_all[:, gw.col_slice] / sigma[:, None])))
    one = torch.ones(1, dtype=F64, device=device)
    phihat = powerlaw_psd(dev(freqs), dev(df), 0.0 * one,
                          gamma_gw * one)[0]
    return per_psr, phihat, sampled


def os_noise(theta, pp):
    """One pulsar's white-noise variances ``nw`` (D, ntoa) and prior
    variances ``phi`` (D, nb) at draws ``theta`` (D, ndim); ``pp`` is its
    entry of :func:`os_inputs`. The timing-model columns take
    ``_TM_PHI``."""
    nw = eval_nw(theta, pp["wb"], pp["ntoa"], pp["sigma2"])
    phi = torch.cat([eval_block_phi(theta, bb) for bb in pp["bb"]],
                    dim=-1) * pp["cs2"]
    return nw, torch.cat([phi, torch.full(
        (theta.shape[0], pp["ntm"]), _TM_PHI, dtype=F64,
        device=theta.device)], dim=-1)


def make_os_fn(psrs, termlists, fixed_values=None, gamma_gw=_GAMMA_GW,
               device="cuda"):
    """Build ``os_pairs(theta) -> (rho, sig)`` over all pulsar pairs.

    Returns ``(fn, pairs, xi, sampled)``: ``fn`` takes one parameter
    vector (ndim,) or a batch of draws (D, ndim) and returns numpy
    float64 ``rho`` and ``sig``, (npairs,) or (D, npairs), pairs in the
    reference's order ``(a, b), a < b``; ``xi`` are the pairs' angular
    separations."""
    device = resolve_device(device)
    per_psr, phihat, sampled = os_inputs(psrs, termlists, fixed_values,
                                         gamma_gw, device)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64,
                               device=device)

    npsr = len(psrs)
    pairs = [(a, b) for a in range(npsr) for b in range(a + 1, npsr)]
    ia, ib = (torch.as_tensor(np.asarray(pairs).T[i], device=device)
              for i in (0, 1))
    pos = np.stack([p.pos for p in psrs])
    cosxi = np.clip(np.einsum("ai,bi->ab", pos, pos), -1, 1)
    xi = np.array([np.arccos(cosxi[a, b]) for a, b in pairs])

    def per_pulsar_XZ(theta, pp):
        """``X`` (D, k) and ``Z`` (D, k, k) of one pulsar at draws
        ``theta`` (D, ndim)."""
        nw, phi = os_noise(theta, pp)
        T = pp["T"]
        w = 1.0 / nw
        Tw = T * w[..., None]                           # (D, ntoa, nb)
        Sigma = torch.diag_embed(1.0 / phi) + T.T @ Tw
        # a draw whose factor fails gets NaN, as the reference's does
        L = cholesky_nan(Sigma)
        # P^-1 applied to the residuals and to the GW columns at once
        x = torch.cat([pp["r_w"][:, None], pp["F_w"]], dim=1)
        y = x * w[..., None]
        s = torch.cholesky_solve(T.T @ y, L)
        Px = pp["F_w"].T @ (y - Tw @ s)                  # (D, k, 1 + k)
        return Px[..., 0], Px[..., 1:]

    def os_batch(theta):
        X, Z = zip(*(per_pulsar_XZ(theta, pp) for pp in per_psr))
        X, Z = torch.stack(X, dim=1), torch.stack(Z, dim=1)
        num = torch.einsum("dak,k,dbk->dab", X, phihat, X)[:, ia, ib]
        A = Z * phihat                                  # Z_a phihat
        den = torch.einsum("dakl,dblk->dab", A, A)[:, ia, ib]
        return num / den, 1.0 / torch.sqrt(den)

    def os_pairs(theta):
        theta = np.asarray(theta, dtype=np.float64)
        single = theta.ndim == 1
        theta = np.atleast_2d(theta)
        rho, sig = [], []
        for i in range(0, len(theta), OS_CHUNK):
            r, s = os_batch(dev(theta[i:i + OS_CHUNK]))
            rho.append(r.cpu().numpy())
            sig.append(s.cpu().numpy())
        rho, sig = np.concatenate(rho), np.concatenate(sig)
        return (rho[0], sig[0]) if single else (rho, sig)

    return os_pairs, pairs, xi, sampled


def combine_os(rho, sig, xi, orf_name, pos):
    """Pair statistics -> (A2, A2_err, SNR) for one ORF."""
    g = orf_matrix(orf_name, pos)
    npsr = len(pos)
    gvals = np.array([g[a, b] for a in range(npsr)
                      for b in range(a + 1, npsr)])
    w = gvals / sig ** 2
    denom = np.sum(gvals ** 2 / sig ** 2)
    a2 = np.sum(w * rho) / denom
    a2_err = 1.0 / np.sqrt(denom)
    snr = np.sum(w * rho) / np.sqrt(denom)
    return float(a2), float(a2_err), float(snr)


def bin_crosscorr(xi, rho, sig, nbins=8):
    """Equal-pairs-per-bin averaging of the cross-correlations."""
    order = np.argsort(xi)
    xi_s, rho_s, sig_s = xi[order], rho[order], sig[order]
    edges = np.array_split(np.arange(len(xi)), nbins)
    xi_b, rho_b, sig_b = [], [], []
    for idx in edges:
        if len(idx) == 0:
            continue
        wgt = 1.0 / sig_s[idx] ** 2
        xi_b.append(np.average(xi_s[idx], weights=wgt))
        rho_b.append(np.average(rho_s[idx], weights=wgt))
        sig_b.append(1.0 / np.sqrt(np.sum(wgt)))
    return np.asarray(xi_b), np.asarray(rho_b), np.asarray(sig_b)


def hd_curve(xi):
    x = (1.0 - np.cos(xi)) / 2.0
    return 1.5 * x * np.log(x) - 0.25 * x + 0.5


class OptimalStatisticResult:
    """One ORF's optimal-statistic output."""

    def __init__(self, orf, xi, rho, sig, a2, a2_err, snr,
                 marginalized=None):
        self.orf = orf
        self.xi, self.rho, self.sig = xi, rho, sig
        self.a2, self.a2_err, self.snr = a2, a2_err, snr
        self.marginalized = marginalized    # (a2_draws, snr_draws)

    def bin_crosscorr(self, nbins=8):
        return bin_crosscorr(self.xi, self.rho, self.sig, nbins)


class OptimalStatisticWarp(EnterpriseWarpResult):
    """Paramfile-driven pipeline: rebuild the array's model, evaluate the
    statistic at the posterior-median noise parameters, then over
    ``--optimal_statistic_nsamples`` posterior draws; writes
    ``optimal_statistic.pkl`` and, where matplotlib imports, two plots."""

    def __init__(self, opts, custom_models_obj=None, device="cuda"):
        if not os.path.isfile(opts.result):
            raise ValueError(
                "--optimal_statistic needs a paramfile (the PTA must be "
                "rebuilt), got a directory")
        super().__init__(opts, custom_models_obj)
        from ..config import Params
        self.device = resolve_device(device)
        self.params = Params(opts.result, opts=opts,
                             custom_models_obj=custom_models_obj,
                             init_pulsars=True)

    def main_pipeline(self):
        from ..models.assemble import build_terms_for_model

        params = self.params
        pm = params.models[min(params.models)]
        termlists = build_terms_for_model(pm, params.psrs,
                                          params.noise_model_obj)
        fn, pairs, xi, sampled = make_os_fn(params.psrs, termlists,
                                            device=self.device)
        names = [p.name for p in sampled]

        loaded = self.load_chains("")
        if loaded is None:
            raise FileNotFoundError(
                f"no chain found under {self.outdir_all}")
        chain, _, pars = loaded
        if not any("gw" in p and "log10_A" in p for p in pars):
            raise ValueError("chain has no GW amplitude parameter; the "
                             "optimal statistic needs a GWB run")
        draws = chain[:, [pars.index(n) for n in names]]

        pos = np.stack([p.pos for p in params.psrs])
        rho, sig = fn(np.median(draws, axis=0))

        orfs = [s.strip() for s in
                self.opts.optimal_statistic_orfs.split(",") if s.strip()]
        nmarg = min(int(self.opts.optimal_statistic_nsamples), len(draws))
        rng = np.random.default_rng(0)
        sel = rng.choice(len(draws), size=nmarg, replace=False)
        rho_m, sig_m = fn(draws[sel])

        self.os_results = {}
        for orf in orfs:
            a2, a2e, snr = combine_os(rho, sig, xi, orf, pos)
            a2_d, snr_d = [], []
            for k in range(nmarg):
                a, _, s = combine_os(rho_m[k], sig_m[k], xi, orf, pos)
                a2_d.append(a)
                snr_d.append(s)
            self.os_results[orf] = OptimalStatisticResult(
                orf, xi, rho, sig, a2, a2e, snr,
                marginalized=(np.asarray(a2_d), np.asarray(snr_d)))
            _log.info("OS[%s]: A^2 = %.3e +- %.3e  S/N = %.2f  "
                      "(marginalized mean S/N = %.2f over %d draws)",
                      orf, a2, a2e, snr, np.mean(snr_d), nmarg)

        self.dump_results()
        try:
            import matplotlib
        except ImportError:
            _log.info("matplotlib is not installed: the two optimal-"
                      "statistic plots are skipped")
        else:
            matplotlib.use("Agg")
            self.plot_os_orf()
            self.plot_noisemarg_os()
        return self.os_results

    # --------------------------- products ----------------------------- #
    def dump_results(self):
        path = os.path.join(self.outdir_all, "optimal_statistic.pkl")
        payload = {orf: dict(xi=r.xi, rho=r.rho, sig=r.sig, a2=r.a2,
                             a2_err=r.a2_err, snr=r.snr,
                             marginalized=r.marginalized)
                   for orf, r in self.os_results.items()}
        with open(path, "wb") as fh:
            pickle.dump(payload, fh)
        _log.info("optimal statistic results: %s", path)

    def plot_os_orf(self):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4.5))
        first = next(iter(self.os_results.values()))
        xb, rb, sb = first.bin_crosscorr()
        ax.errorbar(xb, rb, yerr=sb, fmt="o", capsize=3,
                    label="binned cross-correlations")
        xg = np.linspace(0.01, np.pi, 200)
        for orf, r in self.os_results.items():
            if orf == "hd":
                curve = r.a2 * hd_curve(xg)
            elif orf == "dipole":
                curve = r.a2 * np.cos(xg)
            elif orf == "monopole":
                curve = r.a2 * np.ones_like(xg)
            else:
                continue
            ax.plot(xg, curve, label=f"{orf} (A$^2$={r.a2:.2e})")
        ax.set_xlabel("pulsar separation [rad]")
        ax.set_ylabel(r"$\hat A^2 \Gamma(\xi)$")
        ax.legend(fontsize=8)
        fig.tight_layout()
        path = os.path.join(self.outdir_all, "os_orf.png")
        fig.savefig(path, dpi=130)
        plt.close(fig)
        _log.info("ORF overlay plot: %s", path)

    def plot_noisemarg_os(self):
        import matplotlib.pyplot as plt

        k = len(self.os_results)
        fig, axes = plt.subplots(2, k, figsize=(4 * k, 6), squeeze=False)
        for j, (orf, r) in enumerate(self.os_results.items()):
            a2_d, snr_d = r.marginalized
            axes[0, j].hist(a2_d, bins=40, histtype="step")
            axes[0, j].set_title(f"{orf}: $\\hat A^2$", fontsize=9)
            axes[1, j].hist(snr_d, bins=40, histtype="step")
            axes[1, j].set_title(f"{orf}: S/N", fontsize=9)
        fig.tight_layout()
        path = os.path.join(self.outdir_all, "os_noisemarg.png")
        fig.savefig(path, dpi=130)
        plt.close(fig)
        _log.info("noise-marginalized OS plot: %s", path)
