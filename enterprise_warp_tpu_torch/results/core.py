"""Chain post-processing: the EnterpriseWarpResult pipeline.

Counterpart of ``enterprise_warp_tpu/results/core.py``, numpy only: walk
an output directory for ``<num>_<JName>`` pulsar subdirectories, load
PTMCMC-format chains (25% burn-in, 4 trailing diagnostic columns), and
produce noise files, log Bayes factors from the product-space model
index, corner and trace plots, and the block-diagonal
proposal-covariance collection.

Chain tables are read as the JAX package reads them: through the native
table reader (``native.read_table_native``), with ``np.loadtxt`` where the
native core is not built or the file is not a clean numeric table. One
difference, about what is installed: ``covm_all.csv`` is written with the
``csv`` module, the same text ``pandas.DataFrame.to_csv`` writes, so the
covariance collection needs no pandas; ``covm_all.pkl`` is written only
when pandas imports.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..utils.logging import get_logger

_log = get_logger("ewt.results")

_PSR_DIR_RE = re.compile(r"^\d+_[JB]\d{2,}")
_N_DIAG_COLS = 4           # lnpost, lnlike, acceptance, PT-swap rate
_BURN_FRACTION = 0.25


def parse_commandline(argv=None):
    """The results CLI option set (reference ``results.py:29-121``)."""
    import argparse
    p = argparse.ArgumentParser(
        description="enterprise_warp_tpu_torch results post-processing")
    p.add_argument("-r", "--result", required=True,
                   help="output directory or paramfile")
    p.add_argument("-i", "--info", type=int, default=0,
                   help="print directory and chain info")
    p.add_argument("-n", "--name", type=str, default="all",
                   help="pulsar name or 'all'")
    p.add_argument("-c", "--corner", type=int, default=0,
                   help="1: corner plot; 2: posterior table txt")
    p.add_argument("-p", "--par", action="append", default=None,
                   help="restrict plots to parameters containing this "
                        "substring (repeatable)")
    p.add_argument("-a", "--chains", type=int, default=0,
                   help="trace plots")
    p.add_argument("-b", "--logbf", type=int, default=0,
                   help="print log Bayes factor from nmodel histogram")
    p.add_argument("-f", "--noisefiles", type=int, default=0,
                   help="write PAL2-format noise JSON from posteriors")
    p.add_argument("-l", "--credlevels", type=int, default=0,
                   help="write credible-level tables")
    p.add_argument("-u", "--separate_earliest", type=float, default=0.0,
                   help="backup and strip the earliest fraction of the "
                        "chain")
    p.add_argument("-m", "--mpi_regime", type=int, default=0)
    p.add_argument("-s", "--load_separated", type=int, default=0,
                   help="concatenate time-stamped separated chain files")
    p.add_argument("-v", "--covm", type=int, default=0,
                   help="collect per-pulsar cov.npy into a block-diagonal "
                        "proposal covariance (csv + pkl)")
    p.add_argument("-g", "--diagnostics", type=int, default=0,
                   help="per-parameter split-R-hat / ESS table + JSON "
                        "(no reference counterpart; convergence is by "
                        "eye there)")
    p.add_argument("-e", "--bilby", type=int, default=0,
                   help="treat runs as result-JSON (nested) outputs")
    p.add_argument("-o", "--optimal_statistic", type=int, default=0)
    p.add_argument("--optimal_statistic_orfs", type=str,
                   default="hd,dipole,monopole")
    p.add_argument("-N", "--optimal_statistic_nsamples", type=int,
                   default=1000)
    p.add_argument("-M", "--custom_models_py", type=str, default=None)
    p.add_argument("-U", "--custom_models", type=str, default=None)
    p.add_argument("--errorbars_cdf", type=str, default="16,84",
                   help="lo,hi CDF percentiles for credible intervals "
                        "(reference errorbars_cdf, default 16,84)")
    return p.parse_args(argv)


def _opt_errorbars_cdf(opts):
    """(lo, hi) percentiles from the CLI option; tolerates an opts
    namespace without the attribute (older callers and tests)."""
    raw = getattr(opts, "errorbars_cdf", None) or "16,84"
    if isinstance(raw, (tuple, list)):
        lo, hi = raw
    else:
        lo, hi = (float(t) for t in str(raw).split(","))
    return float(lo), float(hi)


def _read_table(path):
    """Numeric table read: the native reader, or ``np.loadtxt`` where it
    declines (no native core, a non-numeric token, a ragged row), which
    then raises as it does for such a file."""
    from ..native import read_table_native
    out = read_table_native(str(path))
    return out if out is not None else np.loadtxt(path)


def check_if_psr_dir(folder_name: str) -> bool:
    """``<int>_<J|B name>`` pulsar-directory convention (reference
    ``results.py:236-242``)."""
    return bool(_PSR_DIR_RE.match(folder_name))


def estimate_from_distribution(values, method="mode",
                               errorbars_cdf=(16.0, 84.0)):
    """Point estimate from posterior samples (reference
    ``results.py:169-198``): 'mode' via a Gaussian KDE argmax on a grid,
    'median', or credible bounds at configurable CDF percentiles
    (reference ``errorbars_cdf``, default [16, 84])."""
    values = np.asarray(values, dtype=np.float64)
    if method == "median":
        return float(np.median(values))
    if method == "mode":
        if np.ptp(values) == 0:
            return float(values[0])
        from scipy.stats import gaussian_kde
        kde = gaussian_kde(values)
        grid = np.linspace(values.min(), values.max(), 512)
        return float(grid[np.argmax(kde(grid))])
    if method == "credlvl":
        lo_p, hi_p = float(errorbars_cdf[0]), float(errorbars_cdf[1])
        lo, med, hi = np.percentile(values, [lo_p, 50.0, hi_p])
        # 'maximum' via the reference's cheap histogram-argmax
        # (results.py:139-155 dist_mode_position), not the KDE — O(n)
        # per parameter and no degenerate-sample crash mode
        if np.ptp(values) == 0:
            mx = float(values[0])
        else:
            counts, edges = np.histogram(values, bins=50)
            mx = float(edges[np.argmax(counts)])
        # reference key layout (results.py:189-198) + the minus/plus
        # half-widths the posterior table prints
        return {"median": float(med), "maximum": float(mx),
                "50": float(med),
                str(int(lo_p) if lo_p == int(lo_p) else lo_p): float(lo),
                str(int(hi_p) if hi_p == int(hi_p) else hi_p): float(hi),
                "minus": float(med - lo), "plus": float(hi - med),
                "errorbars_cdf": [lo_p, hi_p]}
    raise ValueError(f"unknown estimate method '{method}'")


def suitable_estimator(levels, errorbars_cdf=(16.0, 84.0)):
    """Maximum-posterior (mode) value if it lies inside the credible
    interval, else the median — the reference's maximum-vs-median
    fallback (``results.py:157-167``). Returns ``(value, which)``."""
    lo_p, hi_p = float(errorbars_cdf[0]), float(errorbars_cdf[1])
    lo_k = str(int(lo_p) if lo_p == int(lo_p) else lo_p)
    hi_k = str(int(hi_p) if hi_p == int(hi_p) else hi_p)
    if levels[lo_k] < levels["maximum"] < levels[hi_k]:
        return levels["maximum"], "maximum"
    return levels["50"], "50"


def make_noise_files(psrname, chain, pars, outdir, method="mode"):
    """Posterior point estimates -> PAL2-format noise JSON
    (reference ``results.py:221-233``), consumed back by the run stage as
    fixed white-noise constants (``enterprise_warp.py:504-508``)."""
    est = {p: estimate_from_distribution(chain[:, i], method=method)
           for i, p in enumerate(pars)}
    os.makedirs(outdir, exist_ok=True)
    from ..io.writers import atomic_write_json
    return atomic_write_json(os.path.join(outdir,
                                          f"{psrname}_noise.json"),
                             est, sort_keys=True, indent=2)


class EnterpriseWarpResult:
    """Walk an output directory and post-process every pulsar run."""

    def __init__(self, opts, custom_models_obj=None):
        self.opts = opts
        self.custom_models_obj = custom_models_obj
        self.interpret_opts_result()
        self.get_psr_dirs()
        self.covm = {}          # par name -> row of block-diag covariance
        self.covm_blocks = []

    # ------------------------ directory walking ----------------------- #
    def interpret_opts_result(self):
        """opts.result is an output directory or a paramfile; a paramfile
        is re-parsed (without loading pulsars) to recover the directory
        (reference ``results.py:384-395``)."""
        if os.path.isdir(self.opts.result):
            self.outdir_all = os.path.normpath(self.opts.result)
            self.params = None
        elif os.path.isfile(self.opts.result):
            from ..config import Params
            self.params = Params(self.opts.result, opts=self.opts,
                                 custom_models_obj=self.custom_models_obj,
                                 init_pulsars=False)
            self.outdir_all = os.path.normpath(os.path.join(
                self.params.out,
                f"{self.params.label_models}_"
                f"{self.params.paramfile_label}"))
        else:
            raise FileNotFoundError(
                f"--result {self.opts.result}: no such file or directory")

    def get_psr_dirs(self):
        entries = sorted(os.listdir(self.outdir_all)) \
            if os.path.isdir(self.outdir_all) else []
        self.psr_dirs = [d for d in entries
                         if check_if_psr_dir(d)
                         and os.path.isdir(
                             os.path.join(self.outdir_all, d))]
        if not self.psr_dirs:
            # single-run layout: the output dir itself holds the chain
            self.psr_dirs = [""]

    # ------------------------ chain loading --------------------------- #
    def get_chain_file_name(self, psr_dir):
        d = os.path.join(self.outdir_all, psr_dir)
        if self.opts.load_separated:
            sep = sorted((f for f in os.listdir(d)
                          if re.match(r"^\d+_chain_1\.txt$", f)),
                         key=lambda f: int(f.split("_")[0]))
            live = os.path.join(d, "chain_1.txt")
            if sep:
                return [os.path.join(d, f) for f in sep] + \
                    ([live] if os.path.exists(live) else [])
        for cand in ("chain_1.txt", "chain_1.0.txt"):
            path = os.path.join(d, cand)
            if os.path.exists(path):
                return path
        return None

    def load_chains(self, psr_dir):
        """Returns (chain_burned, diag_cols, pars). Burn-in 25%, last 4
        PTMCMC diagnostic columns split off (reference
        ``results.py:461-493``)."""
        d = os.path.join(self.outdir_all, psr_dir)
        pars_path = os.path.join(d, "pars.txt")
        if not os.path.exists(pars_path):
            return None
        pars = [ln.strip() for ln in open(pars_path) if ln.strip()]
        chain_file = self.get_chain_file_name(psr_dir)
        if chain_file is None:
            return None
        if isinstance(chain_file, list):
            chain = np.vstack([_read_table(f) for f in chain_file])
        else:
            chain = _read_table(chain_file)
        chain = np.atleast_2d(chain)
        burn = int(_BURN_FRACTION * len(chain))
        chain = chain[burn:]
        diag = chain[:, -_N_DIAG_COLS:]
        chain = chain[:, :-_N_DIAG_COLS]
        if chain.shape[1] != len(pars):
            raise ValueError(
                f"{psr_dir}: chain has {chain.shape[1]} parameter columns "
                f"but pars.txt lists {len(pars)}")
        return chain, diag, pars

    # ------------------------ pipeline -------------------------------- #
    def main_pipeline(self):
        for psr_dir in self.psr_dirs:
            if self.opts.name != "all" and self.opts.name not in psr_dir:
                continue
            if self.opts.info:
                _log.info("== %s ==", psr_dir or self.outdir_all)
            if self.opts.separate_earliest:
                self._separate_earliest(psr_dir)
            loaded = self.load_chains(psr_dir)
            if loaded is None:
                if self.opts.info:
                    _log.info("(no chain found)")
                    # nested runs publish a Bilby-schema result JSON
                    # instead of PTMCMC chain files (same contract
                    # split as the reference's --bilby flag at
                    # results.py:104,1060) — point the user there
                    import glob as _glob
                    d = os.path.join(self.outdir_all, psr_dir)
                    if _glob.glob(os.path.join(d, "*_result.json")):
                        _log.info("found a *_result.json here — "
                                  "rerun with --bilby 1 to load "
                                  "nested-sampling output")
                continue
            chain, diag, pars = loaded
            if self.opts.info:
                _log.info("%d post-burn samples, %d parameters",
                          len(chain), len(pars))
            psrname = psr_dir.split("_", 1)[1] if "_" in psr_dir \
                else (psr_dir or self._psrname_from_pars(pars))
            if self.opts.noisefiles:
                path = make_noise_files(
                    psrname, chain, pars,
                    os.path.join(self.outdir_all, "noisefiles"))
                _log.info("noise file: %s", path)
            if self.opts.credlevels:
                self._make_credlevels(psrname, chain, pars)
            if self.opts.logbf:
                self._print_logbf(psr_dir, chain, pars)
            if self.opts.corner:
                self._make_corner_plot(psr_dir, chain, pars)
            if self.opts.chains:
                self._make_chain_plot(psr_dir, chain, diag, pars)
            if self.opts.covm:
                self._collect_covm(psr_dir, pars)
            if getattr(self.opts, "diagnostics", 0):
                self._print_diagnostics(psr_dir, chain, pars)
        if self.opts.covm:
            self._save_covm()

    @staticmethod
    def _psrname_from_pars(pars):
        """Single-run layout has no ``<num>_<psr>`` subdir to name the
        pulsar, but the parameter names carry a ``<JName>_`` prefix;
        recover it so the noisefile round-trip (keyed by pulsar name,
        ``assemble.get_noise_dict``) works without psr subdirs."""
        for p in pars:
            head = p.split("_", 1)[0]
            if re.match(r"^[JB]\d{4}[+-]\d{2,4}$", head):
                return head
        return "run"

    def _infer_nchains(self, psr_dir):
        """Walker count of the run, from the sampler checkpoint: the
        chain file interleaves walkers per step, and diagnostics need
        the (nchains, nsteps) split. Falls back to 1 (split-halves
        R-hat still applies)."""
        from ..io.writers import prev_generation
        # generation-aware but hash-free: np.load only reads the
        # accessed zip members, so try the current generation first
        # and fall back to state.prev.npz only when it is unreadable
        # or foreign — a full sha256 per pulsar dir just to infer
        # nchains would make large-campaign post-processing pay for
        # integrity the samplers already verified at resume
        path = os.path.join(self.outdir_all, psr_dir, "state.npz")
        for cand in (path, prev_generation(path)):
            if not os.path.exists(cand):
                continue
            try:
                z = np.load(cand)
                if "ladder" in z.files:           # PT sampler
                    return int(z["x"].shape[0]) // max(
                        len(z["ladder"]), 1)
                if "z" in z.files:                # HMC sampler
                    return int(z["z"].shape[0])
            except Exception:
                continue
        return 1

    def _print_diagnostics(self, psr_dir, chain, pars):
        """Split-R-hat / multi-chain ESS over the post-burn chain — the
        quantitative convergence check the reference leaves to the
        user's eye (``nsamp: 1000000`` and look at the trace)."""
        from ..utils.diagnostics import summarize_chains
        nch = self._infer_nchains(psr_dir)
        nsteps = len(chain) // max(nch, 1)
        if nsteps < 4:
            _log.info("(chain too short for diagnostics)")
            return
        c = chain[:nsteps * nch].reshape(nsteps, nch, len(pars))
        c = np.transpose(c, (1, 0, 2))
        summ = summarize_chains(c, pars)
        worst = summ["_worst"]

        def _f(v, spec="{:.4f}"):
            # summarize_chains clamps un-computable estimates to None
            # (its JSON contract); render those as n/a
            return "n/a" if v is None else spec.format(v)

        worst_par = max(pars, key=lambda p: (
            summ[p]["rhat"] if summ[p]["rhat"] is not None
            else float("inf")))
        _log.info("diagnostics (%d chains x %d post-burn steps): "
                  "worst R-hat=%s at %s (its ESS=%s; min ESS=%s)",
                  nch, nsteps, _f(worst["rhat"]), worst_par,
                  _f(summ[worst_par]["ess"], "{:.0f}"),
                  _f(worst["ess"], "{:.0f}"))
        for p in pars:
            s = summ[p]
            _log.info("  %-40s rhat=%s ess=%s", p, _f(s["rhat"]),
                      _f(s["ess"], "{:8.0f}"))
        outdir = os.path.join(self.outdir_all, "diagnostics")
        os.makedirs(outdir, exist_ok=True)
        name = psr_dir or "run"
        from ..io.writers import atomic_write_json
        path = atomic_write_json(
            os.path.join(outdir, f"{name}_diagnostics.json"), summ)
        _log.info("diagnostics json: %s", path)

    # ------------------------ products -------------------------------- #
    def _make_credlevels(self, psrname, chain, pars):
        cdf = _opt_errorbars_cdf(self.opts)
        rows = {}
        for i, p in enumerate(pars):
            lv = estimate_from_distribution(chain[:, i], "credlvl",
                                            errorbars_cdf=cdf)
            # the reference's maximum-vs-median fallback picks the point
            # estimate downstream consumers should use
            lv["best"], lv["best_which"] = suitable_estimator(lv, cdf)
            rows[p] = lv
        outdir = os.path.join(self.outdir_all, "credlevels")
        os.makedirs(outdir, exist_ok=True)
        from ..io.writers import atomic_write_json
        path = atomic_write_json(
            os.path.join(outdir, f"{psrname}_credlvl.json"), rows,
            sort_keys=True, indent=2)
        _log.info("credible levels: %s", path)

    def _print_logbf(self, psr_dir, chain, pars):
        """Product-space Bayes factors from the nmodel histogram
        (reference ``results.py:482-491,585-596``)."""
        if "nmodel" not in pars:
            _log.info("%s: no nmodel column (single-model run)",
                      psr_dir)
            return None
        idx = pars.index("nmodel")
        nmodel = np.rint(chain[:, idx]).astype(int)
        ids, counts = np.unique(nmodel, return_counts=True)
        if len(ids) == 1:
            # np.unique only reports visited models: a missing competitor
            # means the sampler never hopped there
            _log.info("logBF: only model %s was ever visited "
                      "(increase nsamp)", ids[0])
            return dict(zip(ids.tolist(), counts.tolist()))
        for i in ids:
            for j in ids:
                if j <= i:
                    continue
                ci = counts[ids == i][0]
                cj = counts[ids == j][0]
                logbf = np.log(cj / ci)
                _log.info("logBF[%s/%s] = %.3f (visits %s:%s)",
                          j, i, logbf, cj, ci)
        return dict(zip(ids.tolist(), counts.tolist()))

    def _select_pars(self, pars):
        if not self.opts.par:
            return list(range(len(pars)))
        return [i for i, p in enumerate(pars)
                if any(sub in p for sub in self.opts.par)]

    def _make_corner_plot(self, psr_dir, chain, pars):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sel = self._select_pars(pars)
        if not sel:
            return
        names = [pars[i] for i in sel]
        data = chain[:, sel]
        k = len(sel)
        fig, axes = plt.subplots(k, k, figsize=(2.2 * k, 2.2 * k))
        axes = np.atleast_2d(axes)
        for i in range(k):
            for j in range(k):
                ax = axes[i, j]
                if j > i:
                    ax.set_visible(False)
                    continue
                if i == j:
                    ax.hist(data[:, i], bins=40, histtype="step",
                            density=True, color="C0")
                else:
                    h, xe, ye = np.histogram2d(data[:, j], data[:, i],
                                               bins=40)
                    hs = np.sort(h.ravel())[::-1]
                    cs = np.cumsum(hs) / hs.sum()
                    levels = sorted(set(
                        float(hs[np.searchsorted(cs, q)])
                        for q in (0.39, 0.86)))     # 1/2-sigma 2D
                    if len(levels) < 2 or levels[0] == levels[-1]:
                        levels = None
                    ax.contourf(0.5 * (xe[1:] + xe[:-1]),
                                0.5 * (ye[1:] + ye[:-1]), h.T,
                                levels=([*levels, h.max() + 1]
                                        if levels else 8),
                                cmap="Blues")
                if i == k - 1:
                    ax.set_xlabel(names[j], fontsize=7)
                if j == 0 and i > 0:
                    ax.set_ylabel(names[i], fontsize=7)
                ax.tick_params(labelsize=6)
        fig.tight_layout()
        path = os.path.join(self.outdir_all, psr_dir, "corner.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        _log.info("corner plot: %s", path)
        if self.opts.corner == 2:
            tab = os.path.join(self.outdir_all, psr_dir,
                               "posterior_table.txt")
            cdf = _opt_errorbars_cdf(self.opts)
            with open(tab, "w") as fh:
                for i, p in enumerate(pars):
                    cl = estimate_from_distribution(chain[:, i],
                                                    "credlvl",
                                                    errorbars_cdf=cdf)
                    fh.write(f"{p} {cl['median']:.6g} "
                             f"-{cl['minus']:.3g} +{cl['plus']:.3g}\n")

    def _make_chain_plot(self, psr_dir, chain, diag, pars):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        sel = self._select_pars(pars)
        k = len(sel)
        ncol = 3
        nrow = -(-(k + 1) // ncol)
        fig, axes = plt.subplots(nrow, ncol,
                                 figsize=(4 * ncol, 1.8 * nrow),
                                 squeeze=False)
        flat = axes.ravel()
        for ax, i in zip(flat, sel):
            ax.plot(chain[:, i], lw=0.3)
            ax.set_title(pars[i], fontsize=7)
            ax.tick_params(labelsize=6)
        flat[k].plot(diag[:, 0], lw=0.3, color="C3")
        flat[k].set_title("ln posterior", fontsize=7)
        for ax in flat[k + 1:]:
            ax.set_visible(False)
        fig.tight_layout()
        path = os.path.join(self.outdir_all, psr_dir, "chains.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        _log.info("trace plot: %s", path)

    # ------------------------ chain surgery --------------------------- #
    def _separate_earliest(self, psr_dir):
        """Move the earliest fraction of the chain into a time-stamped
        backup so a contaminated warm-up can be excluded (reference
        ``results.py:559-583``, minus the hard exit)."""
        frac = float(self.opts.separate_earliest)
        chain_file = self.get_chain_file_name(psr_dir)
        if chain_file is None or isinstance(chain_file, list):
            return
        chain = np.atleast_2d(_read_table(chain_file))
        ncut = int(frac * len(chain))
        if ncut == 0:
            return
        stamp = len([f for f in os.listdir(os.path.dirname(chain_file))
                     if f.endswith("_chain_1.txt")])
        backup = os.path.join(os.path.dirname(chain_file),
                              f"{stamp}_chain_1.txt")
        np.savetxt(backup, chain[:ncut])
        np.savetxt(chain_file, chain[ncut:])
        _log.info("separated %d earliest samples -> %s", ncut, backup)

    # ------------------------ covariance collection ------------------- #
    def _collect_covm(self, psr_dir, pars):
        """Accumulate per-pulsar cov.npy into a block-diagonal proposal
        covariance keyed by parameter names (reference
        ``results.py:517-557``)."""
        path = os.path.join(self.outdir_all, psr_dir, "cov.npy")
        if not os.path.exists(path):
            return
        cov = np.load(path)
        self.covm_blocks.append((pars, cov))

    def _save_covm(self):
        """``covm_all.csv``, the block-diagonal covariance with parameter
        names on both axes, in the text ``pandas.DataFrame.to_csv``
        writes (each float as ``repr``, NaN empty, fields quoted where
        needed); ``covm_all.pkl`` (a pickled DataFrame) only when pandas
        imports."""
        import csv

        names = [p for pars, _ in self.covm_blocks for p in pars]
        n = len(names)
        big = np.zeros((n, n))
        off = 0
        for pars, cov in self.covm_blocks:
            k = len(pars)
            big[off:off + k, off:off + k] = cov[:k, :k]
            off += k
        path = os.path.join(self.outdir_all, "covm_all.csv")
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh, lineterminator="\n")
            w.writerow([""] + names)
            for name, row in zip(names, big):
                w.writerow([name] + ["" if np.isnan(v) else repr(float(v))
                                     for v in row])
        try:
            import pandas as pd
        except ImportError:
            _log.info("pandas is not installed: covm_all.pkl not written")
        else:
            pd.DataFrame(big, index=names, columns=names).to_pickle(
                os.path.join(self.outdir_all, "covm_all.pkl"))
        _log.info("block-diagonal covariance: %s (%d parameters)",
                  path, n)
