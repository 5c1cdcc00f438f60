"""Lower term specs + a Pulsar into one walker-batched likelihood.

Counterpart of ``enterprise_warp_tpu/models/build.py`` for the
single-pulsar, marginalized-timing-model, unsharded build: the term specs
are lowered to static whitened arrays on the device plus per-walker
white-noise (``eval_nw``) and PSD (``eval_phi``) programs, and
:class:`PulsarLikelihood.loglike_batch` evaluates ``(W, ndim)`` parameter
points at once through ``ops.kernel.marginalized_loglike``. A sampled
timing model (``tm="sampled"``) and sampled-coefficient deterministic
terms subtract their delays from the whitened residuals per walker. A
sampled chromatic index and TOA-axis meshes are later slices of the port
(``ROADMAP.md``) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import F64, resolve_device
from ..ops import megakernel, quantization_matrix
from ..ops.kernel import (build_pair_program, gram_blocks,
                          marginalized_loglike, whiten_inputs)
from ..ops.spectra import (broken_powerlaw_psd, df_from_freqs,
                           free_spectrum_psd, powerlaw_psd)
from .prior_mixin import PriorMixin
from .priors import Constant, Parameter, Uniform
from .terms import BasisTerm, CommonTerm, DeterministicTerm, WhiteTerm

_PSD_FNS = {
    "powerlaw": powerlaw_psd,
    "turnover": broken_powerlaw_psd,
    "free_spectrum": free_spectrum_psd,
}

_LATER = "a later slice of the port (see ROADMAP.md)"
# prior half-width of each sampled timing-model offset, in units of the
# whitened, unit-normalized design columns (the reference's default)
TM_RANGE = 10.0


@dataclass
class _WhiteBlock:
    kind: str
    mask_matrix: np.ndarray      # (nsel, ntoa) float
    params: list


@dataclass
class _BasisBlock:
    name: str
    ncols: int
    psd: str
    freqs: np.ndarray
    df: np.ndarray
    params: list
    fixed_phi: np.ndarray = None      # ecorr / bayes_ephem constant prior
    ecorr_param: Parameter = None     # ecorr: phi = 10^(2 p) * ones
    dynamic_idx: Parameter = None
    log_nu_ratio: np.ndarray = None
    col_slice: slice = None
    orf: str = None


class PulsarLikelihood(PriorMixin):
    """Walker-batched single-pulsar likelihood.

    Attributes
    ----------
    params : list[Parameter] — sampled parameters in model (``pars.txt``)
        order; ``param_names``, ``ndim`` likewise.
    device : the device every static array and every evaluation lives on.
    """

    def __init__(self, psr, sampled, evaluate, gram_mode, device):
        self.psr = psr
        self.params = sampled
        self.param_names = [p.name for p in sampled]
        self.ndim = len(sampled)
        self.gram_mode = gram_mode
        self.device = device
        self._evaluate = evaluate

    def as_theta(self, theta):
        """``theta`` as a float64 tensor on the likelihood's device
        (host arrays are copied, so read-only buffers are fine)."""
        if not torch.is_tensor(theta):
            theta = np.array(theta, dtype=np.float64)
        return torch.as_tensor(theta, dtype=F64, device=self.device)

    def loglike_batch(self, theta):
        """lnL at ``(W, ndim)`` parameter points -> ``(W,)`` float64."""
        return self._evaluate(self.as_theta(theta))


def _noise_slide_pairs(psr, names):
    """``(i_efac, i_equad, mean toaerr^2)`` triples for every backend
    whose efac AND equad are both sampled: the metadata of the noise-budget
    slide move (the nested sampler's constrained walks; the PT sampler's
    ``ns`` family). The data constrain the pair's total white variance
    ``efac^2 sigma_bar^2 + 10^(2 equad)``; the slide moves along that
    degeneracy curve in one step. Only this pulsar's names are claimed;
    ``<psr>_efac`` with no backend key covers all TOAs."""
    out = []
    err2 = np.asarray(psr.toaerrs) ** 2
    flags = np.asarray(psr.backend_flags)
    for i, n in enumerate(names):
        if not n.endswith("_efac"):
            continue
        stem = n[: -len("_efac")]
        if stem == psr.name:
            mask = np.ones_like(flags, dtype=bool)
        elif stem.startswith(psr.name + "_"):
            mask = flags == stem[len(psr.name) + 1:]
        else:
            continue
        partner = stem + "_log10_equad"
        if partner not in names:
            continue
        j = names.index(partner)
        s2 = float(err2[mask].mean()) if mask.any() else \
            float(err2.mean())
        out.append((i, j, s2))
    return out


def params_fingerprint(like):
    """Model-identity string of a likelihood's sampled parameters: names
    and prior bounds, the reference's string, so a nested checkpoint is
    recognised by either package."""
    parts = []
    for p in getattr(like, "params", []):
        parts.append(f"{p.name}:{type(p.prior).__name__}"
                     f":{getattr(p.prior, 'lo', '')}"
                     f":{getattr(p.prior, 'hi', '')}"
                     f":{getattr(p.prior, 'mu', '')}"
                     f":{getattr(p.prior, 'sigma', '')}")
    return "|".join(parts)


def _resolve_params(all_params, fixed_values):
    """Split params into sampled ones and a name -> ``("theta", index)``
    or ``("const", value)`` mapping."""
    sampled, mapping = [], {}
    for p in all_params:
        if p.name in mapping:
            continue
        if isinstance(p.prior, Constant):
            val = p.prior.value
            if fixed_values and p.name in fixed_values:
                val = float(fixed_values[p.name])
            elif val == -1.0 and p.name.endswith("efac"):
                raise ValueError(
                    f"constant parameter {p.name} has the noisefile "
                    "sentinel value -1 but no noisefile value was provided")
            mapping[p.name] = ("const", float(val))
        else:
            mapping[p.name] = ("theta", len(sampled))
            sampled.append(p)
    return sampled, mapping


def lower_terms(psr, terms, ecorr_dt=10.0, common_grid=None, det_out=None):
    """Lower a TermList into white/basis blocks + the stacked basis matrix
    (numpy, build time). ``common_grid``, a ``(t0, Tspan)`` pair, puts
    common terms on the shared PTA-wide Fourier grid (the joint
    likelihood); without it they use the pulsar's own span (single-pulsar
    analysis). ``det_out`` collects deterministic terms."""
    from ..ops import fourier_design

    ntoa = len(psr)
    white_blocks, basis_blocks, basis_cols = [], [], []
    col_cursor = 0
    flat_terms = []
    for t in terms:
        flat_terms.extend(t if isinstance(t, list) else [t])

    for t in flat_terms:
        if isinstance(t, WhiteTerm):
            keys = sorted(t.masks)
            if t.kind in ("efac", "equad"):
                mm = np.stack([t.masks[k].astype(np.float64)
                               for k in keys])
                white_blocks.append(_WhiteBlock(t.kind, mm, t.params))
            elif t.kind == "ecorr":
                for k, p in zip(keys, t.params):
                    U = quantization_matrix(psr.toas, dt=ecorr_dt,
                                            mask=t.masks[k])
                    if U.shape[1] == 0:
                        continue
                    basis_cols.append(U)
                    basis_blocks.append(_BasisBlock(
                        name=f"ecorr_{k}", ncols=U.shape[1], psd="ecorr",
                        freqs=None, df=None, params=[p], ecorr_param=p,
                        col_slice=slice(col_cursor,
                                        col_cursor + U.shape[1])))
                    col_cursor += U.shape[1]
        elif isinstance(t, CommonTerm):
            if common_grid is not None:
                t0, Tspan = common_grid
            else:
                t0, Tspan = psr.toas.min(), psr.Tspan
            F, freqs = fourier_design(psr.toas - t0, t.nmodes, Tspan)
            basis_cols.append(F)
            basis_blocks.append(_BasisBlock(
                name=t.name, ncols=F.shape[1], psd=t.psd, freqs=freqs,
                df=df_from_freqs(freqs), params=t.params,
                col_slice=slice(col_cursor, col_cursor + F.shape[1]),
                orf=t.orf))
            col_cursor += F.shape[1]
        elif isinstance(t, DeterministicTerm):
            if det_out is None:
                raise NotImplementedError(
                    f"deterministic term '{t.name}' needs a caller that "
                    "subtracts sampled delays")
            det_out.append(t)
        elif isinstance(t, BasisTerm):
            F = t.F
            if t.row_scale is not None:
                F = F * t.row_scale[:, None]
            basis_cols.append(F)
            basis_blocks.append(_BasisBlock(
                name=t.name, ncols=F.shape[1], psd=t.psd, freqs=t.freqs,
                df=t.df, params=t.params, fixed_phi=t.coeff_sigma2,
                dynamic_idx=t.dynamic_idx, log_nu_ratio=t.log_nu_ratio,
                col_slice=slice(col_cursor, col_cursor + F.shape[1])))
            col_cursor += F.shape[1]
        else:
            raise TypeError(f"unknown term type {type(t)}")

    if not basis_cols:
        # pure white-noise model: one zero column
        basis_cols.append(np.zeros((ntoa, 1)))
        basis_blocks.append(_BasisBlock(
            name="null", ncols=1, psd="null", freqs=None, df=None,
            params=[], fixed_phi=np.array([1.0]), col_slice=slice(0, 1)))
    return white_blocks, basis_blocks, np.concatenate(basis_cols, axis=1)


def lower_det_terms(det_terms, sigma, sampled, mapping):
    """Lower sampled-coefficient deterministic terms (``bayes_ephem:
    sampled``): append each term's parameters to ``sampled``/``mapping``
    in term order and return ``(D_w, det_refs)`` — the delay columns
    (ntoa, k) with their rows whitened (no column normalization: the
    coefficients carry physical priors) and the theta refs aligned with
    the columns; ``(None, None)`` when ``det_terms`` is empty."""
    if not det_terms:
        return None, None
    D_w = np.concatenate(
        [np.asarray(t.D, dtype=np.float64) for t in det_terms], axis=1) \
        / np.asarray(sigma, dtype=np.float64)[:, None]
    det_refs = []
    for t in det_terms:
        for p in t.params:
            if p.name not in mapping:
                mapping[p.name] = ("theta", len(sampled))
                sampled.append(p)
            det_refs.append(mapping[p.name])
    return D_w, det_refs


def collect_params(white_blocks, basis_blocks):
    """All model parameters in canonical (``pars.txt``) order."""
    all_params = []
    for wb in white_blocks:
        all_params.extend(wb.params)
    for bb in basis_blocks:
        all_params.extend(bb.params)
        if bb.dynamic_idx is not None:
            all_params.append(bb.dynamic_idx)
    return all_params


def param_value(theta, ref):
    """A parameter's value per walker: ``(W,)`` from ``theta`` (W, ndim)."""
    kind, v = ref
    if kind == "theta":
        return theta[:, v]
    return torch.full(theta.shape[:1], v, dtype=theta.dtype,
                      device=theta.device)


def white_static(white_blocks, mapping, device):
    return [(wb.kind, torch.as_tensor(wb.mask_matrix, dtype=F64,
                                      device=device),
             [mapping[p.name] for p in wb.params])
            for wb in white_blocks]


def basis_static(basis_blocks, mapping, device):
    def dev(a):
        return None if a is None else torch.as_tensor(a, dtype=F64,
                                                      device=device)
    return [dict(psd=bb.psd, freqs=dev(bb.freqs), df=dev(bb.df),
                 idx_map=[mapping[p.name] for p in bb.params],
                 fixed_phi=dev(bb.fixed_phi), ncols=bb.ncols)
            for bb in basis_blocks]


def eval_nw(theta, wb_static, ntoa, sigma2):
    """Whitened white-noise variance per TOA and walker, (W, ntoa):
    ``efac_b^2 + 10^(2 equad_b) / sigma^2``."""
    W = theta.shape[0]
    efac_toa = torch.ones((W, ntoa), dtype=F64, device=theta.device)
    equad2_toa = torch.zeros((W, ntoa), dtype=F64, device=theta.device)
    for kind, mm, refs in wb_static:
        vals = torch.stack([param_value(theta, rf) for rf in refs], dim=-1)
        if kind == "efac":
            contrib = vals @ mm
            covered = torch.sum(mm, dim=0)
            efac_toa = contrib + (1.0 - covered) * efac_toa
        else:
            equad2_toa = equad2_toa + (10.0 ** (2.0 * vals)) @ mm
    return efac_toa ** 2 + equad2_toa / sigma2


def eval_block_phi(theta, bb):
    """Prior variances of one basis block per walker (before column
    scaling), (W, ncols)."""
    W = theta.shape[0]
    if bb["psd"] == "ecorr":
        p = param_value(theta, bb["idx_map"][0])
        return (10.0 ** (2.0 * p))[:, None].expand(W, bb["ncols"])
    if bb["fixed_phi"] is not None:
        return bb["fixed_phi"].expand(W, bb["ncols"])
    if bb["psd"] == "free_spectrum":
        rho = torch.stack([param_value(theta, rf) for rf in bb["idx_map"]],
                          dim=-1)
        return free_spectrum_psd(bb["freqs"], bb["df"], rho)
    args = [param_value(theta, rf) for rf in bb["idx_map"]]
    return _PSD_FNS[bb["psd"]](bb["freqs"], bb["df"], *args)


def eval_phi(theta, bb_static, cs2):
    """Stacked prior variances per walker, column-scale folded: (W, nb)."""
    return torch.cat([eval_block_phi(theta, bb) for bb in bb_static],
                     dim=-1) * cs2


def build_pulsar_likelihood(psr, terms, fixed_values=None,
                            gram_mode="split", ecorr_dt=10.0,
                            tm="marginalized", const_grams=None, device="cuda"):
    """Build the walker-batched likelihood of one pulsar and TermList.

    ``fixed_values`` maps Constant-prior parameter names to values (the
    noisefile fixing). ``tm``: ``'marginalized'`` integrates the design
    matrix out analytically; ``'sampled'`` adds one
    ``Uniform(-TM_RANGE, TM_RANGE)`` offset per design column, named
    ``<psr>_tmparams_<i>``, after the noise and deterministic parameters,
    in units of the whitened, unit-normalized design columns, and
    subtracts ``M dp`` from the residuals per walker (no Schur stage).
    Sampled deterministic terms subtract ``D c`` likewise.
    ``const_grams`` (None = auto, honouring ``EWT_CONST_GRAMS=0``): with
    every white-noise parameter fixed and nothing walker-dependent on the
    residuals, the Gram stage is theta-independent and is folded once
    here, through the same code path a per-eval recompute takes.
    ``EWT_PAIR_PROGRAM=0`` turns the Gram-as-matmul program off;
    ``EWT_REFINE`` sets the refinement passes of the Sigma solve
    (default 3). The resolved choices are exposed as
    ``like.const_grams`` / ``like.pair_program``.
    """
    device = resolve_device(device)
    if tm not in ("marginalized", "sampled"):
        raise ValueError(f"unknown tm mode '{tm}' "
                         "(use 'marginalized' or 'sampled')")
    ntoa = len(psr)
    sigma = np.asarray(psr.toaerrs, dtype=np.float64)
    det_terms = []
    white_blocks, basis_blocks, T_all = lower_terms(psr, terms,
                                                    ecorr_dt=ecorr_dt,
                                                    det_out=det_terms)
    if any(bb.dynamic_idx is not None for bb in basis_blocks):
        raise NotImplementedError("a sampled chromatic index is " + _LATER)
    r_w, M_w, T_w, col_scale2, _ = whiten_inputs(psr.residuals, sigma,
                                                 psr.Mmat, T_all)
    sampled, mapping = _resolve_params(
        collect_params(white_blocks, basis_blocks), fixed_values)
    D_w, det_refs = lower_det_terms(det_terms, sigma, sampled, mapping)
    tm_refs = None
    if tm == "sampled":
        # one offset per design column, after the noise parameters
        tm_refs = []
        for i in range(psr.Mmat.shape[1]):
            p = Parameter(f"{psr.name}_tmparams_{i}",
                          Uniform(-TM_RANGE, TM_RANGE))
            mapping[p.name] = ("theta", len(sampled))
            tm_refs.append(mapping[p.name])
            sampled.append(p)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64,
                               device=device)

    sigma2 = dev(sigma ** 2)
    r_w_t, M_w_t, T_w_t, cs2 = dev(r_w), dev(M_w), dev(T_w), dev(col_scale2)
    wb_static = white_static(white_blocks, mapping, device)
    bb_static = basis_static(basis_blocks, mapping, device)

    D_w_t = None if D_w is None else dev(D_w)
    # the pair program and the folded Grams need residuals that no walker
    # changes: no sampled timing model, no sampled deterministic delays
    static_resid = tm_refs is None and det_refs is None
    pair_prog = None
    if gram_mode == "split" and static_resid \
            and os.environ.get("EWT_PAIR_PROGRAM", "1") != "0":
        pair_prog = build_pair_program(r_w, M_w, T_w, device=device)
    wn_fixed = all(rf[0] == "const" for _, _, refs in wb_static
                   for rf in refs)
    if const_grams is None:
        const_grams = wn_fixed and static_resid \
            and os.environ.get("EWT_CONST_GRAMS", "1") != "0"
    elif const_grams and not (wn_fixed and static_resid):
        raise ValueError(
            "const_grams=True requires a fixed-white-noise model with no "
            "sampled timing model or deterministic delays "
            f"(white noise fixed: {wn_fixed})")
    grams_cached = None
    if const_grams:
        nw0 = eval_nw(torch.zeros((1, max(len(sampled), 1)), dtype=F64,
                                  device=device), wb_static, ntoa, sigma2)
        grams_cached = tuple(g[0] for g in gram_blocks(
            nw0, r_w_t, M_w_t, T_w_t, gram_mode=gram_mode,
            pair_program=pair_prog))
    n_refine = int(os.environ.get("EWT_REFINE", "3"))

    def stacked(theta, refs):
        return torch.stack([param_value(theta, rf) for rf in refs], dim=-1)

    def evaluate_core(theta, with_health=False, gm=None):
        """lnL (W,) at ``theta``; ``with_health`` also returns the (W, 3)
        health words (classic chain pinned); ``gm="f64"`` is the float64
        twin (no folded Grams, no pair program)."""
        gm = gm or gram_mode
        fold = gm == gram_mode
        megakernel.LAST_REJECT[0] = None
        nw = eval_nw(theta, wb_static, ntoa, sigma2)
        phi = eval_phi(theta, bb_static, cs2)
        r_eff = r_w_t
        if det_refs is not None:
            r_eff = r_eff - stacked(theta, det_refs) @ D_w_t.T
        if tm_refs is None:
            out = marginalized_loglike(
                nw, phi, r_eff, M_w_t, T_w_t, gram_mode=gm,
                pair_program=None if grams_cached is not None or not fold
                else pair_prog, refine=n_refine,
                grams=grams_cached if fold else None,
                with_health=with_health)
        else:
            r_eff = r_eff - stacked(theta, tm_refs) @ M_w_t.T
            out = marginalized_loglike(nw, phi, r_eff, None, T_w_t,
                                       gram_mode=gm, refine=n_refine,
                                       with_health=with_health)
        lnl, hw = out if with_health else (out, None)
        # the kernel route's rejections of this call (None off that route)
        like.last_reject = megakernel.LAST_REJECT[0]
        # a numerically non-PD Sigma (extreme prior corners) yields NaN;
        # the reference maps Cholesky failure to -inf likewise
        lnl = torch.where(torch.isnan(lnl), torch.full_like(lnl, -math.inf),
                          lnl)
        return (lnl, hw) if with_health else lnl

    def evaluate(theta):
        return evaluate_core(theta)

    like = PulsarLikelihood(psr, sampled, evaluate, gram_mode, device)
    like.last_reject = None
    like.noise_pairs = _noise_slide_pairs(psr, like.param_names)
    like.const_grams = bool(const_grams)
    like.pair_program = pair_prog is not None
    like.static = dict(r_w=r_w_t, M_w=M_w_t, T_w=T_w_t, cs2=cs2,
                       sigma2=sigma2, wb=wb_static, bb=bb_static,
                       D_w=D_w_t, det_refs=det_refs, tm_refs=tm_refs)
    # the health plane's twins (resilience/integrity.py): the same lnL on
    # the classic chain plus the (W, 3) health words, and the float64
    # re-evaluation of the ladder's reeval rung
    like._eval_health_batch = lambda theta: evaluate_core(
        like.as_theta(theta), with_health=True)
    like._eval_f64_batch = lambda theta: evaluate_core(
        like.as_theta(theta), gm="f64")
    like.health_psr_names = [psr.name]
    like.eval_nw = lambda theta: eval_nw(like.as_theta(theta), wb_static,
                                         ntoa, sigma2)
    like.eval_phi = lambda theta: eval_phi(like.as_theta(theta), bb_static,
                                           cs2)
    return like
