"""Lower term specs + a Pulsar into one walker-batched likelihood.

Counterpart of ``enterprise_warp_tpu/models/build.py`` for the
single-pulsar, marginalized-timing-model, unsharded build: the term specs
are lowered to static whitened arrays on the device plus per-walker
white-noise (``eval_nw``) and PSD (``eval_phi``) programs, and
:class:`PulsarLikelihood.loglike_batch` evaluates ``(W, ndim)`` parameter
points at once through ``ops.kernel.marginalized_loglike``. A sampled
timing model (``tm="sampled"``) and sampled-coefficient deterministic
terms subtract their delays from the whitened residuals per walker. A
sampled chromatic index (``chromred("vary...")``) scales its block's
basis columns per walker (:func:`eval_T`), so the classic chain gets a
per-walker basis ``(W, ntoa, nb)``; the likelihood kernel declines such a
basis and the Sigma solve makes its own kernel decision.

The TOA axis across processes (``mesh=``, a ``toa``
:class:`~..parallel.distributed.ShardLayout` from
``parallel.make_toa_mesh``): the TOAs are padded to a multiple of
``nshard * 256`` (padded rows: mask 0, sigma 1, zero residual and basis
rows), each rank keeps only its row block on its own device, computes its
white noise, basis, delays, Gram partials and masked ``sum log nw``, and
ONE packed ``all_reduce_sum`` per evaluation sums them; the Sigma stage
(``ops.kernel.sigma_stage``) then runs replicated on every rank. The
likelihood kernel declines such an evaluation (route ``toa-sharded``);
the Sigma solve keeps its own kernel decision.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import F64, resolve_device
from ..ops import megakernel, quantization_matrix
from ..ops.kernel import (_CHUNK, _gram_rows, _row_sum,
                          build_pair_program, gram_blocks,
                          marginalized_loglike, sigma_stage, whiten_inputs)
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


def _stacked(theta, refs):
    """The parameters ``refs`` per walker, (W, len(refs))."""
    return torch.stack([param_value(theta, rf) for rf in refs], dim=-1)


def white_static(white_blocks, mapping, device, n_pad=0, rows=None):
    """Device-ready white-noise blocks. A TOA-sharded build pads each
    selection mask with ``n_pad`` zero columns and keeps the columns
    ``rows`` (a slice) of its shard."""
    out = []
    for wb in white_blocks:
        mm = np.pad(wb.mask_matrix, ((0, 0), (0, n_pad)))
        if rows is not None:
            mm = mm[:, rows]
        out.append((wb.kind, torch.as_tensor(mm, dtype=F64, device=device),
                    [mapping[p.name] for p in wb.params]))
    return out


def basis_static(basis_blocks, mapping, device, n_pad=0, rows=None):
    """Device-ready basis blocks; ``n_pad``/``rows`` cut a TOA-sharded
    build's ``log_nu_ratio`` as :func:`white_static` cuts its masks
    (padded rows get a unit chromatic scale)."""
    def dev(a):
        return None if a is None else torch.as_tensor(a, dtype=F64,
                                                      device=device)

    def lognu(a):
        if a is None:
            return None
        a = np.pad(a, (0, n_pad))
        return dev(a if rows is None else a[rows])
    return [dict(psd=bb.psd, freqs=dev(bb.freqs), df=dev(bb.df),
                 idx_map=[mapping[p.name] for p in bb.params],
                 fixed_phi=dev(bb.fixed_phi), ncols=bb.ncols,
                 col_slice=bb.col_slice,
                 dyn=None if bb.dynamic_idx is None
                 else mapping[bb.dynamic_idx.name],
                 lognu=lognu(bb.log_nu_ratio))
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


def eval_T(theta, bb_static, T_w):
    """The basis at ``theta``: ``T_w`` (ntoa, nb) itself where no block has
    a sampled chromatic index, else the per-walker basis (W, ntoa, nb)
    with each such block's columns scaled by ``exp(idx * log_nu_ratio)``
    per TOA (the reference's ``eval_phi_T``)."""
    dyn = [bb for bb in bb_static if bb["dyn"] is not None]
    if not dyn:
        return T_w
    T = T_w.expand((theta.shape[0],) + tuple(T_w.shape)).clone()
    for bb in dyn:
        idx = param_value(theta, bb["dyn"])
        scale = torch.exp(idx[:, None] * bb["lognu"][None, :])
        sl = bb["col_slice"]
        T[:, :, sl] = T_w[:, sl] * scale[:, :, None]
    return T


def _build_fingerprint(psr, mapping, wb_static, basis_blocks, bb_static,
                       tm, n_refine, const_grams, pair, blocked, toa):
    """Digest of what a build bakes into its evaluation beyond the
    sampled parameters (the serving cache's executable identity, see
    :func:`topology_fingerprint`): the fixed parameters' values, the
    white and basis block structure, the build-time route choices (the
    ``EWT_BLOCKED_CHOL`` pin among them), the TOA layout (``toa``:
    ``(nshard, padded ntoa)``, None unsharded) and the ingestion audit's
    verdict (a repaired dataset keys afresh)."""
    import hashlib
    h = hashlib.sha256()
    for nm in sorted(mapping):
        if mapping[nm][0] == "const":
            h.update(f"c:{nm}={mapping[nm][1]!r};".encode())
    for kind, mm, refs in wb_static:
        h.update(f"w:{kind}:{tuple(mm.shape)}:{refs};".encode())
    for blk, bb in zip(basis_blocks, bb_static):
        h.update(f"b:{bb['psd']}:{bb['ncols']}:{bb['col_slice']}:"
                 f"{bb['idx_map']}:{bb['dyn']}:{blk.orf};".encode())
    h.update(f"tm={tm};refine={n_refine};bchol={blocked};"
             f"cg={bool(const_grams)};pair={pair};toa={toa};".encode())
    dq = getattr(psr, "dq_report", None)
    h.update(f"dq={dq.token() if dq is not None else 'unaudited'};"
             .encode())
    return h.hexdigest()[:16]


#: the environment pins that change what an evaluation runs (kernel
#: routes and solve choices): part of every topology fingerprint, so a
#: demotion that sets ``EWT_PALLAS_MEGA=0`` keys fresh executables
ROUTE_PINS = ("EWT_PALLAS", "EWT_PALLAS_MEGA", "EWT_PALLAS_CHOL",
              "EWT_REFINE", "EWT_BLOCKED_CHOL", "EWT_PAIR_PROGRAM")


def topology_fingerprint(like):
    """Executable identity of a likelihood for the serving cache
    (``serve/aot.py``): two likelihoods with equal fingerprints run the
    same evaluation at a given batch bucket, so one warmed executable
    serves requests against either.

    The digest holds the class name and :func:`params_fingerprint`,
    ``gram_mode`` and ``const_grams``, the ``build_fingerprint``, the
    pulsar's data (name, TOA count, residual and TOA-error bytes, the
    ingestion audit's token) where the likelihood has both a pulsar and a
    build fingerprint, the :data:`ROUTE_PINS`, and the device type. An
    object without a pulsar build keys on its own ``topology_token`` if
    it declares one, else on its instance (joint and multi-pulsar
    builds, the hypermodel, analytic targets: their closures cannot be
    enumerated, so sharing across instances would be unsound). The
    reference also hashes its consts leaves' shapes; the port closes
    over its arrays, so the device type takes their place."""
    import hashlib
    h = hashlib.sha256()
    h.update(type(like).__name__.encode())
    h.update(params_fingerprint(like).encode())
    h.update(f"gram={getattr(like, 'gram_mode', '')};"
             f"cg={getattr(like, 'const_grams', '')};".encode())
    bfp = getattr(like, "build_fingerprint", None)
    psr = getattr(like, "psr", None)
    if bfp is not None:
        h.update(f"build={bfp};".encode())
    if psr is not None and bfp is not None:
        h.update(f"psr={psr.name}:{len(psr)};".encode())
        h.update(np.ascontiguousarray(
            np.asarray(psr.residuals, dtype=np.float64)).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(psr.toaerrs, dtype=np.float64)).tobytes())
        dq = getattr(psr, "dq_report", None)
        h.update(f"dq={dq.token() if dq is not None else 'unaudited'};"
                 .encode())
    else:
        token = getattr(like, "topology_token", None)
        h.update((f"token={token};" if token is not None
                  else f"instance={id(like)};").encode())
    for knob in ROUTE_PINS:
        h.update(f"{knob}={os.environ.get(knob, '')};".encode())
    dev = getattr(like, "device", None)
    h.update(f"device={torch.device(dev).type if dev is not None else ''};"
             .encode())
    return h.hexdigest()[:16]


def _toa_layout(mesh, toa_axis):
    """The layout a build shards its TOA rows over: ``mesh`` where its
    axis is ``toa_axis`` and it has more than one shard, else None (no
    sharding: a ``chain`` or ``psr`` layout is not this build's)."""
    if mesh is None or getattr(mesh, "axis", None) != toa_axis \
            or getattr(mesh, "nshard", 1) < 2:
        return None
    return mesh


def build_pulsar_likelihood(psr, terms, fixed_values=None,
                            gram_mode="split", ecorr_dt=10.0,
                            tm="marginalized", const_grams=None, device="cuda",
                            mesh=None, toa_axis="toa"):
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
    (default 3); ``EWT_BLOCKED_CHOL=1`` declines the three kernels and
    factors the Sigma solve's preconditioner through
    ``ops.kernel.blocked_cholesky``. All three are read here, at build
    time. The resolved choices are exposed as ``like.const_grams`` /
    ``like.pair_program`` / ``like.blocked_chol``.

    ``mesh``: a ``toa_axis`` layout of two or more shards
    (``parallel.make_toa_mesh``) shards the TOA rows across the process
    group (module docstring); any other layout is ignored. The pair
    program and the folded Grams are off under it (``const_grams=True``
    raises). ``like.mesh`` is the layout (None unsharded) and
    ``like.device`` this rank's device. A layout without a process group
    keeps every shard in this process and sums them before the
    collective, so the one-process value is the sharded program's.
    """
    device = resolve_device(device)
    if tm not in ("marginalized", "sampled"):
        raise ValueError(f"unknown tm mode '{tm}' "
                         "(use 'marginalized' or 'sampled')")
    layout = _toa_layout(mesh, toa_axis)
    ntoa = len(psr)
    sigma = np.asarray(psr.toaerrs, dtype=np.float64)
    det_terms = []
    white_blocks, basis_blocks, T_all = lower_terms(psr, terms,
                                                    ecorr_dt=ecorr_dt,
                                                    det_out=det_terms)
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

    cs2 = dev(col_scale2)
    wb_static = white_static(white_blocks, mapping, device,
                             rows=None if layout is None else slice(0, 0))
    bb_static = basis_static(basis_blocks, mapping, device,
                             rows=None if layout is None else slice(0, 0))
    # the pair program and the folded Grams need residuals and a basis
    # that no walker changes: no sampled timing model, no sampled
    # deterministic delays, no sampled chromatic index; and whole rows
    static_basis = all(bb["dyn"] is None for bb in bb_static)
    static_resid = tm_refs is None and det_refs is None and static_basis
    wn_fixed = all(rf[0] == "const" for _, _, refs in wb_static
                   for rf in refs)
    cg_eligible = wn_fixed and static_resid and layout is None
    if const_grams is None:
        const_grams = cg_eligible \
            and os.environ.get("EWT_CONST_GRAMS", "1") != "0"
    elif const_grams and not cg_eligible:
        raise ValueError(
            "const_grams=True requires a fixed-white-noise model with no "
            "sampled timing model, deterministic delays, sampled "
            f"chromatic index, or TOA-axis mesh (white noise fixed: "
            f"{wn_fixed})")
    n_refine = int(os.environ.get("EWT_REFINE", "3"))
    blocked = os.environ.get("EWT_BLOCKED_CHOL", "0") == "1"

    def finish(lnl, hw, with_health):
        # a numerically non-PD Sigma (extreme prior corners) yields NaN;
        # the reference maps Cholesky failure to -inf likewise
        lnl = torch.where(torch.isnan(lnl), torch.full_like(lnl, -math.inf),
                          lnl)
        return (lnl, hw) if with_health else lnl

    pair_prog = None
    static = dict(cs2=cs2, wb=wb_static, bb=bb_static, det_refs=det_refs,
                  tm_refs=tm_refs)
    if layout is None:
        sigma2 = dev(sigma ** 2)
        r_w_t, M_w_t, T_w_t = dev(r_w), dev(M_w), dev(T_w)
        D_w_t = None if D_w is None else dev(D_w)
        if gram_mode == "split" and static_resid \
                and os.environ.get("EWT_PAIR_PROGRAM", "1") != "0":
            pair_prog = build_pair_program(r_w, M_w, T_w, device=device)
        grams_cached = None
        if const_grams:
            nw0 = eval_nw(torch.zeros((1, max(len(sampled), 1)), dtype=F64,
                                      device=device), wb_static, ntoa,
                          sigma2)
            grams_cached = tuple(g[0] for g in gram_blocks(
                nw0, r_w_t, M_w_t, T_w_t, gram_mode=gram_mode,
                pair_program=pair_prog))
        static.update(r_w=r_w_t, M_w=M_w_t, T_w=T_w_t, sigma2=sigma2,
                      D_w=D_w_t)

        def evaluate_core(theta, with_health=False, gm=None):
            """lnL (W,) at ``theta``; ``with_health`` also returns the (W,
            3) health words (classic chain pinned); ``gm="f64"`` is the
            float64 twin (no folded Grams, no pair program)."""
            gm = gm or gram_mode
            fold = gm == gram_mode
            megakernel.LAST_REJECT[0] = None
            nw = eval_nw(theta, wb_static, ntoa, sigma2)
            phi = eval_phi(theta, bb_static, cs2)
            T_eff = eval_T(theta, bb_static, T_w_t)
            r_eff = r_w_t
            if det_refs is not None:
                r_eff = r_eff - _stacked(theta, det_refs) @ D_w_t.T
            if tm_refs is None:
                out = marginalized_loglike(
                    nw, phi, r_eff, M_w_t, T_eff, gram_mode=gm,
                    pair_program=None if grams_cached is not None
                    or not fold else pair_prog, refine=n_refine,
                    grams=grams_cached if fold else None,
                    with_health=with_health, blocked=blocked)
            else:
                r_eff = r_eff - _stacked(theta, tm_refs) @ M_w_t.T
                out = marginalized_loglike(nw, phi, r_eff, None, T_eff,
                                           gram_mode=gm, refine=n_refine,
                                           with_health=with_health,
                                           blocked=blocked)
            lnl, hw = out if with_health else (out, None)
            # the kernel route's rejections of this call (None off that
            # route)
            like.last_reject = megakernel.LAST_REJECT[0]
            return finish(lnl, hw, with_health)
        toa = None
    else:
        evaluate_core, shards, toa = _toa_sharded_core(
            layout, device, dict(
                r_w=r_w, M_w=M_w, T_w=T_w, sigma=sigma, D_w=D_w,
                white_blocks=white_blocks, basis_blocks=basis_blocks,
                mapping=mapping, bb_static=bb_static, cs2=cs2,
                det_refs=det_refs, tm_refs=tm_refs, gram_mode=gram_mode,
                n_refine=n_refine, blocked=blocked), finish)
        static.update(shards=shards, nshard=toa[0], ntoa_padded=toa[1])

    def evaluate(theta):
        return evaluate_core(theta)

    like = PulsarLikelihood(psr, sampled, evaluate, gram_mode, device)
    like.last_reject = None
    like.noise_pairs = _noise_slide_pairs(psr, like.param_names)
    like.const_grams = bool(const_grams)
    like.pair_program = pair_prog is not None
    like.blocked_chol = blocked
    like.mesh = layout
    like.build_fingerprint = _build_fingerprint(
        psr, mapping, wb_static, basis_blocks, bb_static, tm, n_refine,
        const_grams, pair_prog is not None, blocked, toa)
    like.static = static
    # the health plane's twins (resilience/integrity.py): the same lnL on
    # the classic chain plus the (W, 3) health words, and the float64
    # re-evaluation of the ladder's reeval rung
    like._eval_health_batch = lambda theta: evaluate_core(
        like.as_theta(theta), with_health=True)
    like._eval_f64_batch = lambda theta: evaluate_core(
        like.as_theta(theta), gm="f64")
    like.health_psr_names = [psr.name]
    if layout is None:
        like.eval_nw = lambda theta: eval_nw(like.as_theta(theta),
                                             wb_static, ntoa, sigma2)
    like.eval_phi = lambda theta: eval_phi(like.as_theta(theta), bb_static,
                                           cs2)
    return like


def _toa_sharded_core(layout, device, b, finish):
    """The TOA-sharded evaluation of :func:`build_pulsar_likelihood`:
    ``(evaluate_core, shards, (nshard, padded ntoa))``. ``b`` holds the
    build's host arrays (whitened, unpadded) and resolved choices;
    ``finish`` maps NaN to -inf. ``shards`` maps each shard this process
    holds to its device rows: its own in a process group (none for a
    rank past the last shard), every shard without a group."""
    from ..parallel.distributed import all_reduce_sum, grad_all_reduce
    nshard, group = layout.nshard, layout.group
    ntoa = b["r_w"].shape[0]
    # each shard's rows start on a chunk boundary, so the split-mode
    # float32 partials stay shard-local
    n_pad = (-ntoa) % (nshard * _CHUNK)
    rows = (ntoa + n_pad) // nshard
    nb = b["T_w"].shape[1]
    tm_refs, det_refs = b["tm_refs"], b["det_refs"]
    ntm = 0 if tm_refs is not None else b["M_w"].shape[1]
    # one packed row per walker: G, H, P, X, q, rwr and sum log nw
    sizes = [nb * nb, nb * ntm, ntm * ntm, nb, ntm, 1, 1]

    def pad(a, value=0.0):
        a = np.asarray(a, dtype=np.float64)
        return np.pad(a, ((0, n_pad),) + ((0, 0),) * (a.ndim - 1),
                      constant_values=value)

    host = dict(r=pad(b["r_w"]), M=pad(b["M_w"]), T=pad(b["T_w"]),
                s2=pad(b["sigma"] ** 2, 1.0),
                mask=np.r_[np.ones(ntoa), np.zeros(n_pad)],
                D=None if b["D_w"] is None else pad(b["D_w"]))
    if group is None:
        held = range(nshard)
    else:
        held = [layout.rank] if layout.rank < nshard else []
    shards = {}
    for s in held:
        sl = slice(s * rows, (s + 1) * rows)
        sh = {k: None if v is None else torch.as_tensor(
            np.ascontiguousarray(v[sl]), dtype=F64, device=device)
            for k, v in host.items()}
        sh["wb"] = white_static(b["white_blocks"], b["mapping"], device,
                                n_pad=n_pad, rows=sl)
        sh["bb"] = basis_static(b["basis_blocks"], b["mapping"], device,
                                n_pad=n_pad, rows=sl)
        shards[s] = sh

    def shard_packed(theta, sh, gm):
        """One shard's Gram partials and masked ``sum log nw`` at
        ``theta``, packed (W, L)."""
        nw = eval_nw(theta, sh["wb"], rows, sh["s2"])
        T_eff = eval_T(theta, sh["bb"], sh["T"])
        r_eff, M = sh["r"], sh["M"]
        if det_refs is not None:
            r_eff = r_eff - _stacked(theta, det_refs) @ sh["D"].T
        if tm_refs is not None:
            r_eff = r_eff - _stacked(theta, tm_refs) @ M.T
            M = None
        # padded rows hold zero residual, basis and design rows and nw = 1
        # there, so they add nothing unmasked, and the weights' square
        # root stays differentiable (a masked weight of 0 would give the
        # gradient 0 * inf)
        G, H, P, X, q, rwr = gram_blocks(nw, r_eff, M, T_eff, gram_mode=gm,
                                         rows=_gram_rows(ntoa))
        W = theta.shape[0]
        ldn = _row_sum(torch.log(nw) * sh["mask"])
        return torch.cat([G.reshape(W, -1), H.reshape(W, -1),
                          P.reshape(W, -1), X, q, rwr[:, None],
                          ldn[:, None]], dim=-1)

    def unpack(packed):
        """The summed (W, L) -> ``(G, H, P, X, q, rwr)`` and ``logdet_n``."""
        W = packed.shape[0]
        G, H, P, X, q, rwr, ldn = torch.split(packed, sizes, dim=-1)
        return (G.reshape(W, nb, nb), H.reshape(W, nb, ntm),
                P.reshape(W, ntm, ntm), X, q, rwr[:, 0]), ldn[:, 0]

    def evaluate_core(theta, with_health=False, gm=None):
        """One sharded evaluation: the held shards' bodies, THE collective,
        then the Sigma stage replicated (the same words on every rank)."""
        gm = gm or b["gram_mode"]
        megakernel.LAST_REJECT[0] = None
        theta_f = grad_all_reduce(theta, group)
        local = None
        for sh in shards.values():
            part = shard_packed(theta_f, sh, gm)
            local = part if local is None else local + part
        if local is None:
            # a rank past the last shard adds zeros (and still joins the
            # gradient's sum)
            local = theta_f.new_zeros((theta.shape[0], sum(sizes))) \
                + 0.0 * theta_f.sum(dim=1, keepdim=True)
        grams, logdet_n = unpack(all_reduce_sum(local, group))
        if gm in ("split", "f32") and tm_refs is None and not with_health:
            # the likelihood kernel forms its own Gram from whole rows
            megakernel.mega_like_route(
                rows, nb, device,
                decline="blocked" if b["blocked"] else "toa-sharded")
        out = sigma_stage(grams, eval_phi(theta, b["bb_static"], b["cs2"]),
                          logdet_n, schur_tm=tm_refs is None, gram_mode=gm,
                          refine=b["n_refine"], with_health=with_health,
                          blocked=b["blocked"])
        lnl, hw = out if with_health else (out, None)
        return finish(lnl, hw, with_health)

    return evaluate_core, shards, (nshard, ntoa + n_pad)
