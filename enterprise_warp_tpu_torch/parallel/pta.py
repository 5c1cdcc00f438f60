"""The joint correlated-GWB PTA likelihood, batched over walkers.

Counterpart of ``enterprise_warp_tpu/parallel/pta.py`` without its device
mesh. A spatially-correlated common signal (``gwb`` with an ORF option)
couples every pulsar pair through the ORF, so the marginalized likelihood
is no longer a sum of per-pulsar terms::

    C   = N + T Phi T^T
    lnL = -1/2 (r^T N^-1 r - X^T Sigma^-1 X)
          -1/2 (ln|N| + ln|Phi| + ln|Sigma|)
    X     = T^T N^-1 r            (per-pulsar blocks)
    Sigma = Phi^-1 + T^T N^-1 T   (block-diagonal Grams + ORF coupling)

``Phi`` is diagonal except on the GW columns, where frequency column
``k`` carries the (Npsr, Npsr) block ``B_k = phi_gw_k * Gamma``. Each
pulsar's basis columns are permuted into three fixed-width regions
``[noise | TM | GW]`` (widths NW, MW, n_g) and eliminated by nested Schur
complements (``joint_mode='schur'``):

1. the per-pulsar noise blocks ``G_nn + diag(1/phi)`` against the
   right-hand side ``[X_n | H | C_ng]`` (k = 1 + MW + n_g columns) by the
   mixed-precision solve ``ops.kernel._mixed_psd_solve_logdet``: on the
   card the solve kernel, ONE launch over all (walker, pulsar) pairs, a
   flat batch of W·P systems where the reference vmaps twice;
2. the timing model marginalized exactly through a float64 (MW x MW)
   Schur complement per pulsar, factored by ``eigh`` with the
   reference's relative eigenvalue clamp; a pair whose complement comes
   out near singular (``CORNER_C``) is solved again in float64 from
   stage 1 instead;
3. the ORF coupling collapses to one (P·n_g)^2 system per walker,
   ``S = blockdiag_a(D_a - C_a^T A_a^-1 C_a) + K`` (``K`` scatters the
   per-frequency ``B_k^-1`` blocks), solved by the same mixed solve: the
   solve kernel up to its order cap (448), the classic chain above it, as
   in the reference. Low-rank ORFs (monopole, dipole) take a float64
   equilibrated Cholesky here instead.

The whitened Grams feeding both are formed in float64 in every Gram
mode (the reference's split mode uses hi/lo float32 products there; see
``CORNER_C``). ``joint_mode='dense'`` (the default for
``gram_mode='f64'``) assembles and factors the whole (P·nb_tot)^2 Sigma
per walker in float64: the oracle. Parameter evaluation (white-noise
selections, PSD priors) is compiled at build time into flat
gather/scatter programs. The Schur path carries the reference's
evaluation cache (``samplers/evalproto.py``): ``param_blocks`` and
``_cache_init``/``_cache_site``/``_cache_common``, and the health
plane's twin ``_eval_health_batch`` (the lnL and each pulsar's stage-1
health word, ``health_psr_names``).

A sampled chromatic index (``chromred("vary...")`` in a pulsar's model)
rescales that pulsar's region-N columns per walker before the Grams
(``dyn_blocks``, the reference's); the basis is then walker-dependent, so
no evaluation cache is installed, as in the reference.

The pulsar axis across processes (``mesh=``, a
:class:`~.distributed.ShardLayout` from :func:`~.distributed.make_mesh`),
the reference's explicit SPMD path: the parameter programs run
replicated from the replicated theta; each rank runs stages 1-2 on its
own contiguous range of pulsars (on the card one solve-kernel launch
over its (walker, pulsar) pairs, the float64 redo of flagged pairs
local to the shard); every cross-pulsar quantity (the Schur blocks
``Ss``/``Xs`` scattered at the shard's offset, the health words, the
mesh plane's attribution lanes and the six scalar sums) goes into one
flat float64 vector per walker, summed by exactly one
:func:`~.distributed.all_reduce_sum` per evaluation, and stage 3 runs
replicated from the sum. Two departures from the reference: the shards
are uneven where the pulsar count does not divide (no padded pulsars,
where ``shard_map`` needs equal shards), and the kernel routes stay on
inside the sharded region (the reference pins its classic chain there
because a ``custom_vjp`` has no transpose through ``psum``; the port's
gradient goes through the autograd pair of ``distributed.py``: the
packed sum is the identity in the backward and theta's entry into the
shard's front end sums its gradient over the group). A sampled
chromatic index keeps the unsharded path, and a sharded likelihood
carries no evaluation cache, as in the reference.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import F64, resolve_device
from ..models.build import (PulsarLikelihood, _noise_slide_pairs,
                            _resolve_params, collect_params, eval_block_phi,
                            lower_terms, param_value)
from ..models.prior_mixin import PriorMixin
from ..ops.kernel import (CHOL_JITTER, HW_WIDTH, _gram_pair,
                          _mixed_psd_solve_logdet, _t, equilibrated_cholesky,
                          whiten_inputs)
from ..ops.megakernel import _safe_eigh
from ..ops.spectra import (broken_powerlaw_psd, free_spectrum_psd,
                           powerlaw_psd)
from ..samplers.evalproto import (BLOCK_COMMON, BLOCK_GLOBAL,
                                  install_masked_protocol)
from .distributed import all_reduce_sum, grad_all_reduce, scatter_to_global
from .orf import is_low_rank, is_positive_definite, orf_matrix

# Improper-flat-prior stand-in for timing-model columns on the dense oracle
# path (and the constant that keeps both paths' lnL identical); the
# reference keeps it inside the float32 exponent range.
_TM_PHI = 1.0e30


def _bmm64(A, B):
    """Batched float64 ``A^T B`` over the row axis: (..., n, m), (..., n, k)
    -> (..., m, k)."""
    return _t(A) @ B


# The port departs from the reference's Schur path in two places, both
# chosen from measurements against the dense float64 oracle
# (``chip_smoke.py:corner_scan``; PERF.md): the front-end Gram is formed in
# float64 in every Gram mode, where the reference's split mode forms it
# from hi/lo float32 products, about 2e-6 of max|G| off, an error the
# nested Schur stages amplify into attractive float32 corners; and a
# (walker, pulsar) pair whose timing-model complement comes out with its
# smallest eigenvalue below CORNER_C times its largest magnitude has its
# stage-1 solve done again in float64 (``_pairs12``), where the reference
# clamps the eigenvalues.
CORNER_C = 1e-5

#: the mesh plane's attribution lanes per shard, riding the packed sum:
#: evaluations, active TOAs (the stage-1/2 work proxy), jitter-engaged
#: and refine-diverged pulsar counts
MESH_ATTR_WIDTH = 4


def _nan_to_neginf(lnl):
    """A NaN lnL as minus infinity (a rejected proposal)."""
    return torch.where(torch.isnan(lnl), torch.full_like(lnl, -math.inf),
                       lnl)


def _solve_f64(S, B, jitter):
    """``S Z = B`` and ``log|S|`` in float64 by an equilibrated Cholesky,
    retried with ``jitter`` on the unit diagonal where the factor fails
    (a system beyond float64; NaN, which ``evaluate`` maps to -inf, only
    where that fails too): ``(Z, logdet)``."""
    L, s, logdet = equilibrated_cholesky(S, jitter)
    Z = torch.cholesky_solve(s[..., None] * B, L, upper=False)
    return s[..., None] * Z, logdet


class PTALikelihood(PriorMixin):
    """Walker-batched joint likelihood over all pulsars with ORF coupling.

    The interface of :class:`models.build.PulsarLikelihood`: ``params``,
    ``param_names``, ``ndim``, ``device``, ``loglike_batch`` ((W, ndim) ->
    (W,) float64), ``noise_pairs`` and the prior mixin, so every sampler
    runs on it unchanged.
    """

    def __init__(self, psrs, sampled, evaluate, gram_mode, device):
        self.psrs = psrs
        self.params = sampled
        self.param_names = [p.name for p in sampled]
        self.ndim = len(sampled)
        self.gram_mode = gram_mode
        self.device = device
        self._evaluate = evaluate
        # white-noise pair metadata of every pulsar against the joint names
        self.noise_pairs = [p for psr in psrs
                            for p in _noise_slide_pairs(psr,
                                                        self.param_names)]

    as_theta = PulsarLikelihood.as_theta

    def loglike_batch(self, theta):
        """lnL at ``(W, ndim)`` parameter points -> ``(W,)`` float64."""
        return self._evaluate(self.as_theta(theta))


# --------------------------------------------------------------------- #
#  build-time compilation of the parameter-evaluation program            #
# --------------------------------------------------------------------- #

def _refs_to_arrays(refs, device):
    """List of ``('theta', i)`` / ``('const', v)`` refs -> gather tensors
    ``(is_theta, idx, const)``."""
    is_theta = torch.tensor([r[0] == "theta" for r in refs],
                            dtype=torch.bool, device=device)
    idx = torch.tensor([r[1] if r[0] == "theta" else 0 for r in refs],
                       dtype=torch.long, device=device)
    const = torch.tensor([r[1] if r[0] == "const" else 0.0 for r in refs],
                         dtype=F64, device=device)
    return is_theta, idx, const


def _gather_vals(theta, arrs):
    """The referenced values per walker: (W, len(refs))."""
    is_theta, idx, const = arrs
    return torch.where(is_theta, theta[:, idx], const)


def _compile_white(lowered, mapping, npsr, ntoa_max, ntoas, device):
    """Selector-index compilation of all pulsars' white-noise blocks.

    Within an efac block the selection masks partition the covered TOAs,
    later blocks override earlier ones and uncovered TOAs keep efac = 1,
    so each TOA's efac is one table lookup ``sel_e[p, t]`` into a
    parameter-value vector whose last slot is the constant 1. equad
    accumulates across blocks and keeps one selector layer per block,
    the sentinel slot holding -inf (10^-inf = 0).
    """
    efac_refs, equad_refs = [], []
    n_eq_layers = max([1] + [sum(1 for wb in lw[0] if wb.kind == "equad")
                             for lw in lowered])
    sel_e = np.full((npsr, ntoa_max), -1, dtype=np.int64)
    sel_q = np.full((npsr, n_eq_layers, ntoa_max), -1, dtype=np.int64)
    for a, (wbs, _, _) in enumerate(lowered):
        ql = 0
        for wb in wbs:
            mm = wb.mask_matrix            # (nsel, ntoa) 0/1
            if np.any(mm.sum(axis=0) > 1.0):
                raise ValueError(
                    f"overlapping {wb.kind} selection masks within one "
                    "block are not supported (selections partition TOAs)")
            if wb.kind == "efac":
                for s, p in enumerate(wb.params):
                    slot = len(efac_refs)
                    efac_refs.append(mapping[p.name])
                    sel_e[a, :ntoas[a]][mm[s].astype(bool)[:ntoas[a]]] = slot
            elif wb.kind == "equad":
                for s, p in enumerate(wb.params):
                    slot = len(equad_refs)
                    equad_refs.append(mapping[p.name])
                    sel_q[a, ql, :ntoas[a]][
                        mm[s].astype(bool)[:ntoas[a]]] = slot
                ql += 1
    ne, nq = len(efac_refs), len(equad_refs)
    sel_e[sel_e < 0] = ne                  # sentinel -> efac = 1.0
    sel_q[sel_q < 0] = nq                  # sentinel -> equad2 = 0.0
    e_arrs = _refs_to_arrays(efac_refs, device) if ne else None
    q_arrs = _refs_to_arrays(equad_refs, device) if nq else None
    sel_e_t = torch.as_tensor(sel_e, device=device)
    sel_q_t = torch.as_tensor(sel_q, device=device)

    def eval_white(theta, sigma2):
        """Whitened white-noise variance (W, npsr, ntoa_max)."""
        W = theta.shape[0]
        ones = torch.ones((W, 1), dtype=F64, device=theta.device)
        vals_e = ones if e_arrs is None else \
            torch.cat([_gather_vals(theta, e_arrs), ones], dim=1)
        efac = vals_e[:, sel_e_t]
        if q_arrs is None:
            return efac ** 2
        vals_q = torch.cat([_gather_vals(theta, q_arrs), -math.inf * ones],
                           dim=1)
        equad2 = torch.sum(10.0 ** (2.0 * vals_q[:, sel_q_t]), dim=2)
        return efac ** 2 + equad2 / sigma2

    return eval_white


_PSD_FNS = {"powerlaw": powerlaw_psd, "turnover": broken_powerlaw_psd}


def _compile_phi(noise_specs, NW, npsr, device):
    """PSD-group compilation of all pulsars' region-N prior variances.

    ``noise_specs`` — one dict per (pulsar, non-GW basis block): ``psd``,
    ``freqs``, ``df``, ``refs`` (mapping entries), ``flat_idx`` (targets
    in the flat (npsr·NW,) vector), ``fixed`` (host constant or None),
    ``ncols``. Fixed blocks are burned into the initial vector; each
    sampled group (powerlaw / turnover / free_spectrum / ecorr) is one
    batched PSD evaluation and one scatter. The reference drops the
    per-group column padding with a ``mode="drop"`` scatter onto a dump
    slot at ``npsr·NW``; torch has no drop mode, so the slot is a real
    extra entry here, written and sliced off.
    """
    n_flat = npsr * NW
    phi_init = np.ones(n_flat + 1)
    groups = {}
    for spec in noise_specs:
        if spec["fixed"] is not None:
            phi_init[spec["flat_idx"]] = spec["fixed"]
            continue
        groups.setdefault(spec["psd"], []).append(spec)
    phi_init_t = torch.as_tensor(phi_init, dtype=F64, device=device)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64,
                               device=device)

    progs = []
    for psd, specs in groups.items():
        ncmax = max(s["ncols"] for s in specs)
        nmmax = ncmax // 2 if psd != "ecorr" else 0
        B = len(specs)
        tgt = np.full((B, ncmax), n_flat, dtype=np.int64)   # dump slot
        for i, s in enumerate(specs):
            tgt[i, :s["ncols"]] = s["flat_idx"]
        tgt_t = torch.as_tensor(tgt.ravel(), device=device)
        if psd == "ecorr":
            refs = _refs_to_arrays([s["refs"][0] for s in specs], device)

            def vals_fn(theta, refs=refs, ncmax=ncmax):
                p = _gather_vals(theta, refs)                   # (W, B)
                return (10.0 ** (2.0 * p))[..., None].expand(
                    -1, -1, ncmax)
        elif psd == "free_spectrum":
            rows = [list(s["refs"]) + [("const", 0.0)] * (
                nmmax - len(s["refs"])) for s in specs]
            refs = _refs_to_arrays([r for row in rows for r in row], device)
            ones = dev(np.ones((B, nmmax)))

            def vals_fn(theta, refs=refs, B=B, nmmax=nmmax, ones=ones):
                rho = _gather_vals(theta, refs).reshape(-1, B, nmmax)
                return free_spectrum_psd(ones, ones, rho)
        else:
            fn = _PSD_FNS[psd]
            nparams = len(specs[0]["refs"])
            f = np.ones((B, nmmax))
            df = np.ones((B, nmmax))
            for i, s in enumerate(specs):
                nm = len(s["freqs"])
                f[i, :nm] = s["freqs"]
                df[i, :nm] = s["df"]
            refs = [_refs_to_arrays([s["refs"][j] for s in specs], device)
                    for j in range(nparams)]

            def vals_fn(theta, refs=refs, fn=fn, f=dev(f), df=dev(df)):
                return fn(f, df, *[_gather_vals(theta, r) for r in refs])
        progs.append((tgt_t, vals_fn))

    def eval_phi(theta):
        """Region-N prior variances (W, npsr, NW), before column scaling."""
        W = theta.shape[0]
        phi_flat = phi_init_t.expand(W, -1).clone()
        for tgt_t, vals_fn in progs:
            phi_flat[:, tgt_t] = vals_fn(theta).reshape(W, -1)
        return phi_flat[:, :n_flat].reshape(W, npsr, NW)

    return eval_phi


# --------------------------------------------------------------------- #
#  ORF coupling: static prep + per-term inverse                          #
# --------------------------------------------------------------------- #

def _prep_orf_static(orf_name, pos, device):
    """Static (theta-independent) ORF factorization, host float64: the
    inverse and ``ln|Gamma|`` of a positive-definite ORF, else its
    eigendecomposition. The coupling block of frequency column ``k`` is
    ``B_k = phi_k diag(s_k) Gamma diag(s_k)``, so the per-evaluation
    inverse is then elementwise in theta."""
    g = orf_matrix(orf_name, pos)
    if is_positive_definite(orf_name):
        sign, lndet_g = np.linalg.slogdet(g)
        if sign <= 0:
            raise ValueError(
                f"ORF '{orf_name}' matrix is not positive definite "
                "for this pulsar set")
        return dict(pd=True, lndet=float(lndet_g),
                    ginv=torch.as_tensor(np.linalg.inv(g), dtype=F64,
                                         device=device))
    ev, V = np.linalg.eigh(g)
    return dict(pd=False, ev=torch.as_tensor(ev, dtype=F64, device=device),
                V=torch.as_tensor(V, dtype=F64, device=device))


def _coupling_inverse(phi_gw, s, orf):
    """Inverse coupling blocks of one correlated common term.

    ``phi_gw`` — (W, ncols) per-column GW prior variance; ``s`` — (npsr,
    ncols) static column scales; ``orf`` — from :func:`_prep_orf_static`.
    Returns ``(Binv, logdet)``: ``Binv`` (W, ncols, npsr, npsr) with
    ``Binv[:, k] = B_k^-1`` and ``logdet`` (W,) ``= sum_k ln|B_k|``. Exact
    for positive-definite ORFs; an indefinite ORF (``hd_noauto``) clamps
    the eigenvalues of ``phi_k Gamma`` at 1e-12 in the ``diag(s)``-whitened
    coordinates (a PSD regularized inverse, exact on the positive
    eigenspace).
    """
    npsr, ncols = s.shape
    inv_s = 1.0 / s
    log_ss = 2.0 * torch.sum(torch.log(s))
    if orf["pd"]:
        w = inv_s[None] / torch.sqrt(phi_gw)[:, None, :]   # (W, npsr, k)
        Binv = orf["ginv"] * torch.einsum("wak,wbk->wkab", w, w)
        logdet = (npsr * torch.sum(torch.log(phi_gw), dim=-1) + log_ss
                  + ncols * orf["lndet"])
        return Binv, logdet
    ev_cl = torch.clamp(phi_gw[:, :, None] * orf["ev"], min=1e-12)
    WV = inv_s[:, :, None] * orf["V"][:, None, :]        # (npsr, k, nev)
    Binv = torch.einsum("akj,wkj,bkj->wkab", WV, 1.0 / ev_cl, WV)
    return Binv, torch.sum(torch.log(ev_cl), dim=(1, 2)) + log_ss


# --------------------------------------------------------------------- #
#  likelihood builder                                                    #
# --------------------------------------------------------------------- #

def build_pta_likelihood(psrs, termlists, fixed_values=None,
                         gram_mode="split", ecorr_dt=10.0, joint_mode=None,
                         device="cuda", mesh=None):
    """Compile per-pulsar TermLists + ORF coupling into one joint
    walker-batched likelihood (:class:`PTALikelihood`).

    ``joint_mode`` — ``'schur'`` (nested Schur elimination), ``'dense'``
    (one dense equilibrated float64 Cholesky of the joint Sigma per
    walker), or None: schur for ``gram_mode`` 'split'/'f32', dense for
    'f64' (the oracle). The stage-1 and stage-3 mixed solves take the
    solve kernel on CUDA tensors within its order cap, the classic chain
    otherwise; with ``gram_mode`` 'f64' they never take the kernel. The
    stage functions are exposed as ``like._stages`` for measurement.

    ``mesh`` — a pulsar-axis :class:`~.distributed.ShardLayout`: the Schur
    path then runs sharded (module docstring; ``_stages["spmd"]``). A
    layout of another axis (the sampler's ``chain``) is ignored.
    """
    device = resolve_device(device)
    if mesh is not None and getattr(mesh, "axis", None) != "psr":
        mesh = None
    if joint_mode is None:
        joint_mode = "dense" if gram_mode == "f64" else "schur"
    if joint_mode not in ("schur", "dense"):
        raise ValueError(f"unknown joint_mode '{joint_mode}'")
    mega = False if gram_mode == "f64" else None
    npsr = len(psrs)
    if npsr != len(termlists):
        raise ValueError("one TermList per pulsar required")

    # ---- common GW grid: the PTA-wide span (Enterprise common-Tspan) ----
    t0 = min(p.toas.min() for p in psrs)
    t1 = max(p.toas.max() for p in psrs)
    lowered = [lower_terms(p, tl, ecorr_dt=ecorr_dt, common_grid=(t0, t1 - t0))
               for p, tl in zip(psrs, termlists)]

    # ---- global parameter resolution (shared GW names dedup) -----------
    all_params = []
    for wb, bb, _ in lowered:
        all_params.extend(collect_params(wb, bb))
    sampled, mapping = _resolve_params(all_params, fixed_values)

    # ---- correlated common terms: identical layout across pulsars ------
    corr_names = sorted({b.name for _, bb, _ in lowered
                         for b in bb if b.orf is not None})
    corr_blocks = []
    for name in corr_names:
        matches = [[b for b in bb if b.orf is not None and b.name == name]
                   for _, bb, _ in lowered]
        first = matches[0]
        if len(first) != 1 or any(
                len(m) != 1 or m[0].ncols != first[0].ncols
                or m[0].orf != first[0].orf for m in matches):
            raise ValueError(
                f"correlated common term '{name}' must appear "
                "identically in every pulsar's model (reference "
                "common_signals semantics)")
        corr_blocks.append(first[0])
    n_g = sum(b.ncols for b in corr_blocks)
    g_offsets = {}
    off = 0
    for blk in corr_blocks:
        g_offsets[blk.name] = off
        off += blk.ncols

    # ---- per-pulsar whitening; column regions [noise | TM | GW] --------
    ntoa_max = max(len(p) for p in psrs)
    ntoas = [len(p) for p in psrs]
    statics = []
    for (wb, bb, T_all), psr in zip(lowered, psrs):
        r_w, M_w, T_w, cs2, _ = whiten_inputs(
            psr.residuals, psr.toaerrs, psr.Mmat, T_all)
        statics.append(dict(r_w=r_w, T_w=T_w, M_w=M_w, cs2=cs2))
    NW = max(st["T_w"].shape[1] - n_g for st in statics)
    MW = max(st["M_w"].shape[1] for st in statics)
    nb_tot = NW + MW + n_g

    R = np.zeros((npsr, ntoa_max))
    Tst = np.zeros((npsr, ntoa_max, nb_tot))
    toamask = np.zeros((npsr, ntoa_max))
    sigma2 = np.ones((npsr, ntoa_max))
    cs2_N = np.ones((npsr, NW))
    tm_pad = np.ones((npsr, MW))        # 1 on PADDED timing-model slots
    s_gw = np.zeros((npsr, n_g))        # sqrt(cs2) on GW columns
    ntm_real_total = 0
    noise_specs = []                    # phi program inputs (region N)
    dyn_blocks = []                     # sampled chromatic-index rescales
    for a, ((_, bb, _), st, psr) in enumerate(zip(lowered, statics, psrs)):
        n_a = len(psr)
        R[a, :n_a] = st["r_w"]
        toamask[a, :n_a] = 1.0
        sigma2[a, :n_a] = psr.toaerrs ** 2
        ntm_a = st["M_w"].shape[1]
        Tst[a, :n_a, NW:NW + ntm_a] = st["M_w"]
        tm_pad[a, :ntm_a] = 0.0
        ntm_real_total += ntm_a
        # non-GW basis columns keep their relative order in region N
        new_off = 0
        for blk in bb:
            sl = blk.col_slice
            if blk.orf is not None:
                goff = g_offsets[blk.name]
                Tst[a, :n_a, NW + MW + goff:NW + MW + goff + blk.ncols] = \
                    st["T_w"][:, sl]
                s_gw[a, goff:goff + blk.ncols] = np.sqrt(st["cs2"][sl])
                continue
            Tst[a, :n_a, new_off:new_off + blk.ncols] = st["T_w"][:, sl]
            cs2_N[a, new_off:new_off + blk.ncols] = st["cs2"][sl]
            noise_specs.append(dict(
                psr=a, psd=blk.psd, freqs=blk.freqs, df=blk.df,
                refs=[mapping[p.name] for p in blk.params],
                flat_idx=a * NW + new_off + np.arange(blk.ncols),
                fixed=blk.fixed_phi, ncols=blk.ncols))
            if blk.dynamic_idx is not None:
                dyn_blocks.append(dict(
                    psr=a, cols=slice(new_off, new_off + blk.ncols),
                    ref=mapping[blk.dynamic_idx.name],
                    lognu=np.pad(blk.log_nu_ratio, (0, ntoa_max - n_a))))
            new_off += blk.ncols

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64,
                               device=device)

    eval_white = _compile_white(lowered, mapping, npsr, ntoa_max, ntoas,
                                device)
    eval_phi = _compile_phi(noise_specs, NW, npsr, device)
    R_t, T_t, mask_t = dev(R), dev(Tst), dev(toamask)
    sigma2_t, cs2_N_t, tm_pad_t = dev(sigma2), dev(cs2_N), dev(tm_pad)

    # ---- ORF coupling: per-frequency (npsr, npsr) blocks ----------------
    pos = np.stack([np.asarray(p.pos, dtype=np.float64) for p in psrs])
    orfs = [_prep_orf_static(blk.orf, pos, device) for blk in corr_blocks]
    s_gw_t = [dev(s_gw[:, g_offsets[blk.name]:
                       g_offsets[blk.name] + blk.ncols])
              for blk in corr_blocks]
    cb_static = [dict(psd=blk.psd, freqs=dev(blk.freqs), df=dev(blk.df),
                      idx_map=[mapping[p.name] for p in blk.params],
                      fixed_phi=None, ncols=blk.ncols)
                 for blk in corr_blocks]
    low_rank = any(is_low_rank(blk.orf) for blk in corr_blocks)

    # ---- parameter -> block classification (the update_mask contract,
    # samplers/evalproto.py): the pulsar block a parameter touches, the
    # coupling-only common block (correlated GW parameters), or
    # BLOCK_GLOBAL where it appears in more than one block or in none
    param_blocks = np.full(len(sampled), BLOCK_GLOBAL, dtype=np.int64)
    seen = {}

    def mark(ref, blk):
        if ref[0] != "theta":
            return
        i = ref[1]
        if i not in seen:
            seen[i] = param_blocks[i] = blk
        elif seen[i] != blk:
            seen[i] = param_blocks[i] = BLOCK_GLOBAL

    for a, (wbs, _, _) in enumerate(lowered):
        for wb in wbs:
            for p in wb.params:
                mark(mapping[p.name], a)
    for spec in noise_specs:
        for ref in spec["refs"]:
            mark(ref, spec["psr"])
    for db in dyn_blocks:
        mark(db["ref"], db["psr"])
    for cb in cb_static:
        for ref in cb["idx_map"]:
            mark(ref, BLOCK_COMMON)

    # (row, column) targets of the coupling K inside the (npsr·n_g)^2
    # Schur system and inside the (npsr·nb_tot)^2 dense Sigma, flattened
    schur_idx, dense_idx = [], []
    for blk in corr_blocks:
        goff = g_offsets[blk.name]
        flat_s = goff + np.arange(blk.ncols)[None, :] \
            + np.arange(npsr)[:, None] * n_g             # (npsr, ncols)
        flat_d = NW + MW + goff + np.arange(blk.ncols)[None, :] \
            + np.arange(npsr)[:, None] * nb_tot
        for store, flat in ((schur_idx, flat_s), (dense_idx, flat_d)):
            rows = np.broadcast_to(flat.T[:, :, None],
                                   (blk.ncols, npsr, npsr))
            cols = np.broadcast_to(flat.T[:, None, :],
                                   (blk.ncols, npsr, npsr))
            store.append((torch.as_tensor(rows.ravel(), device=device),
                          torch.as_tensor(cols.ravel(), device=device)))

    jitter = CHOL_JITTER[gram_mode]
    # theta-independent constant matching the dense path's big-phi TM
    # marginalization: logphi there carries +ntm·ln(_TM_PHI)
    tm_const = ntm_real_total * np.log(_TM_PHI)
    # stage-1 delta mode: the float64 oracle keeps the tree-exact logdet;
    # reduced-precision Gram modes take the split (fused) route
    stage1_delta = "tree" if gram_mode == "f64" else "split"

    for db in dyn_blocks:
        db["lognu"] = dev(db["lognu"])

    def _basis(theta):
        """The stacked basis ``T_t`` (npsr, ntoa_max, nb_tot), or with a
        sampled chromatic index the per-walker basis (W, npsr, ntoa_max,
        nb_tot): each such block's region-N columns scaled by
        ``exp(idx * log_nu_ratio)`` per TOA (padded TOAs: ratio 0)."""
        if not dyn_blocks:
            return T_t
        T = T_t.expand((theta.shape[0],) + tuple(T_t.shape)).clone()
        for db in dyn_blocks:
            idx = param_value(theta, db["ref"])
            scale = torch.exp(idx[:, None] * db["lognu"][None, :])
            a, sl = db["psr"], db["cols"]
            T[:, a, :, sl] = T_t[a, :, sl] * scale[:, :, None]
        return T

    def _coupling_blocks(theta):
        """Per-term inverse coupling blocks (list of (W, ncols, npsr,
        npsr)) and their total log-determinant (W,)."""
        out = []
        logdet_b = torch.zeros(theta.shape[0], dtype=F64, device=device)
        for ci, cb in enumerate(cb_static):
            Binv, ld = _coupling_inverse(eval_block_phi(theta, cb),
                                         s_gw_t[ci], orfs[ci])
            out.append(Binv)
            logdet_b = logdet_b + ld
        return out, logdet_b

    def _scatter_blocks(M, Binvs, idx):
        """``M`` (W, n, n) plus every coupling block at its targets."""
        W = M.shape[0]
        wi = torch.arange(W, device=device)[:, None]
        for Binv, (rows, cols) in zip(Binvs, idx):
            M.index_put_((wi, rows[None], cols[None]), Binv.reshape(W, -1),
                         accumulate=True)
        return M

    def _block_diag(blocks):
        """(W, npsr, m, m) blocks -> the (W, npsr·m, npsr·m) block-diagonal
        matrix."""
        W, _, m, _ = blocks.shape
        M = torch.zeros((W, npsr, m, npsr, m), dtype=F64, device=device)
        torch.diagonal(M, dim1=1, dim2=3).copy_(blocks.permute(0, 2, 3, 1))
        return M.reshape(W, npsr * m, npsr * m)

    def _common(theta, gram="f64", lo=0, hi=None):
        """Shared front end: white noise and PSD programs, whitened Grams,
        for the pulsars ``lo:hi`` (all of them by default; a shard of the
        pulsar axis passes its range, the parameter programs still run
        over every pulsar from the replicated theta). Returns ``(G, X,
        rwr_p, logdet_n, logphi, invphi_N)``: ``G`` (W, P, nb_tot,
        nb_tot), ``X`` (W, P, nb_tot), the per-pulsar whitened-residual
        norms ``rwr_p`` (W, P), the sums ``logdet_n`` and ``logphi`` over
        the range. ``gram`` is the Gram's precision
        (``ops/kernel.py:_gram_pair``): float64 in every Gram mode (the
        port's departure from the reference, see CORNER_C); ``"split"``
        gives the reference's front end, for measurement."""
        sl = slice(lo, npsr if hi is None else hi)
        nw = eval_white(theta, sigma2_t)[:, sl]         # (W, P, ntoa)
        phi_N = (eval_phi(theta) * cs2_N_t)[:, sl]      # (W, P, NW)
        logphi = torch.sum(torch.log(phi_N), dim=(1, 2))
        sqw = torch.sqrt(mask_t[sl] / nw)
        Ts = _basis(theta)[..., sl, :, :] * sqw[..., None]
        rs = R_t[sl] * sqw
        # the large Gram: a plain product outside any kernel, batched over
        # walkers and pulsars
        G = _gram_pair(Ts, Ts, gram).to(F64)
        X = torch.einsum("wpik,wpi->wpk", Ts, rs)
        rwr_p = torch.sum(rs * rs, dim=-1)
        logdet_n = torch.sum(torch.log(nw) * mask_t[sl], dim=(1, 2))
        return G, X, rwr_p, logdet_n, logphi, 1.0 / phi_N

    def _split(G, X, invphi_N, tm_pad):
        """A flat batch of (walker, pulsar) pairs, ``G`` (B, nb_tot,
        nb_tot), ``X`` (B, nb_tot), ``invphi_N`` (B, NW), ``tm_pad`` (B,
        MW), cut into the regions of the nested Schur elimination: the
        noise block ``Gnn``, its right-hand side ``[Xn | H | Cng]`` and
        the rest of ``G`` and ``X``."""
        H = G[:, :NW, NW:NW + MW]
        Cng = G[:, :NW, NW + MW:]
        return dict(
            Gnn=G[:, :NW, :NW] + torch.diag_embed(invphi_N),
            RHS=torch.cat([X[:, :NW, None], H, Cng], dim=-1),
            P=G[:, NW:NW + MW, NW:NW + MW] + torch.diag_embed(tm_pad),
            H=H, Cng=Cng, Cmg=G[:, NW:NW + MW, NW + MW:],
            Dgg=G[:, NW + MW:, NW + MW:], Xn=X[:, :NW],
            Xm=X[:, NW:NW + MW], Xg=X[:, NW + MW:])

    def _stage2(r, Z, ld_nn):
        """Exact timing-model marginalization in float64 from the
        stage-1 solution ``Z`` of the regions ``r`` (:func:`_split`): the
        (MW x MW) complement is factored by ``eigh`` with the reference's
        relative clamp (a condition-bounded PSD solve, never NaN). Returns
        each pair's ``q1``, ``ld_nn``, ``ld_tm``, ``Xs``, ``Ss`` and
        ``ev_ratio``, the complement's smallest eigenvalue over its
        largest magnitude."""
        H, Cng, Xn = r["H"], r["Cng"], r["Xn"]
        Zx, ZH, ZC = Z[:, :, 0], Z[:, :, 1:1 + MW], Z[:, :, 1 + MW:]
        Atm = r["P"] - _bmm64(H, ZH)
        ym = r["Xm"] - torch.sum(H * Zx[..., None], dim=1)
        Cmt = r["Cmg"] - _bmm64(H, ZC)
        evA, VA = _safe_eigh(Atm)
        emax = evA.abs().amax(dim=-1, keepdim=True)
        evA_cl = torch.maximum(evA, 1e-13 * emax + 1e-300)
        rhs_m = torch.cat([ym[..., None], Cmt], dim=-1)
        Wm = VA @ ((_t(VA) @ rhs_m) / evA_cl[..., None])
        Wy, WC = Wm[:, :, 0], Wm[:, :, 1:]
        return dict(
            q1=torch.sum(Xn * Zx, dim=-1) + torch.sum(ym * Wy, dim=-1),
            ld_nn=ld_nn, ld_tm=torch.sum(torch.log(evA_cl), dim=-1),
            Xs=r["Xg"] - torch.sum(Cng * Zx[..., None], dim=1)
            - torch.sum(Cmt * Wy[..., None], dim=1),
            Ss=r["Dgg"] - _bmm64(Cng, ZC) - _bmm64(Cmt, WC),
            ev_ratio=evA[:, 0] / emax[:, 0])

    def _pairs12(G, X, invphi_N, psr, corner_c, with_health=False):
        """Stages 1 and 2 of a flat batch of (walker, pulsar) pairs:
        ``G`` (B, nb_tot, nb_tot), ``X`` (B, nb_tot), ``invphi_N`` (B,
        NW), ``psr`` (B,) each pair's pulsar. One mixed-precision solve of
        the noise blocks over the batch (one kernel launch on the card),
        then stage 2; a pair whose timing-model complement came out with
        ``ev_ratio`` below ``corner_c`` (or not finite) has its stage-1
        solve done again in float64 (:func:`_solve_f64`) and its stage 2
        from that. Every other pair keeps its values bit for bit.
        ``with_health=True`` pins the classic chain for the stage-1 solve
        and adds each pair's health word ``hw`` (B, 3) of that solve."""
        tm_pad = tm_pad_t[psr]
        r = _split(G, X, invphi_N, tm_pad)
        out = _mixed_psd_solve_logdet(r["Gnn"], r["RHS"], jitter, refine=3,
                                      delta_mode=stage1_delta,
                                      mega=False if with_health else mega,
                                      with_health=with_health)
        Z, ld_nn = out[:2]
        st = _stage2(r, Z, ld_nn)
        if corner_c is not None and gram_mode != "f64":
            flag = ~(st["ev_ratio"] >= corner_c)
            if bool(flag.any()):
                idx = flag.nonzero()[:, 0]
                ri = {k: v[idx] for k, v in r.items()}
                fix = _stage2(ri, *_solve_f64(ri["Gnn"], ri["RHS"],
                                              jitter))
                st = {k: v.index_put((idx,), fix[k]) for k, v in st.items()}
        if with_health:
            st["hw"] = out[2]
        return st

    def _stage12(G, X, invphi_N, corner_c=CORNER_C, with_health=False,
                 lo=0):
        """Stages 1 and 2 for every (walker, pulsar) pair at once, as one
        flat batch of W·P systems (:func:`_pairs12`; the P pulsars from
        ``lo`` on, as :func:`_common` gave them), and each pulsar's
        contribution to the GW Schur system: ``q1``, ``ld_nn``, ``ld_tm``,
        ``ev_ratio`` (W, P), ``Xs`` (W, P, n_g), ``Ss`` (W, P, n_g, n_g).
        ``corner_c`` is the float64 redo's threshold (``CORNER_C``);
        ``None`` is the reference's clamp alone; the float64 Gram mode
        never redoes a pair."""
        W, P = G.shape[:2]
        B = W * P
        st = _pairs12(G.reshape(B, nb_tot, nb_tot), X.reshape(B, nb_tot),
                      invphi_N.reshape(B, NW),
                      torch.arange(lo, lo + P, device=G.device).repeat(W),
                      corner_c, with_health)
        return {k: v.reshape(W, P, *v.shape[1:]) for k, v in st.items()}

    def _stage3(theta, st, rwr_p, logdet_n, logphi):
        """The GW Schur system with the ORF coupling, and the scalar sums."""
        quad_base = torch.sum(rwr_p, dim=-1) - torch.sum(st["q1"], dim=-1)
        lds = (logdet_n + logphi + torch.sum(st["ld_nn"], dim=-1)
               + torch.sum(st["ld_tm"], dim=-1) + tm_const)
        if n_g == 0:
            return -0.5 * (quad_base + lds)
        W = theta.shape[0]
        n_s = npsr * n_g
        Binvs, logdet_b = _coupling_blocks(theta)
        S = _scatter_blocks(_block_diag(st["Ss"]), Binvs, schur_idx)
        # the Schur blocks come from float32 stage-1 solves and are
        # symmetric only to that accuracy; a factor reads one triangle,
        # so both triangles are made the same system
        S = 0.5 * (S + _t(S))
        Xs = st["Xs"].reshape(W, n_s)
        if low_rank:
            # monopole/dipole coupling inverses span ~1/jitter = 1e6 in
            # scale, beyond the float32 preconditioner: factor in float64
            L, sS, ld_S = equilibrated_cholesky(S, CHOL_JITTER[gram_mode])
            u = torch.linalg.solve_triangular(L, (sS * Xs)[..., None],
                                              upper=False)[..., 0]
            xsx = torch.sum(u * u, dim=-1)
        else:
            Zs, ld_S = _mixed_psd_solve_logdet(S, Xs[..., None], jitter,
                                               refine=3, delta_mode="split",
                                               mega=mega)
            xsx = torch.sum(Xs * Zs[..., 0], dim=-1)
        return -0.5 * (quad_base - xsx + lds + logdet_b + ld_S)

    def loglike_schur(theta):
        G, X, rwr_p, logdet_n, logphi, invphi_N = _common(theta)
        return _stage3(theta, _stage12(G, X, invphi_N), rwr_p, logdet_n,
                       logphi)

    def loglike_health(theta):
        """The Schur path's lnL (W,) and the per-pulsar stage-1 health
        words (W, npsr, 3), the ladder's per-pulsar attribution (stage 3
        has no single owner and is not instrumented)."""
        G, X, rwr_p, logdet_n, logphi, invphi_N = _common(theta)
        st = _stage12(G, X, invphi_N, with_health=True)
        hw = st.pop("hw")
        return _nan_to_neginf(_stage3(theta, st, rwr_p, logdet_n,
                                      logphi)), hw

    # ---- the update_mask contract (samplers/evalproto.py): one
    # parameter vector (ndim,), the cache a dict of (1, ...) tensors -----
    def _cache_lnl(th, cache):
        return _nan_to_neginf(_stage3(th, cache, cache["rwr"], cache["ldn"],
                                      cache["lphi"])[0])

    def _cache_init(theta):
        """Full recompute: ``(lnl, cache)``; the cache holds every
        per-pulsar stage-1/2 result that stage 3 reads."""
        th = theta[None]
        G, X, rwr_p, logdet_n, logphi, invphi_N = _common(th)
        cache = dict(_stage12(G, X, invphi_N), rwr=rwr_p, ldn=logdet_n,
                     lphi=logphi)
        return _cache_lnl(th, cache), cache

    def _cache_site(theta, a, cache):
        """Only pulsar ``a``'s parameters changed: re-Gram and re-solve
        that pulsar alone (one system through stages 1-2), recompute the
        scalar sums in full, as the reference does, and rerun stage 3.
        Returns a new cache; ``cache`` is left as it was."""
        th = theta[None]
        nw = eval_white(th, sigma2_t)
        phi_N = eval_phi(th) * cs2_N_t
        sqw = torch.sqrt(mask_t[a] / nw[:, a])          # (1, ntoa_max)
        Ts = T_t[a] * sqw[..., None]
        rs = R_t[a] * sqw
        G_a = _gram_pair(Ts, Ts, "f64")
        X_a = torch.einsum("wik,wi->wk", Ts, rs)
        st_a = _pairs12(G_a, X_a, 1.0 / phi_N[:, a],
                        torch.full((1,), a, device=device), CORNER_C)
        idx = (torch.zeros(1, dtype=torch.long, device=device),
               torch.full((1,), a, device=device))
        new = {k: cache[k].index_put(idx, v) for k, v in st_a.items()}
        new["rwr"] = cache["rwr"].index_put(idx, torch.sum(rs * rs, dim=-1))
        new["ldn"] = torch.sum(torch.log(nw) * mask_t, dim=(1, 2))
        new["lphi"] = torch.sum(torch.log(phi_N), dim=(1, 2))
        return _cache_lnl(th, new), new

    def _cache_common(theta, cache):
        """Only coupling-only GW parameters changed: every per-pulsar
        result is reused and stage 3 reruns."""
        return _cache_lnl(theta[None], cache), cache

    def loglike_dense(theta):
        G, X, rwr_p, logdet_n, logphi, invphi_N = _common(theta)
        W = theta.shape[0]
        # region M gets the big-phi stand-in (1 on padded slots), region
        # G none (its prior lives in the coupling blocks)
        invphi_M = (1.0 - tm_pad_t) / _TM_PHI + tm_pad_t
        invphi = torch.cat([invphi_N, invphi_M.expand(W, -1, -1),
                            torch.zeros((W, npsr, n_g), dtype=F64,
                                        device=device)], dim=-1)
        n_tot = npsr * nb_tot
        Binvs, logdet_b = _coupling_blocks(theta)
        Sigma = _scatter_blocks(
            _block_diag(G + torch.diag_embed(invphi)), Binvs, dense_idx)
        L, sS, logdet_sigma = equilibrated_cholesky(Sigma,
                                                    CHOL_JITTER[gram_mode])
        u = torch.linalg.solve_triangular(
            L, (sS * X.reshape(W, n_tot))[..., None], upper=False)[..., 0]
        quad = torch.sum(rwr_p, dim=-1) - torch.sum(u * u, dim=-1)
        return -0.5 * (quad + logdet_n + logphi + tm_const + logdet_b
                       + logdet_sigma)

    # ---- the pulsar axis across processes (module docstring) -----------
    use_spmd = mesh is not None and joint_mode == "schur" and not dyn_blocks
    if mesh is not None and not use_spmd:
        print("note: psr_shard keeps the unsharded joint likelihood here ("
              + ("a sampled chromatic index makes the basis "
                 "walker-dependent" if dyn_blocks else
                 f"joint_mode '{joint_mode}' has no sharded path") + ")")
    if use_spmd:
        ranges = mesh.ranges(npsr)
        nshard = len(ranges)
        group = mesh.group
        n_ss, n_xs = npsr * n_g * n_g, npsr * n_g

        def _shard_packed(theta, s, with_health=False, with_attr=False):
            """Stages 1-2 of shard ``s`` at ``theta`` (W, ndim): the front
            end and the (walker, pulsar) pairs of its pulsars only
            (:func:`_common` and :func:`_stage12` on its range), packed
            into one vector (W, L) with every cross-pulsar quantity at its
            global offset. The sum of every shard's vector is what stage
            3 reads (:func:`_unpack`)."""
            lo, hi = ranges[s]
            G, X, rwr_p, logdet_n, logphi, invphi_N = _common(theta, lo=lo,
                                                              hi=hi)
            st = _stage12(G, X, invphi_N, with_health=with_health, lo=lo)
            W, P = rwr_p.shape
            parts = []
            if n_g:
                parts.append(scatter_to_global(
                    st["Ss"].reshape(W, P, n_g * n_g), npsr, lo,
                    dim=1).reshape(W, -1))
                parts.append(scatter_to_global(st["Xs"], npsr, lo,
                                               dim=1).reshape(W, -1))
            if with_health:
                parts.append(scatter_to_global(st["hw"].to(F64), npsr, lo,
                                               dim=1).reshape(W, -1))
            if with_attr:
                ones = torch.ones(W, dtype=F64, device=device)
                if with_health:
                    jit = torch.sum(st["hw"][..., 0] > 0.5, dim=1).to(F64)
                    div = torch.sum(st["hw"][..., 1] > 0.5, dim=1).to(F64)
                else:
                    jit = div = 0.0 * ones
                row = torch.stack([ones, ones * mask_t[lo:hi].sum(), jit,
                                   div], dim=-1)[:, None, :]
                parts.append(scatter_to_global(row, nshard, s,
                                               dim=1).reshape(W, -1))
            parts.append(torch.stack([
                st["q1"].sum(dim=1), st["ld_nn"].sum(dim=1),
                st["ld_tm"].sum(dim=1), rwr_p.sum(dim=1), logdet_n,
                logphi], dim=-1))
            return torch.cat(parts, dim=-1)

        def _packed_len(with_health, with_attr):
            return (n_ss + n_xs) + (npsr * HW_WIDTH if with_health else 0) \
                + (nshard * MESH_ATTR_WIDTH if with_attr else 0) + 6

        def _unpack(packed, with_health, with_attr=False):
            """The summed vector (W, L) -> stage 3's inputs, the health
            words (W, npsr, 3) and the attribution table (W, nshard,
            4)."""
            W = packed.shape[0]
            off, st, hw, attr = 0, {}, None, None
            if n_g:
                st["Ss"] = packed[:, :n_ss].reshape(W, npsr, n_g, n_g)
                st["Xs"] = packed[:, n_ss:n_ss + n_xs].reshape(W, npsr, n_g)
                off = n_ss + n_xs
            if with_health:
                hw = packed[:, off:off + npsr * HW_WIDTH].reshape(
                    W, npsr, HW_WIDTH)
                off += npsr * HW_WIDTH
            if with_attr:
                attr = packed[:, off:off + nshard * MESH_ATTR_WIDTH] \
                    .reshape(W, nshard, MESH_ATTR_WIDTH)
                off += nshard * MESH_ATTR_WIDTH
            sc = packed[:, off:off + 6]
            # the scalar slots arrive summed: stage 3's sums over the
            # pulsar axis see one column
            st.update(q1=sc[:, 0:1], ld_nn=sc[:, 1:2], ld_tm=sc[:, 2:3])
            return st, sc[:, 3:4], sc[:, 4], sc[:, 5], hw, attr

        def _spmd(theta, with_health=False, with_attr=False):
            """One sharded evaluation: this rank's shard body and THE
            collective, then stage 3 replicated."""
            theta_f = grad_all_reduce(theta, group)
            if mesh.rank < nshard:
                local = _shard_packed(theta_f, mesh.rank, with_health,
                                      with_attr)
            else:
                # a rank past the last shard adds zeros (and still joins
                # the gradient's sum)
                local = torch.zeros(
                    (theta.shape[0], _packed_len(with_health, with_attr)),
                    dtype=F64, device=device) \
                    + 0.0 * theta_f.sum(dim=1, keepdim=True)
            packed = all_reduce_sum(local, group)
            st, rwr, ldn, lphi, hw, attr = _unpack(packed, with_health,
                                                   with_attr)
            return _nan_to_neginf(_stage3(theta, st, rwr, ldn, lphi)), \
                hw, attr

        def loglike_spmd(theta):
            return _spmd(theta)[0]

        def loglike_health_spmd(theta):
            """lnL and the (W, npsr, 3) health words, riding the same
            collective: every rank sees the same words and takes the same
            ladder decision."""
            lnl, hw, _ = _spmd(theta, with_health=True)
            return lnl, hw

        def loglike_mesh_spmd(theta, with_health=True):
            """lnL, the health words (None without ``with_health``, which
            pins the classic chain as the health twin does) and the (W,
            nshard, 4) attribution table, all on the one collective."""
            return _spmd(theta, with_health=with_health, with_attr=True)

    if use_spmd:
        inner = loglike_spmd
    else:
        inner = loglike_schur if joint_mode == "schur" else loglike_dense

    def evaluate(theta):
        return _nan_to_neginf(inner(theta))

    like = PTALikelihood(psrs, sampled, evaluate, gram_mode, device)
    like.joint_mode = joint_mode
    # the update_mask contract, under the reference's conditions (the
    # Schur path, no mesh, a static basis: a sampled chromatic index makes
    # the basis walker-dependent) unless EWT_UPDATE_MASK=0
    if joint_mode == "schur" and not dyn_blocks and not use_spmd \
            and os.environ.get("EWT_UPDATE_MASK", "1") != "0":
        install_masked_protocol(like, _cache_init, _cache_site,
                                _cache_common, param_blocks)
    if joint_mode == "schur":
        # the health plane's twin and its pulsar-axis attribution
        health = loglike_health_spmd if use_spmd else loglike_health
        like._eval_health_batch = lambda theta: health(like.as_theta(theta))
        like.health_psr_names = [p.name for p in psrs]
    like._stages = dict(common=_common, stage12=_stage12, stage3=_stage3,
                        NW=NW, MW=MW, n_g=n_g, npsr=npsr, nb_tot=nb_tot,
                        spmd=use_spmd, nshard=nshard if use_spmd else 1)
    like.mesh = mesh if use_spmd else None
    if use_spmd:
        like._eval_mesh_batch = lambda theta, with_health=True: \
            loglike_mesh_spmd(like.as_theta(theta), with_health)
        like._stages.update(shard_packed=_shard_packed, unpack=_unpack,
                            ranges=ranges)
        # the mesh plane's static cost model (the reference's layout):
        # stage-1/2 FLOPs per shard (Gram 2·ntoa·nb^2 + factor nb^3 per
        # pulsar), stage 3's (npsr·n_g)^3 and the collective's payload
        shard_psrs = [hi - lo for lo, hi in ranges]
        shard_toas = [int(toamask[lo:hi].sum()) for lo, hi in ranges]
        like.mesh_layout = dict(
            nshard=nshard, npsr_loc=max(shard_psrs),
            attr_width=MESH_ATTR_WIDTH, shard_psrs=shard_psrs,
            shard_toas=shard_toas, shard_process=list(range(nshard)),
            flops_stage12_per_shard=[
                2.0 * t * nb_tot ** 2 + p * float(nb_tot) ** 3
                for t, p in zip(shard_toas, shard_psrs)],
            flops_stage3=float(npsr * n_g) ** 3,
            psum_payload_bytes=int(_packed_len(True, True) * 8),
            cost_basis="static_cost_model")
    return like
