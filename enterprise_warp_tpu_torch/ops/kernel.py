"""The marginalized Gaussian-process likelihood, batched over walkers.

Counterpart of ``enterprise_warp_tpu/ops/kernel.py``. It evaluates, for
every walker at once,

    lnL = -1/2 [ r^T C_n^-1 r - y^T A^-1 y ]
          -1/2 [ ln|N| + ln|B| + ln|Sigma| + ln|A| ]  + const
    Sigma = B^-1 + T^T N^-1 T,   A = M^T C_n^-1 M,   y = M^T C_n^-1 r

with the timing model ``M`` marginalized analytically. The reference's
``vmap`` over walkers is an explicit leading walker axis here: ``nw`` is
``(W, ntoa)``, ``b`` is ``(W, nbasis)`` and the result is ``(W,)``; the
whitened static arrays ``r_w``/``M_w``/``T_w`` are shared.

Precision follows the reference exactly:

- ``gram_mode='split'``: the O(ntoa nbasis^2) noise-basis Gram runs in
  float32 on hi/lo double-float splits with chunked float64
  accumulation; every product touching ``M`` or ``r`` stays float64;
- the Sigma solve is mixed precision (:func:`_mixed_psd_solve_logdet`):
  a jittered float32 Cholesky preconditioner (by default the fused
  ``ops/cholfuse.py:chol_precond``), float64-residual iterative
  refinement, and a trace-expansion logdet correction;
- ``gram_mode='f64'`` runs everything in float64 (the oracle path).

Route decision (:func:`marginalized_loglike`): on CUDA tensors the
whole evaluation goes through the likelihood megakernel when its size
caps allow, else the classic chain below runs and its Sigma solve goes
through the solve megakernel (``ops/megakernel.py``). CPU tensors always
take the classic chain — the reference's non-TPU behaviour. Gradients of
either megakernel route re-derive through the classic chain, whose fused
preconditioner is the third kernel (``ops/cholfuse.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_CHUNK = 256  # TOA-axis chunk length for f64 accumulation of f32 partials

# Preconditioner jitter per gram mode, applied to the unit-diagonal
# equilibrated float32 cast in ``_mixed_psd_solve_logdet``; it must
# dominate the Gram noise of the mode so the float32 factorization of a
# near-singular cast succeeds (the refined solves and the trace
# correction then target the computed Sigma, so well-conditioned
# evaluations carry no jitter bias).
CHOL_JITTER = {"split": 3.0e-6, "f32": 1.0e-5, "f64": 0.0}

# the health word (resilience/integrity.py): a float64 (..., 3) side
# output of the classic chain. [HW_JITTER] a jittered retry or the
# identity factor was substituted; [HW_DIVERGE] refinement diverged and
# the preconditioner solution was kept; [HW_LOGCOND] log10 of the
# equilibration diagonal's dynamic range, a condition proxy.
HW_JITTER, HW_DIVERGE, HW_LOGCOND = 0, 1, 2
HW_WIDTH = 3


def _health_word(jitter_bit, diverge_bit, d):
    """Pack ``(..., 3)`` health words from the two event bits (boolean or
    float tensors of the batch shape) and the equilibration diagonal ``d``
    (``(..., n)``)."""
    logcond = torch.log10(d.amax(dim=-1)
                          / torch.clamp(d.amin(dim=-1), min=1e-300))
    return torch.stack([jitter_bit.to(d.dtype), diverge_bit.to(d.dtype),
                        logcond], dim=-1)


def whiten_inputs(residuals, toaerrs, M, T):
    """Host-side whitening/normalization (float64 numpy).

    Returns ``(r_w, M_w, T_w, col_scale2, logdet_sigma2)``: rows divided
    by the TOA uncertainty, noise-basis columns normalized to unit RMS
    with their squared norms returned (folded into the prior variances),
    and ``logdet_sigma2 = 2 sum ln sigma``. Timing-model columns are
    normalized for conditioning only (flat-prior invariance)."""
    sigma = np.asarray(toaerrs, dtype=np.float64)
    r_w = np.asarray(residuals, dtype=np.float64) / sigma
    M_w = np.asarray(M, dtype=np.float64) / sigma[:, None]
    M_w = M_w / np.linalg.norm(M_w, axis=0)
    T_w = np.asarray(T, dtype=np.float64) / sigma[:, None]
    norms = np.linalg.norm(T_w, axis=0)
    norms = np.where(norms > 0, norms, 1.0)
    T_w = T_w / norms
    col_scale2 = norms ** 2
    logdet_sigma2 = 2.0 * np.sum(np.log(sigma))
    return r_w, M_w, T_w, col_scale2, logdet_sigma2


# --------------------------------------------------------------------
# small batched helpers
# --------------------------------------------------------------------

def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _diag(A):
    return torch.diagonal(A, dim1=-2, dim2=-1)


def _t(A):
    return A.transpose(-1, -2)


def cholesky_nan(A):
    """Lower Cholesky factor with JAX's failure semantics: a batch
    element whose factorization fails comes back all-NaN (where
    ``torch.linalg.cholesky`` would raise). No host synchronisation."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, math.nan), L)


def _all_finite(A):
    return torch.isfinite(A).all(dim=-1).all(dim=-1)


def _split_hi_lo(x):
    """Double-float decomposition: x == hi + lo with both float32."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return hi, lo


def _pad_rows(x, n_pad):
    """Zero-pad the row (second-to-last) axis by ``n_pad``."""
    if n_pad == 0:
        return x
    return F.pad(x, (0, 0, 0, n_pad))


def _chunked_f32_gram(x, y):
    """x^T y of two float32 row-padded matrices (leading batch axes
    allowed), with per-chunk partials accumulated in float64."""
    nc = x.shape[-2] // _CHUNK
    xc = x.reshape(x.shape[:-2] + (nc, _CHUNK, x.shape[-1]))
    yc = y.reshape(y.shape[:-2] + (nc, _CHUNK, y.shape[-1]))
    parts = torch.einsum("...cik,...cil->...ckl", xc, yc)
    return parts.to(torch.float64).sum(dim=-3)


def _gram_pair(S, B, mode):
    """S^T B over the TOA axis: (..., ntoa, k) x (..., ntoa, l) ->
    (..., k, l). ``mode``: 'f64' direct; 'f32' single-pass float32;
    'split' hi/lo products with chunked float64 accumulation."""
    if mode == "f64":
        return torch.einsum("...ik,...il->...kl", S, B)
    if mode == "f32":
        out = torch.einsum("...ik,...il->...kl", S.to(torch.float32),
                           B.to(torch.float32))
        return out.to(S.dtype)
    S = _pad_rows(S, (-S.shape[-2]) % _CHUNK)
    B = _pad_rows(B, (-B.shape[-2]) % _CHUNK)
    Sh, Sl = _split_hi_lo(S)
    Bh, Bl = _split_hi_lo(B)
    return (_chunked_f32_gram(Sh, Bh) + _chunked_f32_gram(Sh, Bl)
            + _chunked_f32_gram(Sl, Bh))


# --------------------------------------------------------------------
# Gram stage
# --------------------------------------------------------------------

def build_pair_program(r_w, M_w, T_w, device="cuda"):
    """Static pair-product matrices for the Gram-as-matmul path.

    Every Gram entry is linear in the per-walker weights ``w = 1/nw``
    over the stacked columns ``[T_w | M_w | r_w]``, so the batched Gram
    stage is one ``(W, ntoa) @ (ntoa, m^2)`` product against the static
    ``Q[i, a*m+b] = S_ia S_ib``. The (T, T) block is hi/lo split and
    chunked (split precision); the skinny M/r side stays float64. Only
    valid when nothing walker-dependent touches the basis or residuals.
    """
    T = np.asarray(T_w, np.float64)
    U = np.concatenate([np.asarray(M_w, np.float64),
                        np.asarray(r_w, np.float64)[:, None]], axis=1)
    ntoa, nb = T.shape
    nu = U.shape[1]
    Qtt = (T[:, :, None] * T[:, None, :]).reshape(ntoa, nb * nb)
    n_pad = (-ntoa) % _CHUNK
    if n_pad:
        Qtt = np.pad(Qtt, ((0, n_pad), (0, 0)))
    nc = Qtt.shape[0] // _CHUNK
    Qtt = Qtt.reshape(nc, _CHUNK, nb * nb)
    Qtt_h = Qtt.astype(np.float32)
    Qtt_l = (Qtt - Qtt_h.astype(np.float64)).astype(np.float32)
    Qtu = (T[:, :, None] * U[:, None, :]).reshape(ntoa, nb * nu)
    Quu = (U[:, :, None] * U[:, None, :]).reshape(ntoa, nu * nu)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return dict(Qtt_h=dev(Qtt_h), Qtt_l=dev(Qtt_l), Qtu=dev(Qtu),
                Quu=dev(Quu), nb=nb, ntm=nu - 1, nu=nu, ntoa=ntoa,
                n_pad=n_pad)


def pair_program_grams(w, prog):
    """All Gram blocks at weights ``w`` (float64, (W, ntoa)) through the
    pair program: ``(G, H, P, X, q, rwr)`` with the same precision classes
    as the per-walker split-mode Grams."""
    nc = prog["Qtt_h"].shape[0]
    nb, nu = prog["nb"], prog["nu"]
    ntm = nu - 1
    W = w.shape[0]
    wp = F.pad(w, (0, nc * _CHUNK - w.shape[-1]))
    wc = wp.reshape(W, nc, _CHUNK)
    wh = wc.to(torch.float32)
    wl = (wc - wh.to(w.dtype)).to(torch.float32)
    parts = (torch.einsum("wci,cik->wck", wh, prog["Qtt_h"])
             + torch.einsum("wci,cik->wck", wh, prog["Qtt_l"])
             + torch.einsum("wci,cik->wck", wl, prog["Qtt_h"]))
    G = parts.to(torch.float64).sum(dim=1).reshape(W, nb, nb)
    HX = (w @ prog["Qtu"]).reshape(W, nb, nu)
    Pq = (w @ prog["Quu"]).reshape(W, nu, nu)
    H, X = HX[..., :ntm], HX[..., ntm]
    P, q, rwr = Pq[:, :ntm, :ntm], Pq[:, :ntm, ntm], Pq[:, ntm, ntm]
    return G, H, P, X, q, rwr


def gram_blocks(nw, r_w, M_w, T_w, mask=None, gram_mode="split",
                pair_program=None):
    """The Gram stage of :func:`marginalized_loglike` on its own:
    ``(G, H, P, X, q, rwr)`` for the weights ``w = mask / nw``
    (``nw`` is (W, ntoa)). Factored out so fixed-white-noise builds can
    constant-fold it at build time through this same code path.
    ``M_w=None`` is the sampled-timing-model likelihood: the caller has
    subtracted the timing-model delay from ``r_w`` (then (W, ntoa), one
    row per walker), and ``H``, ``P`` and ``q`` have no columns."""
    w = 1.0 / nw
    if mask is not None:
        w = w * mask
    ntm = 0 if M_w is None else M_w.shape[1]
    if pair_program is not None:
        return pair_program_grams(w, pair_program)
    sqw = torch.sqrt(w)
    Ts = T_w * sqw[..., None]
    Ms = None if M_w is None else M_w * sqw[..., None]
    rs = r_w * sqw
    G = _gram_pair(Ts, Ts, gram_mode)
    if gram_mode == "split":
        # the M/r side feeds A = P - H^T Sigma^-1 H, whose cancellation
        # amplifies Gram error by up to ~1e8: genuine float64
        U = rs[..., None] if Ms is None \
            else torch.cat([Ms, rs[..., None]], dim=-1)
        HX = torch.einsum("...ti,...tj->...ij", Ts, U)
        Pq = torch.einsum("...ti,...tj->...ij", U, U)
        H, X = HX[..., :ntm], HX[..., ntm]
        P, q, rwr = Pq[..., :ntm, :ntm], Pq[..., :ntm, ntm], \
            Pq[..., ntm, ntm]
    else:
        X = _gram_pair(Ts, rs[..., None], gram_mode)[..., 0]
        rwr = torch.sum(rs * rs, dim=-1)
        if Ms is None:
            H = Ts.new_zeros(Ts.shape[:-2] + (Ts.shape[-1], 0))
            P = Ts.new_zeros(Ts.shape[:-2] + (0, 0))
            q = Ts.new_zeros(Ts.shape[:-2] + (0,))
        else:
            H = _gram_pair(Ts, Ms, gram_mode)
            P = _gram_pair(Ms, Ms, gram_mode)
            q = _gram_pair(Ms, rs[..., None], gram_mode)[..., 0]
    return G, H, P, X, q, rwr


# --------------------------------------------------------------------
# factorizations and the mixed solve
# --------------------------------------------------------------------

def equilibrated_cholesky(S, jitter, with_health=False):
    """Cholesky of symmetric PD ``S`` (batched) via unit-diagonal
    equilibration, with an on-failure jitter fallback. Returns
    ``(L, s, logdet)``: ``L`` factors ``D^-1/2 S D^-1/2``, ``s =
    D^-1/2`` and ``logdet = log|S|``. A failed factorization without
    jitter leaves NaN (the caller maps it to -inf). ``with_health=True``
    appends the health word, its jitter bit set where the jittered factor
    was substituted."""
    d = torch.clamp(_diag(S), min=1e-30)
    s = 1.0 / torch.sqrt(d)
    Sn = S * s[..., :, None] * s[..., None, :]
    L = cholesky_nan(Sn)
    engaged = torch.zeros(S.shape[:-2], dtype=torch.bool, device=S.device)
    if jitter:
        bad = ~_all_finite(L)
        Lj = cholesky_nan(Sn + jitter * _eye(S.shape[-1], S))
        L = torch.where(bad[..., None, None], Lj, L)
        engaged = bad
    logdet = 2.0 * torch.sum(torch.log(_diag(L)), dim=-1) \
        + torch.sum(torch.log(d), dim=-1)
    if with_health:
        return L, s, logdet, _health_word(engaged, torch.zeros_like(engaged),
                                          d)
    return L, s, logdet


def _mixed_psd_solve_logdet(S, B, jitter, jitter2=None, refine=2,
                            delta_mode="tree", mega=None, with_health=False):
    """Solve ``S Z = B`` and compute ``log|S|`` for a batch of symmetric
    PD float64 matrices ``S`` (W, n, n) in mixed precision.

    - equilibrate to unit diagonal (float64), dropping numerically null
      rows (non-positive diagonal: decoupled, charged the largest scale
      in the matrix in the logdet, so such corners never attract);
    - ``mega`` (None = auto: CUDA tensors with ``delta_mode='split'``
      whose order fits the cap): the whole post-equilibration chain
      runs in the solve megakernel (``ops/megakernel.py``, float32
      class);
    - otherwise the classic chain: a three-tier jittered float32
      Cholesky preconditioner (``jitter``, then ``jitter2`` for walkers
      whose factor went non-finite, then the identity), ``refine``
      refinement passes (the last two with float64 residuals), a guard
      that keeps the plain preconditioner solution where refinement
      diverged, and a 4-term trace-expansion logdet correction applied
      only inside its convergence region;
    - with ``delta_mode='split'`` (and ``EWT_FUSED_CHOL`` not ``0``) the
      classic chain takes its preconditioner trio ``(U, V = U^-1, E)``
      from ``ops/cholfuse.py:chol_precond`` (one CUDA launch on the
      card) instead of factoring, inverting and forming ``E`` step by
      step; same tiers, same precision class.

    ``with_health=True`` appends the health word ``(W, 3)`` and returns
    ``(Z, logdet, hw)``. It pins the classic chain (the solve megakernel
    carries no word; asking for both raises), and leaves ``Z`` and the
    logdet of that chain unchanged. The jitter bit follows the
    reference: on the unfused branch, tier 2 or the identity factor was
    substituted; on the fused branch, the kernel's own per-walker tier is
    2 or 3 (CUDA), or tier 1's factor of the cast fails or ``U`` is the
    identity (the plain version's rule).

    Returns ``(Z, logdet)`` with ``Z`` (W, n, k) float64.
    """
    f64 = S.dtype
    n = S.shape[-1]
    if with_health:
        if mega:
            raise ValueError("with_health=True cannot ride the mega route "
                             "(the solve kernel carries no health word); "
                             "pass mega=False or None")
        if mega is None and delta_mode == "split":
            # the route is still decided, so a decline (the CPU's plain
            # version, an opt-out, over-cap) is counted in ROUTES; the
            # health word pins the classic chain either way
            from .megakernel import mega_solve_route
            mega_solve_route(n, S.device)
        mega = False
    if jitter2 is None:
        jitter2 = 30.0 * jitter
    diag = _diag(S)
    null = diag <= 0.0
    dmax = torch.clamp(torch.maximum(diag.amax(dim=-1),
                                     S.abs().amax(dim=(-2, -1))), min=1.0)
    d = torch.where(null, dmax[..., None], torch.clamp(diag, min=1e-30))
    s = torch.where(null, torch.zeros_like(d), 1.0 / torch.sqrt(d))
    Sn = S * s[..., :, None] * s[..., None, :]
    Sn = torch.diagonal_scatter(
        Sn, torch.where(null, torch.ones_like(d), _diag(Sn)),
        dim1=-2, dim2=-1)
    if mega is None and delta_mode == "split":
        from .megakernel import mega_solve_route
        mega = mega_solve_route(n, S.device)
    if mega:
        from .megakernel import mega_solve_logdet
        Bn32 = (s[..., None] * B).to(torch.float32)
        Z32, ld_eq = mega_solve_logdet(Sn.to(torch.float32), Bn32,
                                       float(jitter), float(jitter2),
                                       refine)
        logdet = ld_eq.to(f64) + torch.sum(torch.log(d), dim=-1)
        return s[..., None] * Z32.to(f64), logdet
    from .cholfuse import fused_chol_enabled
    fused = delta_mode == "split" and fused_chol_enabled()

    Sn32 = Sn.to(torch.float32)
    eye = _eye(n, Sn32)
    if fused:
        from .cholfuse import chol_precond, chol_precond_health
        if with_health:
            U, Vu, E32f, engaged = chol_precond_health(Sn32, jitter,
                                                       jitter2)
        else:
            U, Vu, E32f = chol_precond(Sn32, jitter, jitter2)
        diagL = _diag(U)

        def psolve(R):
            x = _t(Vu) @ R.to(torch.float32)
            return (Vu @ x).to(f64)
    else:
        L = cholesky_nan(Sn32 + float(jitter) * eye)
        bad = ~_all_finite(L)
        L = torch.where(bad[..., None, None],
                        cholesky_nan(Sn32 + float(jitter2) * eye), L)
        # health: tier 2 or the identity substituted (tier 1's jitter is
        # the designed preconditioner and does not count)
        engaged = bad | ~_all_finite(L)
        # last-resort identity preconditioner: never NaN
        L = torch.where(_all_finite(L)[..., None, None], L, eye)
        Linv = torch.linalg.solve_triangular(L, eye.expand_as(L),
                                             upper=False)
        diagL = _diag(L)

        def psolve(R):
            x = Linv @ R.to(torch.float32)
            return (_t(Linv) @ x).to(f64)

    def mm_split(A, C):
        return _gram_pair(_t(A), C, "split")

    Bn = s[..., None] * B
    Z0 = psolve(Bn)
    Z = Z0
    r0 = None
    for i in range(refine):
        exact = i >= refine - 2
        r = Bn - (Sn @ Z if exact else mm_split(Sn, Z))
        if i == 0:
            r0 = r
        Z = Z + psolve(r)
    res_ref = torch.sum(torch.square(Bn - Sn @ Z), dim=(-2, -1))
    res_pre = torch.sum(torch.square(r0 if r0 is not None
                                     else Bn - Sn @ Z0), dim=(-2, -1))
    # NaN-propagating comparison: a NaN refined residual falls back too
    diverged = ~(res_ref <= res_pre)
    Z = torch.where(diverged[..., None, None], Z0, Z)

    if fused:
        E = E32f.to(f64)
    else:
        if delta_mode == "split":
            Lp = _pad_rows(_t(L), (-n) % _CHUNK)
            LLt = _chunked_f32_gram(Lp, Lp)
        else:
            Lf = L.to(f64)
            LLt = Lf @ _t(Lf)
        Delta = (Sn - LLt).to(torch.float32)
        K = Linv @ Delta
        E = (Linv @ _t(K)).to(f64)
    E32 = E.to(torch.float32)
    E2 = E32 @ E32
    corr = (_diag(E).sum(dim=-1) - torch.sum(E * _t(E), dim=(-2, -1)) / 2.0
            + torch.sum(E2 * _t(E32), dim=(-2, -1)).to(f64) / 3.0
            - torch.sum(E2 * _t(E2), dim=(-2, -1)).to(f64) / 4.0)
    corr = torch.where(torch.sum(E * E, dim=(-2, -1)) < 0.09, corr,
                       torch.zeros_like(corr))
    logdet = (2.0 * torch.sum(torch.log(diagL.to(f64)), dim=-1)
              + corr + torch.sum(torch.log(d), dim=-1))
    if with_health:
        return s[..., None] * Z, logdet, _health_word(engaged, diverged, d)
    return s[..., None] * Z, logdet


# --------------------------------------------------------------------
# the likelihood
# --------------------------------------------------------------------

def marginalized_loglike(nw, b, r_w, M_w, T_w, mask=None, gram_mode="split",
                         pair_program=None, refine=3, grams=None,
                         mega=None, with_health=False):
    """Marginalized GP log-likelihood for one pulsar at W parameter points.

    Parameters
    ----------
    nw : (W, ntoa) whitened white-noise variance per TOA.
    b : (W, nbasis) prior variance per (scale-folded) basis column.
    r_w, M_w, T_w : whitened residuals / TM matrix / noise basis
        (static, float64). ``r_w`` may also be (W, ntoa), one row per
        walker (sampled deterministic delays subtracted). ``M_w=None``
        is the sampled-timing-model likelihood: no timing-model Schur
        stage, ``quad = rwr - X^T Sigma^-1 X``, and the likelihood
        megakernel declines (the Sigma solve still makes its own
        solve-kernel decision).
    mask : optional (ntoa,) 0/1 padding mask.
    gram_mode : 'split', 'f32' or 'f64'.
    grams : optional precomputed ``(G, H, P, X, q, rwr)`` (unbatched) from
        :func:`gram_blocks` — the constant-folded Gram stage of
        fixed-white-noise builds.
    mega : ``None`` (auto): on CUDA tensors, a reduced-precision
        ``gram_mode`` with a live Gram stage routes the whole eval through
        the likelihood megakernel when it fits its caps; otherwise the
        classic chain runs (and its Sigma solve makes its own solve-kernel
        decision). ``False`` pins the classic chain end to end. ``True``
        forces the megakernel tolerance class (on CPU tensors through
        the kernel's plain torch version).

    with_health : return ``(lnL, hw)`` with ``hw`` (W, 3) the health word
        joined over the Sigma solve and the timing-model Schur factor. It
        pins the classic chain end to end (an explicit ``mega=True``
        raises).

    Returns lnL (W,) up to a theta-independent constant.
    """
    f64 = r_w.dtype
    solve_mega = False if mega is False else None
    if with_health:
        if mega:
            raise ValueError("with_health=True pins the classic chain; an "
                             "explicit mega route cannot carry the health "
                             "word")
        mega = False
    if mega is None:
        if gram_mode in ("split", "f32") and grams is None \
                and M_w is not None:
            from .megakernel import mega_like_route
            mega = mega_like_route(T_w.shape[0], T_w.shape[1], T_w.device)
        else:
            mega = False
    if mega:
        if M_w is None or grams is not None:
            raise ValueError("the mega route requires the marginalized-TM "
                             "path with a live Gram stage (M_w present, "
                             "grams=None)")
        from .megakernel import mega_marginalized_loglike
        mask_arr = torch.ones_like(nw) if mask is None \
            else mask.expand_as(nw)
        return mega_marginalized_loglike(nw, b, r_w, M_w, T_w, mask_arr,
                                         refine)
    W = nw.shape[0]
    if grams is not None:
        G, H, P, X, q, rwr = (g.expand((W,) + tuple(g.shape))
                              for g in grams)
    else:
        G, H, P, X, q, rwr = gram_blocks(nw, r_w, M_w, T_w, mask=mask,
                                         gram_mode=gram_mode,
                                         pair_program=pair_program)
    b = b.to(f64)
    Sigma = G.to(f64) + torch.diag_embed(1.0 / b)

    def chol(A, jit):
        """Equilibrated factor, its health word joined into ``hw``."""
        nonlocal hw
        if not with_health:
            return equilibrated_cholesky(A, jit)
        L, sA, ld, hw_a = equilibrated_cholesky(A, jit, with_health=True)
        hw = hw_a if hw is None else torch.maximum(hw, hw_a)
        return L, sA, ld

    def solve(A, R):
        """Mixed solve, its health word joined into ``hw``."""
        nonlocal hw
        out = _mixed_psd_solve_logdet(A, R, CHOL_JITTER[gram_mode],
                                      refine=refine, delta_mode="split",
                                      mega=solve_mega,
                                      with_health=with_health)
        if with_health:
            hw = out[2] if hw is None else torch.maximum(hw, out[2])
        return out[0], out[1]

    hw = None
    logdet_a = 0.0
    if M_w is None:
        # no-TM path: C_n-only quadratic form and determinant
        if gram_mode == "f64":
            L, sS, logdet_sigma = chol(Sigma, 0.0)
            u = torch.linalg.solve_triangular(L, (sS * X)[..., None],
                                              upper=False)[..., 0]
            quad = rwr - torch.sum(u * u, dim=-1)
        else:
            zx, logdet_sigma = solve(Sigma, X[..., None])
            quad = rwr - torch.sum(X * zx[..., 0], dim=-1)
    elif gram_mode == "f64":
        L, sS, logdet_sigma = chol(Sigma, 0.0)
        u = torch.linalg.solve_triangular(L, (sS * X)[..., None],
                                          upper=False)[..., 0]
        V = torch.linalg.solve_triangular(L, sS[..., None] * H,
                                          upper=False)
        A = P - _t(V) @ V
        y = q - (_t(V) @ u[..., None])[..., 0]
        LA, sA, logdet_a = chol(A, 0.0)
        z = torch.linalg.solve_triangular(LA, (sA * y)[..., None],
                                          upper=False)[..., 0]
        quad = rwr - torch.sum(u * u, dim=-1) - torch.sum(z * z, dim=-1)
    else:
        ZXH, logdet_sigma = solve(Sigma, torch.cat([X[..., None], H],
                                                   dim=-1))
        zx, ZH = ZXH[..., 0], ZXH[..., 1:]
        A = P - _t(H) @ ZH
        y = q - (_t(ZH) @ X[..., None])[..., 0]
        # split mode's float64 sides leave A accurate (no jitter); f32
        # mode's Gram noise can make A indefinite, so it keeps a retry
        jitter_a = CHOL_JITTER["f32"] if gram_mode == "f32" else 0.0
        LA, sA, logdet_a = chol(A, jitter_a)
        z = torch.linalg.solve_triangular(LA, (sA * y)[..., None],
                                          upper=False)[..., 0]
        quad = rwr - torch.sum(X * zx, dim=-1) - torch.sum(z * z, dim=-1)

    logn = torch.log(nw) if mask is None else torch.log(nw) * mask
    logdet_n = torch.sum(logn, dim=-1)
    logdet_b = torch.sum(torch.log(b), dim=-1)
    lnl = -0.5 * (quad + logdet_n + logdet_b + logdet_sigma + logdet_a)
    return (lnl, hw) if with_health else lnl
