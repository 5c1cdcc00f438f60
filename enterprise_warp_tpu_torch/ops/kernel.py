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

``blocked=True`` (``EWT_BLOCKED_CHOL=1`` at build time) declines all
three kernels under the route ``blocked`` and factors the classic chain's
preconditioner through :func:`blocked_cholesky`. :func:`sigma_stage` is
the evaluation after the Gram stage, on Gram blocks summed elsewhere (the
TOA axis across processes, ``models/build.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_CHUNK = 256  # TOA-axis chunk length for f64 accumulation of f32 partials
#: rows of one float32 partial of the hi*hi product of the likelihood's
#: (T, T) Gram (:func:`gram_blocks`, :func:`pair_program_grams`) over more
#: than :data:`_SUB_ABOVE` TOAs; hi*hi is the only product of the three
#: whose rounding reaches float64. A BLAS float32 GEMM (MKL or OpenBLAS
#: on the CPU, cuBLAS on the card) sums its contraction in one sequential
#: pass, so a 256-row partial rounds like a 256-term running sum; XLA's
#: CPU dot, which the reference runs, does the same at some widths and
#: keeps several partial sums at others (nb 80 among them), landing
#: closer. The rounding reaches lnL in proportion to the TOA count.
#: Partials of 32 rows, summed in float64, put the port's G below the
#: reference's error on the CPU and round the same on the card (PERF.md,
#: the split class, with the figures at 1024 to 32768 TOAs).
_SUB = 32
#: TOA counts up to this keep the reference's :data:`_CHUNK`-row
#: partials: the split class holds there, and the port's partials are
#: then the reference's bit for bit wherever XLA's dot sums in one pass.
#: So do the mixed solve's refinement products and the joint front end's
#: split Gram, which reproduces the reference's.
_SUB_ABOVE = 1024


def _gram_rows(ntoa):
    """The hi*hi partial length of the likelihood's Gram for a pulsar of
    ``ntoa`` TOAs (its whole count, also for one shard of its rows)."""
    return _SUB if ntoa > _SUB_ABOVE else _CHUNK

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


# ewt: allow-precision — the whitening island: residuals and bases are
# divided by sigma and normalized on the host in float64 before the
# float32 kernel class sees them
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


#: row length multiple (elements) that puts every row of a fresh tensor on
#: the same alignment as the first (32 bytes for float32 and float64)
_ROW_ALIGN = 8


def _row_sum(x):
    """Sum over the last axis, each row's value independent of the other
    rows and of the row's place in the batch. CUDA's reduction kernel
    reads a long contiguous row in vectors from its first aligned element,
    so two rows whose start addresses differ in alignment are summed in
    different orders: a walker's lnL would then depend on where it sits in
    the batch (the serving layer's packing contract, ``serve/packer.py``).
    Every row is zero-padded to a multiple of :data:`_ROW_ALIGN` elements
    in a fresh tensor, which puts all rows on one alignment; the zeros add
    exactly."""
    pad = (-x.shape[-1]) % _ROW_ALIGN
    if pad or not x.is_contiguous() or x.data_ptr() % (
            _ROW_ALIGN * x.element_size()):
        x = torch.nn.functional.pad(x, (0, pad))
    return x.sum(dim=-1)


def _sym(A):
    """``(A + A^T) / 2``, the input ``jnp.linalg.cholesky`` and
    ``jnp.linalg.eigh`` factor (``symmetrize_input=True``); ``torch.linalg``
    reads the lower triangle alone. A symmetric ``A`` comes back bit for
    bit."""
    return (A + A.transpose(-1, -2)) / 2


def cholesky_nan(A):
    """Lower Cholesky factor with JAX's semantics: the symmetrized input
    (a Schur complement from an inexact solve, ``P - H^T Z``, is not
    exactly symmetric), and a batch element whose factorization fails
    comes back all-NaN (where ``torch.linalg.cholesky`` would raise). No
    host synchronisation."""
    L, info = torch.linalg.cholesky_ex(_sym(A))
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


# ewt: allow-precision — the Gram island: float32 chunk products summed
# in float64, so a long TOA axis adds no float32 rounding
def _chunked_f32_gram(x, y, rows=_CHUNK):
    """x^T y of two float32 row-padded matrices (leading batch axes
    allowed), with the float32 partials of ``rows`` rows each (a divisor
    of :data:`_CHUNK`) accumulated in float64."""
    nc = x.shape[-2] // rows
    xc = x.reshape(x.shape[:-2] + (nc, rows, x.shape[-1]))
    yc = y.reshape(y.shape[:-2] + (nc, rows, y.shape[-1]))
    parts = torch.einsum("...cik,...cil->...ckl", xc, yc)
    return parts.to(torch.float64).sum(dim=-3)


def _gram_pair(S, B, mode, rows=_CHUNK):
    """S^T B over the TOA axis: (..., ntoa, k) x (..., ntoa, l) ->
    (..., k, l). ``mode``: 'f64' direct; 'f32' single-pass float32;
    'split' hi/lo products with chunked float64 accumulation, the hi*hi
    product's float32 partials ``rows`` rows long (the reference's
    :data:`_CHUNK` by default; the likelihood's (T, T) Gram takes
    :func:`_gram_rows`)."""
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
    return (_chunked_f32_gram(Sh, Bh, rows) + _chunked_f32_gram(Sh, Bl)
            + _chunked_f32_gram(Sl, Bh))


# --------------------------------------------------------------------
# Gram stage
# --------------------------------------------------------------------

# ewt: allow-precision — the skinny M/r Grams and the hi/lo split of
# (T, T) are built from float64 host bases
# ewt: allow-host-sync — the pair program's static products go to the device
# once, when the likelihood is built
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
                n_pad=n_pad, rows=_gram_rows(ntoa))


# ewt: allow-precision — the Gram island: split-precision products of
# (T, T) summed in float64, the skinny M/r side in float64
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
    # hi*hi in partials of the program's rows (_gram_rows); the two cross
    # products, 2^-24 of it, each converted before the sum (in float32
    # they would round into hi*hi's last bit)
    rows = prog["rows"]
    ns = nc * _CHUNK // rows
    hh = torch.einsum("wci,cik->wck", wh.reshape(W, ns, rows),
                      prog["Qtt_h"].reshape(ns, rows, -1))
    parts = (hh.to(torch.float64).sum(dim=1)
             + torch.einsum("wci,cik->wck", wh, prog["Qtt_l"]).to(
                 torch.float64).sum(dim=1)
             + torch.einsum("wci,cik->wck", wl, prog["Qtt_h"]).to(
                 torch.float64).sum(dim=1))
    G = parts.reshape(W, nb, nb)
    HX = (w @ prog["Qtu"]).reshape(W, nb, nu)
    Pq = (w @ prog["Quu"]).reshape(W, nu, nu)
    H, X = HX[..., :ntm], HX[..., ntm]
    P, q, rwr = Pq[:, :ntm, :ntm], Pq[:, :ntm, ntm], Pq[:, ntm, ntm]
    return G, H, P, X, q, rwr


def gram_blocks(nw, r_w, M_w, T_w, mask=None, gram_mode="split",
                pair_program=None, rows=None):
    """The Gram stage of :func:`marginalized_loglike` on its own:
    ``(G, H, P, X, q, rwr)`` for the weights ``w = mask / nw``
    (``nw`` is (W, ntoa)). Factored out so fixed-white-noise builds can
    constant-fold it at build time through this same code path.
    ``M_w=None`` is the sampled-timing-model likelihood: the caller has
    subtracted the timing-model delay from ``r_w`` (then (W, ntoa), one
    row per walker), and ``H``, ``P`` and ``q`` have no columns. ``rows``
    is the split (T, T) Gram's hi*hi partial length (default
    :func:`_gram_rows` of ``T_w``'s row count; a shard of a pulsar's rows
    passes its whole pulsar's)."""
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
    G = _gram_pair(Ts, Ts, gram_mode,
                   rows=_gram_rows(T_w.shape[-2]) if rows is None else rows)
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
        rwr = _row_sum(rs * rs)
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

def blocked_cholesky(S, block=16):
    """Left-looking blocked Cholesky factor of a batch of symmetric
    matrices ``S`` (..., n, n): ``n / block`` steps, each a panel update
    by batched products, a small factor of the diagonal block and one
    triangular solve for the rows below it. Rows padded up to a multiple
    of ``block`` get unit pivots and are cut off again. An indefinite
    diagonal block factors to NaN (:func:`cholesky_nan`), which every
    later panel inherits, so the caller's finiteness-gated jitter retry
    works unchanged. The reference's (XLA) factor, batched over the
    leading axes; built from new tensors, so it differentiates."""
    n = S.shape[-1]
    n_pad = (-n) % block
    m = n + n_pad
    if n_pad:
        S = F.pad(S, (0, n_pad, 0, n_pad))
        idx = torch.arange(n, m, device=S.device)
        S[..., idx, idx] = 1.0
    cols = []
    for k in range(0, m, block):
        Lk = torch.cat(cols, dim=-1) if cols \
            else S.new_zeros(S.shape[:-1] + (0,))
        panel = Lk[..., k:k + block, :]
        Lkk = cholesky_nan(S[..., k:k + block, k:k + block]
                           - panel @ _t(panel))
        parts = [S.new_zeros(S.shape[:-2] + (k, block)), Lkk]
        if k + block < m:
            Ark = S[..., k + block:, k:k + block] \
                - Lk[..., k + block:, :] @ _t(panel)
            parts.append(_t(torch.linalg.solve_triangular(
                Lkk, _t(Ark), upper=False)))
        cols.append(torch.cat(parts, dim=-2))
    return torch.cat(cols, dim=-1)[..., :n, :n]


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
    logdet = 2.0 * _row_sum(torch.log(_diag(L))) \
        + _row_sum(torch.log(d))
    if with_health:
        return L, s, logdet, _health_word(engaged, torch.zeros_like(engaged),
                                          d)
    return L, s, logdet


def _mixed_psd_solve_logdet(S, B, jitter, jitter2=None, refine=2,
                            delta_mode="tree", mega=None, with_health=False,
                            blocked=False):
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

    ``blocked=True`` (the reference's precedence: an explicit blocked
    factor outranks both auto-routes) declines the solve megakernel and
    the fused preconditioner, each recorded in ``ROUTES`` as
    ``blocked``, and the classic chain's jittered tiers factor through
    :func:`blocked_cholesky`.

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
            mega_solve_route(n, S.device, blocked)
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
        mega = mega_solve_route(n, S.device, blocked)
    if mega:
        from .megakernel import mega_solve_logdet
        Bn32 = (s[..., None] * B).to(torch.float32)
        Z32, ld_eq = mega_solve_logdet(Sn.to(torch.float32), Bn32,
                                       float(jitter), float(jitter2),
                                       refine)
        logdet = ld_eq.to(f64) + _row_sum(torch.log(d))
        return s[..., None] * Z32.to(f64), logdet
    from .cholfuse import fused_chol_enabled
    fused = delta_mode == "split" and fused_chol_enabled()
    if fused and blocked:
        from .routes import route
        route("chol_precond", False, S.device, why="blocked")
        fused = False

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
        factor = blocked_cholesky if blocked else cholesky_nan
        L = factor(Sn32 + float(jitter) * eye)
        bad = ~_all_finite(L)
        L = torch.where(bad[..., None, None],
                        factor(Sn32 + float(jitter2) * eye), L)
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
    res_ref = _row_sum(torch.square(Bn - Sn @ Z).flatten(-2))
    res_pre = _row_sum(torch.square(r0 if r0 is not None
                                    else Bn - Sn @ Z0).flatten(-2))
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
    corr = (_row_sum(_diag(E)) - _row_sum((E * _t(E)).flatten(-2)) / 2.0
            + _row_sum((E2 * _t(E32)).flatten(-2)).to(f64) / 3.0
            - _row_sum((E2 * _t(E2)).flatten(-2)).to(f64) / 4.0)
    corr = torch.where(_row_sum((E * E).flatten(-2)) < 0.09, corr,
                       torch.zeros_like(corr))
    logdet = (2.0 * _row_sum(torch.log(diagL.to(f64)))
              + corr + _row_sum(torch.log(d)))
    if with_health:
        return s[..., None] * Z, logdet, _health_word(engaged, diverged, d)
    return s[..., None] * Z, logdet


# --------------------------------------------------------------------
# the likelihood
# --------------------------------------------------------------------

def marginalized_loglike(nw, b, r_w, M_w, T_w, mask=None, gram_mode="split",
                         pair_program=None, refine=3, grams=None,
                         mega=None, with_health=False, blocked=False):
    """Marginalized GP log-likelihood for one pulsar at W parameter points.

    Parameters
    ----------
    nw : (W, ntoa) whitened white-noise variance per TOA.
    b : (W, nbasis) prior variance per (scale-folded) basis column.
    r_w, M_w, T_w : whitened residuals / TM matrix / noise basis
        (static, float64). ``r_w`` may also be (W, ntoa), one row per
        walker (sampled deterministic delays subtracted), and ``T_w``
        (W, ntoa, nbasis), one basis per walker (a sampled chromatic
        index): the likelihood megakernel, which takes one basis for the
        batch, declines it (route ``per-walker-basis``). ``M_w=None``
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
    blocked : the ``EWT_BLOCKED_CHOL`` pin: the auto-routes of all three
        kernels decline as ``blocked`` and the classic chain factors
        through :func:`blocked_cholesky`.

    Returns lnL (W,) up to a theta-independent constant.
    """
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
            mega = mega_like_route(T_w.shape[-2], T_w.shape[-1], T_w.device,
                                   T_w.dim() == 3,
                                   "blocked" if blocked else None)
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
        grams = tuple(g.expand((W,) + tuple(g.shape)) for g in grams)
    else:
        grams = gram_blocks(nw, r_w, M_w, T_w, mask=mask,
                            gram_mode=gram_mode, pair_program=pair_program)
    logn = torch.log(nw) if mask is None else torch.log(nw) * mask
    return sigma_stage(grams, b, _row_sum(logn), schur_tm=M_w is not None,
                       gram_mode=gram_mode, refine=refine,
                       solve_mega=solve_mega, with_health=with_health,
                       blocked=blocked)


def _quad_forms(B, Z, Sigma):
    """``B^T Sigma^-1 B`` (W, k, k) from a solve ``Z`` of ``Sigma Z = B``,
    taken variationally: ``2 B^T Z - Z^T Sigma Z``, symmetrized. Its error
    is second order in the solve's residual ``B - Sigma Z``, where
    ``B^T Z`` is first order: the solve kernel hands back a float32 ``Z``,
    whose rounding would otherwise reach the quadratic forms (of order
    ``ntoa``) as u |B^T Z| (on an NVIDIA H100, 7.9e-3 of lnL at 32768
    TOAs, against 1.1e-3 from the split Gram; PERF.md, the split class).
    A departure from the reference, whose kernel route keeps ``B^T Z``."""
    W = 2.0 * (_t(B) @ Z) - _t(Z) @ (Sigma @ Z)
    return (W + _t(W)) / 2


def sigma_stage(grams, b, logdet_n, schur_tm=True, gram_mode="split",
                refine=3, solve_mega=None, with_health=False, blocked=False):
    """The evaluation after the Gram stage: ``Sigma = G + diag(1/b)``, its
    solve and log-determinant, the timing-model Schur stage and lnL (W,)
    (``(lnL, hw)`` with ``with_health``).

    ``grams`` is ``(G, H, P, X, q, rwr)`` per walker, (W, ...), and
    ``logdet_n`` (W,) the masked ``sum log nw``, wherever they were
    summed: :func:`marginalized_loglike` passes its own, the TOA axis
    across processes the sum of every shard's (``models/build.py``).
    ``schur_tm=False`` is the sampled-timing-model likelihood (``H``,
    ``P`` and ``q`` without columns). ``solve_mega`` is the Sigma solve's
    kernel pin (None: its own decision); ``blocked`` as in
    :func:`marginalized_loglike`."""
    G, H, P, X, q, rwr = grams
    f64 = X.dtype
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
                                      with_health=with_health,
                                      blocked=blocked)
        if with_health:
            hw = out[2] if hw is None else torch.maximum(hw, out[2])
        return out[0], out[1]

    hw = None
    logdet_a = 0.0
    if not schur_tm:
        # no-TM path: C_n-only quadratic form and determinant
        if gram_mode == "f64":
            L, sS, logdet_sigma = chol(Sigma, 0.0)
            u = torch.linalg.solve_triangular(L, (sS * X)[..., None],
                                              upper=False)[..., 0]
            quad = rwr - _row_sum(u * u)
        else:
            zx, logdet_sigma = solve(Sigma, X[..., None])
            quad = rwr - _quad_forms(X[..., None], zx, Sigma)[..., 0, 0]
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
        quad = rwr - _row_sum(u * u) - _row_sum(z * z)
    else:
        XH = torch.cat([X[..., None], H], dim=-1)
        ZXH, logdet_sigma = solve(Sigma, XH)
        W = _quad_forms(XH, ZXH, Sigma)
        A = P - W[..., 1:, 1:]
        y = q - W[..., 1:, 0]
        # split mode's float64 sides leave A accurate (no jitter); f32
        # mode's Gram noise can make A indefinite, so it keeps a retry
        jitter_a = CHOL_JITTER["f32"] if gram_mode == "f32" else 0.0
        LA, sA, logdet_a = chol(A, jitter_a)
        z = torch.linalg.solve_triangular(LA, (sA * y)[..., None],
                                          upper=False)[..., 0]
        quad = rwr - W[..., 0, 0] - _row_sum(z * z)

    logdet_b = _row_sum(torch.log(b))
    lnl = -0.5 * (quad + logdet_n + logdet_b + logdet_sigma + logdet_a)
    return (lnl, hw) if with_health else lnl
