"""The two likelihood megakernels: routing, wrappers, plain versions.

Counterpart of ``enterprise_warp_tpu/ops/megakernel.py``. The two Pallas
kernels of the reference (``_mega_solve_kernel``, ``_mega_like_kernel``)
are hand-written CUDA here (``csrc/megakernel.cu``, built and bound by
``ops/cuda_lib.py``):

- :func:`mega_solve_logdet` — the solve megakernel: on an equilibrated
  float32 ``Sn`` (B, n, n) and right-hand side ``Bn`` (B, n, k), the
  three-tier jittered Cholesky, the triangular inverse, the
  preconditioner solves, ``refine`` refinement passes, the
  divergence guard and the trace-corrected logdet, as a pipeline of
  eight phase launches on one workspace (:func:`_mega_solve_phases`): the
  triangular inverse and the four logdet products run on grids over
  (tile, walker), the rest one block per walker (the refined solve on
  skinny products up to 8 right-hand-side columns, on tiled products
  above).
- :func:`mega_marginalized_loglike` — the single-pulsar likelihood: its
  device half (:func:`mega_like`) adds the per-walker basis Gram and the
  Sigma assembly in front of the same chain, as one C call that enqueues
  a tiled Gram launch, a factor with the walker's matrix in shared
  memory, and the solve pipeline's other phases; its float64 host half
  (skinny Grams, equilibration scales, timing-model Schur stage with a
  relatively-clamped ``eigh``) stays outside the kernel, exactly as in
  the reference: an in-kernel float32 Schur stage is off by O(1) in lnL.
  Unlike the reference, a walker whose Schur complement comes out
  indefinite is rejected there (:func:`schur_reject`), as the classic
  chain rejects it.

One departure of the kernels from the reference (and from their plain
versions, which keep the reference's arithmetic): the refinement's
residual ``Bn - Sn Z`` is summed in float64 and rounded to float32 once.
With a float32 residual the refined ``Z`` stalls at float32's floor,
cond(Sn) eps |Z|, at one pass's value or another's at random; with this
one it reaches its float32 rounding (``chip_smoke.py:refine_floor``
measures both against float64 on every system of a ``gwb_array.dat``
chain; ``PERF.md``, PR 13).

Each wrapper takes its kernel's plain PyTorch version
(:func:`_mega_solve_torch`, :func:`_mega_like_torch` — the counterparts
of ``_mega_solve_xla``/``_mega_like_xla``) ONLY for tensors on the CPU.
A CUDA tensor gets the kernel or an exception; there is no probe and no
fallback, unless the user opts out with ``EWT_PALLAS=0`` (every kernel)
or ``EWT_PALLAS_MEGA=0`` (these two), the reference's environment
switches under the same names.

Autograd mirrors the reference's ``custom_vjp``s: both entry points are
``torch.autograd.Function``s whose forward is the kernel and whose
backward re-derives the value through plain PyTorch —
:func:`mega_solve_logdet` through ``_mega_solve_torch(..., ad=True)``
(the AD-safe factorization twin), :func:`mega_marginalized_loglike`
through the classic chain ``marginalized_loglike(..., mega=False)``,
whose fused preconditioner is the third kernel, ``chol_precond``
(``ops/cholfuse.py``).

Routing and launch counts: ``ops/routes.py``. The dispatch census
(:func:`dispatch_ab_counts`, :func:`dispatch_reduction`) counts one
evaluation's ATen ops, device dispatches and kernel launches on the
classic chain and on the kernel route; the reference's ``force_route``
has no counterpart, since ``mega=True`` pins the kernel route.
"""

from __future__ import annotations

import torch

from .cholfuse import _fused_torch, _fused_torch_ad
from .routes import check, launch_check, record_launch, route

# Above these sizes the reference's VMEM working set no longer fits; the
# port keeps the same caps so both packages route the same shapes.
_MEGA_MAX_N = 448          # solve kernel: matrix order
_MEGA_MAX_TOA = 4096       # likelihood kernel: TOA rows
_MEGA_MAX_M = 192          # likelihood kernel: noise-basis columns


def mega_like_fits(ntoa, nb):
    return ntoa <= _MEGA_MAX_TOA and nb <= _MEGA_MAX_M


def mega_solve_fits(n):
    return n <= _MEGA_MAX_N


def mega_like_route(ntoa, nb, device, per_walker=False, decline=None):
    """Whether ``marginalized_loglike`` sends a whole evaluation through
    the likelihood megakernel: CUDA tensors, kernels enabled, shape
    within the caps, one basis shared by the batch. A decline keeps the
    classic chain; a per-walker basis (``per_walker``, a sampled
    chromatic index) is declined as ``per-walker-basis``, where the
    reference's kernel route raises (its ``vmap`` rule takes a static
    basis only). ``decline`` names a reason the caller already holds
    (``blocked``: the ``EWT_BLOCKED_CHOL`` pin; ``toa-sharded``: Gram
    blocks summed across processes), which takes precedence."""
    if decline is not None:
        return route("mega_like", False, device, why=decline) == "kernel"
    if per_walker:
        return route("mega_like", False, device,
                     why="per-walker-basis") == "kernel"
    return route("mega_like", mega_like_fits(ntoa, nb), device) == "kernel"


def mega_solve_route(n, device, blocked=False):
    """Whether ``_mixed_psd_solve_logdet`` sends its post-equilibration
    chain through the solve megakernel (same contract; ``blocked``, the
    ``EWT_BLOCKED_CHOL`` pin, declines as ``blocked``)."""
    if blocked:
        return route("mega_solve", False, device, why="blocked") == "kernel"
    return route("mega_solve", mega_solve_fits(n), device) == "kernel"


# --------------------------------------------------------------------
# plain PyTorch versions (CPU tensors; the reference for the kernels)
# --------------------------------------------------------------------

def _mega_solve_torch(Sn_b, Bn_b, j1, j2, refine, ad=False):
    """Plain version of the solve megakernel (``_mega_solve_xla``):
    float32 in, ``(Z (B, n, k), ld (B,))`` out. ``ad=True`` factors
    through the AD-safe twin (the backward's recompute)."""
    from .kernel import _diag, _t
    U, V, E = (_fused_torch_ad if ad else _fused_torch)(Sn_b, j1, j2)
    Vt = _t(V)

    def psolve(R):
        return V @ (Vt @ R)

    Z0 = psolve(Bn_b)
    Z = Z0
    r0 = None
    for i in range(refine):
        r = Bn_b - Sn_b @ Z
        if i == 0:
            r0 = r
        Z = Z + psolve(r)
    res_ref = torch.sum(torch.square(Bn_b - Sn_b @ Z), dim=(1, 2))
    res_pre = torch.sum(torch.square(r0), dim=(1, 2)) if r0 is not None \
        else res_ref
    Z = torch.where((res_ref <= res_pre)[:, None, None], Z, Z0)

    Et = _t(E)
    E2 = E @ E
    corr = (_diag(E).sum(dim=-1) - torch.sum(E * Et, dim=(1, 2)) / 2.0
            + torch.sum(E2 * Et, dim=(1, 2)) / 3.0
            - torch.sum(E2 * _t(E2), dim=(1, 2)) / 4.0)
    corr = torch.where(torch.sum(E * E, dim=(1, 2)) < 0.09, corr,
                       torch.zeros_like(corr))
    ld = 2.0 * torch.sum(torch.log(_diag(U)), dim=1) + corr
    return Z, ld


def _mega_like_torch(S32, w_b, s_b, ivb_b, Bn_b, j1, j2, refine):
    """Plain version of the likelihood megakernel (``_mega_like_xla``):
    ``Sn = s (Ss^T Ss) s + diag(ivb)`` with ``Ss = S sqrt(w)``, then the
    solve chain."""
    nb = s_b.shape[-1]
    sqw = torch.sqrt(w_b)
    Ss = S32[None] * sqw[:, :, None]
    G = torch.einsum("bik,bil->bkl", Ss, Ss)
    eye = torch.eye(nb, dtype=S32.dtype, device=S32.device)
    Sn = (G * s_b[:, :, None] * s_b[:, None, :]
          + ivb_b[:, :, None] * eye[None])
    return _mega_solve_torch(Sn, Bn_b, j1, j2, refine)


# --------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------

#: the logdet correction's four products, one launch each, in order
SOLVE_PRODUCTS = ("Sn-UtU", "VtD", "E", "EE")


def _mega_solve_check(Sn, Bn):
    B, n = Sn.shape[0], Sn.shape[-1]
    check(Sn, "Sn", (B, n, n))
    check(Bn, "Bn", (B, n, Bn.shape[-1]))
    if Bn.device != Sn.device:
        raise ValueError("Sn and Bn must lie on the same device")


def _mega_solve_buffers(lib, Sn, Bn):
    """A solve call's outputs ``Z``, ``ld``, ``tier`` and its per-walker
    workspace ``ws``."""
    B, n, k = Bn.shape
    dev = Sn.device
    ws = torch.empty(int(lib.mega_solve_ws_floats(n, k)) * B,
                     dtype=torch.float32, device=dev)
    Z = torch.empty((B, n, k), dtype=torch.float32, device=dev)
    ld = torch.empty((B,), dtype=torch.float32, device=dev)
    tier = torch.empty((B,), dtype=torch.int32, device=dev)
    return Z, ld, tier, ws


def _mega_solve_phases(lib, Sn, Bn, bufs, j1, j2, refine, stream):
    """The solve pipeline as ``[(phase, launch)]`` in launch order: the
    factor, the triangular inverse, the refined solve, the four logdet
    products and the trace sums. Each ``launch()`` enqueues one kernel on
    ``stream`` and returns its ``cudaGetLastError()``."""
    Z, ld, tier, ws = (t.data_ptr() for t in bufs)
    B, n, k = Bn.shape
    S, R = Sn.data_ptr(), Bn.data_ptr()
    phases = [
        ("factor", lambda: lib.mega_solve_factor_launch(
            S, tier, ws, B, n, k, float(j1), float(j2), stream)),
        ("inverse", lambda: lib.mega_solve_inverse_launch(ws, B, n, k,
                                                          stream)),
        ("refine", lambda: lib.mega_solve_refine_launch(
            S, R, Z, ws, B, n, k, int(refine), stream))]
    phases += [(f"product {name}",
                (lambda p=p: lib.mega_solve_product_launch(S, ws, B, n, k, p,
                                                           stream)))
               for p, name in enumerate(SOLVE_PRODUCTS)]
    phases.append(("logdet", lambda: lib.mega_solve_logdet_launch(
        ld, ws, B, n, k, stream)))
    return phases


def _mega_solve_cuda(Sn, Bn, j1, j2, refine):
    """Run the solve pipeline on ``torch.cuda.current_stream()``: returns
    ``(Z, ld, tier)``, ``tier`` (B,) int32 being the factorization tier
    each walker ended on (1, 2 or 3). One call is one launch of the
    ``mega_solve`` kernel in ``LAUNCHES``, whatever its phase count."""
    from .cuda_lib import load_library
    _mega_solve_check(Sn, Bn)
    lib = load_library()
    bufs = _mega_solve_buffers(lib, Sn, Bn)
    with torch.cuda.device(Sn.device):
        stream = torch.cuda.current_stream(Sn.device).cuda_stream
        for phase, launch in _mega_solve_phases(lib, Sn, Bn, bufs, j1, j2,
                                                refine, stream):
            launch_check(launch(), f"mega_solve ({phase})")
    record_launch("mega_solve")
    return bufs[:3]


def _mega_like_buffers(lib, Bn):
    """A likelihood call's outputs ``Z``, ``ld``, ``tier``, its workspace
    ``ws`` (the solve pipeline's per-walker slots, then every walker's
    ``Sn``) and ``Sn`` (B, nb, nb), the view of ``ws`` that
    ``mega_like_launch`` fills and the solve phases read."""
    B, nb, k = Bn.shape
    dev = Bn.device
    ws = torch.empty(int(lib.mega_like_ws_floats(nb, k)) * B,
                     dtype=torch.float32, device=dev)
    Z = torch.empty((B, nb, k), dtype=torch.float32, device=dev)
    ld = torch.empty((B,), dtype=torch.float32, device=dev)
    tier = torch.empty((B,), dtype=torch.int32, device=dev)
    off = int(lib.mega_solve_ws_floats(nb, k)) * B
    return Z, ld, tier, ws, ws[off:off + B * nb * nb].view(B, nb, nb)


def _mega_like_cuda(S32, w, s, ivb, Bn, j1, j2, refine):
    """Run the likelihood pipeline on ``torch.cuda.current_stream()``:
    returns ``(Z, ld, tier)``. ``mega_like_launch`` enqueues every phase
    (the Gram, the shared-memory factor, then the solve pipeline's
    inverse, refine, four products and logdet) in one C call, and one
    call is one launch of the ``mega_like`` kernel in ``LAUNCHES``."""
    from .cuda_lib import load_library
    ntoa, nb = S32.shape
    B, k = w.shape[0], Bn.shape[-1]
    check(S32, "S", (ntoa, nb))
    check(w, "w", (B, ntoa))
    check(s, "s", (B, nb))
    check(ivb, "ivb", (B, nb))
    check(Bn, "Bn", (B, nb, k))
    if len({t.device for t in (S32, w, s, ivb, Bn)}) != 1:
        raise ValueError("all inputs must lie on the same device")
    lib = load_library()
    bufs = _mega_like_buffers(lib, Bn)
    dev = S32.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mega_like_launch(
            S32.data_ptr(), w.data_ptr(), s.data_ptr(), ivb.data_ptr(),
            Bn.data_ptr(), *(t.data_ptr() for t in bufs[:4]), B, ntoa, nb,
            k, float(j1), float(j2), int(refine), stream)
    launch_check(rc, "mega_like")
    record_launch("mega_like")
    return bufs[:3]


def _wrapper_route(kernel, fits, device):
    """The route of a direct wrapper call: True for a launch. An over-cap
    CUDA call raises — the route functions decline such shapes, and the
    card runs no plain version unless the user opts out."""
    path = route(kernel, fits, device)
    if path == "over-cap" and device.type == "cuda":
        raise ValueError(f"{kernel}: shape over the kernel's size cap")
    return path == "kernel"


def _grads(outputs, inputs, needs, cotangents):
    """``torch.autograd.grad`` of ``outputs`` with respect to the
    ``inputs`` whose ``needs`` flag is set; None for the others."""
    wanted = [t for t, nd in zip(inputs, needs) if nd]
    got = iter(torch.autograd.grad(outputs, wanted, cotangents)
               if wanted else ())
    return tuple(next(got) if nd else None for nd in needs)


class _MegaSolve(torch.autograd.Function):
    """Forward: the solve kernel (or its plain version); backward: the
    vector-Jacobian product of ``_mega_solve_torch(..., ad=True)`` at the
    saved inputs (``_mega_solve_fwd``/``_mega_solve_bwd``)."""

    @staticmethod
    def forward(ctx, Sn32, Bn32, j1, j2, refine):
        ctx.save_for_backward(Sn32, Bn32)
        ctx.args = (j1, j2, refine)
        if not _wrapper_route("mega_solve", mega_solve_fits(Sn32.shape[-1]),
                              Sn32.device):
            return _mega_solve_torch(Sn32, Bn32, j1, j2, refine)
        Z, ld, _ = _mega_solve_cuda(Sn32.contiguous(), Bn32.contiguous(),
                                    j1, j2, refine)
        return Z, ld

    @staticmethod
    def backward(ctx, gZ, gld):
        needs = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(nd)
                   for t, nd in zip(ctx.saved_tensors, needs)]
            out = _mega_solve_torch(*ins, *ctx.args, ad=True)
            return _grads(out, ins, needs, (gZ, gld)) + (None,) * 3


def mega_solve_logdet(Sn32, Bn32, j1, j2, refine):
    """Fused post-equilibration mixed solve: ``(Z, ld_eq)`` for a batch of
    equilibrated float32 casts ``Sn32`` (B, n, n) and right-hand sides
    ``Bn32`` (B, n, k) — one CUDA launch for CUDA tensors, the plain
    version for CPU tensors. Differentiable (see :class:`_MegaSolve`)."""
    return _MegaSolve.apply(Sn32, Bn32, float(j1), float(j2), int(refine))


def mega_like(S32, w, s, ivb, Bn, j1, j2, refine):
    """Device half of the likelihood megakernel: per walker the Gram of
    ``S32 * sqrt(w)``, ``Sn = s G s + diag(ivb)`` and the solve chain on
    ``Bn``; returns ``(Z, ld_eq)``."""
    if not _wrapper_route("mega_like",
                          mega_like_fits(S32.shape[0], S32.shape[1]),
                          S32.device):
        return _mega_like_torch(S32, w, s, ivb, Bn, j1, j2, refine)
    Z, ld, _ = _mega_like_cuda(S32.contiguous(), w.contiguous(),
                               s.contiguous(), ivb.contiguous(),
                               Bn.contiguous(), j1, j2, refine)
    return Z, ld


def _safe_eigh(A):
    """``torch.linalg.eigh`` with JAX's semantics: the symmetrized input
    (``ops/kernel.py:_sym``), and a non-finite batch element yields NaN
    eigenvalues instead of an exception."""
    from .kernel import _sym
    finite = torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    # ewt: allow-host-sync — the Schur test's eigensolve: eigh checks its
    # info on the host, one sync per kernel-2 call; a device-side test would
    # remove it and let the PT step become one CUDA graph
    ev, V = torch.linalg.eigh(torch.where(finite[:, None, None], _sym(A),
                                          eye))
    ev = torch.where(finite[:, None], ev, torch.full_like(ev, float("nan")))
    return ev, V


class _MegaLnl(torch.autograd.Function):
    """Forward: :func:`_mega_lnl_impl`; backward: the vector-Jacobian
    product of the classic split chain ``marginalized_loglike(...,
    gram_mode="split", mega=False)`` at the saved inputs
    (``_mega_lnl_fwd``/``_mega_lnl_bwd``)."""

    @staticmethod
    def forward(ctx, nw, b, r_w, M_w, T_w, mask, refine):
        ctx.save_for_backward(nw, b, r_w, M_w, T_w, mask)
        ctx.refine = refine
        return _mega_lnl_impl(nw, b, r_w, M_w, T_w, mask, refine)

    @staticmethod
    def backward(ctx, g):
        from .kernel import marginalized_loglike
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(nd)
                   for t, nd in zip(ctx.saved_tensors, needs)]
            lnl = marginalized_loglike(*ins[:5], mask=ins[5],
                                       gram_mode="split", refine=ctx.refine,
                                       mega=False)
            return _grads(lnl, ins, needs, g) + (None,)


def mega_marginalized_loglike(nw, b, r_w, M_w, T_w, mask, refine):
    """Single-pulsar marginalized log-likelihood (W,) through the
    likelihood megakernel: one C call that enqueues the Gram -> Sigma ->
    factor -> solve -> refine -> logdet chain, plus float64 host-precision
    work around it. ``nw`` (W, ntoa), ``b`` (W, nb), ``mask`` (W, ntoa) (ones
    when unmasked). Differentiable (see :class:`_MegaLnl`)."""
    return _MegaLnl.apply(nw, b, r_w, M_w, T_w, mask, int(refine))


def _mega_lnl_impl(nw, b, r_w, M_w, T_w, mask, refine):
    """The host-precision half around :func:`mega_like` (counterpart of
    ``_mega_lnl_impl``). Departs from the reference in one place: a
    walker that :func:`schur_reject` flags gets NaN, where the reference's
    kernel route returns a finite lnL far above float64."""
    from .kernel import CHOL_JITTER, _row_sum
    f64 = r_w.dtype
    ntm = M_w.shape[1]
    nb = T_w.shape[1]
    w = mask / nw
    sqw = torch.sqrt(w)
    invb = 1.0 / b.to(f64)
    # the genuine-float64 skinny side: everything touching M or r feeds
    # the TM Schur complement and must never pass through the kernel;
    # ``r_w`` is (ntoa,) or, with sampled deterministic delays, (W, ntoa)
    W = nw.shape[0]
    Us = torch.cat([M_w.expand(W, -1, -1), r_w.expand(W, -1)[..., None]],
                   dim=-1) * sqw[..., None]
    Ts = T_w * sqw[..., None]
    TU = torch.cat([Ts, Us], dim=-1)
    R1 = torch.einsum("wta,wtb->wab", TU, Us)
    HX, Pq = R1[:, :nb], R1[:, nb:]
    H, X = HX[..., :ntm], HX[..., ntm]
    P, q, rwr = Pq[:, :ntm, :ntm], Pq[:, :ntm, ntm], Pq[:, ntm, ntm]
    # equilibration in float64 outside the kernel: 1/phi spans the whole
    # prior exponent range and would overflow a float32 cast
    dG = w @ (T_w * T_w)
    d = dG + invb
    s = 1.0 / torch.sqrt(d)
    Bn = s[..., None] * torch.cat([X[..., None], H], dim=-1)
    j1 = float(CHOL_JITTER["split"])
    f32 = torch.float32
    Z32, ld_eq = mega_like(T_w.to(f32), w.to(f32), s.to(f32),
                           (invb * s * s).to(f32), Bn.to(f32), j1,
                           30.0 * j1, refine)
    ZXH = s[..., None] * Z32.to(f64)
    # TM Schur stage, genuine float64
    Wm = torch.einsum("wak,wal->wkl", HX, ZXH)
    A = P - Wm[:, :ntm, 1:]
    y = q - Wm[:, ntm, 1:]
    evA, VA = _safe_eigh(A)
    emax = evA.abs().amax(dim=-1, keepdim=True)
    evA_cl = torch.maximum(evA, 1e-13 * emax + 1e-300)
    u = (VA.transpose(-1, -2) @ y[..., None])[..., 0]
    quad = rwr - Wm[:, ntm, 0] - _row_sum(u * u / evA_cl)
    ld_all = (_row_sum(torch.log(nw) * mask) + _row_sum(torch.log(d))
              + _row_sum(torch.log(b)) + _row_sum(torch.log(evA_cl)))
    lnl = -0.5 * (quad + ld_all + ld_eq.to(f64))
    rej = schur_reject(evA, quad)
    LAST_REJECT[0] = rej
    return torch.where(rej, torch.full_like(lnl, float("nan")), lnl)


#: the rejection mask (W,) of the latest kernel-route evaluation, a
#: device tensor: the likelihood constructors hand it on to the samplers
#: (``last_reject``), which count those chosen NaNs apart from genuine
#: non-finite evaluations
LAST_REJECT = [None]


# A walker whose Schur complement has an eigenvalue below -SCHUR_REJECT_C
# times its largest |eigenvalue| is rejected (see :func:`schur_reject`).
# Measured by chip_smoke.py (phase 7, NVIDIA H100) on 8000 prior draws of
# default_model_nested.dat's model re-scored in float64: every walker
# with a negative eigenvalue lay outside the lnL class of float64 (the
# largest such ratio -1.15e-9), every walker inside it had a ratio of at
# least 2.76e-9; the plain version on the CPU gives the same split. The
# limit sits near the float64 eigensolver's own resolution, below every
# negative ratio observed.
SCHUR_REJECT_C = 1e-12


def schur_reject(evA, quad):
    """Walkers whose timing-model Schur complement ``A`` is beyond
    repair: an eigenvalue ``evA`` below ``-SCHUR_REJECT_C * max|evA|``, or
    a negative quadratic form ``quad`` (impossible for a positive
    definite covariance). There the float32 solve has lost Sigma^-1 and
    the clamped eigenvalues would turn an indefinite ``A`` into a finite
    lnL far above float64; the walker gets NaN instead, which the
    likelihood constructors map to -inf, as the classic chain's failed
    Cholesky of ``A`` gives. Every other walker's lnL is left as it
    is."""
    emax = evA.abs().amax(dim=-1)
    return (evA.amin(dim=-1) < -SCHUR_REJECT_C * emax) | (quad < 0.0)


# --------------------------------------------------------------------
# the dispatch census
# --------------------------------------------------------------------

# ewt: allow-host-sync,precision — the census's whitened inputs come back
# to the host once, in float64, as the reference's protocol takes them
def _host(a):
    """A float64 numpy copy of a host array or a tensor."""
    import numpy as np
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


# ewt: allow-host-sync,precision — the census uploads its seeded float64
# fixture (the reference's draws) once, before anything is counted
def census_calls(r_w, M_w, T_w, cs2, batch=64, seed=7, solve_refine=3,
                 device=None):
    """The four calls the dispatch census counts, ``{name: (fn, args)}``
    under :func:`dispatch_ab_counts`'s keys, on the reference's fixture:
    one ``numpy.random.default_rng(seed)`` draws ``nw`` (batch, ntoa),
    ``b`` (batch, nb) and the solve fixture ``Gs`` (batch, nb, nb),
    symmetric positive definite, with right-hand sides ``RHS`` (batch,
    nb, ntm + 1), in the reference's order.

    ``full_*`` is the whole evaluation ``nw, b -> lnL``, ``solve_*`` the
    mixed Sigma solve alone (``_mixed_psd_solve_logdet``, jitter 3e-6,
    ``solve_refine`` passes). The classic side pins the classic chain
    (``mega=False``; the full one on the pair-program Gram, its Sigma
    solve with the fused preconditioner, kernel 3 on the card). The
    kernel side takes the kernel route (``mega=True``): the likelihood
    kernel where the shape fits its caps, else the auto route, which
    declines it as ``over-cap`` and sends the Sigma solve through the
    solve kernel. CPU tensors have no kernel route: the two ``*_mega``
    entries are None there, since a plain version is no kernel."""
    from .. import resolve_device
    from .kernel import (_mixed_psd_solve_logdet, build_pair_program,
                         marginalized_loglike)
    import numpy as np

    dev = resolve_device(device or "cuda")
    r_w, M_w, T_w = _host(r_w), _host(M_w), _host(T_w)
    ntoa, nb = T_w.shape
    nu = M_w.shape[1] + 1
    rng = np.random.default_rng(seed)
    nw = np.exp(0.1 * rng.standard_normal((batch, ntoa)))
    b = 10.0 ** rng.uniform(-2, 2, (batch, nb)) * _host(cs2)
    A = rng.standard_normal((batch, nb, nb))
    Gs = np.einsum("bij,bkj->bik", A, A) / nb + 3.0 * np.eye(nb)[None]
    RHS = rng.standard_normal((batch, nb, nu))
    nw, b, Gs, RHS, r_t, M_t, T_t = (
        torch.as_tensor(a, dtype=torch.float64, device=dev)
        for a in (nw, b, Gs, RHS, r_w, M_w, T_w))
    prog = build_pair_program(r_w, M_w, T_w, device=dev)

    def full(mega, pair=None):
        return lambda nwb, bb: marginalized_loglike(
            nwb, bb, r_t, M_t, T_t, pair_program=pair, mega=mega)

    def solve(mega):
        return lambda Sb, Rb: _mixed_psd_solve_logdet(
            Sb, Rb, 3e-6, refine=solve_refine, delta_mode="split",
            mega=mega)

    card = dev.type == "cuda"
    like_mega = True if mega_like_fits(ntoa, nb) else None
    return {"full_classic": (full(False, prog), (nw, b)),
            "full_mega": (full(like_mega), (nw, b)) if card else None,
            "solve_classic": (solve(False), (Gs, RHS)),
            "solve_mega": (solve(True), (Gs, RHS)) if card else None}


def dispatch_ab_counts(r_w, M_w, T_w, cs2, batch=64, seed=7,
                       solve_refine=3, device=None):
    """Classic-against-kernel dispatch census of one evaluation, the
    reference's protocol on its fixture (:func:`census_calls`): each of
    ``{"full_classic", "full_mega", "solve_classic", "solve_mega"}`` is a
    ``utils/telemetry.py:dispatch_stats`` record of one call, or None for
    a kernel side on CPU tensors.

    Departures from the reference: the records count what the eager
    program dispatched (no ``hlo_*`` keys: nothing is compiled), and no
    ``force_route`` is needed, since ``mega=True``/``mega=False`` pin the
    two sides; ``EWT_PALLAS=0`` still turns every kernel off."""
    from ..utils.telemetry import dispatch_stats
    calls = census_calls(r_w, M_w, T_w, cs2, batch=batch, seed=seed,
                         solve_refine=solve_refine, device=device)
    return {k: None if c is None else dispatch_stats(c[0], *c[1])
            for k, c in calls.items()}


def dispatch_reduction(counts, phase, key="dispatch_ops"):
    """``classic / kernel`` of one phase (``full`` or ``solve``) of a
    :func:`dispatch_ab_counts` record, rounded to 2 places; None where a
    side is missing, None or zero."""
    cl = (counts.get(f"{phase}_classic") or {}).get(key)
    mg = (counts.get(f"{phase}_mega") or {}).get(key)
    if not cl or not mg:
        return None
    return round(cl / mg, 2)
