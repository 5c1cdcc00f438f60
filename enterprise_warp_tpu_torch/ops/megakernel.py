"""The two likelihood megakernels: routing, wrappers, plain versions.

Counterpart of ``enterprise_warp_tpu/ops/megakernel.py``. The two Pallas
kernels of the reference (``_mega_solve_kernel``, ``_mega_like_kernel``)
are hand-written CUDA here (``csrc/megakernel.cu``, built and bound by
``ops/cuda_lib.py``):

- :func:`mega_solve_logdet` — the solve megakernel: on an equilibrated
  float32 ``Sn`` (B, n, n) and right-hand side ``Bn`` (B, n, k), the
  three-tier jittered Cholesky, the triangular inverse, the
  preconditioner solves, ``refine`` float32 refinement passes, the
  divergence guard and the trace-corrected logdet, in ONE launch.
- :func:`mega_marginalized_loglike` — the single-pulsar likelihood: its
  device half (:func:`mega_like`) adds the per-walker basis Gram and the
  Sigma assembly in front of the same chain, and its float64 host half
  (skinny Grams, equilibration scales, timing-model Schur stage with a
  relatively-clamped ``eigh``) stays outside the kernel, exactly as in
  the reference: an in-kernel float32 Schur stage is off by O(1) in lnL.

Each wrapper takes its kernel's plain PyTorch version
(:func:`_mega_solve_torch`, :func:`_mega_like_torch` — the counterparts
of ``_mega_solve_xla``/``_mega_like_xla``) ONLY for tensors on the CPU.
A CUDA tensor gets the kernel or an exception; there is no probe and no
fallback, unless the user opts out with ``EWT_PALLAS=0`` (every kernel)
or ``EWT_PALLAS_MEGA=0`` (these two), the reference's environment
switches under the same names.

Counters (``ROUTES``, ``LAUNCHES``): every routing decision records the
path it took under ``(kernel, path)`` with path one of ``kernel`` (CUDA
launch), ``plain-cpu``, ``over-cap`` and ``disabled`` — the counterpart
of the reference's ``pallas_path{kernel,path}`` counter. One decision,
:func:`_route`, serves both the route functions and the wrappers; a
launch adds one to ``LAUNCHES[kernel]`` and to the ``kernel`` route at
the launch site and nowhere else.
"""

from __future__ import annotations

import collections
import os

import torch

# Above these sizes the reference's VMEM working set no longer fits; the
# port keeps the same caps so both packages route the same shapes.
_MEGA_MAX_N = 448          # solve kernel: matrix order
_MEGA_MAX_TOA = 4096       # likelihood kernel: TOA rows
_MEGA_MAX_M = 192          # likelihood kernel: noise-basis columns

KERNELS = ("mega_solve", "mega_like")
ROUTES = collections.Counter()
LAUNCHES = {k: 0 for k in KERNELS}


def reset_counts():
    """Zero the route and launch counters (a run reads them after)."""
    ROUTES.clear()
    for k in KERNELS:
        LAUNCHES[k] = 0


def _record_route(kernel, path):
    ROUTES[(kernel, path)] += 1


def kernels_enabled():
    """``EWT_PALLAS=0`` switches every hand-written kernel off."""
    return os.environ.get("EWT_PALLAS", "1") != "0"


def _mega_enabled():
    return kernels_enabled() \
        and os.environ.get("EWT_PALLAS_MEGA", "1") != "0"


def mega_like_fits(ntoa, nb):
    return ntoa <= _MEGA_MAX_TOA and nb <= _MEGA_MAX_M


def mega_solve_fits(n):
    return n <= _MEGA_MAX_N


def _route(kernel, fits, device):
    """The one routing decision for a call of ``kernel`` on ``device``:
    ``kernel`` (a CUDA launch, recorded at the launch site), or a decline
    — ``disabled``, ``over-cap`` or ``plain-cpu`` — recorded here. Raises
    for a device the port does not run on."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    if not _mega_enabled():
        path = "disabled"
    elif not fits:
        path = "over-cap"
    elif dev.type == "cpu":
        path = "plain-cpu"
    else:
        return "kernel"
    _record_route(kernel, path)
    return path


def mega_like_route(ntoa, nb, device):
    """Whether ``marginalized_loglike`` sends a whole evaluation through
    the likelihood megakernel: CUDA tensors, kernels enabled, shape
    within the caps. A decline keeps the classic chain."""
    return _route("mega_like", mega_like_fits(ntoa, nb), device) == "kernel"


def mega_solve_route(n, device):
    """Whether ``_mixed_psd_solve_logdet`` sends its post-equilibration
    chain through the solve megakernel (same contract)."""
    return _route("mega_solve", mega_solve_fits(n), device) == "kernel"


# --------------------------------------------------------------------
# plain PyTorch versions (CPU tensors; the reference for the kernels)
# --------------------------------------------------------------------

def _fused_torch(Sn_b, j1, j2):
    """Batched three-tier factorization: ``(U, V, E)`` with ``U = L^T``
    the upper Cholesky factor of the jittered cast, ``V = U^-1`` and
    ``E = Linv (Sn - L L^T) Linv^T`` (counterpart of ``_fused_xla``)."""
    from .kernel import _all_finite, _t, cholesky_nan
    n = Sn_b.shape[-1]
    eye = torch.eye(n, dtype=Sn_b.dtype, device=Sn_b.device)
    L = cholesky_nan(Sn_b + float(j1) * eye)
    bad1 = ~_all_finite(L)
    if bool(bad1.any()):
        jm = torch.where(bad1, float(j2), float(j1)).to(Sn_b.dtype)
        L2 = cholesky_nan(Sn_b + jm[:, None, None] * eye)
        L = torch.where(bad1[:, None, None], L2, L)
    bad2 = ~_all_finite(L)
    L = torch.where(bad2[:, None, None], eye, L)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    Delta = Sn_b - L @ _t(L)
    K = Linv @ Delta
    E = K @ _t(Linv)
    return _t(L), _t(Linv), E


def _mega_solve_torch(Sn_b, Bn_b, j1, j2, refine):
    """Plain version of the solve megakernel (``_mega_solve_xla``):
    float32 in, ``(Z (B, n, k), ld (B,))`` out."""
    from .kernel import _diag, _t
    U, V, E = _fused_torch(Sn_b, j1, j2)
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

def _check(t, name, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch_check(rc, kernel):
    if rc != 0:
        raise RuntimeError(f"{kernel} CUDA launch failed: cudaError {rc}")


def _mega_solve_cuda(Sn, Bn, j1, j2, refine):
    """Launch the solve megakernel on ``torch.cuda.current_stream()``:
    returns ``(Z, ld, tier)``, ``tier`` (B,) int32 being the
    factorization tier each walker ended on (1, 2 or 3)."""
    from .cuda_lib import load_library
    B, n = Sn.shape[0], Sn.shape[-1]
    k = Bn.shape[-1]
    _check(Sn, "Sn", (B, n, n))
    _check(Bn, "Bn", (B, n, k))
    if Bn.device != Sn.device:
        raise ValueError("Sn and Bn must lie on the same device")
    lib = load_library()
    dev = Sn.device
    ws = torch.empty(int(lib.mega_solve_ws_floats(n, k)) * B,
                     dtype=torch.float32, device=dev)
    Z = torch.empty((B, n, k), dtype=torch.float32, device=dev)
    ld = torch.empty((B,), dtype=torch.float32, device=dev)
    tier = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mega_solve_launch(
            Sn.data_ptr(), Bn.data_ptr(), Z.data_ptr(), ld.data_ptr(),
            tier.data_ptr(), ws.data_ptr(), B, n, k, float(j1), float(j2),
            int(refine), stream)
    _launch_check(rc, "mega_solve")
    LAUNCHES["mega_solve"] += 1
    _record_route("mega_solve", "kernel")
    return Z, ld, tier


def _mega_like_cuda(S32, w, s, ivb, Bn, j1, j2, refine):
    """Launch the likelihood megakernel: returns ``(Z, ld, tier)``."""
    from .cuda_lib import load_library
    ntoa, nb = S32.shape
    B, k = w.shape[0], Bn.shape[-1]
    _check(S32, "S", (ntoa, nb))
    _check(w, "w", (B, ntoa))
    _check(s, "s", (B, nb))
    _check(ivb, "ivb", (B, nb))
    _check(Bn, "Bn", (B, nb, k))
    if len({t.device for t in (S32, w, s, ivb, Bn)}) != 1:
        raise ValueError("all inputs must lie on the same device")
    lib = load_library()
    dev = S32.device
    ws = torch.empty(int(lib.mega_like_ws_floats(ntoa, nb, k)) * B,
                     dtype=torch.float32, device=dev)
    Z = torch.empty((B, nb, k), dtype=torch.float32, device=dev)
    ld = torch.empty((B,), dtype=torch.float32, device=dev)
    tier = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mega_like_launch(
            S32.data_ptr(), w.data_ptr(), s.data_ptr(), ivb.data_ptr(),
            Bn.data_ptr(), Z.data_ptr(), ld.data_ptr(), tier.data_ptr(),
            ws.data_ptr(), B, ntoa, nb, k, float(j1), float(j2),
            int(refine), stream)
    _launch_check(rc, "mega_like")
    LAUNCHES["mega_like"] += 1
    _record_route("mega_like", "kernel")
    return Z, ld, tier


def _wrapper_route(kernel, fits, device):
    """The route of a direct wrapper call: True for a launch. An over-cap
    CUDA call raises — the route functions decline such shapes, and the
    card runs no plain version unless the user opts out."""
    path = _route(kernel, fits, device)
    if path == "over-cap" and device.type == "cuda":
        raise ValueError(f"{kernel}: shape over the kernel's size cap")
    return path == "kernel"


def mega_solve_logdet(Sn32, Bn32, j1, j2, refine):
    """Fused post-equilibration mixed solve: ``(Z, ld_eq)`` for a batch of
    equilibrated float32 casts ``Sn32`` (B, n, n) and right-hand sides
    ``Bn32`` (B, n, k) — one CUDA launch for CUDA tensors, the plain
    version for CPU tensors."""
    if not _wrapper_route("mega_solve", mega_solve_fits(Sn32.shape[-1]),
                          Sn32.device):
        return _mega_solve_torch(Sn32, Bn32, j1, j2, refine)
    Z, ld, _ = _mega_solve_cuda(Sn32.contiguous(), Bn32.contiguous(),
                                j1, j2, refine)
    return Z, ld


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
    """``torch.linalg.eigh`` with JAX's failure semantics: a non-finite
    batch element yields NaN eigenvalues instead of an exception."""
    finite = torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    ev, V = torch.linalg.eigh(torch.where(finite[:, None, None], A, eye))
    ev = torch.where(finite[:, None], ev, torch.full_like(ev, float("nan")))
    return ev, V


def mega_marginalized_loglike(nw, b, r_w, M_w, T_w, mask, refine):
    """Single-pulsar marginalized log-likelihood (W,) through the
    likelihood megakernel (counterpart of ``_mega_lnl_impl``): one launch
    for the Gram -> Sigma -> factor -> solve -> refine -> logdet chain,
    plus float64 host-precision work around it. ``nw`` (W, ntoa), ``b``
    (W, nb), ``mask`` (W, ntoa) (ones when unmasked)."""
    from .kernel import CHOL_JITTER
    f64 = r_w.dtype
    ntm = M_w.shape[1]
    nb = T_w.shape[1]
    w = mask / nw
    sqw = torch.sqrt(w)
    invb = 1.0 / b.to(f64)
    # the genuine-float64 skinny side: everything touching M or r feeds
    # the TM Schur complement and must never pass through the kernel
    Us = torch.cat([M_w, r_w[:, None]], dim=1) * sqw[..., None]
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
    quad = rwr - Wm[:, ntm, 0] - torch.sum(u * u / evA_cl, dim=-1)
    ld_all = (torch.sum(torch.log(nw) * mask, dim=-1)
              + torch.sum(torch.log(d), dim=-1)
              + torch.sum(torch.log(b), dim=-1)
              + torch.sum(torch.log(evA_cl), dim=-1))
    return -0.5 * (quad + ld_all + ld_eq.to(f64))
