"""The fused float32 preconditioner factorization of the mixed solve.

Counterpart of ``enterprise_warp_tpu/ops/cholfuse.py``. Per walker, on an
equilibrated float32 ``Sn`` (B, n, n), :func:`chol_precond` returns the
trio the classic chain's fused branch consumes
(``ops/kernel.py:_mixed_psd_solve_logdet``):

- ``U = L^T``, the upper Cholesky factor of the jittered cast, three-tier:
  ``j1``, then ``j2`` for walkers whose factor went non-finite, then the
  identity;
- ``V = U^-1``;
- ``E = V^T (Sn - U^T U) V``, the conjugated factorization residual that
  feeds the trace-corrected logdet.

The reference's Pallas kernel ``_chol_kernel`` is hand-written CUDA here,
launched by :func:`_chol_precond_cuda` in one of two designs chosen by
the order: up to the library's ``chol_precond_smem_maxn()`` (128) the
walker's matrices stay in one block's shared memory
(``csrc/megakernel.cu:chol_precond_smem_kernel``, no workspace); above
it ``chol_precond_kernel`` keeps them in a global workspace.
:func:`_fused_torch` is its plain PyTorch version (``_fused_xla``), taken
only for CPU tensors, the explicit opt-outs (``EWT_PALLAS=0``,
``EWT_PALLAS_CHOL=0``) and orders over the kernel's cap — the routes the
reference takes to its XLA twin.

The health plane calls :func:`chol_precond_health`, which passes the
kernel's per-walker tier on as the health word's jitter bit.

Autograd: :class:`_CholPrecond` mirrors the reference's ``custom_vjp``.
Its forward is the kernel (or the plain version); its backward recomputes
the trio through the AD-safe twin :func:`_fused_torch_ad` on the saved
input and differentiates that. Every gradient evaluation of the gradient
samplers reaches the kernel this way: the likelihood megakernel's own
backward re-derives through the classic chain, whose fused branch calls
:func:`chol_precond`.
"""

from __future__ import annotations

import os

import torch

from . import cuda_lib
from .routes import check, launch_check, record_launch, route

# Above this order the reference's VMEM working set no longer fits and it
# routes to the XLA twin; the port keeps the same cap (the CUDA kernel's
# MAXN) so both packages route the same shapes.
_PALLAS_MAX_N = 448


def fused_chol_enabled():
    """``EWT_FUSED_CHOL=0`` turns the fused preconditioner branch of the
    classic chain off (the unfused branch then runs)."""
    return os.environ.get("EWT_FUSED_CHOL", "1") != "0"


def _trio(Sn_b, L, eye):
    """``(U, V, E)`` from the chosen lower factor ``L``."""
    from .kernel import _t
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    E = Linv @ (Sn_b - L @ _t(L)) @ _t(Linv)
    return _t(L), _t(Linv), E


def _fused_torch(Sn_b, j1, j2, tiers=False):
    """Batched three-tier factorization: ``(U, V, E)`` with ``U = L^T``
    the upper Cholesky factor of the jittered cast, ``V = U^-1`` and
    ``E = Linv (Sn - L L^T) Linv^T`` (counterpart of ``_fused_xla``).
    Tier 2 runs only when some walker needs it, as the reference's
    batch-level ``lax.cond``. ``tiers=True`` also returns each walker's
    tier (B,) int32, 1, 2 or 3, as the kernel reports it."""
    from .kernel import _all_finite, cholesky_nan
    n = Sn_b.shape[-1]
    eye = torch.eye(n, dtype=Sn_b.dtype, device=Sn_b.device)
    L = cholesky_nan(Sn_b + float(j1) * eye)
    bad1 = ~_all_finite(L)
    if bool(bad1.any()):
        jm = torch.where(bad1, float(j2), float(j1)).to(Sn_b.dtype)
        L2 = cholesky_nan(Sn_b + jm[:, None, None] * eye)
        L = torch.where(bad1[:, None, None], L2, L)
    bad2 = ~_all_finite(L)
    trio = _trio(Sn_b, torch.where(bad2[:, None, None], eye, L), eye)
    if tiers:
        return trio + ((1 + bad1.int() + bad2.int()).to(torch.int32),)
    return trio


def _fused_torch_ad(Sn_b, j1, j2):
    """AD-safe twin of :func:`_fused_torch` (``_fused_xla_ad``): the same
    values, but every Cholesky factors an input sanitized to the identity
    wherever that tier failed, with the failure detected on a detached
    copy. A ``where`` over a failed factorization would otherwise
    back-propagate NaN (zero cotangent times NaN partials) into every
    retried walker's gradient. Both tiers are always computed."""
    from .kernel import _all_finite, cholesky_nan
    n = Sn_b.shape[-1]
    eye = torch.eye(n, dtype=Sn_b.dtype, device=Sn_b.device)

    def safe_chol(A):
        bad = ~_all_finite(cholesky_nan(A.detach()))
        return cholesky_nan(torch.where(bad[:, None, None], eye, A)), bad

    L1, bad1 = safe_chol(Sn_b + float(j1) * eye)
    jm = torch.where(bad1, float(j2), float(j1)).to(Sn_b.dtype)
    L2, bad2t = safe_chol(Sn_b + jm[:, None, None] * eye)
    L = torch.where(bad1[:, None, None], L2, L1)
    bad2 = torch.where(bad1, bad2t, bad1)     # tier 3: the chosen tier failed
    return _trio(Sn_b, torch.where(bad2[:, None, None], eye, L), eye)


def _chol_precond_cuda(Sn, j1, j2):
    """Launch the preconditioner kernel on ``torch.cuda.current_stream()``:
    ``chol_precond_smem_launch`` for orders up to the library's
    ``chol_precond_smem_maxn()``, else ``chol_precond_launch`` with its
    global workspace. Returns ``(U, V, E, tier)``, ``tier`` (B,) int32
    being the factorization tier each walker ended on (1, 2 or 3)."""
    B, n = Sn.shape[0], Sn.shape[-1]
    check(Sn, "Sn", (B, n, n))
    lib = cuda_lib.load_library()
    dev = Sn.device
    # one allocation for the four outputs: the wrapper's host time before
    # the launch is a large part of a call at the gradient path's shape
    bnn = B * n * n
    out = torch.empty(3 * bnn + B, dtype=torch.float32, device=dev)
    U, V, E = out[:3 * bnn].view(3, B, n, n)
    tier = out[3 * bnn:].view(torch.int32)
    smem = n <= int(lib.chol_precond_smem_maxn())
    if not smem:
        ws = torch.empty(int(lib.chol_precond_ws_floats(n)) * B,
                         dtype=torch.float32, device=dev)
    ptrs = (Sn.data_ptr(), U.data_ptr(), V.data_ptr(), E.data_ptr(),
            tier.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if smem:
            rc = lib.chol_precond_smem_launch(*ptrs, B, n, float(j1),
                                              float(j2), stream)
        else:
            rc = lib.chol_precond_launch(*ptrs, ws.data_ptr(), B, n,
                                         float(j1), float(j2), stream)
    launch_check(rc, "chol_precond")
    record_launch("chol_precond", "smem" if smem else "global")
    return U, V, E, tier


class _CholPrecond(torch.autograd.Function):
    """Forward: the kernel (CUDA) or :func:`_fused_torch`; backward: the
    vector-Jacobian product of :func:`_fused_torch_ad` at the saved input
    (``_chol_precond_fwd``/``_chol_precond_bwd`` of the reference)."""

    @staticmethod
    def forward(ctx, Sn32, j1, j2):
        ctx.save_for_backward(Sn32)
        ctx.jitters = (j1, j2)
        path = route("chol_precond", Sn32.shape[-1] <= _PALLAS_MAX_N,
                     Sn32.device)
        if path == "kernel":
            return _chol_precond_cuda(Sn32.contiguous(), j1, j2)[:3]
        return _fused_torch(Sn32, j1, j2)

    @staticmethod
    def backward(ctx, gU, gV, gE):
        Sn32, = ctx.saved_tensors
        with torch.enable_grad():
            s = Sn32.detach().requires_grad_(True)
            out = _fused_torch_ad(s, *ctx.jitters)
            gS, = torch.autograd.grad(out, s, (gU, gV, gE))
        return gS, None, None


def jitter_bit_plain(Sn32, U, j1):
    """The reference's health rule on the fused branch
    (``enterprise_warp_tpu/ops/kernel.py``): a walker engaged a jittered
    tier when tier 1's factor of ``Sn32 + j1 I`` fails, or when ``U`` is
    the identity (tier 3). (B,) bool."""
    from .kernel import _all_finite, cholesky_nan
    eye = torch.eye(Sn32.shape[-1], dtype=Sn32.dtype, device=Sn32.device)
    bad1 = ~_all_finite(cholesky_nan(Sn32 + float(j1) * eye))
    return bad1 | torch.all(torch.all(U == eye, dim=-1), dim=-1)


def chol_precond_health(Sn32, j1, j2):
    """:func:`chol_precond` for the health plane (no autograd):
    ``(U, V, E, jitter_bit)``, ``jitter_bit`` (B,) bool set where a walker
    needed a jittered tier. On the kernel route the bit is the kernel's
    own tier (2 or 3); on the plain version it is
    :func:`jitter_bit_plain`, the reference's rule (the two agree: tier 2
    or 3 is exactly a failed tier-1 factor)."""
    path = route("chol_precond", Sn32.shape[-1] <= _PALLAS_MAX_N,
                 Sn32.device)
    if path == "kernel":
        U, V, E, tier = _chol_precond_cuda(Sn32.contiguous(), j1, j2)
        return U, V, E, tier >= 2
    U, V, E = _fused_torch(Sn32, j1, j2)
    return U, V, E, jitter_bit_plain(Sn32, U, j1)


def chol_precond(Sn32, j1, j2):
    """Three-tier float32 preconditioner factorization of a batch of
    equilibrated casts ``Sn32`` (B, n, n): ``(U, V, E)`` as in
    :func:`_fused_torch`. One CUDA launch for CUDA tensors whose order
    fits the cap; differentiable (see :class:`_CholPrecond`)."""
    return _CholPrecond.apply(Sn32, float(j1), float(j2))
