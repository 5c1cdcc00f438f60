"""Parity of the port's fused preconditioner (``ops/cholfuse.py``) with the
JAX package.

On the CPU ``chol_precond`` runs its kernel's plain PyTorch version
(``_fused_torch``); its backward differentiates the AD-safe twin
(``_fused_torch_ad``). They are held against the JAX package:

- ``_fused_torch`` against the Pallas kernel ``_pallas_fused_raw`` in
  interpret mode on the 12 x 80 fixture of ``tests/test_cholfuse.py``
  and at the orders on either side of the CUDA kernel's splits (a warp
  of columns, its 64-wide product tiles, the shared-memory cap), each
  with one tier-3 walker: U atol 2e-5, V 2e-4, E 2e-5, the reference's
  own kernel-vs-twin limits;
- the tier-2 rescue fixture against ``_fused_xla`` and the interpret
  kernel, with the rescue itself checked in float64;
- at the gradient path's shape, 64 walkers x n = 60, on the equilibrated
  Sigma the classic chain hands the op for ``hmc_single_psr.dat --num 0``
  near typical points, against ``_fused_xla``;
- the vector-Jacobian product against ``jax.vjp`` of JAX ``chol_precond``
  under ``vmap`` with the same cotangents on a clean / tier-2 / tier-3
  batch: all finite, the clean walker within rtol 1e-4 / atol 1e-6 (the
  JAX test's own limit);
- the classic chain's fused branch of ``_mixed_psd_solve_logdet`` against
  JAX's ``fused=True``: ``Z`` rtol 1e-9, the logdet abs 1e-5 (the limits
  ``tests/test_cholfuse.py`` holds the fused branch to against the
  unfused one);
- the wrapper's routing between the kernel's two designs (the walker in
  shared memory up to the cap, with no workspace; the global-memory
  kernel above it), through a fake library.
"""

import contextlib
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.ops import cholfuse as jcf
from enterprise_warp_tpu.ops.kernel import \
    _mixed_psd_solve_logdet as j_mixed
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init
from enterprise_warp_tpu_torch.ops import cholfuse as tcf
from enterprise_warp_tpu_torch.ops import cuda_lib
from enterprise_warp_tpu_torch.ops import routes as troutes
from enterprise_warp_tpu_torch.ops.kernel import \
    _mixed_psd_solve_logdet as t_mixed

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HMC_PRFILE = os.path.join(REPO, "examples", "example_params",
                          "hmc_single_psr.dat")
# the order up to which the CUDA wrapper takes the shared-memory design,
# as the kernel source sets it
SMEM_MAXN = int(re.search(
    r"constexpr int PRECOND_SMEM_MAXN = (\d+);",
    open(os.path.join(REPO, "enterprise_warp_tpu_torch", "ops", "csrc",
                      "megakernel.cu")).read()).group(1))


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    """Routes read ``EWT_PALLAS``/``EWT_PALLAS_CHOL``/``EWT_FUSED_CHOL``;
    an in-process demotion elsewhere in the suite may have left an
    opt-out set, so each test here starts without them."""
    for var in ("EWT_PALLAS", "EWT_PALLAS_MEGA", "EWT_PALLAS_CHOL",
                "EWT_FUSED_CHOL"):
        monkeypatch.delenv(var, raising=False)


def _spd_batch(B, n, seed=0):
    """Unit-diagonal SPD float32 batch (``tests/test_cholfuse.py``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(B):
        A = rng.standard_normal((n, n))
        S = A @ A.T / n + np.eye(n) * (0.5 + 0.1 * i)
        d = np.sqrt(np.diag(S))
        out.append((S / d[:, None] / d[None, :]).astype(np.float32))
    return np.stack(out)


def _tier2_matrix(n, seed):
    """Indefinite at j1 = 1e-6 (minimum eigenvalue -5e-5), PD at 1e-3."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.5, 1.5, n)
    ev[0] = -5e-5
    return (Q * ev) @ Q.T


def _port(Sb, j1, j2):
    U, V, E = tcf.chol_precond(torch.as_tensor(Sb), j1, j2)
    return U.numpy(), V.numpy(), E.numpy()


def _assert_trio(port, ref, atol=(2e-5, 2e-4, 2e-5), rtol=1e-7):
    for name, a, b, tol in zip("UVE", port, ref, atol):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=tol,
                                   err_msg=name)


# (n, B, seed, the tier-3 walker): the reference test's 12 x 80 fixture,
# and the orders on either side of the CUDA kernel's splits (a warp of
# columns, two warps, its product tiles of 64, the shared-memory cap)
_INTERPRET_CASES = [(80, 12, 7, 5)] + [
    (n, 3, n, 2) for n in (1, 32, 33, 64, 65, SMEM_MAXN, SMEM_MAXN + 1)]


@pytest.mark.parametrize("n,B,seed,bad", _INTERPRET_CASES,
                         ids=[str(c[0]) for c in _INTERPRET_CASES])
def test_matches_interpret_kernel_with_tier3_walker(n, B, seed, bad):
    Sb = _spd_batch(B, n, seed=seed)
    Sb[bad] = Sb[bad] - 1.2 * np.eye(n, dtype=np.float32)     # tier 3
    ref = jcf._pallas_fused_raw(jnp.asarray(Sb), 3e-6, 9e-5, interpret=True)
    troutes.reset_counts()
    port = _port(Sb, 3e-6, 9e-5)
    assert troutes.ROUTES[("chol_precond", "plain-cpu")] == 1
    assert troutes.LAUNCHES["chol_precond"] == 0
    _assert_trio(port, ref)
    np.testing.assert_array_equal(port[0][bad], np.eye(n, dtype=np.float32))
    np.testing.assert_array_equal(port[1][bad], np.eye(n, dtype=np.float32))


def test_tier2_rescue():
    n = 16
    S_mid = _tier2_matrix(n, seed=13)
    Sb = np.stack([_spd_batch(1, n, seed=2)[0], S_mid.astype(np.float32),
                   -np.eye(n, dtype=np.float32)])
    U, V, E = _port(Sb, 1e-6, 1e-3)
    # the rescued walker's cast has condition number ~1.5e3 and V entries
    # up to ~30, so its float32 entries also agree to a relative 1e-4
    _assert_trio((U, V, E), jcf._fused_xla(jnp.asarray(Sb), 1e-6, 1e-3),
                 rtol=1e-4)
    _assert_trio((U[:2], V[:2], E[:2]), jcf._pallas_fused_raw(
        jnp.asarray(Sb[:2]), 1e-6, 1e-3, interpret=True), rtol=1e-4)
    # the tier-2 factor reproduces S_mid + j2 I and is not the identity
    U1 = U[1].astype(np.float64)
    np.testing.assert_allclose(U1.T @ U1, S_mid + 1e-3 * np.eye(n),
                               atol=5e-5)
    assert np.abs(U1 - np.eye(n)).max() > 0.1
    np.testing.assert_array_equal(U[2], np.eye(n, dtype=np.float32))
    np.testing.assert_array_equal(V[2], np.eye(n, dtype=np.float32))


def _capture_hmc_sigma(num, nwalk, seed):
    """The equilibrated float32 Sigma the classic chain hands
    ``chol_precond`` for ``hmc_single_psr.dat --num num`` at ``nwalk``
    points near typical noise values (efac 1, equad -7, log10_A -13.5,
    gamma 3.5; sigma 0.05)."""
    opts = types.SimpleNamespace(num=num, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)
    like = t_init(TParams(HMC_PRFILE, opts=opts), write_pars=False,
                  device="cpu")[0]
    seen = []
    orig = tcf.chol_precond

    def record(Sn32, j1, j2):
        seen.append((Sn32.clone(), j1, j2))
        return orig(Sn32, j1, j2)

    tcf.chol_precond = record
    try:
        like.loglike_batch(typical_points(like, nwalk, seed))
    finally:
        tcf.chol_precond = orig
    assert len(seen) == 1
    return seen[0]


def typical_points(like, n, seed):
    base = []
    for p in like.params:
        name = p.name
        base.append(1.0 if name.endswith("efac") else
                    -7.0 if "equad" in name else
                    -13.5 if name.endswith("log10_A") else 3.5)
    rng = np.random.default_rng(seed)
    return np.asarray(base) + 0.05 * rng.standard_normal((n, like.ndim))


def test_slice_shape_against_xla_twin():
    Sn, j1, j2 = _capture_hmc_sigma(0, 64, seed=3)
    assert tuple(Sn.shape) == (64, 60, 60) and Sn.dtype == torch.float32
    assert (j1, j2) == (3e-6, pytest.approx(9e-5))
    _assert_trio(_port(Sn.numpy(), j1, j2),
                 jcf._fused_xla(jnp.asarray(Sn.numpy()), j1, j2))


def test_vjp_matches_jax_on_three_tiers():
    n = 16
    Sb = np.stack([_spd_batch(1, n, seed=2)[0],
                   _tier2_matrix(n, seed=21).astype(np.float32),
                   -np.eye(n, dtype=np.float32)])
    rng = np.random.default_rng(4)
    cts = [rng.standard_normal(Sb.shape).astype(np.float32)
           for _ in range(3)]
    _, vjp = jax.vjp(lambda s: jax.vmap(
        lambda m: jcf.chol_precond(m, 1e-6, 1e-3))(s), jnp.asarray(Sb))
    gj, = vjp(tuple(jnp.asarray(c) for c in cts))
    S = torch.as_tensor(Sb).requires_grad_(True)
    out = tcf.chol_precond(S, 1e-6, 1e-3)
    gt, = torch.autograd.grad(out, S, tuple(map(torch.as_tensor, cts)))
    gt, gj = gt.numpy(), np.asarray(gj)
    assert np.isfinite(gt).all()
    np.testing.assert_allclose(gt[0], gj[0], rtol=1e-4, atol=1e-6)
    # tier 3 is the identity: the cotangent reaches Sn through E alone
    np.testing.assert_allclose(gt[2], cts[2][2], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gt[2], gj[2], rtol=1e-6, atol=1e-6)


def test_fused_mixed_solve_matches_jax():
    rng = np.random.default_rng(11)
    n, k, W = 40, 5, 3
    S = np.stack([(lambda A: A @ A.T / n + np.eye(n) * (2.0 + i))(
        rng.standard_normal((n, n))) for i in range(W)])
    Bm = rng.standard_normal((W, n, k))
    Zj, ldj = jax.vmap(lambda s, b: j_mixed(
        s, b, 3e-6, refine=3, delta_mode="split", fused=True))(
            jnp.asarray(S), jnp.asarray(Bm))
    troutes.reset_counts()
    Zt, ldt = t_mixed(torch.as_tensor(S), torch.as_tensor(Bm), 3e-6,
                      refine=3, delta_mode="split")
    # fused=None resolves to the fused branch, as in the reference
    assert troutes.ROUTES[("chol_precond", "plain-cpu")] == 1
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), rtol=1e-9,
                               atol=1e-12)
    # the logdet carries the float32 factor's last bits (LAPACK and XLA
    # factor in different orders): the reference's own fused-vs-unfused
    # limit, abs 1e-5 (tests/test_cholfuse.py)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(Zt.numpy(), np.linalg.solve(S, Bm),
                               rtol=1e-7, atol=1e-10)


def test_switches(monkeypatch):
    cuda = torch.device("cuda")
    troutes.reset_counts()
    assert troutes.route("chol_precond", True, cuda) == "kernel"
    # the master switch and the kernel's own switch turn it off ...
    for var in ("EWT_PALLAS", "EWT_PALLAS_CHOL"):
        monkeypatch.setenv(var, "0")
        assert troutes.route("chol_precond", True, cuda) == "disabled"
        monkeypatch.delenv(var)
    # ... the megakernels' switch does not, and is not turned off by it
    monkeypatch.setenv("EWT_PALLAS_MEGA", "0")
    assert troutes.route("chol_precond", True, cuda) == "kernel"
    assert troutes.route("mega_solve", True, cuda) == "disabled"
    monkeypatch.delenv("EWT_PALLAS_MEGA")
    monkeypatch.setenv("EWT_PALLAS_CHOL", "0")
    assert troutes.route("mega_like", True, cuda) == "kernel"
    assert troutes.route("chol_precond", False, cuda) == "disabled"
    monkeypatch.delenv("EWT_PALLAS_CHOL")
    assert troutes.route("chol_precond", False, cuda) == "over-cap"
    assert troutes.ROUTES[("chol_precond", "disabled")] == 3
    # EWT_FUSED_CHOL=0 takes the unfused branch: no chol_precond route
    monkeypatch.setenv("EWT_FUSED_CHOL", "0")
    troutes.reset_counts()
    S = _spd_batch(2, 12, seed=1).astype(np.float64)
    t_mixed(torch.as_tensor(S), torch.ones(2, 12, 1, dtype=torch.float64),
            3e-6, delta_mode="split")
    assert ("chol_precond", "plain-cpu") not in troutes.ROUTES


# ---- the wrapper's two designs, through a fake library ---------------- #

class _FakePrecondLib:
    """Records the preconditioner's C calls; the cap and the workspace
    size as the CUDA source gives them; every launch returns ``rc``."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def chol_precond_smem_maxn(self):
        return SMEM_MAXN

    def chol_precond_ws_floats(self, n):
        self.calls.append(("chol_precond_ws_floats", (n,)))
        return n * n

    def chol_precond_smem_launch(self, *args):
        self.calls.append(("chol_precond_smem_launch", args))
        return self.rc

    def chol_precond_launch(self, *args):
        self.calls.append(("chol_precond_launch", args))
        return self.rc


def _fake_cuda(monkeypatch, lib, stream=7):
    """Route ``_chol_precond_cuda`` to ``lib`` on CPU tensors: the
    library, the device context, the current stream and the device
    check."""
    monkeypatch.setattr(cuda_lib, "load_library", lambda name="": lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(
                            cuda_stream=stream))

    def check(t, name, shape):
        assert t.dtype == torch.float32 and tuple(t.shape) == tuple(shape)
    monkeypatch.setattr(tcf, "check", check)


@pytest.mark.parametrize("n", [1, 60, SMEM_MAXN, SMEM_MAXN + 1, 448])
def test_wrapper_routes_by_order(monkeypatch, n):
    B = 3
    S = torch.zeros(B, n, n)
    lib = _FakePrecondLib()
    _fake_cuda(monkeypatch, lib)
    troutes.reset_counts()
    U, V, E, tier = tcf._chol_precond_cuda(S, 3e-6, 9e-5)
    assert [t.shape for t in (U, V, E)] == [(B, n, n)] * 3
    assert tier.shape == (B,) and tier.dtype == torch.int32
    out = (S.data_ptr(), U.data_ptr(), V.data_ptr(), E.data_ptr(),
           tier.data_ptr())
    assert troutes.LAUNCHES["chol_precond"] == 1
    if n <= SMEM_MAXN:
        # the walker lives in shared memory: no workspace is sized
        assert lib.calls == [("chol_precond_smem_launch",
                              out + (B, n, 3e-6, 9e-5, 7))]
        assert troutes.DESIGNS == {("chol_precond", "smem"): 1}
    else:
        (ws_call, ws_args), (call, args) = lib.calls
        assert (ws_call, ws_args) == ("chol_precond_ws_floats", (n,))
        assert call == "chol_precond_launch"
        assert args[:5] == out and args[6:] == (B, n, 3e-6, 9e-5, 7)
        assert troutes.DESIGNS == {("chol_precond", "global"): 1}


def test_kernel_route_outputs_back_propagate(monkeypatch):
    # the wrapper's four outputs share one allocation; through the
    # autograd Function they differentiate as the plain version's do
    lib = _FakePrecondLib()
    _fake_cuda(monkeypatch, lib)
    monkeypatch.setattr(tcf, "route", lambda kernel, fits, device: "kernel")
    B, n = 3, 9
    S = torch.as_tensor(_spd_batch(B, n, seed=1)).requires_grad_(True)
    U, V, E = tcf.chol_precond(S, 3e-6, 9e-5)
    assert [c for c, _ in lib.calls] == ["chol_precond_smem_launch"]
    assert V.data_ptr() == U.data_ptr() + 4 * B * n * n
    assert E.data_ptr() == V.data_ptr() + 4 * B * n * n
    rng = np.random.default_rng(2)
    cts = [torch.as_tensor(rng.standard_normal((B, n, n)).astype(np.float32))
           for _ in range(3)]
    g, = torch.autograd.grad((U, V, E), S, cts)
    ref, = torch.autograd.grad(tcf._fused_torch_ad(S, 3e-6, 9e-5), S, cts)
    np.testing.assert_array_equal(g.numpy(), ref.numpy())


@pytest.mark.parametrize("n", [60, SMEM_MAXN + 1])
def test_wrapper_raises_on_a_failed_launch(monkeypatch, n):
    lib = _FakePrecondLib(rc=700)
    _fake_cuda(monkeypatch, lib)
    troutes.reset_counts()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tcf._chol_precond_cuda(torch.zeros(2, n, n), 3e-6, 9e-5)
    # one launch tried, none counted, and no other design taken
    assert len([c for c, _ in lib.calls if c.endswith("_launch")]) == 1
    assert troutes.LAUNCHES["chol_precond"] == 0 and not troutes.DESIGNS


# ---- on the card: kernel vs plain version on CUDA tensors ------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these checks "
                    "on the card)")
    return torch.device("cuda")


def test_cuda_chol_kernel_matches_plain(cuda):
    n = 60
    Sb = _spd_batch(64, n, seed=5)
    Sb[7] = Sb[7] - 1.2 * np.eye(n, dtype=np.float32)     # tier 3
    S = torch.as_tensor(Sb, device=cuda)
    n0 = troutes.LAUNCHES["chol_precond"]
    U, V, E = tcf.chol_precond(S, 3e-6, 9e-5)
    torch.cuda.synchronize()
    assert troutes.LAUNCHES["chol_precond"] == n0 + 1
    _assert_trio(tuple(t.cpu().numpy() for t in (U, V, E)),
                 tuple(t.cpu().numpy()
                       for t in tcf._fused_torch(S, 3e-6, 9e-5)))


@pytest.mark.parametrize("n", [1, 17, 33, 60, 64, 65, 97, SMEM_MAXN])
def test_cuda_smem_kernel_matches_global_kernel(cuda, n):
    # U and V bit for bit chol_precond_kernel's (the same operations in
    # the same order); E within the reference's limits of the plain
    # version (D's float64 sum changes its last bits), and, per walker,
    # within 1e-4 of its largest |E| (+ 1e-12) of V^T (Sn - U^T U) V
    # formed in float64 from the kernel's own U and V: only the float32
    # products' rounding is left, where D summed in float32 would leave
    # about 1e-2
    B = 5
    Sb = _spd_batch(B, n, seed=n)
    Sb[3] = Sb[3] - 1.2 * np.eye(n, dtype=np.float32)     # tier 3
    S = torch.as_tensor(Sb, device=cuda)
    lib = cuda_lib.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for name in ("chol_precond_smem_launch", "chol_precond_launch"):
        U, V, E = (torch.empty(B, n, n, device=cuda) for _ in range(3))
        tier = torch.empty(B, dtype=torch.int32, device=cuda)
        ws = torch.empty(B * n * n, device=cuda)
        args = [S.data_ptr(), U.data_ptr(), V.data_ptr(), E.data_ptr(),
                tier.data_ptr()]
        if name == "chol_precond_launch":
            args.append(ws.data_ptr())
        assert getattr(lib, name)(*args, B, n, 3e-6, 9e-5, stream) == 0
        outs.append((U, V, E, tier))
    torch.cuda.synchronize()
    (Un, Vn, En, tn), (Uo, Vo, Eo, to) = outs
    assert torch.equal(Un, Uo) and torch.equal(Vn, Vo)
    assert torch.equal(tn, to) and tn.tolist() == [1, 1, 1, 3, 1]
    _assert_trio(tuple(t.cpu().numpy() for t in (Un, Vn, En)),
                 tuple(t.cpu().numpy()
                       for t in tcf._fused_torch(S, 3e-6, 9e-5)))
    S64, U64, V64 = (t.double() for t in (S, Un, Vn))
    E64 = V64.mT @ (S64 - U64.mT @ U64) @ V64
    err = (En.double() - E64).abs().amax((-2, -1))
    assert bool((err <= 1e-4 * E64.abs().amax((-2, -1)) + 1e-12).all()), \
        err.tolist()
