"""Parity of the port's likelihood megakernels with the JAX package.

On the CPU the port's wrappers run each kernel's plain PyTorch version
(``_mega_solve_torch``, ``_mega_like_torch``); these are held against the
JAX Pallas kernels in interpret mode at small sizes and against their XLA
twins (``_mega_solve_xla``, ``_mega_like_xla``) at the slice's shapes:

- the solve kernel on the ``_spd_batch`` fixture (n 40, B 5, k 4):
  atol 2e-5, the reference's own kernel-vs-twin tolerance;
- the three-tier and odd-batch fixtures: rtol/atol 2e-4;
- a right-hand side wider than the CUDA refine phase's 8-column panel,
  (4, 20, 20) with k = 44, against the interpret-mode kernel and the XLA
  twin: atol 5e-4; and the divergence guard, which keeps or reverts a
  walker's whole Z on its residual summed over all columns (a fixture
  whose refinement diverges in one panel only): against the XLA twin
  within 1e-5 and against float64 refinement arithmetic;
- 16 x 250 x 4 (the ``--num 0`` solve shape) against the XLA twin;
- the likelihood kernel at nb 24 / ntoa 96 (interpret) and 122 x 120
  (the ``--num 1`` shape, XLA twin);
- end to end, ``--num 1`` near the injected noise: the port's mega route
  against JAX ``marginalized_loglike(..., mega="interpret")``, rtol 1e-3,
  atol 5e-2 (the reference's documented megakernel class);
- gradients: both entry points are autograd Functions whose backward
  re-derives through plain PyTorch, as the reference's ``custom_vjp``s
  do. The gradient of ``mega_marginalized_loglike`` with respect to
  ``nw`` and ``b`` (nb 24, ntoa 96) against ``jax.grad`` of JAX
  ``marginalized_loglike(..., mega="interpret")``, and the
  vector-Jacobian product of ``mega_solve_logdet`` against ``jax.vjp``
  of JAX ``mega_solve_logdet(..., interpret=True)``:
  |dg| <= 1e-3 max(1, |g|).

Float32 arithmetic in two frameworks sums in different orders, so the
agreement is the float32 class, not bitwise. The CUDA checks at the end
need a card and skip without one; ``chip_smoke.py`` is what holds the
kernels against these plain versions on the card.
"""

import ctypes
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.ops import megakernel as jmk
from enterprise_warp_tpu.ops.kernel import \
    marginalized_loglike as j_marginalized_loglike
from enterprise_warp_tpu.samplers.evalproto import eval_protocol
from enterprise_warp_tpu_torch.ops import cuda_lib
from enterprise_warp_tpu_torch.ops import megakernel as tmk
from enterprise_warp_tpu_torch.ops import routes as troutes
from enterprise_warp_tpu_torch.ops.kernel import \
    marginalized_loglike as t_marginalized_loglike

from test_torch_kernel import _likes, _three_tier_fixture, near_truth
from test_torch_models import _jax_nw_phi, _opts

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    """The route decisions read ``EWT_PALLAS``/``EWT_PALLAS_MEGA``; an
    in-process demotion elsewhere in the suite may have left the opt-out
    set, so each test here starts without it."""
    monkeypatch.delenv("EWT_PALLAS", raising=False)
    monkeypatch.delenv("EWT_PALLAS_MEGA", raising=False)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRFILE = os.path.join(REPO, "examples", "example_params", "system_noise.dat")


def _spd_batch(B, n, seed=0, scale=1.0):
    """Unit-diagonal SPD float32 batch (``tests/test_megakernel.py``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(B):
        A = rng.standard_normal((n, n))
        S = A @ A.T / n + np.eye(n) * (0.5 + 0.1 * i) * scale
        d = np.sqrt(np.diag(S))
        out.append((S / d[:, None] / d[None, :]).astype(np.float32))
    return np.stack(out)


def _t(a):
    return torch.as_tensor(np.array(a))


def _solve_both(Sn, Bn, j1, j2, refine, interpret=True):
    if interpret:
        Zj, ldj = jmk._mega_solve_raw(jnp.asarray(Sn), jnp.asarray(Bn), j1,
                                      j2, refine, interpret=True)
    else:
        Zj, ldj = jmk._mega_solve_xla(jnp.asarray(Sn), jnp.asarray(Bn), j1,
                                      j2, refine)
    Zt, ldt = tmk.mega_solve_logdet(_t(Sn), _t(Bn), j1, j2, refine)
    assert Zt.dtype == torch.float32 and ldt.dtype == torch.float32
    return (np.asarray(Zj), np.asarray(ldj)), (Zt.numpy(), ldt.numpy())


def test_solve_matches_interpret_kernel():
    n, B, k = 40, 5, 4
    Sn = _spd_batch(B, n, seed=1)
    Bn = np.random.default_rng(1).standard_normal((B, n, k)).astype(
        np.float32)
    troutes.reset_counts()
    (Zj, ldj), (Zt, ldt) = _solve_both(Sn, Bn, 3e-6, 9e-5, 3)
    assert troutes.ROUTES[("mega_solve", "plain-cpu")] == 1
    assert troutes.LAUNCHES["mega_solve"] == 0
    np.testing.assert_allclose(Zt, Zj, atol=2e-5)
    np.testing.assert_allclose(ldt, ldj, atol=2e-5)


def test_solve_three_tier_semantics():
    S, B = _three_tier_fixture()
    S = (S / np.array([1.0, 3.0, 2.0])[:, None, None]).astype(np.float32)
    B = B.astype(np.float32)
    (Zj, ldj), (Zt, ldt) = _solve_both(S, B, 1e-6, 1e-3, 2)
    assert np.isfinite(Zt).all() and np.isfinite(ldt).all()
    np.testing.assert_allclose(Zt, Zj, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ldt, ldj, rtol=2e-4, atol=2e-4)


def test_solve_odd_batch():
    n = 24
    Sn = _spd_batch(3, n, seed=8)
    Bn = np.random.default_rng(8).standard_normal((3, n, 1)).astype(
        np.float32)
    (Zj, ldj), (Zt, ldt) = _solve_both(Sn, Bn, 1e-6, 3e-5, 2)
    assert Zt.shape == (3, n, 1) and ldt.shape == (3,)
    np.testing.assert_allclose(Zt, Zj, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ldt, ldj, rtol=2e-4, atol=2e-4)
    Zx = np.linalg.solve(Sn.astype(np.float64), Bn.astype(np.float64))
    np.testing.assert_allclose(Zt, Zx, atol=1e-4)


def test_solve_slice_shape_against_xla_twin():
    # the --num 0 solve: 16 walkers, n = 250, k = ntm + 1 = 4
    Sn = _spd_batch(16, 250, seed=11)
    Bn = np.random.default_rng(11).standard_normal((16, 250, 4)).astype(
        np.float32)
    (Zj, ldj), (Zt, ldt) = _solve_both(Sn, Bn, 3e-6, 9e-5, 3,
                                       interpret=False)
    np.testing.assert_allclose(Zt, Zj, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ldt, ldj, rtol=2e-4, atol=2e-4)


RAGGED_N = (1, 17, 63, 65, 250, 448)
RAGGED_B = (1, 3, 8)


def _ragged_inputs(B, n, seed):
    Sn = _spd_batch(B, n, seed=seed)
    Bn = np.random.default_rng(seed).standard_normal((B, n, 4)).astype(
        np.float32)
    return Sn, Bn


@pytest.mark.parametrize("B", RAGGED_B)
@pytest.mark.parametrize("n", RAGGED_N)
def test_solve_ragged_shapes(n, B):
    # orders off the kernels' 64-wide product tiles and 32-wide inverse
    # tiles, up to the cap: the interpret-mode kernel where it is quick,
    # the XLA twin above
    Sn, Bn = _ragged_inputs(B, n, seed=n + B)
    interpret = n <= 65
    (Zj, ldj), (Zt, ldt) = _solve_both(Sn, Bn, 3e-6, 9e-5, 3,
                                       interpret=interpret)
    assert Zt.shape == (B, n, 4) and ldt.shape == (B,)
    tol = dict(atol=2e-5) if interpret else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(Zt, Zj, **tol)
    np.testing.assert_allclose(ldt, ldj, **tol)


# ---- right-hand sides wider than the kernel's 8-column panel ---------- #

# the reference probe's tolerance on Z and ld (ops/megakernel.py:823-827)
WIDE_ATOL = 5e-4


@pytest.mark.parametrize("interpret", [True, False],
                         ids=["interpret", "xla"])
def test_solve_wide_rhs_matches_jax(interpret):
    # k = 44: the 45-pulsar array's stage-1 right-hand side (1 + MW + n_g
    # = 1 + 3 + 40); the CUDA refine phase walks it in six panels
    Sn = _spd_batch(4, 20, seed=21)
    Bn = np.random.default_rng(21).standard_normal((4, 20, 44)).astype(
        np.float32)
    (Zj, ldj), (Zt, ldt) = _solve_both(Sn, Bn, 3e-6, 9e-5, 3,
                                       interpret=interpret)
    assert Zt.shape == (4, 20, 44)
    np.testing.assert_allclose(Zt, Zj, atol=WIDE_ATOL)
    np.testing.assert_allclose(ldt, ldj, atol=WIDE_ATOL)


def _guard_fixture(n=20, k=16):
    """Two walkers on the identity preconditioner (tier 3: Sn has the
    eigenvalue -0.3, so both jittered factors fail), whose refinement
    converges on columns 0-7 (the stable eigenvectors only) and diverges
    on columns 8-15 (a component along the unstable one). Walker 0: the
    residual summed over all columns falls, so the guard keeps the
    refined Z everywhere, the diverged panel included; walker 1: it
    rises, so the guard reverts to Z0 everywhere, the converged panel
    included. A guard taken panel by panel would split both walkers."""
    rng = np.random.default_rng(29)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.6, 1.4, n)
    ev[0] = -0.3
    S = (Q * ev) @ Q.T

    def cols(amp_stable, amp_unstable, m):
        c = rng.standard_normal((n, m)) * amp_stable
        c[0] = amp_unstable * rng.choice([-1.0, 1.0], m)
        return Q @ c
    keep = np.concatenate([cols(1.0, 0.0, 8), cols(0.02, 0.1, k - 8)], 1)
    revert = np.concatenate([cols(0.02, 0.0, 8), cols(0.02, 0.1, k - 8)], 1)
    return (np.stack([S, S]).astype(np.float32),
            np.stack([keep, revert]).astype(np.float32))


def test_solve_guard_is_per_walker_over_all_columns():
    Sn, Bn = _guard_fixture()
    refine = 3
    (Zj, ldj), (Zt, ldt) = _solve_both(Sn, Bn, 1e-6, 1e-3, refine,
                                       interpret=False)
    np.testing.assert_allclose(Zt, Zj, atol=1e-5)
    np.testing.assert_allclose(ldt, ldj, atol=1e-5)
    S, B = Sn.astype(np.float64), Bn.astype(np.float64)
    Z = B.copy()                           # Z0 = B on the identity tier
    for _ in range(refine):
        Z = Z + (B - S @ Z)
    r0, rf = B - S @ B, B - S @ Z
    panels = (slice(0, 8), slice(8, 16))
    for b, kept in ((0, True), (1, False)):
        pre = [float(np.sum(r0[b, :, p] ** 2)) for p in panels]
        ref = [float(np.sum(rf[b, :, p] ** 2)) for p in panels]
        # panel 1 converges and panel 2 diverges on both walkers
        assert ref[0] < pre[0] and ref[1] > pre[1]
        assert (sum(ref) <= sum(pre)) == kept
        np.testing.assert_allclose(Zt[b], Z[b] if kept else B[b], atol=1e-4)


class _FakeLib:
    """Records the solve pipeline's C calls in order."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


def test_solve_phases_launch_in_order():
    B, n, k = 3, 17, 4
    Sn, Bn = torch.zeros(B, n, n), torch.zeros(B, n, k)
    bufs = (torch.zeros(B, n, k), torch.zeros(B), torch.zeros(B),
            torch.zeros(8))
    lib = _FakeLib()
    phases = tmk._mega_solve_phases(lib, Sn, Bn, bufs, 3e-6, 9e-5, 2, 7)
    assert [name for name, _ in phases] == (
        ["factor", "inverse", "refine"]
        + [f"product {p}" for p in tmk.SOLVE_PRODUCTS] + ["logdet"])
    assert lib.calls == []
    assert all(launch() == 0 for _, launch in phases)
    names = [c for c, _ in lib.calls]
    assert names == (["mega_solve_factor_launch", "mega_solve_inverse_launch",
                      "mega_solve_refine_launch"]
                     + ["mega_solve_product_launch"] * 4
                     + ["mega_solve_logdet_launch"])
    ws = bufs[3].data_ptr()
    # every phase works on the one workspace, at (B, n, k), on the stream
    for _, args in lib.calls:
        assert ws in args and args[-1] == 7
        assert args[args.index(ws) + 1:args.index(ws) + 4] == (B, n, k)
    assert [args[-2] for c, args in lib.calls
            if c == "mega_solve_product_launch"] == [0, 1, 2, 3]
    assert lib.calls[0][1][-3:-1] == (3e-6, 9e-5)
    assert lib.calls[2][1][-2] == 2


CSRC = os.path.join(REPO, "enterprise_warp_tpu_torch", "ops", "csrc",
                    "megakernel.cu")
_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _c_entry_points():
    """``{name: (argtypes, restype)}`` of every function the CUDA source
    exports (its ``extern "C"`` block), read from the declarations."""
    src = open(CSRC).read()
    block = src[src.index('extern "C" {'):]
    out = {}
    for ret, name, params in re.findall(
            r"^(int|long long) (\w+)\(([^)]*)\)\s*\{", block, re.M):
        args = [a.strip() for a in params.split(",") if a.strip()]
        out[name] = ([ctypes.c_void_p if "*" in a else
                      _C_TYPES[a.rsplit(" ", 1)[0].replace("const ", "")]
                      for a in args],
                     ctypes.c_int if ret == "int" else ctypes.c_longlong)
    return out


def test_signature_table_lists_every_entry_point():
    exported = _c_entry_points()
    new = ("mega_like_launch", "mega_like_gram_launch",
           "mega_like_factor_launch", "mega_like_factor_threads",
           "mega_like_single_block_launch",
           "mega_like_gram_single_block_launch", "mega_like_ws_floats",
           "mega_like_single_block_ws_floats", "chol_precond_smem_maxn",
           "chol_precond_smem_launch", "chol_precond_smem_phases_launch")
    assert set(new) <= set(exported)
    # every exported function is bound, with its C argument and return
    # types (a pointer or the stream as c_void_p, else ctypes passes a
    # 32-bit int and cuts it)
    assert exported == cuda_lib._SIGNATURES


class _FakeLikeLib(_FakeLib):
    """The likelihood pipeline's C calls, recorded; the workspace sizes
    as the CUDA source computes them."""

    def mega_solve_ws_floats(self, n, k):
        return 5 * n * n + 5 * n * k

    def mega_like_ws_floats(self, *args):
        self.calls.append(("mega_like_ws_floats", args))
        nb, k = args
        return self.mega_solve_ws_floats(nb, k) + nb * nb


def test_like_workspace_has_no_ss_slot():
    B, nb, k = 3, 17, 4
    lib = _FakeLikeLib()
    Z, ld, tier, ws, Sn = tmk._mega_like_buffers(lib, torch.zeros(B, nb, k))
    # sized from (nb, k) alone: the (ntoa, nb) Ss slot of the single-launch
    # design is gone
    assert lib.calls == [("mega_like_ws_floats", (nb, k))]
    sw = lib.mega_solve_ws_floats(nb, k)
    assert ws.numel() == B * (sw + nb * nb)
    assert (Z.shape, ld.shape, tier.shape) == ((B, nb, k), (B,), (B,))
    assert tier.dtype == torch.int32
    # Sn is the (B, nb, nb) tail of ws, after every walker's solve slots,
    # where mega_like_launch writes it
    assert Sn.shape == (B, nb, nb) and Sn.is_contiguous()
    assert Sn.data_ptr() == ws.data_ptr() + 4 * B * sw
    assert Sn.data_ptr() + 4 * Sn.numel() == ws.data_ptr() + 4 * ws.numel()


def _fake_cuda(monkeypatch, lib, stream=7):
    """Route ``_mega_like_cuda`` to ``lib`` on CPU tensors: the library,
    the device context, the current stream and the device test."""
    import contextlib
    monkeypatch.setattr(cuda_lib, "load_library", lambda name="": lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(
                            cuda_stream=stream))

    def check(t, name, shape):
        assert t.dtype == torch.float32 and tuple(t.shape) == tuple(shape)
    monkeypatch.setattr(tmk, "check", check)


def test_like_wrapper_makes_one_c_call_per_eval(monkeypatch):
    ntoa, nb, B, k = 11, 9, 3, 2
    args = [_t(a) for a in _like_inputs(ntoa, nb, B, k, seed=2)]
    lib = _FakeLikeLib()
    _fake_cuda(monkeypatch, lib)
    n0 = troutes.LAUNCHES["mega_like"]
    for call in range(3):
        Z, ld, tier = tmk._mega_like_cuda(*args, 3e-6, 9e-5, 3)
        assert (Z.shape, ld.shape, tier.shape) == ((B, nb, k), (B,), (B,))
    launches = [a for c, a in lib.calls if c == "mega_like_launch"]
    assert [c for c, _ in lib.calls] == ["mega_like_ws_floats",
                                         "mega_like_launch"] * 3
    assert troutes.LAUNCHES["mega_like"] == n0 + 3
    for a in launches:
        # inputs, the four buffers, the shape, the jitters, refine, and
        # the caller's stream last
        assert a[:5] == tuple(t.data_ptr() for t in args)
        assert a[9:] == (B, ntoa, nb, k, 3e-6, 9e-5, 3, 7)


def test_like_wrapper_raises_on_a_failed_launch(monkeypatch):
    class Failing(_FakeLikeLib):
        def mega_like_launch(self, *args):
            self.calls.append(("mega_like_launch", args))
            return 700
    args = [_t(a) for a in _like_inputs(5, 4, 2, 1, seed=3)]
    _fake_cuda(monkeypatch, Failing())
    n0 = troutes.LAUNCHES["mega_like"]
    with pytest.raises(RuntimeError, match="cudaError 700"):
        tmk._mega_like_cuda(*args, 3e-6, 9e-5, 1)
    assert troutes.LAUNCHES["mega_like"] == n0


def _like_inputs(ntoa, nb, B, k, seed):
    rng = np.random.default_rng(seed)
    S = (rng.standard_normal((ntoa, nb)) / np.sqrt(ntoa)).astype(np.float32)
    w = (1.0 + 0.3 * rng.random((B, ntoa))).astype(np.float32)
    s = (0.8 + 0.4 * rng.random((B, nb))).astype(np.float32)
    ivb = (0.5 + rng.random((B, nb))).astype(np.float32)
    Bn = rng.standard_normal((B, nb, k)).astype(np.float32)
    return S, w, s, ivb, Bn


@pytest.mark.parametrize("ntoa,nb,B,interpret", [
    (96, 24, 3, True), (122, 120, 16, False)], ids=["interpret", "slice"])
def test_like_matches_jax(ntoa, nb, B, interpret):
    args = _like_inputs(ntoa, nb, B, 4, seed=4)
    if interpret:
        Zj, ldj = jmk._mega_like_raw(*map(jnp.asarray, args), 3e-6, 9e-5, 3,
                                     interpret=True)
    else:
        Zj, ldj = jmk._mega_like_xla(*map(jnp.asarray, args), 3e-6, 9e-5, 3)
    troutes.reset_counts()
    Zt, ldt = tmk.mega_like(*map(_t, args), 3e-6, 9e-5, 3)
    assert troutes.ROUTES[("mega_like", "plain-cpu")] == 1
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=2e-4,
                               atol=2e-4)
    # and the Gram it built is the float64 one: Sn Z = Bn
    S, w, s, ivb, Bn = (a.astype(np.float64) for a in args)
    for i in range(B):
        Ss = S * np.sqrt(w[i])[:, None]
        Sn = s[i][:, None] * (Ss.T @ Ss) * s[i][None, :] + np.diag(ivb[i])
        np.testing.assert_allclose(Sn @ Zt[i].numpy().astype(np.float64),
                                   Bn[i], atol=5e-4)


def test_mega_route_end_to_end_num1_near_truth():
    jl, tl = _likes(1, "split")
    jp = JParams(PRFILE, opts=_opts(1))
    theta = near_truth(tl, 16, seed=2)
    nw, phi = _jax_nw_phi(jp, theta)
    c = eval_protocol(jl)[2]
    lnl_j = np.asarray(jax.vmap(lambda a, b: j_marginalized_loglike(
        a, b, c["r"], c["M"], c["T"], mega="interpret"))(
            jnp.asarray(nw), jnp.asarray(phi)))
    st = tl.static
    troutes.reset_counts()
    lnl_t = t_marginalized_loglike(_t(nw), _t(phi), st["r_w"], st["M_w"],
                                   st["T_w"], mega=True).numpy()
    assert troutes.ROUTES[("mega_like", "plain-cpu")] == 1
    assert sum(troutes.LAUNCHES.values()) == 0
    assert np.isfinite(lnl_t).all()
    np.testing.assert_allclose(lnl_t, lnl_j, rtol=1e-3, atol=5e-2)
    # the auto route on CPU tensors declines to the classic chain
    troutes.reset_counts()
    t_marginalized_loglike(_t(nw), _t(phi), st["r_w"], st["M_w"], st["T_w"])
    assert troutes.ROUTES[("mega_like", "plain-cpu")] == 1
    assert troutes.ROUTES[("mega_solve", "plain-cpu")] == 1


def test_routes_and_opt_outs(monkeypatch):
    cpu = torch.device("cpu")
    assert not tmk.mega_like_route(122, 120, cpu)
    # --num 0's basis is wider than the likelihood kernel's cap
    troutes.reset_counts()
    assert not tmk.mega_like_route(334, 250, "cuda")
    assert troutes.ROUTES[("mega_like", "over-cap")] == 1
    monkeypatch.setenv("EWT_PALLAS", "0")
    assert not tmk.mega_solve_route(250, "cuda")
    monkeypatch.setenv("EWT_PALLAS", "1")
    monkeypatch.setenv("EWT_PALLAS_MEGA", "0")
    assert not tmk.mega_like_route(122, 120, "cuda")
    assert troutes.ROUTES[("mega_solve", "disabled")] == 1
    assert troutes.ROUTES[("mega_like", "disabled")] == 1
    monkeypatch.delenv("EWT_PALLAS_MEGA")
    assert tmk.mega_solve_route(250, "cuda")
    assert not tmk.mega_solve_route(449, "cuda")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    Sn = torch.eye(8).expand(2, 8, 8).contiguous()
    with pytest.raises(TypeError):
        tmk._mega_solve_cuda(Sn.double(), torch.zeros(2, 8, 1), 1e-6, 1e-3,
                             1)
    with pytest.raises(ValueError):
        tmk._mega_solve_cuda(Sn, torch.zeros(2, 8, 1), 1e-6, 1e-3, 1)
    with pytest.raises(ValueError):
        troutes.route("mega_solve", True, torch.device("meta"))


def _assert_grad_close(gt, gj):
    gt, gj = np.asarray(gt), np.asarray(gj)
    assert np.isfinite(gt).all()
    assert np.all(np.abs(gt - gj) <= 1e-3 * np.maximum(1.0, np.abs(gj))), \
        np.max(np.abs(gt - gj) / np.maximum(1.0, np.abs(gj)))


def _lnl_inputs(W, ntoa, nb, ntm, seed):
    """Whitened single-pulsar arrays (unit-norm basis and timing-model
    columns, as ``whiten_inputs`` leaves them) and per-walker noise."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((ntoa, nb))
    M = rng.standard_normal((ntoa, ntm))
    T, M = T / np.linalg.norm(T, axis=0), M / np.linalg.norm(M, axis=0)
    r = rng.standard_normal(ntoa)
    nw = 1.0 + 0.3 * rng.random((W, ntoa))
    b = 10.0 ** rng.uniform(-1.0, 1.0, (W, nb))
    return nw, b, r, M, T


def test_mega_lnl_gradient_matches_jax():
    nw, b, r, M, T = _lnl_inputs(4, 96, 24, 3, seed=9)

    def total(nw_, b_):
        return jnp.sum(jax.vmap(lambda a, c: j_marginalized_loglike(
            a, c, jnp.asarray(r), jnp.asarray(M), jnp.asarray(T),
            mega="interpret"))(nw_, b_))

    gj_nw, gj_b = jax.grad(total, argnums=(0, 1))(jnp.asarray(nw),
                                                 jnp.asarray(b))
    nw_t, b_t = _t(nw).requires_grad_(True), _t(b).requires_grad_(True)
    troutes.reset_counts()
    lnl = t_marginalized_loglike(nw_t, b_t, _t(r), _t(M), _t(T), mega=True)
    assert troutes.ROUTES[("mega_like", "plain-cpu")] == 1
    gt_nw, gt_b = torch.autograd.grad(lnl.sum(), (nw_t, b_t))
    # the backward re-derived through the classic chain and its fused
    # preconditioner
    assert troutes.ROUTES[("chol_precond", "plain-cpu")] == 1
    _assert_grad_close(gt_nw, gj_nw)
    _assert_grad_close(gt_b, gj_b)


def test_mega_solve_vjp_matches_jax():
    n, B, k = 40, 5, 4
    Sn = _spd_batch(B, n, seed=1)
    rng = np.random.default_rng(1)
    Bn = rng.standard_normal((B, n, k)).astype(np.float32)
    cZ = rng.standard_normal((B, n, k)).astype(np.float32)
    cld = rng.standard_normal(B).astype(np.float32)
    _, vjp = jax.vjp(lambda S, R: jax.vmap(
        lambda s, q: jmk.mega_solve_logdet(s, q, 3e-6, 9e-5, 3, True))(S, R),
        jnp.asarray(Sn), jnp.asarray(Bn))
    gj_S, gj_B = vjp((jnp.asarray(cZ), jnp.asarray(cld)))
    S_t, B_t = _t(Sn).requires_grad_(True), _t(Bn).requires_grad_(True)
    Z, ld = tmk.mega_solve_logdet(S_t, B_t, 3e-6, 9e-5, 3)
    gt_S, gt_B = torch.autograd.grad((Z, ld), (S_t, B_t),
                                     (_t(cZ), _t(cld)))
    _assert_grad_close(gt_S, gj_S)
    _assert_grad_close(gt_B, gj_B)


# ---- on the card: kernel vs plain version on CUDA tensors ------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs these checks "
                    "on the card)")
    return torch.device("cuda")


def test_cuda_solve_kernel_matches_plain(cuda):
    Sn = torch.as_tensor(_spd_batch(8, 250, seed=3), device=cuda)
    Bn = torch.randn(8, 250, 4, dtype=torch.float32, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(0))
    n0 = troutes.LAUNCHES["mega_solve"]
    Zk, ldk = tmk.mega_solve_logdet(Sn, Bn, 3e-6, 9e-5, 3)
    torch.cuda.synchronize()
    assert troutes.LAUNCHES["mega_solve"] == n0 + 1
    Zp, ldp = tmk._mega_solve_torch(Sn, Bn, 3e-6, 9e-5, 3)
    assert float((Zk - Zp).abs().max()) <= 5e-4
    assert float((ldk - ldp).abs().max()) <= 5e-4


@pytest.mark.parametrize("B", RAGGED_B)
@pytest.mark.parametrize("n", RAGGED_N)
def test_cuda_solve_pipeline_ragged_shapes(cuda, n, B):
    Sn, Bn = (torch.as_tensor(a, device=cuda)
              for a in _ragged_inputs(B, n, seed=n + B))
    for call in range(2):
        n0 = troutes.LAUNCHES["mega_solve"]
        Zk, ldk = tmk.mega_solve_logdet(Sn, Bn, 3e-6, 9e-5, 3)
        torch.cuda.synchronize()
        assert troutes.LAUNCHES["mega_solve"] == n0 + 1
    Zp, ldp = tmk._mega_solve_torch(Sn, Bn, 3e-6, 9e-5, 3)
    assert float((Zk - Zp).abs().max()) <= 5e-4
    assert float((ldk - ldp).abs().max()) <= 5e-4


def test_cuda_like_kernel_matches_plain(cuda):
    args = [torch.as_tensor(a, device=cuda)
            for a in _like_inputs(122, 120, 8, 4, seed=6)]
    n0 = troutes.LAUNCHES["mega_like"]
    Zk, ldk = tmk.mega_like(*args, 3e-6, 9e-5, 3)
    torch.cuda.synchronize()
    assert troutes.LAUNCHES["mega_like"] == n0 + 1
    Zp, ldp = tmk._mega_like_torch(*args, 3e-6, 9e-5, 3)
    assert float((Zk - Zp).abs().max()) <= 5e-4
    assert float((ldk - ldp).abs().max()) <= 5e-4


LIKE_NB = (1, 33, 64, 65, 120, 192)
LIKE_NTOA = (1, 122, 334)


def _single_block_like(lib, args):
    """The earlier single-launch likelihood kernel on CUDA tensors."""
    S, w, s, ivb, Bn, j1, j2, refine = args
    B, nb, k = Bn.shape
    ntoa = S.shape[0]
    ws = torch.empty(int(lib.mega_like_single_block_ws_floats(ntoa, nb, k))
                     * B, dtype=torch.float32, device=S.device)
    Z = torch.empty_like(Bn)
    ld = torch.empty(B, dtype=torch.float32, device=S.device)
    tier = torch.empty(B, dtype=torch.int32, device=S.device)
    rc = lib.mega_like_single_block_launch(
        *(t.data_ptr() for t in (S, w, s, ivb, Bn, Z, ld, tier, ws)), B,
        ntoa, nb, k, j1, j2, refine,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return Z, ld


@pytest.mark.parametrize("B", RAGGED_B)
@pytest.mark.parametrize("ntoa", LIKE_NTOA)
@pytest.mark.parametrize("nb", LIKE_NB)
def test_cuda_like_pipeline_ragged_shapes(cuda, nb, ntoa, B):
    # basis widths off the Gram's 32-wide tiles and the solve phases'
    # tiles, up to the cap; the pipeline against its plain version and
    # against the single-launch design
    args = [torch.as_tensor(a, device=cuda)
            for a in _like_inputs(ntoa, nb, B, 4, seed=nb + ntoa + B)]
    args += [3e-6, 9e-5, 3]
    n0 = troutes.LAUNCHES["mega_like"]
    Zk, ldk, tk = tmk._mega_like_cuda(*args)
    torch.cuda.synchronize()
    assert troutes.LAUNCHES["mega_like"] == n0 + 1
    assert tk.tolist() == [1] * B
    Zp, ldp = tmk._mega_like_torch(*args)
    Zo, ldo = _single_block_like(cuda_lib.load_library(), args)
    torch.cuda.synchronize()
    for Zr, ldr in ((Zp, ldp), (Zo, ldo)):
        assert float((Zk - Zr).abs().max()) <= 5e-4
        assert float((ldk - ldr).abs().max()) <= 5e-4


@pytest.mark.parametrize("k", [9, 24, 44])
def test_cuda_solve_kernel_wide_rhs(cuda, k):
    Sn = torch.as_tensor(_spd_batch(16, 20, seed=k), device=cuda)
    Bn = torch.randn(16, 20, k, dtype=torch.float32, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(k))
    n0 = troutes.LAUNCHES["mega_solve"]
    Zk, ldk = tmk.mega_solve_logdet(Sn, Bn, 3e-6, 9e-5, 3)
    torch.cuda.synchronize()
    assert troutes.LAUNCHES["mega_solve"] == n0 + 1
    Zp, ldp = tmk._mega_solve_torch(Sn, Bn, 3e-6, 9e-5, 3)
    assert float((Zk - Zp).abs().max()) <= WIDE_ATOL
    assert float((ldk - ldp).abs().max()) <= WIDE_ATOL


def test_cuda_like_kernel_wide_rhs(cuda):
    args = [torch.as_tensor(a, device=cuda)
            for a in _like_inputs(334, 60, 8, 33, seed=33)]
    Zk, ldk = tmk.mega_like(*args, 3e-6, 9e-5, 3)
    Zp, ldp = tmk._mega_like_torch(*args, 3e-6, 9e-5, 3)
    torch.cuda.synchronize()
    assert float((Zk - Zp).abs().max()) <= WIDE_ATOL
    assert float((ldk - ldp).abs().max()) <= WIDE_ATOL


def test_cuda_solve_guard_is_per_walker(cuda):
    Sn, Bn = (torch.as_tensor(a, device=cuda) for a in _guard_fixture())
    Zk, ldk, tk = tmk._mega_solve_cuda(Sn, Bn, 1e-6, 1e-3, 3)
    Zp, ldp = tmk._mega_solve_torch(Sn, Bn, 1e-6, 1e-3, 3)
    torch.cuda.synchronize()
    assert tk.tolist() == [3, 3]
    assert float((Zk - Zp).abs().max()) <= 1e-4
    assert float((ldk - ldp).abs().max()) <= 1e-4
