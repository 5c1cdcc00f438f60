"""The TOA axis across processes and the ``EWT_BLOCKED_CHOL`` pin, against
the JAX package (``tests/test_parallel.py::TestToaSharding``,
``tests/test_distributed.py``'s two-process TOA tests and
``tests/test_kernel.py::TestBlockedCholesky``).

- ``blocked_cholesky`` against the reference's on its fixtures (the native
  factor, NaN from an indefinite block), the mixed solve through it
  unchanged, and ``EWT_BLOCKED_CHOL=1`` at build time: all three kernels
  declined as ``blocked`` (also for a CUDA device), no launch, lnL within
  the split class of the default build, the fingerprint keyed on it;
- in one process, a ``toa`` layout without a group holds every shard and
  sums their bodies before the collective: 2, 3 and 8 shards of 2047
  TOAs (not a multiple of ``nshard * 256``) against the port's unsharded
  build (the pair program off: rtol 1e-9, atol 1e-6), with one
  ``all_reduce`` and no ``all_gather`` per evaluation; the same against
  the JAX package's ``build_pulsar_likelihood(mesh=make_toa_mesh())`` on
  its 8 virtual devices (float64 rtol 1e-9; split |dlnL| <= 1e-3 near
  truth, the convention of ``tests/test_torch_kernel.py``); each variant
  (chromatic, sampled timing model, sampled deterministic delays), the
  float64 twin and the health twin; gradients (one ``all_reduce`` and
  one ``all_reduce_grad``); a ``chain`` layout ignored by the build and a
  ``toa`` layout ignored by ``PTSampler``;
- two real gloo processes through the ``EWT_*`` contract: each rank holds
  only its block, the same lnL on both equal to the one-process build,
  then PT for 40 steps with equal final states, rank 0 writing the run's
  files and rank 1 only its own events stream.
"""

import os

import jax  # noqa: F401  (float64 on: the reference's package import)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.models import StandardModels as JSM
from enterprise_warp_tpu.models import TermList as JTL
from enterprise_warp_tpu.models import build_pulsar_likelihood as j_build
from enterprise_warp_tpu.ops.kernel import blocked_cholesky as j_blocked
from enterprise_warp_tpu.parallel import make_toa_mesh as j_toa_mesh
from enterprise_warp_tpu.sim.noise import make_fake_pulsar as j_fake
from enterprise_warp_tpu_torch.models import StandardModels as TSM
from enterprise_warp_tpu_torch.models import TermList as TTL
from enterprise_warp_tpu_torch.models import build_pulsar_likelihood as t_build
from enterprise_warp_tpu_torch.models.build import topology_fingerprint
from enterprise_warp_tpu_torch.ops import routes as troutes
from enterprise_warp_tpu_torch.ops.kernel import (_mixed_psd_solve_logdet,
                                                  blocked_cholesky)
from enterprise_warp_tpu_torch.parallel import distributed, make_toa_mesh
from enterprise_warp_tpu_torch.parallel.distributed import (COLLECTIVES,
                                                            ShardLayout)
from enterprise_warp_tpu_torch.samplers import PTSampler
from enterprise_warp_tpu_torch.sim.noise import make_fake_pulsar as t_fake

from test_torch_distributed import _PREAMBLE, _launch, _lines

torch.set_num_threads(2)

NTOA = 2047
PINS = ("EWT_PALLAS", "EWT_PALLAS_MEGA", "EWT_PALLAS_CHOL",
        "EWT_BLOCKED_CHOL", "EWT_PAIR_PROGRAM", "EWT_CONST_GRAMS",
        "EWT_COORDINATOR", "EWT_NUM_PROCESSES", "EWT_PROCESS_ID")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No route pins, no launcher contract and no group; counters zero."""
    for k in PINS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(distributed, "_INITIALIZED", False)
    monkeypatch.setattr(distributed, "_LOCAL_RANK", None)
    troutes.reset_counts()
    COLLECTIVES.clear()


def _psr(fake):
    # the reference test's pulsar: 2047 TOAs, two backends, two bands
    psr = fake(name="J1000+1000", ntoa=NTOA, backends=("A", "B"),
               freqs_mhz=(1400.0, 3100.0), seed=13)
    psr.residuals = psr.toaerrs * np.random.default_rng(13).standard_normal(
        NTOA)
    return psr


def _terms(SM, TL, psr, variant):
    m = SM(psr=psr)
    tl = [m.efac("by_backend"), m.equad("by_backend"),
          m.spin_noise("powerlaw_10_nfreqs")]
    if variant == "chrom":
        tl.append(m.chromred("vary_5_nfreqs"))
    if variant == "det":
        tl.append(m.bayes_ephem("sampled"))
    return TL(psr, tl)


VARIANTS = ("marg", "chrom", "tm", "det")


@pytest.fixture(scope="module")
def psrs():
    return _psr(t_fake), _psr(j_fake)


def _port(psrs, variant, mesh=None, gram_mode="split", pair=False):
    """The port's build (the pair program off unless ``pair``)."""
    tp = psrs[0]
    old = os.environ.pop("EWT_PAIR_PROGRAM", None)
    if not pair:
        os.environ["EWT_PAIR_PROGRAM"] = "0"
    try:
        return t_build(tp, _terms(TSM, TTL, tp, variant), device="cpu",
                       gram_mode=gram_mode, mesh=mesh,
                       tm="sampled" if variant == "tm" else "marginalized")
    finally:
        os.environ.pop("EWT_PAIR_PROGRAM", None)
        if old is not None:
            os.environ["EWT_PAIR_PROGRAM"] = old


def _ref(psrs, variant, gram_mode):
    """The JAX package's TOA-mesh build on its 8 virtual devices."""
    jp = psrs[1]
    return j_build(jp, _terms(JSM, JTL, jp, variant), gram_mode=gram_mode,
                   mesh=j_toa_mesh(),
                   tm="sampled" if variant == "tm" else "marginalized")


def near_truth(like, n, seed):
    """Points near the simulated truth (white residuals at the quoted
    errors: efac 1, equad and red noise negligible), spread 0.05; the
    ephemeris and timing-model offsets near 0 (1e-5 and 2% of the
    prior width)."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, like.ndim))
    for i, p in enumerate(like.params):
        z = rng.standard_normal(n)
        pr = p.prior
        if p.name.endswith("efac"):
            out[:, i] = 1.0 + 0.05 * z
        elif "equad" in p.name:
            out[:, i] = -8.0 + 0.05 * z
        elif p.name.endswith("log10_A"):
            out[:, i] = -15.0 + 0.05 * z
        elif p.name.endswith("gamma"):
            out[:, i] = 3.5 + 0.05 * z
        elif p.name.endswith("gp_idx"):
            out[:, i] = 2.0 + 0.05 * z
        elif hasattr(pr, "mu"):
            out[:, i] = pr.mu + 1e-5 * pr.sigma * z
        else:
            rel = 0.02 if "tmparams" in p.name else 1e-5
            out[:, i] = 0.5 * (pr.lo + pr.hi) + rel * (pr.hi - pr.lo) * z
    return out


def _theta(like, variant, seed=0, n=4):
    # prior draws where lnL is moderate; the ephemeris at its own prior
    # scale moves the residuals by seconds, so near zero offsets there
    if variant == "det":
        return near_truth(like, n, seed)
    return like.sample_prior(np.random.default_rng(seed), n)


# ------------------------------------------------------------------ #
#  blocked_cholesky and the EWT_BLOCKED_CHOL pin                       #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("n", [7, 16, 80, 93])
def test_blocked_cholesky_matches_reference_and_native(n):
    # the reference test's matrices: one generator over its four orders
    rng = np.random.default_rng(5)
    for k in (7, 16, 80, 93):
        A = rng.standard_normal((k, k + 8))
        if k == n:
            break
    S = (A @ A.T + n * np.eye(n)).astype(np.float32)
    L = blocked_cholesky(torch.as_tensor(S)).numpy()
    np.testing.assert_allclose(L, np.asarray(j_blocked(jnp.asarray(S))),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(L, np.linalg.cholesky(S.astype(np.float64)),
                               rtol=2e-4, atol=2e-4)
    assert np.allclose(np.triu(L, 1), 0.0)
    # batched: each matrix its own factor
    Sb = torch.as_tensor(np.stack([S, S + np.eye(n, dtype=np.float32)]))
    Lb = blocked_cholesky(Sb)
    torch.testing.assert_close(Lb[0], torch.as_tensor(L))
    np.testing.assert_allclose(Lb[1].numpy(), np.linalg.cholesky(
        Sb[1].numpy().astype(np.float64)), rtol=2e-4, atol=2e-4)


def test_blocked_cholesky_indefinite_propagates_nan():
    S = np.diag([1.0, -1.0] + [1.0] * 30).astype(np.float32)
    L = blocked_cholesky(torch.as_tensor(S)).numpy()
    assert np.isnan(L).any()
    assert np.isnan(np.asarray(j_blocked(jnp.asarray(S)))).any()
    # every panel after the failed block inherits the NaN
    assert np.isnan(L[16:, :16]).all() or np.isnan(L[16:, 16:]).any()


def test_mixed_solve_with_blocked_chol():
    """``blocked=True`` reproduces the mixed solve (the refinement targets
    the computed Sigma) and declines the solve kernel and the fused
    preconditioner as ``blocked``."""
    rng = np.random.default_rng(6)
    A = rng.standard_normal((80, 120))
    S = torch.as_tensor(A @ A.T + 5.0 * np.eye(80))[None]
    B = torch.as_tensor(rng.standard_normal((80, 3)))[None]
    Z0, ld0 = _mixed_psd_solve_logdet(S, B, 3e-6, refine=3,
                                      delta_mode="split")
    troutes.reset_counts()
    Z1, ld1 = _mixed_psd_solve_logdet(S, B, 3e-6, refine=3,
                                      delta_mode="split", blocked=True)
    assert dict(troutes.ROUTES) == {("mega_solve", "blocked"): 1,
                                    ("chol_precond", "blocked"): 1}
    np.testing.assert_allclose(Z1.numpy(), Z0.numpy(), rtol=1e-7,
                               atol=1e-9)
    assert np.isclose(float(ld1), float(ld0), rtol=1e-8, atol=1e-5)
    # the health twin on the blocked factor: same Z and logdet
    Z2, ld2, hw = _mixed_psd_solve_logdet(S, B, 3e-6, refine=3,
                                          delta_mode="split", blocked=True,
                                          with_health=True)
    torch.testing.assert_close(Z2, Z1, rtol=0, atol=0)
    torch.testing.assert_close(ld2, ld1, rtol=0, atol=0)
    assert hw.shape == (1, 3) and float(hw[0, 0]) == 0.0


def test_build_env_selects_blocked_chol(psrs, monkeypatch):
    """``EWT_BLOCKED_CHOL=1`` read at build time: the three kernels
    declined as ``blocked`` with no launch, lnL within the split class of
    the default build (the reference test's rtol 1e-9, atol 5e-3), the
    gradient finite, and the fingerprint keyed on the pin."""
    base = _port(psrs, "marg", pair=True)
    monkeypatch.setenv("EWT_BLOCKED_CHOL", "1")
    blocked = _port(psrs, "marg", pair=True)
    monkeypatch.delenv("EWT_BLOCKED_CHOL")
    assert blocked.blocked_chol and not base.blocked_chol
    assert blocked.build_fingerprint != base.build_fingerprint
    th = near_truth(base, 4, 10)
    v0 = base.loglike_batch(th)
    troutes.reset_counts()
    # the pin was read at build time: the environment now says nothing
    thr = blocked.as_theta(th).requires_grad_(True)
    v1 = blocked.loglike_batch(thr)
    g, = torch.autograd.grad(v1.sum(), thr)
    assert dict(troutes.ROUTES) == {("mega_like", "blocked"): 1,
                                    ("mega_solve", "blocked"): 1,
                                    ("chol_precond", "blocked"): 1}
    assert sum(troutes.LAUNCHES.values()) == 0
    np.testing.assert_allclose(v1.detach().numpy(), v0.numpy(), rtol=1e-9,
                               atol=5e-3)
    assert torch.isfinite(g).all()
    # the health twin on the blocked factor
    troutes.reset_counts()
    lh, hw = blocked._eval_health_batch(th)
    assert dict(troutes.ROUTES) == {("mega_solve", "blocked"): 1,
                                    ("chol_precond", "blocked"): 1}
    np.testing.assert_allclose(lh.numpy(), v0.numpy(), rtol=1e-9, atol=5e-3)
    # the pin on a CUDA device's route decisions: still no kernel
    from enterprise_warp_tpu_torch.ops.megakernel import (mega_like_route,
                                                          mega_solve_route)
    troutes.reset_counts()
    cuda = torch.device("cuda")
    assert not mega_like_route(NTOA, 24, cuda, decline="blocked")
    assert not mega_solve_route(24, cuda, blocked=True)
    assert dict(troutes.ROUTES) == {("mega_like", "blocked"): 1,
                                    ("mega_solve", "blocked"): 1}


def test_blocked_pin_keys_the_topology(psrs, monkeypatch):
    a = _port(psrs, "marg")
    monkeypatch.setenv("EWT_BLOCKED_CHOL", "1")
    b = _port(psrs, "marg")
    assert topology_fingerprint(a) != topology_fingerprint(b)
    assert a.build_fingerprint != b.build_fingerprint


# ------------------------------------------------------------------ #
#  the TOA axis in one process                                         #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("nshard", [2, 3, 8])
def test_shards_summed_match_unsharded(psrs, nshard):
    base = _port(psrs, "marg")
    lay = ShardLayout(nshard, axis="toa")
    like = _port(psrs, "marg", mesh=lay)
    assert like.param_names == base.param_names
    assert like.mesh is lay and like.device == torch.device("cpu")
    quantum = nshard * 256
    npad = -(-NTOA // quantum) * quantum
    assert like.static["ntoa_padded"] == npad
    assert sorted(like.static["shards"]) == list(range(nshard))
    rows = npad // nshard
    for sh in like.static["shards"].values():
        assert sh["T"].shape == (rows, base.static["T_w"].shape[1])
        assert sh["mask"].shape == (rows,)
    # the padded rows: mask 0, sigma 1, zero residual and basis rows
    last = like.static["shards"][nshard - 1]
    npr = npad - NTOA
    assert float(last["mask"][rows - npr:].sum()) == 0.0
    assert torch.all(last["s2"][rows - npr:] == 1.0)
    assert float(last["T"][rows - npr:].abs().sum()) == 0.0
    assert not like.pair_program and not like.const_grams
    th = base.sample_prior(np.random.default_rng(0), 4)
    v0 = base.loglike_batch(th)
    COLLECTIVES.clear()
    troutes.reset_counts()
    v1 = like.loglike_batch(th)
    assert dict(COLLECTIVES) == {"all_reduce": 1}
    # the likelihood kernel declines a TOA-sharded evaluation; the Sigma
    # solve makes its own decision (the plain version on the CPU)
    assert troutes.ROUTES[("mega_like", "toa-sharded")] == 1
    assert troutes.ROUTES[("mega_solve", "plain-cpu")] == 1
    np.testing.assert_allclose(v1.numpy(), v0.numpy(), rtol=1e-9, atol=1e-6)
    assert like.build_fingerprint != base.build_fingerprint


def test_const_grams_refused_under_a_toa_layout(psrs, monkeypatch):
    tp = psrs[0]
    m = TSM(psr=tp)
    terms = TTL(tp, [m.spin_noise("powerlaw_10_nfreqs")])
    lay = ShardLayout(2, axis="toa")
    with pytest.raises(ValueError, match="TOA-axis mesh"):
        t_build(tp, terms, device="cpu", mesh=lay, const_grams=True)
    # auto: no fold under the layout, the same value as the folded build
    # (folded through the per-walker Grams: the pair program's summation
    # order is another member of the split class)
    like = t_build(tp, terms, device="cpu", mesh=lay)
    monkeypatch.setenv("EWT_PAIR_PROGRAM", "0")
    base = t_build(tp, terms, device="cpu")
    assert base.const_grams and not like.const_grams
    th = base.sample_prior(np.random.default_rng(3), 4)
    np.testing.assert_allclose(like.loglike_batch(th).numpy(),
                               base.loglike_batch(th).numpy(), rtol=1e-9,
                               atol=1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_against_unsharded_and_twins(psrs, variant):
    """Each variant sharded 3 ways against the unsharded port: lnL, the
    float64 twin and the health twin (lnL and words) within rtol 1e-9 /
    atol 1e-6, each on one collective."""
    base = _port(psrs, variant)
    like = _port(psrs, variant, mesh=ShardLayout(3, axis="toa"))
    th = _theta(base, variant)
    for name, fn in (("lnl", "loglike_batch"),
                     ("f64", "_eval_f64_batch")):
        COLLECTIVES.clear()
        v1 = getattr(like, fn)(th)
        assert dict(COLLECTIVES) == {"all_reduce": 1}, name
        v0 = getattr(base, fn)(th)
        np.testing.assert_allclose(v1.numpy(), v0.numpy(), rtol=1e-9,
                                   atol=1e-6, err_msg=name)
    COLLECTIVES.clear()
    l1, h1 = like._eval_health_batch(th)
    assert dict(COLLECTIVES) == {"all_reduce": 1}
    l0, h0 = base._eval_health_batch(th)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-9, atol=1e-6)
    assert h1.shape == h0.shape == (4, 3)
    np.testing.assert_allclose(h1.numpy(), h0.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_against_jax_toa_mesh_f64(psrs, variant):
    """The float64 sharded build against the JAX package's on its 8
    virtual devices: rtol 1e-9."""
    like = _port(psrs, variant, mesh=ShardLayout(8, axis="toa"),
                 gram_mode="f64")
    ref = _ref(psrs, variant, "f64")
    assert like.param_names == ref.param_names
    assert like.static["ntoa_padded"] == 2048
    th = _theta(like, variant, seed=1)
    v1 = like.loglike_batch(th).numpy()
    v0 = np.asarray(ref.loglike_batch(jnp.asarray(th)))
    np.testing.assert_allclose(v1, v0, rtol=1e-9)


def test_split_against_jax_toa_mesh_near_truth(psrs):
    """Split mode near truth against the JAX package's sharded split
    build: |dlnL| <= 1e-3; and the port's split against its own float64
    sharded twin there."""
    like = _port(psrs, "marg", mesh=ShardLayout(8, axis="toa"))
    ref = _ref(psrs, "marg", "split")
    th = near_truth(like, 8, 4)
    v1 = like.loglike_batch(th).numpy()
    v0 = np.asarray(ref.loglike_batch(jnp.asarray(th)))
    assert np.all(np.abs(v1 - v0) <= 1e-3), np.abs(v1 - v0).max()
    f1 = like._eval_f64_batch(th).numpy()
    assert np.all(np.abs(v1 - f1) <= 1e-3), np.abs(v1 - f1).max()


@pytest.mark.parametrize("variant", ["marg", "det"])
def test_gradient_sums_over_shards(psrs, variant):
    """The gradient through the sharded evaluation against the
    unsharded build's (rtol 1e-9 of the largest component): one
    ``all_reduce`` forward, one ``all_reduce_grad`` backward."""
    base = _port(psrs, variant)
    like = _port(psrs, variant, mesh=ShardLayout(3, axis="toa"))
    th = near_truth(base, 4, 7)

    def value_grad(lk):
        t = lk.as_theta(th).requires_grad_(True)
        v = lk.loglike_batch(t)
        g, = torch.autograd.grad(v.sum(), t)
        return v.detach().numpy(), g.numpy()

    COLLECTIVES.clear()
    v1, g1 = value_grad(like)
    assert dict(COLLECTIVES) == {"all_reduce": 1, "all_reduce_grad": 1}
    v0, g0 = value_grad(base)
    np.testing.assert_allclose(v1, v0, rtol=1e-9, atol=1e-6)
    assert np.isfinite(g1).all()
    np.testing.assert_allclose(g1, g0, rtol=1e-9,
                               atol=1e-9 * np.abs(g0).max())


def test_a_rank_holds_only_its_block(psrs, monkeypatch):
    """In a process group each rank keeps its own rows only; a rank past
    the last shard keeps none, adds a zero vector to the sum and still
    joins the gradient's (the group's sum stubbed by the identity)."""
    group = object()
    one = _port(psrs, "marg", mesh=ShardLayout(2, rank=1, axis="toa",
                                                group=group))
    assert sorted(one.static["shards"]) == [1]
    like = _port(psrs, "marg", mesh=ShardLayout(2, rank=2, axis="toa",
                                                 group=group))
    assert like.static["shards"] == {}
    seen = []

    def identity(t, grp):
        seen.append((tuple(t.shape), grp is group, float(t.abs().sum())))
        return t.clone()

    monkeypatch.setattr(distributed, "_raw_all_reduce", identity)
    th = like.as_theta(near_truth(like, 2, 5)).requires_grad_(True)
    v = like.loglike_batch(th)
    g, = torch.autograd.grad(v.sum(), th)
    assert dict(COLLECTIVES) == {"all_reduce": 1, "all_reduce_grad": 1}
    nb = one.static["shards"][1]["T"].shape[1]
    width = nb * nb + nb * 3 + 9 + nb + 3 + 2
    # the forward's sum gets zeros; the backward's sums theta's gradient
    assert seen[0] == ((2, width), True, 0.0)
    assert len(seen) == 2 and seen[1][:2] == (tuple(th.shape), True)
    assert v.shape == (2,) and g.shape == th.shape


def test_layouts_of_other_axes_are_ignored(psrs):
    base = _port(psrs, "marg")
    th = base.sample_prior(np.random.default_rng(2), 4)
    for lay in (ShardLayout(2, axis="chain"), ShardLayout(2, axis="psr"),
                ShardLayout(1, axis="toa")):
        like = _port(psrs, "marg", mesh=lay)
        assert like.mesh is None and "shards" not in like.static
        assert like.build_fingerprint == base.build_fingerprint
        COLLECTIVES.clear()
        torch.testing.assert_close(like.loglike_batch(th),
                                   base.loglike_batch(th), rtol=0, atol=0)
        assert not COLLECTIVES
    # a TOA axis of another name
    like = _port(psrs, "marg", mesh=ShardLayout(2, axis="toa"))
    assert like.mesh is not None
    tp = psrs[0]
    other = t_build(tp, _terms(TSM, TTL, tp, "marg"), device="cpu",
                    mesh=ShardLayout(2, axis="toa"), toa_axis="rows")
    assert other.mesh is None


def test_pt_sampler_ignores_a_toa_layout(psrs, tmp_path):
    like = _port(psrs, "marg", mesh=ShardLayout(2, axis="toa"))
    pt = PTSampler(like, str(tmp_path / "pt"), ntemps=1, nchains=4, seed=0,
                   mesh=ShardLayout(2, axis="toa"))
    assert pt.like is like and pt.mesh_stats is None
    st = pt.sample(10, resume=False, verbose=False)
    assert np.isfinite(np.asarray(st.lnl)).all()
    assert (tmp_path / "pt" / "chain_1.txt").exists()


def test_hmc_and_nested_take_a_toa_sharded_likelihood(psrs, tmp_path):
    """The gradient sampler and nested sampling on the sharded build: the
    state on the likelihood's device, finite, the evaluations' sums and
    the gradients' only."""
    from enterprise_warp_tpu_torch.samplers.devicestate import \
        resolve_placement
    from enterprise_warp_tpu_torch.samplers.hmc import HMCSampler
    from enterprise_warp_tpu_torch.samplers.nested import run_nested
    like = _port(psrs, "marg", mesh=ShardLayout(2, axis="toa"))
    assert resolve_placement(like) == like.device
    COLLECTIVES.clear()
    h = HMCSampler(like, str(tmp_path / "hmc"), nchains=4, seed=0,
                   warmup=4, n_leapfrog=3)
    st = h.sample(6, resume=False, verbose=False, block_size=3)
    assert torch.isfinite(st.z).all() and st.z.device == like.device
    # each gradient sums theta's over the group once; evaluations without
    # a gradient (the start) add an all_reduce alone
    assert COLLECTIVES["all_reduce"] >= COLLECTIVES["all_reduce_grad"] > 0
    assert set(COLLECTIVES) == {"all_reduce", "all_reduce_grad"}
    COLLECTIVES.clear()
    res = run_nested(like, outdir=str(tmp_path / "ns"), nlive=40, kbatch=10,
                     nsteps=4, dlogz=0.1, seed=3, verbose=False, max_iter=6,
                     block_iters=3)
    assert np.isfinite(res["log_evidence"])
    assert set(COLLECTIVES) == {"all_reduce"}


def test_make_toa_mesh(monkeypatch):
    lay = make_toa_mesh(device="cpu")
    assert (lay.axis, lay.nshard, lay.rank, lay.group) == ("toa", 1, 0,
                                                           None)
    monkeypatch.setenv("EWT_NUM_PROCESSES", "4")
    monkeypatch.setenv("EWT_PROCESS_ID", "3")
    lay = make_toa_mesh(device="cpu")
    assert (lay.nshard, lay.rank) == (4, 3)
    assert make_toa_mesh(n_devices=2, device="cpu").nshard == 2
    assert make_toa_mesh(n_devices=8, device="cpu").nshard == 4
    assert lay.device == torch.device("cpu")


# ------------------------------------------------------------------ #
#  two real gloo processes                                             #
# ------------------------------------------------------------------ #

_TOA = _PREAMBLE + r'''
from enterprise_warp_tpu_torch.models import (StandardModels, TermList,
                                              build_pulsar_likelihood)
from enterprise_warp_tpu_torch.parallel import make_toa_mesh
from enterprise_warp_tpu_torch.samplers import PTSampler
from enterprise_warp_tpu_torch.sim.noise import make_fake_pulsar
psr = make_fake_pulsar(name="D", ntoa=300, backends=("A",),
                       freqs_mhz=(1400.0,), seed=3)
psr.residuals = psr.toaerrs * np.random.default_rng(3).standard_normal(300)
m = StandardModels(psr=psr)
terms = TermList(psr, [m.efac("by_backend"),
                       m.spin_noise("powerlaw_6_nfreqs")])
os.environ["EWT_PAIR_PROGRAM"] = "0"
like0 = build_pulsar_likelihood(psr, terms, device="cpu")
os.environ.pop("EWT_PAIR_PROGRAM")
mesh = make_toa_mesh(device="cpu")
like = build_pulsar_likelihood(psr, terms, device="cpu", mesh=mesh)
th = torch.as_tensor(like.sample_prior(np.random.default_rng(0), 4))
distributed.reset_collectives()
v = like.loglike_batch(th)
coll = dict(distributed.COLLECTIVES)
v0 = like0.loglike_batch(th)
out = sys.argv[1]
pt = PTSampler(like, out, ntemps=2, nchains=4, seed=0)
st = pt.sample(40, resume=False, verbose=False, block_size=20)
print("RANK " + json.dumps(dict(
    rank=rank, nshard=mesh.nshard, held=sorted(like.static["shards"]),
    rows=int(like.static["shards"][rank]["r"].shape[0]), coll=coll,
    lnl=digest(v), gap=float(((v - v0).abs() / v0.abs()).max()),
    state=digest(st.x, st.lnl, st.lnp),
    finite=bool(torch.isfinite(torch.as_tensor(st.lnl)).all()),
    mesh_stats=pt.mesh_stats is not None)))
'''


def test_two_ranks_shard_the_toas_and_sample(tmp_path):
    outs = _launch(tmp_path, _TOA, [tmp_path / "out"])
    got = _lines(outs, "RANK")
    assert set(got) == {0, 1}
    for rank, r in got.items():
        # 300 TOAs padded to 512: 256 rows a rank, each its own block
        assert r["nshard"] == 2 and r["held"] == [rank] and r["rows"] == 256
        assert r["coll"] == {"all_reduce": 1}
        assert r["gap"] < 1e-12
        assert r["finite"] and not r["mesh_stats"]
    for key in ("lnl", "state"):
        assert got[0][key] == got[1][key], key
    names = set(os.listdir(tmp_path / "out"))
    assert {"chain_1.txt", "pars.txt", "state.npz", "events.jsonl",
            "events.1.jsonl"} <= names
    assert not any(".1." in n and not n.startswith("events.")
                   for n in names)
    assert not any(n.startswith("mesh_stats") for n in names)
