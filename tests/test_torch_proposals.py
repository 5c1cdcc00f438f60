"""The port's ensemble proposal families (ind, cg, kde, ns) against
independent densities and the JAX package.

- each family's proposal and MH correction, with injected draws, against
  a scipy density: the independence Gaussian, the subset's conditional
  Gaussian, the KDE mixture, and for the noise slide the Jacobian of
  (efac, equad) <-> (v, f) (and (v, equad)) by finite differences, with
  the global branch's rejection outside its reachable range;
- the per-block ensemble fits (``_host_prep``) equal to the JAX
  ``PTSampler._host_prep`` on the same cloud;
- the ``update_mask`` classes of subsets and slides on ``gwb_array.dat``'s
  parameter blocks against the reference's rule, and a joint run's
  ``mask_stats.json`` counting them;
- ports of ``tests/test_samplers.py``'s independence-jump recovery and
  ``TestEnsembleFamilies`` (cg on a Gaussian, kde across two separated
  modes at 0.7/0.3, ns leaving the white-noise posterior invariant, here
  against the exact posterior on a grid), and a posterior match of the
  port against the JAX ``PTSampler`` with the same family weights;
- ``chip_smoke.py``'s copy of the north star's problem against
  ``tools/north_star.py:build_problem``.
"""

import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as ss
import torch
from scipy.special import logsumexp

from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.models.assemble import \
    init_model_likelihoods as j_init
from enterprise_warp_tpu.models.priors import Parameter as JParameter
from enterprise_warp_tpu.models.priors import Uniform as JUniform
from enterprise_warp_tpu.samplers import PTSampler as JPTSampler
from enterprise_warp_tpu.samplers.evalproto import BLOCK_COMMON as J_COMMON
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.models import (StandardModels, TermList,
                                              build_pulsar_likelihood)
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init
from enterprise_warp_tpu_torch.models.prior_mixin import PriorMixin
from enterprise_warp_tpu_torch.models.priors import Parameter, Uniform
from enterprise_warp_tpu_torch.samplers import PTSampler
from enterprise_warp_tpu_torch.samplers import ptmcmc as pt
from enterprise_warp_tpu_torch.sim.noise import (inject_white,
                                                 make_fake_pulsar)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GWB_ARRAY = os.path.join(REPO, "examples", "example_params", "gwb_array.dat")
F64 = torch.float64
# the reference's own posterior gates (tools/north_star.py:_posterior_match)
SHIFT_MAX, RATIO_MAX = 0.25, 1.25


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


class GaussianLike(PriorMixin):
    """Analytic Gaussian in a uniform box (float64 torch)."""

    device = torch.device("cpu")

    def __init__(self, mu, sigma, lo=-10.0, hi=10.0):
        self.mu, self.sigma = T(mu), T(sigma)
        self.ndim = len(mu)
        self.params = [Parameter(f"p{i}", Uniform(lo, hi))
                       for i in range(self.ndim)]
        self.param_names = [p.name for p in self.params]

    def loglike_batch(self, theta):
        z = (torch.as_tensor(theta, dtype=F64) - self.mu) / self.sigma
        return -0.5 * torch.sum(z * z, dim=-1)


class Bimodal(GaussianLike):
    """Two Gaussians (sigma 0.5) at +-(3, 2), masses 0.7 and 0.3."""

    def __init__(self):
        super().__init__([0.0, 0.0], [1.0, 1.0])

    def loglike_batch(self, theta):
        t = torch.as_tensor(theta, dtype=F64)
        a = -0.5 * torch.sum((t - T([3.0, 2.0])) ** 2 / 0.25, dim=-1)
        b = -0.5 * torch.sum((t + T([3.0, 2.0])) ** 2 / 0.25, dim=-1)
        return torch.logaddexp(a + math.log(0.7), b + math.log(0.3))


class JGaussianLike:
    """The same Gaussian for the JAX ``PTSampler`` (tests/test_samplers.py)."""

    def __init__(self, mu, sigma, lo=-10.0, hi=10.0):
        self.mu = jnp.asarray(mu, dtype=jnp.float64)
        self.sigma = jnp.asarray(sigma, dtype=jnp.float64)
        self.ndim = len(mu)
        self.params = [JParameter(f"p{i}", JUniform(lo, hi))
                       for i in range(self.ndim)]
        self.param_names = [p.name for p in self.params]

        def ll(theta):
            z = (theta - self.mu) / self.sigma
            return -0.5 * jnp.sum(z * z)
        self._fn = ll
        self.loglike = jax.jit(ll)
        self.loglike_batch = jax.jit(jax.vmap(ll))

    def log_prior(self, theta):
        theta = jnp.atleast_1d(theta)
        out = 0.0
        for i, p in enumerate(self.params):
            out = out + p.prior.logpdf(theta[..., i])
        return out

    def from_unit(self, u):
        return jnp.stack([p.prior.from_unit(u[..., i])
                          for i, p in enumerate(self.params)], axis=-1)

    def sample_prior(self, rng, n=1):
        out = np.empty((n, self.ndim))
        for i, p in enumerate(self.params):
            out[:, i] = [p.prior.sample(rng) for _ in range(n)]
        return out


def _spd(rng, nd):
    a = rng.standard_normal((nd, nd))
    return a @ a.T / nd + 0.3 * np.eye(nd)


# ---- each family's correction against an independent density ---------- #

def test_ind_against_scipy():
    rng = np.random.default_rng(0)
    nd, W = 4, 16
    mean, cov = rng.standard_normal(nd), _spd(rng, nd)
    L = np.linalg.cholesky(1.4 ** 2 * cov)
    x, z = rng.standard_normal((W, nd)), rng.standard_normal((W, nd))
    prop = pt.propose_ind(T(mean), T(L), T(z))
    np.testing.assert_allclose(prop.numpy(), mean + z @ L.T, rtol=1e-13)
    qc = pt.ind_qc(T(x), prop, T(mean), T(np.linalg.inv(L))).numpy()
    mvn = ss.multivariate_normal(mean, L @ L.T)
    np.testing.assert_allclose(qc, mvn.logpdf(x) - mvn.logpdf(prop.numpy()),
                               rtol=1e-10, atol=1e-10)


def test_subsets_from_injected_draws():
    rng = np.random.default_rng(1)
    nd, W, k = 6, 64, 3
    cg_rows = np.stack([rng.permutation(nd)[:k] for _ in range(nd)])
    u, j = rng.uniform(size=W), rng.integers(0, nd, W)
    perm = rng.uniform(size=(W, nd))
    S = pt.draw_subsets(torch.as_tensor(cg_rows), 0.5, T(u),
                        torch.as_tensor(j), T(perm)).numpy()
    for w in range(W):
        want = cg_rows[j[w]] if u[w] < 0.5 else np.argsort(perm[w])[:k]
        np.testing.assert_array_equal(S[w], want)
        assert len(set(S[w])) == k


def test_cg_against_the_conditional_gaussian():
    rng = np.random.default_rng(2)
    nd, W, k = 5, 24, 3
    mean, cov = rng.standard_normal(nd), _spd(rng, nd)
    lam = np.linalg.inv(cov)
    x = mean + rng.standard_normal((W, nd))
    S = np.stack([rng.permutation(nd)[:k] for _ in range(W)])
    z = rng.standard_normal((W, k))
    prop, qc = pt.propose_cg(T(x), T(mean), T(lam), torch.as_tensor(S),
                             T(z))
    prop, qc = prop.numpy(), qc.numpy()
    for w in range(W):
        s = S[w]
        r = np.setdiff1d(np.arange(nd), s)
        np.testing.assert_array_equal(prop[w, r], x[w, r])
        g = cov[np.ix_(s, r)] @ np.linalg.inv(cov[np.ix_(r, r)])
        mu_c = mean[s] + g @ (x[w, r] - mean[r])
        cov_c = cov[np.ix_(s, s)] - g @ cov[np.ix_(r, s)]
        d = ss.multivariate_normal(mu_c, cov_c)
        np.testing.assert_allclose(
            qc[w], d.logpdf(x[w, s]) - d.logpdf(prop[w, s]),
            rtol=1e-9, atol=1e-9)
        # the draw is the conditional's: its whitened norm is |z|^2
        dv = prop[w, s] - mu_c
        np.testing.assert_allclose(dv @ np.linalg.solve(cov_c, dv),
                                   z[w] @ z[w], rtol=1e-9)


def test_kde_against_the_mixture_density():
    rng = np.random.default_rng(3)
    nd, W, k, n = 4, 16, 2, 20
    pts = rng.standard_normal((n, nd))
    bw = rng.uniform(0.1, 0.6, nd)
    x = rng.standard_normal((W, nd))
    S = np.stack([rng.permutation(nd)[:k] for _ in range(W)])
    m, z = rng.integers(0, n, W), rng.standard_normal((W, k))
    prop, qc = pt.propose_kde(T(x), T(pts), T(bw), torch.as_tensor(S),
                              torch.as_tensor(m), T(z))
    prop, qc = prop.numpy(), qc.numpy()

    def logq(v, s):
        return logsumexp([ss.norm.logpdf(v, pts[i, s], bw[s]).sum()
                          for i in range(n)]) - math.log(n)
    for w in range(W):
        s = S[w]
        xs = pts[m[w], s] + bw[s] * z[w]
        np.testing.assert_allclose(prop[w, s], xs, rtol=1e-14)
        r = np.setdiff1d(np.arange(nd), s)
        np.testing.assert_array_equal(prop[w, r], x[w, r])
        np.testing.assert_allclose(qc[w], logq(x[w, s], s) - logq(xs, s),
                                   rtol=1e-10, atol=1e-10)


def _jac_logdet(fn, a, b, h=1e-6):
    """log |det d fn / d(a, b)| by central differences (relative steps)."""
    ha, hb = h * abs(a), h * abs(b)
    ca = (np.asarray(fn(a + ha, b)) - np.asarray(fn(a - ha, b))) / (2 * ha)
    cb = (np.asarray(fn(a, b + hb)) - np.asarray(fn(a, b - hb))) / (2 * hb)
    return math.log(abs(ca[0] * cb[1] - ca[1] * cb[0]))


def _ns_fixture():
    """Two backends' pairs over [e0, q0, e1, q1], 64 walkers, and draws
    that take each branch."""
    rng = np.random.default_rng(4)
    W = 64
    s2 = np.array([1e-12, 4e-12])
    pairs = (torch.as_tensor([0, 2]), torch.as_tensor([1, 3]), T(s2),
             T([-10.0, -10.0]), T([-5.0, -5.0]))
    x = np.stack([rng.uniform(0.5, 2.0, W), rng.uniform(-8.0, -5.5, W),
                  rng.uniform(0.5, 2.0, W), rng.uniform(-8.0, -5.5, W)], 1)
    draws = (rng.integers(0, 2, W), rng.uniform(size=W),
             rng.standard_normal(W), rng.uniform(size=W))
    return pairs, s2, x, draws


def test_ns_against_finite_difference_jacobians():
    """The slide preserves v = efac^2 s2 + 10^(2 equad). Local branch: the
    logit-normal kernel in f plus the Jacobian of (efac, equad) <-> (v,
    f); global branch: equad uniform on [lo, upper] at fixed v plus the
    Jacobian of (efac, equad) <-> (v, equad). Both against finite
    differences."""
    pairs, s2, x, (b, ug, z, uf) = _ns_fixture()
    prop, qc, ie = pt.propose_ns(T(x), pairs, torch.as_tensor(b), T(ug),
                                 T(z), T(uf))
    prop, qc = prop.numpy(), qc.numpy()
    np.testing.assert_array_equal(ie.numpy(), 2 * b)
    assert (ug < 0.5).any() and (ug >= 0.5).any()
    for w in range(len(x)):
        i0 = 2 * b[w]
        other = [c for c in range(4) if c not in (i0, i0 + 1)]
        np.testing.assert_array_equal(prop[w, other], x[w, other])
        e, q = x[w, i0], x[w, i0 + 1]
        e1, q1 = prop[w, i0], prop[w, i0 + 1]
        sw = s2[b[w]]
        v = e * e * sw + 10 ** (2 * q)
        np.testing.assert_allclose(e1 * e1 * sw + 10 ** (2 * q1), v,
                                   rtol=1e-12)
        if ug[w] >= 0.5:
            def th_vf(vv, ff):
                return (math.sqrt((1 - ff) * vv / sw),
                        0.5 * math.log10(ff * vv))
            f0, f1 = 10 ** (2 * q) / v, 10 ** (2 * q1) / v
            lg0, lg1 = math.log(f0 / (1 - f0)), math.log(f1 / (1 - f1))
            np.testing.assert_allclose(lg1, lg0 + 0.8 * z[w], rtol=1e-9,
                                       atol=1e-9)
            # log q(f | f') - log q(f' | f): the logit-normal densities
            kern = (ss.norm.logpdf(lg0, lg1, 0.8) - math.log(f0 * (1 - f0))
                    - ss.norm.logpdf(lg1, lg0, 0.8)
                    + math.log(f1 * (1 - f1)))
            want = _jac_logdet(th_vf, v, f1) - _jac_logdet(th_vf, v, f0) \
                + kern
        else:
            def th_vq(vv, qq):
                return (math.sqrt((vv - 10 ** (2 * qq)) / sw), qq)
            upper = min(-5.0, 0.5 * math.log10(v) - 1e-6)
            np.testing.assert_allclose(q1, -10 + (upper + 10) * uf[w],
                                       rtol=1e-12)
            want = _jac_logdet(th_vq, v, q1) - _jac_logdet(th_vq, v, q)
        np.testing.assert_allclose(qc[w], want, rtol=1e-5, atol=1e-6)


def test_ns_global_branch_rejects_outside_its_range():
    """A state inside the 1e-6 guard band below 0.5 log10 v (almost all
    of v in equad) cannot be reached by the reverse global draw: the
    move must reject (-inf), while the local branch still corrects."""
    pairs, _, x, _ = _ns_fixture()
    x = x[:2].copy()
    x[:, 0], x[:, 1] = 1e-9, -5.5
    prop, qc, _ = pt.propose_ns(T(x), pairs, torch.as_tensor([0, 0]),
                                T([0.2, 0.7]), T([0.3, 0.3]), T([0.5, 0.5]))
    assert qc[0] == -math.inf
    assert np.isfinite(qc[1].item())


# ---- the ensemble fits against the JAX package ------------------------- #

@pytest.mark.parametrize("nchains,kde_bw,weights", [
    (32, None, dict(ind_weight=3, cg_weight=10, kde_weight=5)),
    (32, 0.3, dict(kde_weight=5)),
    (6, None, dict(cg_weight=10)),
    (32, None, dict()),
], ids=["fitted", "kde_bw", "degenerate_cloud", "no_ensemble_family"])
def test_host_prep_matches_jax(tmp_path, nchains, kde_bw, weights):
    """The per-block fits (eigh and Cholesky of the adapted covariance,
    the inflated independence Gaussian, the precision, the correlation
    blocks, the frozen cloud and its bandwidths) equal the reference's on
    the same cloud and covariance, to 1e-12."""
    rng = np.random.default_rng(6)
    nd = 4
    mu, sig = rng.standard_normal(nd), rng.uniform(0.5, 2.0, nd)
    kw = dict(ntemps=1, nchains=nchains, seed=0, cg_k=2, kde_bw=kde_bw,
              **weights)
    js = JPTSampler(JGaussianLike(mu, sig), str(tmp_path / "j"), **kw)
    ts = PTSampler(GaussianLike(mu, sig), str(tmp_path / "t"), **kw)
    cloud = rng.standard_normal((nchains, nd)) @ np.linalg.cholesky(
        _spd(rng, nd)).T
    cov = _spd(rng, nd)
    jp = js._host_prep(types.SimpleNamespace(x=cloud, cov=cov))
    tp = ts._host_prep(types.SimpleNamespace(x=T(cloud), cov=cov))
    names = ("eigvecs", "eigvals", "chol", "ind_mean", "ind_L", "ind_iL",
             "lam", "cg_rows", "kde_pts", "kde_bw")
    assert len(jp) == len(tp) == len(names)
    for name, a, b in zip(names, jp, tp):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(tp[7], jp[7])


# ---- update_mask classes on gwb_array.dat's blocks ---------------------- #

def _opts():
    return types.SimpleNamespace(num=0, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)


@pytest.fixture(scope="module")
def gwb_like():
    return t_init(TParams(GWB_ARRAY, opts=_opts()), write_pars=False,
                  device="cpu")[0]


def _ref_class(pb, dims):
    """The reference's rule (samplers/ptmcmc.py:_mask_cls_subset): a
    subset is maskable only when all its dimensions share one block; a
    pulsar's block is 'site' (0), the common block 1, else 'full' (2)."""
    blk = pb[dims]
    if not np.all(blk == blk[0]):
        return 2
    return 0 if blk[0] >= 0 else 1 if blk[0] == J_COMMON else 2


def test_mask_classes_on_gwb_array(gwb_like):
    jlike = j_init(JParams(GWB_ARRAY, opts=_opts()), write_pars=False)[0]
    pb = np.asarray(gwb_like.param_blocks)
    np.testing.assert_array_equal(pb, np.asarray(jlike.param_blocks))
    rng = np.random.default_rng(7)
    nd = gwb_like.ndim
    # random subsets, and subsets drawn inside each block
    subsets = [rng.permutation(nd)[:3] for _ in range(200)]
    for blk in np.unique(pb):
        dims = np.flatnonzero(pb == blk)
        subsets += [rng.choice(dims, min(3, len(dims)), replace=False)
                    for _ in range(5)]
    subsets = [s for s in subsets if len(s) == 3]
    S = torch.as_tensor(np.stack(subsets))
    pbt = torch.as_tensor(pb)
    got = pt.subset_class(pbt, pt.block_classes(pbt), S).numpy()
    want = [_ref_class(pb, s) for s in subsets]
    np.testing.assert_array_equal(got, want)
    assert {0, 2} <= set(want)
    # a slide pair is one backend's two parameters, in one pulsar's block
    cls = pt.block_classes(pbt).numpy()
    for ie, iq, _ in gwb_like.noise_pairs:
        assert pb[ie] == pb[iq] >= 0 and cls[ie] == 0


def test_joint_run_counts_subset_classes(tmp_path, gwb_like, monkeypatch):
    """A joint run with the subset families writes ``mask_stats.json``
    whose maskable proposals include the subsets' and the slides', not
    the prior draws' alone."""
    monkeypatch.delenv("EWT_UPDATE_MASK", raising=False)
    monkeypatch.delenv("EWT_PALLAS", raising=False)
    s = PTSampler(gwb_like, str(tmp_path), ntemps=1, nchains=8, seed=2,
                  cov_update=20, cg_weight=15, kde_weight=18, ns_weight=35)
    s.sample(40, resume=False, verbose=False)
    got = json.load(open(tmp_path / "mask_stats.json"))
    p = got["proposals"]
    assert got["total"] == 8 * 40
    assert p["site"] + p["common"] >= s.fam_propose[3] + s.fam_propose[7]
    assert p["site"] + p["common"] > s.fam_propose[3] + s.fam_propose[7]
    assert (s.fam_propose[[5, 6, 7]] > 0).all()


# ---- sampler-level ports of tests/test_samplers.py --------------------- #

def test_independence_jump_recovery(tmp_path):
    """Posterior widths must not inherit the proposal's 1.4x inflation
    (they would with a wrong correction), and acceptance is O(1)."""
    like = GaussianLike([1.0, -2.0], [0.3, 0.7])
    s = PTSampler(like, str(tmp_path), ntemps=1, nchains=64, seed=2,
                  scam_weight=10, am_weight=10, de_weight=10,
                  prior_weight=5, ind_weight=65)
    st = s.sample(3000, resume=False, verbose=False, block_size=500)
    chain = np.loadtxt(tmp_path / "chain_1.txt")
    post = chain[len(chain) // 4:, :like.ndim]
    np.testing.assert_allclose(post.mean(0), [1.0, -2.0], atol=0.1)
    np.testing.assert_allclose(post.std(0), [0.3, 0.7], rtol=0.15)
    assert float(st.accepted[:64].mean()) / st.step > 0.25


def test_cgibbs_only_recovers_gaussian(tmp_path):
    mu = np.array([1.0, -2.0, 0.5])
    sig = np.array([0.5, 2.0, 1.0])
    like = GaussianLike(mu, sig)
    s = PTSampler(like, str(tmp_path), ntemps=1, nchains=64, seed=0,
                  scam_weight=0, am_weight=0, de_weight=0, prior_weight=0,
                  cg_weight=100, cg_k=2)
    blocks = []
    s.sample(3000, resume=False, verbose=False, block_size=250,
             collect=blocks)
    c = np.concatenate(blocks, 0)[1000:]
    assert c.dtype == np.float32 and c.shape == (2000, 64, 3)
    assert s.fam_accept[5] / max(s.fam_propose[5], 1) > 0.3
    assert np.allclose(c.reshape(-1, 3).mean(0), mu, atol=0.1)
    assert np.allclose(c.reshape(-1, 3).std(0), sig, rtol=0.15)


def test_kde_family_crosses_separated_modes(tmp_path):
    """Mode occupancy at the 0.7/0.3 mass split: the random-walk families
    alone cannot cross the ~24-sigma gap."""
    like = Bimodal()
    s = PTSampler(like, str(tmp_path), ntemps=1, nchains=128, seed=0,
                  scam_weight=10, am_weight=5, de_weight=15, prior_weight=5,
                  cg_weight=25, kde_weight=40, cg_k=2)
    s.anneal_init(schedule=[16.0, 4.0], steps_per=100, verbose=False)
    blocks = []
    s.sample(3000, resume=False, verbose=False, block_size=100,
             collect=blocks)
    c = np.concatenate(blocks, 0)[1000:]
    assert (c[:, :, 0] > 0).mean() == pytest.approx(0.7, abs=0.07)
    assert s.fam_accept[6] / max(s.fam_propose[6], 1) > 0.1


def _white_like():
    psr = make_fake_pulsar(name="T", ntoa=100, backends=("X",),
                           freqs_mhz=(1400.,), seed=2)
    psr.residuals = 0.0 * psr.toaerrs
    inject_white(psr, efac=1.1, equad_log10=-6.8,
                 rng=np.random.default_rng(5))
    m = StandardModels(psr=psr)
    return build_pulsar_likelihood(
        psr, TermList(psr, [m.efac("by_backend"), m.equad("by_backend")]),
        gram_mode="f64", device="cpu")


def test_noise_slide_posterior_invariance(tmp_path):
    """A chain moving mostly by the slide has the exact (efac, equad)
    posterior's means and widths: the posterior on a 400 x 400 grid of
    the prior box (uniform priors), within 0.15 sigma and 15 %."""
    like = _white_like()
    assert like.noise_pairs, "pair metadata missing"
    lo = np.array([p.prior.lo for p in like.params])
    hi = np.array([p.prior.hi for p in like.params])
    g = [np.linspace(lo[i], hi[i], 401)[:-1] + (hi[i] - lo[i]) / 800
         for i in range(2)]
    E, Q = np.meshgrid(*g, indexing="ij")
    lnl = like.loglike_batch(np.stack([E.ravel(), Q.ravel()], 1)).numpy()
    w = np.exp(lnl - lnl.max())
    w /= w.sum()
    pts = np.stack([E.ravel(), Q.ravel()], 1)
    mean = w @ pts
    std = np.sqrt(w @ (pts - mean) ** 2)
    s = PTSampler(like, str(tmp_path), ntemps=1, nchains=64, seed=3,
                  scam_weight=10, am_weight=5, de_weight=10, prior_weight=10,
                  ns_weight=65)
    blocks = []
    s.sample(3000, resume=False, verbose=False, block_size=500,
             collect=blocks)
    c = np.concatenate(blocks, 0)[750:].reshape(-1, 2)
    assert s.fam_accept[7] / max(s.fam_propose[7], 1) > 0.3
    np.testing.assert_allclose(c.mean(0), mean, atol=0.15 * std.min())
    np.testing.assert_allclose(c.std(0), std, rtol=0.15)


def _match(a, mu, sig):
    """Worst mean shift (in sigma) and width ratio of draws ``a``."""
    shift = np.abs(a.mean(0) - mu) / sig
    r = a.std(0) / sig
    return shift.max(), np.maximum(r, 1 / r).max()


def test_posterior_matches_jax_sampler(tmp_path):
    """The port and the JAX ``PTSampler`` with the same family weights
    (ind, cg, kde besides the classic four) on the same target agree with
    each other and with the target within the reference's posterior
    gates."""
    mu, sig = np.array([0.5, -1.0, 2.0]), np.array([0.4, 1.2, 0.8])
    kw = dict(ntemps=1, nchains=32, seed=4, scam_weight=10, am_weight=5,
              de_weight=10, prior_weight=5, ind_weight=10, cg_weight=20,
              kde_weight=20, cg_k=2, cov_update=250)
    js = JPTSampler(JGaussianLike(mu, sig), str(tmp_path / "j"), **kw)
    ts = PTSampler(GaussianLike(mu, sig), str(tmp_path / "t"), **kw)
    jb, tb = [], []
    js.sample(2000, resume=False, verbose=False, block_size=250, collect=jb)
    ts.sample(2000, resume=False, verbose=False, block_size=250, collect=tb)
    a = np.concatenate(jb)[500:].reshape(-1, 3).astype(float)
    b = np.concatenate(tb)[500:].reshape(-1, 3).astype(float)
    for draws in (a, b):
        shift, ratio = _match(draws, mu, sig)
        assert shift <= SHIFT_MAX and ratio <= RATIO_MAX, (shift, ratio)
    shift, ratio = _match(b, a.mean(0), a.std(0))
    assert shift <= SHIFT_MAX and ratio <= RATIO_MAX, (shift, ratio)
    assert (ts.fam_propose[4:7] > 0).all() and (ts.fam_accept[4:7] > 0).all()


# ---- chip_smoke.py's copy of the north star's problem ------------------ #

def test_north_star_problem_copy(monkeypatch):
    """``chip_smoke.north_star_problem`` (the port's ``sim.noise``) gives
    the pulsar arrays of ``tools/north_star.py:build_problem`` and an lnL
    within rtol 1e-3 of the reference's at 8 prior draws."""
    import enterprise_warp_tpu.models as jmodels
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import north_star
    from chip_smoke import north_star_problem
    seen = []
    build = jmodels.build_pulsar_likelihood

    def keep(psr, terms, **kw):
        seen.append(psr)
        return build(psr, terms, **kw)
    monkeypatch.setattr(jmodels, "build_pulsar_likelihood", keep)
    jl = north_star.build_problem("f64")
    tl = north_star_problem("f64", "cpu")
    jp, tp = seen[0], tl.psr
    for key in ("toas", "residuals", "toaerrs", "freqs", "backend_flags",
                "Mmat"):
        np.testing.assert_array_equal(np.asarray(getattr(tp, key)),
                                      np.asarray(getattr(jp, key)),
                                      err_msg=key)
    assert tl.param_names == jl.param_names and tl.ndim == 12
    th = jl.sample_prior(np.random.default_rng(10), 8)
    a = np.asarray(jl.loglike_batch(jnp.asarray(th)))
    b = tl.loglike_batch(T(th)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-3)
    assert np.isfinite(b).all()


def test_zero_weight_families_draw_nothing(tmp_path, monkeypatch):
    """With every ensemble weight at 0 no family function runs and no
    draw is taken for them: the generator ends where a run of the classic
    four alone leaves it, so the existing paths' chains are unchanged."""
    like = _white_like()
    for name in ("propose_ind", "propose_cg", "propose_kde", "propose_ns",
                 "draw_subsets", "ind_qc"):
        monkeypatch.setattr(pt, name, None)
    s = PTSampler(like, str(tmp_path), ntemps=2, nchains=4, seed=1,
                  cov_update=50)
    s.sample(100, resume=False, verbose=False)
    # the classic step's draws: z (W nd), j (W), scam (W), ia, ib, jp (W
    # each), the prior draw (W nd), the choice (W), the accept (W), and
    # the swap's uniforms every 10th step
    gen = torch.Generator().manual_seed(1)
    W, nd = 8, like.ndim
    for step in range(100):
        torch.randn((W, nd), generator=gen, dtype=F64)
        torch.randint(0, nd, (W,), generator=gen)
        torch.randn((W, 1), generator=gen, dtype=F64)
        for _ in range(2):        # the DE pair (its range takes no draws)
            torch.randint(0, 1, (W,), generator=gen)
        torch.randint(0, nd, (W,), generator=gen)
        torch.rand((W, nd), generator=gen, dtype=F64)
        torch.rand((W,), generator=gen, dtype=F64)
        torch.rand((W,), generator=gen, dtype=F64)
        if step % 10 == 9:
            torch.rand((1, 4), generator=gen, dtype=F64)
    assert torch.equal(s.gen.get_state(), gen.get_state())
