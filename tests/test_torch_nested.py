"""The port's nested sampler against the JAX package's.

- (i) one iteration of ``_make_iteration`` on the same seeded ``(u, lnl)``
  of an analytic target, both kernels: the evidence bookkeeping (``lnz``,
  ``ln_x``, ``dead_u``, ``dead_lnl``, ``lnx0``) does not depend on the
  draws and matches the reference's to 1e-12 (float64 sums in a
  different order);
- (ii) ``_finalize`` on the same dead arrays and seed: evidence, its
  error, the weights and the equal-weight posterior to 1e-12;
- (iii) the insertion-rank helpers equal the reference's on seeded ranks;
- (iv) in distribution, on the reference's constrained-uniform target
  (nd 3, a Gaussian truncated to the unit box), both kernels: lnZ within
  max(4 err, 0.25) of the erf value, within twice the combined error
  bar of the reference's ``run_nested`` at the same nlive and seed (the
  criterion of ``tests/test_evidence.py``, without its 0.2 floor), and
  the insertion-rank KS passes;
- (v) kill at ``max_iter`` and resume gives the uninterrupted run bit for
  bit, result file included; a changed ``block_iters`` or ``kernel``
  starts fresh;
- (vi) at the default ``block_iters`` at most 0.1 host syncs per
  iteration;
- (vii) ``slide_effective`` agrees for both packages' J1234-5678
  likelihoods of ``default_model_nested.dat``;
- the checkpoint helpers the sampler uses (``checkpoint_exists``,
  ``resolve_checkpoint(path, what=)``, ``remove_checkpoint``) give the
  reference's verdicts.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

from enterprise_warp_tpu.samplers import convergence as jconv
from enterprise_warp_tpu.samplers import nested as jnested
from enterprise_warp_tpu_torch.models.prior_mixin import PriorMixin
from enterprise_warp_tpu_torch.models.priors import Parameter, Uniform
from enterprise_warp_tpu_torch.samplers import convergence as tconv
from enterprise_warp_tpu_torch.samplers import nested as tnested

from test_samplers import GaussianLike
from test_torch_models import _opts

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIG = 1.0 / np.sqrt(2.0)
# the analytic target's lnZ: prod_i int_0^1 N(x; 0.5, SIG^2) dx
LNZ_TRUE = 3.0 * np.log(erf(0.5 / (SIG * np.sqrt(2.0))))


class TorchGaussian(PriorMixin):
    """``GaussianLike`` of ``tests/test_samplers.py`` in torch: a
    normalized Gaussian in a uniform box, on the CPU."""

    def __init__(self, mu, sigma, lo, hi):
        self.mu = torch.tensor(mu, dtype=torch.float64)
        self.sigma = torch.tensor(sigma, dtype=torch.float64)
        self.ndim = len(mu)
        self.device = torch.device("cpu")
        self.params = [Parameter(f"p{i}", Uniform(lo, hi))
                       for i in range(self.ndim)]
        self.param_names = [p.name for p in self.params]

    def loglike_batch(self, theta):
        z = (theta - self.mu) / self.sigma
        return (-0.5 * torch.sum(z * z, dim=-1)
                - torch.sum(torch.log(self.sigma))
                - 0.5 * self.ndim * math.log(2 * math.pi))


def _likes():
    return (GaussianLike([0.5] * 3, [SIG] * 3, lo=0.0, hi=1.0),
            TorchGaussian([0.5] * 3, [SIG] * 3, 0.0, 1.0))


@pytest.mark.parametrize("kernel", ["slice", "walk"])
def test_iteration_bookkeeping_matches_reference(kernel):
    jl, tl = _likes()
    nlive, kbatch, nsteps = 60, 12, 8
    rng = np.random.default_rng(11)
    u = rng.uniform(size=(nlive, 3))
    lnl = np.asarray(tl.loglike_batch(tl.from_unit(torch.tensor(u))))
    lnz, ln_x = -5.0, -1.3
    j_it = jnested._make_iteration(jl, nlive, kbatch, nsteps,
                                   kernel=kernel, extras=True)
    jout = j_it(jnp.asarray(u), jnp.asarray(lnl), jax.random.PRNGKey(0),
                jnp.float64(0.5), jnp.float64(lnz), jnp.float64(ln_x), ())
    t_it = tnested._make_iteration(tl, nlive, kbatch, nsteps, kernel=kernel)
    gen = torch.Generator().manual_seed(0)
    f64 = torch.float64
    tout = t_it(torch.tensor(u), torch.tensor(lnl), gen,
                torch.tensor(0.5, dtype=f64), torch.tensor(lnz, dtype=f64),
                torch.tensor(ln_x, dtype=f64))
    # reference: (u, lnl, key, scale, lnz, ln_x, dead_u, dead_lnl, acc,
    # delta, ranks, lnx0, first); port: the same without the key
    for name, j, t in (("lnz", 4, 3), ("ln_x", 5, 4), ("dead_u", 6, 5),
                       ("dead_lnl", 7, 6), ("lnx0", 11, 10)):
        np.testing.assert_allclose(np.asarray(tout[t]), np.asarray(jout[j]),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    # the refill lies above the deleted floor and ranks are in range
    lstar = float(np.sort(lnl)[kbatch - 1])
    assert float(tout[1][:kbatch].min()) > lstar
    assert int(tout[9].min()) >= 0 and int(tout[9].max()) <= nlive - kbatch


def test_finalize_matches_reference():
    jl, tl = _likes()
    nlive, kbatch, nsteps, it = 50, 10, 8, 6
    rng = np.random.default_rng(5)
    counts = nlive - np.arange(kbatch)
    dlnx_per = 1.0 / counts
    offs = np.concatenate([[0.0], np.cumsum(dlnx_per)[:-1]])
    dead_u = [rng.uniform(size=(kbatch, 3)) for _ in range(it)]
    dead_lnl = [np.sort(rng.normal(-3.0 + i, 0.3, kbatch))
                for i in range(it)]
    dead_lnx = [-i * dlnx_per.sum() - offs for i in range(it)]
    dead_dlnx = [dlnx_per.copy() for _ in range(it)]
    u = rng.uniform(size=(nlive, 3))
    lnl = rng.normal(4.0, 0.5, nlive)
    ln_x = -it * dlnx_per.sum()

    def args():
        return (None, "result", 7, nlive, kbatch, nsteps, it, True, u, lnl,
                ln_x, [a.copy() for a in dead_u], [a.copy() for a in dead_lnl],
                [a.copy() for a in dead_lnx], [a.copy() for a in dead_dlnx])
    jr = jnested._finalize(jl, *args(), slide_eff=False, dispatch_stats={},
                           insertion_rank=None)
    tr = tnested._finalize(tl, *args(), slide_eff=False, dispatch_stats={},
                           insertion_rank=None)
    for key in ("log_evidence", "log_evidence_err", "log_weights",
                "posterior_samples", "samples"):
        np.testing.assert_allclose(tr[key], jr[key], rtol=1e-12, atol=1e-12,
                                   err_msg=key)
    assert tr["num_likelihood_evaluations"] == \
        jr["num_likelihood_evaluations"]


def test_insertion_rank_helpers_match_reference():
    rng = np.random.default_rng(0)
    uni = rng.integers(0, 101, size=4000)
    bad = rng.integers(0, 30, size=4000)
    for ranks, verdict in ((uni, True), (bad, False)):
        d = tconv.insertion_rank_ks(ranks, 100)
        assert d == jconv.insertion_rank_ks(ranks, 100)
        neff = tconv.insertion_rank_neff(ranks.size, 500, 100)
        assert neff == jconv.insertion_rank_neff(ranks.size, 500, 100)
        tp = tconv.insertion_rank_pass(d, ranks.size, n_eff=neff)
        assert tp == jconv.insertion_rank_pass(d, ranks.size, n_eff=neff)
        assert tconv.insertion_rank_pass(d, ranks.size)["pass"] is verdict
    assert tconv.insertion_rank_ks(np.zeros(0), 100) is None


@pytest.mark.parametrize("kernel", ["slice", "walk"])
def test_constrained_uniform_target_in_distribution(kernel):
    jl, tl = _likes()
    kw = dict(nlive=300, dlogz=0.05, seed=2, verbose=False, kernel=kernel)
    res = tnested.run_nested(tl, **kw)
    ref = jnested.run_nested(jl, **kw)
    assert res["kernel"] == kernel and res["converged"]
    ir = res["insertion_rank"]
    assert ir is not None and ir["pass"], ir
    err = res["log_evidence_err"]
    assert res["log_evidence"] == pytest.approx(LNZ_TRUE,
                                                abs=max(4 * err, 0.25))
    both = math.hypot(err, ref["log_evidence_err"])
    assert abs(res["log_evidence"] - ref["log_evidence"]) <= 2.0 * both


KW = dict(nlive=100, kbatch=20, nsteps=8, dlogz=0.1, seed=3, verbose=False,
          checkpoint_every=6, block_iters=6)


def _narrow():
    """The reference's resume target: a narrow Gaussian in a wide box,
    which takes tens of iterations to converge."""
    return TorchGaussian([0.5, -1.0], [0.4, 0.8], -10.0, 10.0)


def test_resume_reproduces_uninterrupted_run(tmp_path):
    tl = _narrow()
    full = tnested.run_nested(tl, outdir=str(tmp_path / "full"), **KW)
    out2 = str(tmp_path / "resumed")
    # a kill off the block grid: the resume first runs a partial block
    tnested.run_nested(tl, outdir=out2, max_iter=14, **KW)
    assert os.path.exists(os.path.join(out2, "result_nested_ckpt.npz"))
    res = tnested.run_nested(tl, outdir=out2, resume=True, **KW)
    assert not os.path.exists(os.path.join(out2, "result_nested_ckpt.npz"))
    assert res["num_iterations"] == full["num_iterations"]
    assert res["log_evidence"] == full["log_evidence"]
    assert np.array_equal(res["samples"], full["samples"])
    assert (tmp_path / "full" / "result_result.json").read_bytes() \
        == (tmp_path / "resumed" / "result_result.json").read_bytes()


@pytest.mark.parametrize("change", [dict(block_iters=2),
                                    dict(kernel="walk")])
def test_changed_geometry_starts_fresh(tmp_path, change):
    tl = _narrow()
    kw = dict(KW, dlogz=1e-12, block_iters=3, checkpoint_every=3)
    tnested.run_nested(tl, outdir=str(tmp_path), max_iter=6, **kw)
    assert os.path.exists(tmp_path / "result_nested_ckpt.npz")
    res = tnested.run_nested(tl, outdir=str(tmp_path), max_iter=4,
                             resume=True, **dict(kw, **change))
    assert res["num_iterations"] == 4       # fresh, not resumed at 6


def test_host_syncs_amortized():
    tl = _narrow()
    r = tnested.run_nested(tl, max_iter=32, nlive=120, kbatch=24, nsteps=10,
                           dlogz=1e-12, seed=3, verbose=False)
    ds = r["dispatch_stats"]
    assert ds["block_iters"] == tnested.DEFAULT_BLOCK_ITERS >= 10
    assert ds["host_syncs_per_iteration"] <= 0.1
    with pytest.raises(NotImplementedError):
        tnested.run_nested(tl, max_iter=2, block_iters=0, verbose=False)


def test_slide_effective_matches_reference():
    from enterprise_warp_tpu.config import Params as JParams
    from enterprise_warp_tpu.models.assemble import \
        init_model_likelihoods as j_init
    from enterprise_warp_tpu_torch.config import Params as TParams
    from enterprise_warp_tpu_torch.models.assemble import \
        init_model_likelihoods as t_init
    prfile = os.path.join(REPO, "examples", "example_params",
                          "default_model_nested.dat")
    jl = j_init(JParams(prfile, opts=_opts(0)), write_pars=False)[0]
    tl = t_init(TParams(prfile, opts=_opts(0)), write_pars=False,
                device="cpu")[0]
    assert tnested.slide_effective(tl) is True
    for moves in (None, True, False):
        assert tnested.slide_effective(tl, moves) == \
            jnested.slide_effective(jl, moves)
    # a likelihood without pair metadata never slides
    assert not tnested.slide_effective(_likes()[1])


def test_checkpoint_helpers_match_reference(tmp_path):
    """``checkpoint_exists``, ``resolve_checkpoint(path, what=)`` and
    ``remove_checkpoint`` give the reference's verdicts on the same
    generations: present, digest-verified with fallback to the previous
    generation on a corrupt one, and every generation removed."""
    from enterprise_warp_tpu.io import writers as jw
    from enterprise_warp_tpu_torch.io import writers as tw
    path = str(tmp_path / "result_nested_ckpt.npz")
    for w in (jw, tw):
        assert not w.checkpoint_exists(path)
        assert w.resolve_checkpoint(path, what="nested checkpoint") is None
    for gen in (b"first", b"second"):
        tmp = str(tmp_path / "tmp.npz")
        with open(tmp, "wb") as fh:
            fh.write(gen)
        tw.checkpoint_replace(tmp, path)
    for w in (jw, tw):
        assert w.checkpoint_exists(path)
        assert w.resolve_checkpoint(path, what="nested checkpoint") == path
    with open(path, "wb") as fh:
        fh.write(b"rotten")
    prev = tw.prev_generation(path)
    for w in (jw, tw):
        assert w.resolve_checkpoint(path, what="nested checkpoint") == prev
    tw.remove_checkpoint(path)
    assert not os.listdir(tmp_path)
    assert not jw.checkpoint_exists(path)
