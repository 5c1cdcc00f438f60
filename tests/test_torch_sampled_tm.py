"""The sampled timing model in the torch port, against the JAX package.

``examples/example_params/sampled_timing_model.dat --num 0``
(J1234-5678: white noise by backend, spin noise of 20 frequencies,
``bayes_ephem: sampled`` and ``tm: sampled``) is built through both
packages. They must give the same 26 parameter names in ``pars.txt``
order (8 white, 2 spin, 13 ephemeris, 3 ``tmparams``), the same whitened
static arrays including the delay columns ``D`` (rtol 1e-12, as
``tests/test_torch_models.py``), and the same float64 lnL at 8 prior
draws and at 8 points near zero offsets (rtol 1e-9 or the conditioning
limit, as ``tests/test_torch_kernel.py::test_f64_lnl_at_prior_draws``).
In split mode the port is held against its own dense float64 oracle
(``ops/oracle.py`` with a timing-model matrix of no columns, the
residuals less ``D c + M dp``) within 5e-3 in lnL (``tests/test_kernel.py``'s
mixed-precision class is 5e-2; both packages sit 3e-4 to 6e-4 from
float64 here), and against the JAX package's split path within 1e-5. A
short CPU run of the port's CLI leaves finite chain rows under the same
``pars.txt``. With the timing model marginalized instead, the sampled
ephemeris delays are subtracted per walker ahead of the Schur stage:
float64 lnL within rtol 1e-9 of the JAX package's, and the likelihood
megakernel's route (its plain version here) within the megakernel
class (rtol 1e-3, atol 5e-2) of the classic chain.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.models.assemble import \
    init_model_likelihoods as j_init
from enterprise_warp_tpu.samplers.evalproto import eval_protocol
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init
from enterprise_warp_tpu_torch.models.priors import Normal, Uniform
from enterprise_warp_tpu_torch.ops import routes as troutes
from enterprise_warp_tpu_torch.ops.kernel import marginalized_loglike
from enterprise_warp_tpu_torch.ops.oracle import (kernel_constant_offset,
                                                  oracle_loglike)

from test_torch_cli import _paramfile
from test_torch_kernel import _sigma_condition
from test_torch_models import RTOL, _opts

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    """The route decisions read ``EWT_PALLAS``/``EWT_PALLAS_MEGA``; an
    in-process demotion elsewhere in the suite may have left the opt-out
    set, so each test here starts without it."""
    monkeypatch.delenv("EWT_PALLAS", raising=False)
    monkeypatch.delenv("EWT_PALLAS_MEGA", raising=False)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRFILE = os.path.join(REPO, "examples", "example_params",
                      "sampled_timing_model.dat")
PSR = "J1234-5678"


@pytest.fixture(scope="module")
def pair():
    jl = j_init(JParams(PRFILE, opts=_opts(0)), gram_mode="f64",
                write_pars=False)[0]
    tl = t_init(TParams(PRFILE, opts=_opts(0)), gram_mode="f64",
                write_pars=False, device="cpu")[0]
    return jl, tl


def near_zero_offsets(like, n, seed):
    """Typical white and spin noise (efac 1, log10 equad -7, log10_A
    -13.5, gamma 3.5; spread 0.05), timing-model offsets near 0 (spread 2%
    of the prior width) and ephemeris offsets near the middle of their
    priors, spread 1e-5 of the width (or of the prior sigma): a physical
    ephemeris offset at the prior's own scale moves the residuals by
    seconds, against microsecond TOA errors (lnL ~ -1e9)."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, like.ndim))
    for i, p in enumerate(like.params):
        z = rng.standard_normal(n)
        if p.name.endswith("efac"):
            out[:, i] = 1.0 + 0.05 * z
        elif "equad" in p.name:
            out[:, i] = -7.0 + 0.05 * z
        elif p.name.endswith("log10_A"):
            out[:, i] = -13.5 + 0.05 * z
        elif p.name.endswith("gamma"):
            out[:, i] = 3.5 + 0.05 * z
        elif isinstance(p.prior, Normal):
            out[:, i] = p.prior.mu + 1e-5 * p.prior.sigma * z
        else:
            assert isinstance(p.prior, Uniform), p.name
            lo, hi = p.prior.lo, p.prior.hi
            rel = 0.02 if "tmparams" in p.name else 1e-5
            out[:, i] = 0.5 * (lo + hi) + rel * (hi - lo) * z
    return out


def test_param_names_equal(pair):
    jl, tl = pair
    assert tl.param_names == jl.param_names
    assert [type(p.prior).__name__ for p in tl.params] == \
        [type(p.prior).__name__ for p in jl.params]
    assert tl.ndim == 26
    assert tl.param_names[-3:] == [f"{PSR}_tmparams_{i}" for i in range(3)]
    assert all(p.prior.lo == -10.0 and p.prior.hi == 10.0
               for p in tl.params[-3:])
    assert tl.static["D_w"].shape == (334, 13)
    assert tl.static["M_w"].shape == (334, 3)
    assert tl.static["T_w"].shape == (334, 40)


def test_static_arrays_equal(pair):
    jl, tl = pair
    consts = eval_protocol(jl)[2]
    for jk, tk in (("r", "r_w"), ("M", "M_w"), ("T", "T_w"),
                   ("s2", "sigma2"), ("D", "D_w")):
        np.testing.assert_allclose(tl.static[tk].numpy(),
                                   np.asarray(consts[jk]), rtol=RTOL,
                                   atol=0, err_msg=jk)


def test_build_choices_match(pair):
    jl, tl = pair
    # walker-dependent residuals: no folded Grams and no pair program
    assert tl.const_grams is False and jl.const_grams is False
    assert not tl.pair_program
    assert len(tl.static["tm_refs"]) == 3


@pytest.mark.parametrize("draw", ["prior", "near_zero"])
def test_f64_lnl(pair, draw):
    jl, tl = pair
    theta = (jl.sample_prior(np.random.default_rng(3), 8)
             if draw == "prior" else near_zero_offsets(tl, 8, 4))
    lnl_j = np.asarray(jl.loglike_batch(jnp.asarray(theta)))
    lnl_t = tl.loglike_batch(theta).numpy()
    assert np.isfinite(lnl_t).all()
    kappa = _sigma_condition(tl, theta)
    rtol = np.maximum(1e-9, 10.0 * kappa * np.finfo(np.float64).eps)
    assert np.all(np.abs(lnl_t - lnl_j) <= rtol * np.abs(lnl_j)), \
        (lnl_t - lnl_j, kappa)


def test_split_against_the_ports_oracle():
    tl = t_init(TParams(PRFILE, opts=_opts(0)), gram_mode="split",
                write_pars=False, device="cpu")[0]
    jl = j_init(JParams(PRFILE, opts=_opts(0)), gram_mode="split",
                write_pars=False)[0]
    theta = near_zero_offsets(tl, 8, 5)
    troutes.reset_counts()
    lnl = tl.loglike_batch(theta).numpy()
    # no likelihood-kernel route without a timing-model matrix; the
    # Sigma solve (n = 40) makes its own solve-kernel decision
    assert troutes.ROUTES[("mega_like", "plain-cpu")] == 0
    assert troutes.ROUTES[("mega_solve", "plain-cpu")] == 1
    st = tl.static
    th = torch.as_tensor(theta)
    c = th[:, [v for _, v in st["det_refs"]]]
    dp = th[:, [v for _, v in st["tm_refs"]]]
    r_eff_w = (st["r_w"] - c @ st["D_w"].T - dp @ st["M_w"].T).numpy()
    sigma = np.sqrt(st["sigma2"].numpy())
    nw = tl.eval_nw(theta).numpy()
    b = tl.eval_phi(theta).numpy()
    # the whitened, column-normalized basis scaled back by sigma: its
    # covariance T' diag(b) T'^T is the physical one
    Tp = sigma[:, None] * st["T_w"].numpy()
    M0 = np.zeros((len(sigma), 0))
    want = np.array([
        oracle_loglike(sigma * r_eff_w[w], sigma, nw[w] * sigma ** 2, M0,
                       Tp, b[w]) for w in range(len(theta))]) \
        + kernel_constant_offset(sigma, M0)
    assert np.max(np.abs(lnl - want)) <= 5e-3, lnl - want
    lnl_j = np.asarray(jl.loglike_batch(jnp.asarray(theta)))
    assert np.max(np.abs(lnl - lnl_j)) <= 1e-5, lnl - lnl_j


def test_cli_runs_on_cpu(tmp_path, pair):
    prfile = _paramfile(tmp_path, 40, "sampled_timing_model.dat")
    rc = cli.main(["--prfile", prfile, "--num", "0"], device="cpu")
    assert rc == 0
    runs = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "out")
            for d in ds if d == f"0_{PSR}"]
    assert len(runs) == 1
    chain = np.loadtxt(os.path.join(runs[0], "chain_1.txt"))
    # the sampler defaults: ntemps 1, nchains 8, thin 10
    assert chain.shape == (40 // 10 * 8, 26 + 4)
    assert np.isfinite(chain).all()
    pars = open(os.path.join(runs[0], "pars.txt")).read().split()
    assert pars == pair[0].param_names


@pytest.fixture(scope="module")
def ephem_marginalized_tm(tmp_path_factory):
    """The same model with the timing model marginalized: sampled
    ephemeris delays subtracted per walker ahead of the Schur stage."""
    src = open(PRFILE).read().replace("tm: sampled\n", "")
    assert "tm:" not in src
    path = tmp_path_factory.mktemp("ephem") / "ephem.dat"
    path.write_text(src.replace(
        "noise_model_file: ", "noise_model_file: "
        + os.path.join(REPO, "examples", "")).replace(
        "datadir: data", "datadir: " + os.path.join(REPO, "examples",
                                                    "data")))
    return str(path)


def test_ephemeris_with_marginalized_tm(ephem_marginalized_tm):
    jl = j_init(JParams(ephem_marginalized_tm, opts=_opts(0)),
                gram_mode="f64", write_pars=False)[0]
    tl = t_init(TParams(ephem_marginalized_tm, opts=_opts(0)),
                gram_mode="f64", write_pars=False, device="cpu")[0]
    assert tl.param_names == jl.param_names and tl.ndim == 23
    assert tl.static["tm_refs"] is None and tl.static["M_w"].shape[1] == 3
    theta = near_zero_offsets(tl, 8, 9)
    lnl_j = np.asarray(jl.loglike_batch(jnp.asarray(theta)))
    lnl_t = tl.loglike_batch(theta).numpy()
    np.testing.assert_allclose(lnl_t, lnl_j, rtol=1e-9, atol=0)
    # per-walker residuals through the likelihood megakernel's host half
    # (its plain version on the CPU) against the classic split chain,
    # within the megakernel class (rtol 1e-3, atol 5e-2)
    st = tl.static
    th = torch.as_tensor(theta)
    r_eff = st["r_w"] - th[:, [v for _, v in st["det_refs"]]] @ st["D_w"].T
    args = (tl.eval_nw(theta), tl.eval_phi(theta), r_eff, st["M_w"],
            st["T_w"])
    mega = marginalized_loglike(*args, gram_mode="split", mega=True)
    classic = marginalized_loglike(*args, gram_mode="split", mega=False)
    np.testing.assert_allclose(mega.numpy(), classic.numpy(), rtol=1e-3,
                               atol=5e-2)
    np.testing.assert_allclose(classic.numpy(), lnl_j, rtol=1e-3, atol=5e-2)
