"""The port's sampled chromatic index (``chromred("vary...")``) against the
JAX package's, on the CPU.

- J1234-5678 (334 TOAs, four backends, 600-3100 MHz) with white noise by
  backend, spin and DM noise of 30 frequencies and ``chromred
  ("vary_30_nfreqs")`` (nb 180): the same ``param_names`` (the index
  last, where ``collect_params`` puts it), and lnL at 16 prior draws
  made from numpy uniforms: in ``gram_mode="f64"`` within rtol 1e-8 of the
  JAX package's (float64 on both sides; the largest gap at these draws
  is 4.3e-9 relative, at a draw whose Sigma has condition 3e4); in
  ``split`` mode, at every draw whose equilibrated Sigma has a condition
  number below 5e4 (where both float32 preconditioned solves converge),
  within 5e-4 + 1e-6 |lnL| (the repo's split-against-split class), at
  least 10 of the 16 such, and the same non-finite draws everywhere
  (past 5e4 both packages' split paths leave their own float64 oracle,
  by up to 6 at these draws, in different directions);
- the counterpart of ``tests/test_models.py:118-131`` in both packages:
  ``vary`` at index 4 equals the fixed index ``"4"`` within 1e-6;
- the route: the JAX package's kernel route (forced, interpret mode)
  raises on the per-walker basis, where the port's likelihood kernel
  declines it with the reason ``per-walker-basis`` recorded in
  ``ops/routes.py:ROUTES`` (also for a CUDA device) and the Sigma solve
  makes its own decision; the health twin gives the same lnL;
- the joint likelihood of ``gwb_array.dat``'s model with J1234-5678's
  entry adding ``chromred: vary_10_nfreqs``: the same names in both
  packages, no evaluation cache in either (no ``param_blocks``), at 8
  prior draws the two dense float64 oracles within rtol 1e-6 and the
  port's Schur path within 5e-2 + 1e-7 |lnL| of the JAX package's dense
  oracle (the Schur class of ``tests/test_torch_pta.py``), the port's
  health twin equal to its Schur path;
- one HMC gradient at chromatic points near a typical state against the
  JAX gradient, within 1e-3 max(1, |g|);
- two PT blocks of the single-pulsar model through the port's CLI (its
  ``pars.txt`` the JAX package's parameter names, the index inside its
  prior, the plane's ledger one entry a block), and its results CLI on
  the output.
"""

import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.io import load_pulsar as j_load
from enterprise_warp_tpu.models import StandardModels as JSM
from enterprise_warp_tpu.models import TermList as JTL
from enterprise_warp_tpu.models import build_pulsar_likelihood as j_build
from enterprise_warp_tpu.models.assemble import \
    init_model_likelihoods as j_init
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.io import load_pulsar as t_load
from enterprise_warp_tpu_torch.models import StandardModels as TSM
from enterprise_warp_tpu_torch.models import TermList as TTL
from enterprise_warp_tpu_torch.models import build_pulsar_likelihood as t_build
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init
from enterprise_warp_tpu_torch.models.build import eval_T
from enterprise_warp_tpu_torch.ops import megakernel as tmk
from enterprise_warp_tpu_torch.ops import routes as troutes
from enterprise_warp_tpu_torch.ops.kernel import gram_blocks
from enterprise_warp_tpu_torch.results import EnterpriseWarpResult as TResult

from test_results import opts_for
from test_torch_cholfuse import typical_points

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
DATA = os.path.join(EXAMPLES, "data")
IDX = "J1234-5678_chromatic_gp_idx"
MODEL = {"white_noise": "by_backend", "spin_noise": "powerlaw_30_nfreqs",
         "dm_noise": "powerlaw_30_nfreqs", "chromred": "vary_30_nfreqs"}


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    for var in ("EWT_PALLAS", "EWT_PALLAS_MEGA", "EWT_PALLAS_CHOL",
                "EWT_FUSED_CHOL", "EWT_PALLAS_INTERPRET", "EWT_UPDATE_MASK"):
        monkeypatch.delenv(var, raising=False)


def _psrs():
    par, tim = (os.path.join(DATA, "J1234-5678" + e) for e in (".par", ".tim"))
    return j_load(par, tim), t_load(par, tim)


def _terms(SM, TL, psr, model):
    m = SM(psr=psr)
    return TL(psr, [getattr(m, k)(v) for k, v in model.items()])


def _likes(gram_mode, model=MODEL):
    jp, tp = _psrs()
    return (j_build(jp, _terms(JSM, JTL, jp, model), gram_mode=gram_mode),
            t_build(tp, _terms(TSM, TTL, tp, model), gram_mode=gram_mode,
                    device="cpu"))


def _draws(like, n, seed):
    u = np.random.default_rng(seed).uniform(size=(n, like.ndim))
    return like.from_unit(torch.as_tensor(u)).numpy()


def _sigma_condition(tl, theta):
    """Condition number of each walker's equilibrated Sigma (float64),
    on its own per-walker basis."""
    st = tl.static
    th = torch.as_tensor(theta)
    G = gram_blocks(tl.eval_nw(th), st["r_w"], st["M_w"],
                    eval_T(th, st["bb"], st["T_w"]), gram_mode="f64")[0]
    S = G.numpy() + np.stack([np.diag(1.0 / p)
                              for p in tl.eval_phi(th).numpy()])
    d = np.sqrt(np.einsum("wii->wi", S))
    return np.linalg.cond(S / d[:, :, None] / d[:, None, :])


@pytest.mark.parametrize("gram_mode", ["f64", "split"])
def test_lnl_at_prior_draws_matches_jax(gram_mode):
    jl, tl = _likes(gram_mode)
    assert tl.param_names == jl.param_names
    assert tl.param_names[-1] == IDX and tl.ndim == 15
    assert tuple(tl.static["T_w"].shape) == (334, 180)
    assert not tl.const_grams and not tl.pair_program
    theta = _draws(tl, 16, seed=0)
    lnl_j = np.asarray(jl.loglike_batch(jnp.asarray(theta)))
    lnl_t = tl.loglike_batch(theta).numpy()
    fin = np.isfinite(lnl_j)
    np.testing.assert_array_equal(np.isfinite(lnl_t), fin)
    gap = np.abs(lnl_t[fin] - lnl_j[fin])
    if gram_mode == "f64":
        assert fin.all()
        assert np.all(gap <= 1e-8 * np.abs(lnl_j)), gap
        return
    held = (_sigma_condition(tl, theta) < 5e4)[fin]
    assert held.sum() >= 10
    assert np.all(gap[held] <= 5e-4 + 1e-6 * np.abs(lnl_j[fin][held])), \
        gap[held]


def test_vary_at_four_equals_fixed_four():
    """``tests/test_models.py:118-131`` in both packages."""
    vary = {"white_noise": "by_backend", "chromred": "vary"}
    fixed = {"white_noise": "by_backend", "chromred": "4"}
    jv, tv = _likes("f64", vary)
    jf, tf = _likes("f64", fixed)
    assert tv.param_names == jv.param_names and tv.ndim == tf.ndim + 1
    assert tv.param_names[-1] == IDX
    th_f = np.array([0.5 * (p.prior.lo + p.prior.hi) for p in tf.params])
    th_f[-2:] = (-13.0, 3.0)
    th_v = np.concatenate([th_f, [4.0]])
    for lv, lf in ((jv, jf), (tv, tf)):
        a = float(np.asarray(lv.loglike_batch(th_v[None]))[0])
        b = float(np.asarray(lf.loglike_batch(th_f[None]))[0])
        assert a == pytest.approx(b, abs=1e-6)


def test_route_declines_per_walker_basis(monkeypatch):
    jl, tl = _likes("split")
    theta = typical_points(tl, 4, seed=3)
    theta[:, -1] = 4.0
    # the reference's kernel route (forced, interpret mode) raises: its
    # vmap rule takes a static basis only
    # (the route is decided at trace time: drop the programs traced by
    # earlier tests so this call traces anew)
    monkeypatch.setenv("EWT_PALLAS_INTERPRET", "1")
    jax.clear_caches()
    with pytest.raises(NotImplementedError, match="static basis"):
        jl.loglike_batch(jnp.asarray(theta))
    monkeypatch.delenv("EWT_PALLAS_INTERPRET")
    jax.clear_caches()
    troutes.reset_counts()
    lnl = tl.loglike_batch(theta).numpy()
    assert troutes.ROUTES[("mega_like", "per-walker-basis")] == 1
    assert troutes.ROUTES[("mega_solve", "plain-cpu")] == 1
    assert sum(troutes.LAUNCHES.values()) == 0
    assert np.isfinite(lnl).all()
    # a CUDA device takes the same decline (no launch, reason recorded)
    troutes.reset_counts()
    assert not tmk.mega_like_route(334, 180, "cuda", True)
    assert troutes.ROUTES == {("mega_like", "per-walker-basis"): 1}
    # the health plane's twin: the same lnL on the classic chain
    lh, hw = tl._eval_health_batch(theta)
    np.testing.assert_allclose(lh.numpy(), lnl, rtol=1e-12)
    assert tuple(hw.shape) == (4, 3)


# ---- the joint likelihood ----------------------------------------------- #

def _opts():
    return types.SimpleNamespace(num=0, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)


def _array_paramfile(tmp, nsamp=40):
    nm = json.load(open(os.path.join(EXAMPLES, "example_noisemodels",
                                     "gwb_noise.json")))
    nm["J1234-5678"] = dict(nm["universal"], chromred="vary_10_nfreqs")
    (tmp / "nm.json").write_text(json.dumps(nm))
    path = tmp / "array.dat"
    path.write_text(f"datadir: {DATA}\nout: {tmp / 'out'}\noverwrite: True\n"
                    "array_analysis: True\nsampler: ptmcmcsampler\n"
                    f"nsamp: {nsamp}\n{{0}}\nnoise_model_file: "
                    f"{tmp / 'nm.json'}\n")
    return str(path)


def test_joint_dynamic_blocks_match_jax(tmp_path):
    pf = _array_paramfile(tmp_path)
    lk = {}
    for gm in ("f64", "split"):
        lk[gm] = (j_init(JParams(pf, opts=_opts()), gram_mode=gm,
                         write_pars=False)[0],
                  t_init(TParams(pf, opts=_opts()), gram_mode=gm,
                         write_pars=False, device="cpu")[0])
    jd, td = lk["f64"]
    js, ts = lk["split"]
    assert td.param_names == jd.param_names == ts.param_names
    assert IDX in ts.param_names
    assert "J0042-0000_chromatic_gp_idx" not in ts.param_names
    # no evaluation cache where the basis is walker-dependent
    for like in (jd, js, td, ts):
        assert getattr(like, "param_blocks", None) is None
    theta = jd.sample_prior(np.random.default_rng(1), 8)
    oracle = np.asarray(jd.loglike_batch(jnp.asarray(theta)))
    np.testing.assert_allclose(td.loglike_batch(theta).numpy(), oracle,
                               rtol=1e-6)
    schur = ts.loglike_batch(theta).numpy()
    assert np.all(np.abs(schur - oracle) <= 5e-2 + 1e-7 * np.abs(oracle))
    lh, hw = ts._eval_health_batch(theta)
    np.testing.assert_allclose(lh.numpy(), schur, rtol=1e-12)
    assert tuple(hw.shape) == (8, 2, 3)


def test_hmc_gradient_matches_jax():
    jl, tl = _likes("split")
    theta = typical_points(tl, 8, seed=7)
    theta[:, -1] = 2.0 + 0.1 * np.arange(8)
    gj = jax.vmap(jax.grad(jl.loglike))(jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    gt, = torch.autograd.grad(tl.loglike_batch(th).sum(), th)
    gt, gj = gt.numpy(), np.asarray(gj)
    assert np.isfinite(gt).all()
    rel = np.abs(gt - gj) / np.maximum(1.0, np.abs(gj))
    assert rel.max() <= 1e-3, rel.max()
    assert np.abs(gt[:, -1]).max() > 0          # the index moves lnL


def test_cli_two_pt_blocks_and_results(tmp_path):
    (tmp_path / "nm.json").write_text(json.dumps(
        {"model_name": "chrom", "universal": MODEL}))
    pf = tmp_path / "run.dat"
    pf.write_text(f"datadir: {DATA}\nout: {tmp_path / 'out'}\n"
                  "overwrite: True\narray_analysis: False\n"
                  "sampler: ptmcmcsampler\nnsamp: 80\ncovUpdate: 40\n{0}\n"
                  f"noise_model_file: {tmp_path / 'nm.json'}\n")
    assert cli.main(["--prfile", str(pf), "--num", "0"], device="cpu") == 0
    run = [r for r, _, fs in os.walk(tmp_path / "out")
           if "chain_1.txt" in fs]
    assert len(run) == 1
    run = run[0]
    chain = np.loadtxt(os.path.join(run, "chain_1.txt"))
    names = open(os.path.join(run, "pars.txt")).read().split()
    assert names[-1] == IDX and chain.shape[1] == len(names) + 4
    # 80 steps at the paramfile parser's default thin (10), 8 cold chains
    assert chain.shape[0] == 80 // 10 * 8 and np.isfinite(chain).all()
    assert np.all((chain[:, len(names) - 1] >= 0.0)
                  & (chain[:, len(names) - 1] <= 6.0))
    assert list(np.load(os.path.join(run, "state.npz"))["diag_counts"]) \
        == [40, 40]
    # the JAX package's parameters for the same paramfile
    assert j_init(JParams(str(pf), opts=_opts()),
                  write_pars=False)[0].param_names == names
    dst = str(tmp_path / "res")
    shutil.copytree(run, dst)
    TResult(opts_for(dst, noisefiles=1, credlevels=1)).main_pipeline()
    noise = [f for f in os.listdir(os.path.join(dst, "noisefiles"))]
    assert noise
    vals = json.load(open(os.path.join(dst, "noisefiles", noise[0])))
    assert IDX in vals and 0.0 <= vals[IDX] <= 6.0
