"""The port's joint multi-pulsar likelihoods against the JAX package's.

Inputs are made from a seed with numpy and go through both packages:

- the ORF matrices (``parallel/orf.py``, a numpy copy): equal to 1e-15;
- ``lower_terms(common_grid=...)``: the common term's basis on the
  PTA-wide grid equal to the reference's (1e-15), and without the grid
  the single-pulsar basis unchanged, bit for bit;
- ``build_pta_likelihood`` on ``make_fake_pta(npsr=4, ntoa=100)`` with
  efac/equad by backend, ``spin_noise`` 5 modes and a Hellings-Downs
  ``gwb`` 5 modes (stage-1 right-hand side k = 1 + 3 + 10 = 14, wider
  than the solve kernel's 8-column panel), at 8 seeded walkers:
  the float64 dense oracle within rtol 1e-9 of the reference's; the
  Schur path in ``split`` mode (here the plain versions of the kernels)
  within 5e-2 + 1e-7 |lnL| of the reference's classic chain and of its
  Pallas kernel in interpret mode; the Schur path against the port's own
  dense oracle in the reference's classes (``tests/test_parallel.py``):
  values 5e-2 + 1e-7 |lnL|, differences 1e-3 + 1e-5 |dlnL|;
- ``hd_noauto``, ``monopole`` and ``dipole`` at npsr 5: both paths,
  the same classes, the dense oracle also within atol 1e-5 (the
  reference's own float64 class, for the low-rank ORFs' conditioning);
- ``examples/example_params/gwb_array.dat`` through both packages'
  ``init_model_likelihoods``: the same ``param_names`` and
  ``noise_pairs``; at prior draws the port's lnL (its float64 Gram, the
  float64 redo of flagged pairs: ``parallel/pta.py``, ``CORNER_C``) in
  the Schur class of the JAX package's dense float64 oracle and of the
  port's, and, bit for bit, its clamp path's on every walker with no
  pair flagged; the reference's algebra in the port (the split Gram,
  the clamp) in the Schur class of the reference's; the dense oracles
  within rtol 1e-9 at near-typical points;
- at a prior corner of ``gwb_array.dat`` (``GWB_CORNER``) the
  reference's split Schur path lies 3.9e10 above float64 (its stage-2
  clamp; ``ROADMAP.md`` Queue 3) and so does its algebra in the port;
  the port's likelihood, one pair flagged and redone in float64, lies in
  the class of the JAX package's dense float64 oracle and the port's:
  the port's departure from the reference, recorded; unflagged pairs and
  walkers keep the clamp path's values bit for bit;
- ``chip_smoke.py:corner_scan`` (the card's corner scan) on 400 prior
  draws: the reference's algebra in the port mostly outside the class of
  float64 and often far above it, in the class of the JAX package's
  split path; the port's lnL far above at none, outside at few, against
  either package's float64 oracle (the two within 1e-4);
- ``MultiPulsarLikelihood`` (a ``gwb`` with no ORF): lnL within rtol
  1e-9 of the reference's in float64, the same names and pairs;
- the port's CLI on ``gwb_array.dat`` (40 steps on the CPU) and its
  results CLI on the output: both exit 0; ``pars.txt`` and the
  ``*_nfreqs.txt`` files are the reference's, and the results CLIs of
  both packages write the same files with the same noise values.
"""

import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (float64 on: the reference's package import)

from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.models import StandardModels as JSM
from enterprise_warp_tpu.models import TermList as JTL
from enterprise_warp_tpu.models import build as jb
from enterprise_warp_tpu.models.assemble import \
    init_model_likelihoods as j_init
from enterprise_warp_tpu.parallel import build_pta_likelihood as j_build
from enterprise_warp_tpu.parallel import orf as jorf
from enterprise_warp_tpu.results import EnterpriseWarpResult as JResult
from enterprise_warp_tpu.sim.noise import make_fake_pta as j_fake
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.models import StandardModels as TSM
from enterprise_warp_tpu_torch.models import TermList as TTL
from enterprise_warp_tpu_torch.models import build as tb
from enterprise_warp_tpu_torch.models.assemble import \
    MultiPulsarLikelihood
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init
from enterprise_warp_tpu_torch.ops import routes as troutes
from enterprise_warp_tpu_torch.parallel import build_pta_likelihood as t_build
from enterprise_warp_tpu_torch.parallel import orf as torf
from enterprise_warp_tpu_torch.parallel.pta import CORNER_C
from enterprise_warp_tpu_torch.results import EnterpriseWarpResult as TResult
from enterprise_warp_tpu_torch.sim import make_fake_pta as t_fake

from test_results import opts_for
from test_torch_cli import _paramfile

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    """The route decisions read ``EWT_PALLAS``/``EWT_PALLAS_MEGA``; an
    in-process demotion elsewhere in the suite may have left the opt-out
    set, so each test here starts without it."""
    monkeypatch.delenv("EWT_PALLAS", raising=False)
    monkeypatch.delenv("EWT_PALLAS_MEGA", raising=False)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GWB_ARRAY = os.path.join(REPO, "examples", "example_params", "gwb_array.dat")
NW_MODES = 5
W = 8
# the Schur path (float32 solves) against a float64 value: the reference's
# class (tests/test_parallel.py), |dlnL| <= 5e-2 + 1e-7 |lnL|
VAL_ATOL, VAL_RTOL = 5e-2, 1e-7
# lnL differences between two points: 1e-3 + 1e-5 |dlnL|
DIFF_ATOL, DIFF_RTOL = 1e-3, 1e-5
# the float64 dense oracle of both packages: the same algebra in float64
F64_RTOL = 1e-9
# ... where a low-rank ORF leaves the equilibrated Sigma at condition ~3e6:
# the reference's own float64 class between its two algebras
# (tests/test_parallel.py, schur-f64 vs dense-f64: rtol 1e-9, atol 1e-5).
# Measured on the dipole fixture: the reference's Cholesky logdet lies
# 7e-6 from a long-double factorization of the same Sigma, the port's
# 5e-10
F64_ATOL_LOW_RANK = 1e-5


def _pta(fake, npsr=4, ntoa=100, seed=3):
    psrs = fake(npsr=npsr, ntoa=ntoa, seed=seed, backends=("A", "B"))
    rng = np.random.default_rng(seed)
    for p in psrs:
        p.residuals = p.toaerrs * rng.standard_normal(len(p))
    return psrs


def _terms(SM, TL, psrs, orf="hd"):
    opt = {"hd": "hd_vary_gamma", "hd_noauto": "hd_vary_gamma_noauto",
           "monopole": "mono_vary_gamma", "dipole": "dipo_vary_gamma",
           None: "vary_gamma"}[orf] + f"_{NW_MODES}_nfreqs"
    out = []
    for p in psrs:
        m = SM(psr=p)
        out.append(TL(p, [m.efac("by_backend"), m.equad("by_backend"),
                          m.spin_noise(f"powerlaw_{NW_MODES}_nfreqs"),
                          m.gwb(opt)]))
    return out


def _theta(names, nwalk=W, seed=1, shift=0.0):
    """Seeded points near typical noise values."""
    rng = np.random.default_rng(seed)
    base = np.array([1.0 if n.endswith("efac") else
                     -7.0 if "equad" in n else
                     -13.5 if n.endswith("log10_A") else 3.5
                     for n in names]) + shift
    return base + 0.2 * rng.standard_normal((nwalk, len(names)))


def _builds(orf="hd", npsr=4, **kw):
    """The JAX and the port likelihood of the same seeded array."""
    jp, tp = _pta(j_fake, npsr), _pta(t_fake, npsr)
    jl = j_build(jp, _terms(JSM, JTL, jp, orf), **kw)
    tl = t_build(tp, _terms(TSM, TTL, tp, orf), device="cpu",
                 **{k: v for k, v in kw.items() if k != "mega"})
    assert jl.param_names == tl.param_names
    return jl, tl


def _in_class(a, ref, atol=VAL_ATOL, rtol=VAL_RTOL):
    a, ref = np.asarray(a), np.asarray(ref)
    assert np.isfinite(a).all() and np.isfinite(ref).all()
    assert np.all(np.abs(a - ref) <= atol + rtol * np.abs(ref)), \
        (a - ref, ref)


# ---- parallel/orf.py -------------------------------------------------- #

@pytest.mark.parametrize("name", ["hd", "hd_noauto", "dipole", "monopole"])
def test_orf_matrices_equal(name):
    pos = np.stack([p.pos for p in _pta(t_fake, 7)])
    np.testing.assert_allclose(torf.orf_matrix(name, pos),
                               jorf.orf_matrix(name, pos), rtol=0,
                               atol=1e-15)
    assert torf.is_positive_definite(name) == jorf.is_positive_definite(name)
    assert torf.is_low_rank(name) == jorf.is_low_rank(name)
    with pytest.raises(ValueError):
        torf.orf_matrix("quadrupole", pos)


# ---- models/build.py: lower_terms(common_grid=...) --------------------- #

def test_lower_terms_common_grid_bases_equal():
    jp, tp = _pta(j_fake), _pta(t_fake)
    t0 = min(p.toas.min() for p in tp)
    grid = (t0, max(p.toas.max() for p in tp) - t0)
    for a, b, ta, tt in zip(jp, tp, _terms(JSM, JTL, jp),
                            _terms(TSM, TTL, tp)):
        _, bj, Tj = jb.lower_terms(a, ta, common_grid=grid)
        _, bt, Tt = tb.lower_terms(b, tt, common_grid=grid)
        np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-15)
        gj = next(x for x in bj if x.orf is not None)
        gt = next(x for x in bt if x.orf is not None)
        np.testing.assert_allclose(gt.freqs, gj.freqs, rtol=1e-15)
        assert (gt.col_slice, gt.orf) == (gj.col_slice, gj.orf)
        # without the grid: the pulsar's own span, as before, bit for bit
        _, _, T_own = tb.lower_terms(b, tt)
        _, _, T_span = tb.lower_terms(b, tt, common_grid=(b.toas.min(),
                                                          b.Tspan))
        np.testing.assert_array_equal(T_own, T_span)
        assert not np.array_equal(T_own, Tt)


# ---- parallel/pta.py --------------------------------------------------- #

def test_dense_f64_matches_jax():
    jl, tl = _builds(gram_mode="f64")
    assert tl.joint_mode == "dense"
    th = _theta(tl.param_names)
    np.testing.assert_allclose(tl.loglike_batch(th).numpy(),
                               np.asarray(jl.loglike_batch(th)),
                               rtol=F64_RTOL)


@pytest.mark.parametrize("mega", [False, "interpret"],
                         ids=["classic", "interpret"])
def test_schur_split_matches_jax(mega):
    # JAX's classic chain, or its Pallas solve kernel in interpret mode
    # in stages 1 and 3, against the port's plain versions on the CPU
    jl, tl = _builds(gram_mode="split", mega=mega)
    st = tl._stages
    assert tl.joint_mode == "schur"
    assert 1 + st["MW"] + st["n_g"] == 14 > 8
    th = _theta(tl.param_names)
    troutes.reset_counts()
    lt = tl.loglike_batch(th).numpy()
    # one stage-1 and one stage-3 solve, each one call for all walkers
    assert troutes.ROUTES[("mega_solve", "plain-cpu")] == 2
    _in_class(lt, np.asarray(jl.loglike_batch(th)))


def test_schur_matches_dense_oracle():
    _, dense = _builds(gram_mode="f64")
    _, schur = _builds(gram_mode="split")
    names = dense.param_names
    a, b = _theta(names, seed=2), _theta(names, seed=2, shift=0.3)
    vd = [dense.loglike_batch(t).numpy() for t in (a, b)]
    vs = [schur.loglike_batch(t).numpy() for t in (a, b)]
    for x, ref in zip(vs, vd):
        _in_class(x, ref)
    _in_class(vs[0] - vs[1], vd[0] - vd[1], DIFF_ATOL, DIFF_RTOL)


@pytest.mark.parametrize("orf", ["hd_noauto", "monopole", "dipole"])
def test_other_orfs_match_jax(orf):
    jd, td = _builds(orf, npsr=5, gram_mode="f64")
    js, ts = _builds(orf, npsr=5, gram_mode="split", mega=False)
    th = _theta(td.param_names, seed=4)
    d = td.loglike_batch(th).numpy()
    np.testing.assert_allclose(d, np.asarray(jd.loglike_batch(th)),
                               rtol=F64_RTOL, atol=F64_ATOL_LOW_RANK)
    s = ts.loglike_batch(th).numpy()
    _in_class(s, np.asarray(js.loglike_batch(th)))
    _in_class(s, d)


def test_pta_interface():
    _, tl = _builds(gram_mode="split")
    assert tl.param_names.count("gw_log10_A") == 1
    assert tl.ndim == 4 * (2 + 2 + 2) + 2
    assert tl.device == torch.device("cpu")
    th = torch.as_tensor(_theta(tl.param_names, nwalk=3))
    assert tl.log_prior(th).shape == (3,)
    out = tl.loglike_batch(th)
    assert out.dtype == torch.float64 and out.shape == (3,)
    # a non-finite walker is -inf, its neighbours untouched
    bad = th.clone()
    bad[1, 0] = float("nan")
    out2 = tl.loglike_batch(bad)
    assert out2[1] == -np.inf
    np.testing.assert_array_equal(out2[[0, 2]].numpy(), out[[0, 2]].numpy())


# ---- models/assemble.py: the three-way dispatch ----------------------- #

def _opts():
    return types.SimpleNamespace(num=0, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)


@pytest.fixture(scope="module")
def gwb_array():
    jp = JParams(GWB_ARRAY, opts=_opts())
    tp = TParams(GWB_ARRAY, opts=_opts())
    return jp, tp


def test_gwb_array_paramfile_matches_jax(gwb_array):
    jp, tp = gwb_array
    js = j_init(jp, write_pars=False)[0]
    ts = t_init(tp, write_pars=False, device="cpu")[0]
    assert type(ts).__name__ == "PTALikelihood"
    assert ts.param_names == js.param_names and ts.ndim == 16
    assert ts.noise_pairs == js.noise_pairs and len(ts.noise_pairs) == 5
    st = ts._stages
    assert (st["NW"], st["MW"], st["n_g"], st["npsr"]) == (20, 3, 20, 2)
    rng = np.random.default_rng(5)
    u = rng.uniform(size=(W, ts.ndim))
    th = ts.from_unit(torch.as_tensor(u)).numpy()
    # at prior draws the port's likelihood (float64 Gram, the float64 redo
    # of flagged pairs: parallel/pta.py, CORNER_C) lies in the Schur class
    # of the JAX package's dense float64 oracle (the reference's own split
    # Schur path lies outside it there: its float32 corners); the
    # reference's algebra in the port (the split Gram and the clamp
    # alone) lies in the Schur class of the reference's; the port's
    # likelihood keeps the clamp path's value bit for bit on every walker
    # with no pair flagged, and lies in the class of the port's dense
    # float64 oracle at every draw
    lnl = ts.loglike_batch(th).numpy()
    _in_class(lnl, np.asarray(j_init(jp, gram_mode="f64", write_pars=False)[0]
                              .loglike_batch(th)))
    st, t = ts._stages, ts.as_theta(th)
    com = st["common"](t, gram="split")
    ref = st["stage12"](com[0], com[1], com[5], corner_c=None)
    _in_class(st["stage3"](t, ref, *com[2:5]).numpy(),
              np.asarray(js.loglike_batch(th)))
    com = st["common"](t)
    clamp = st["stage12"](com[0], com[1], com[5], corner_c=None)
    l_clamp = st["stage3"](t, clamp, *com[2:5]).numpy()
    keep = (clamp["ev_ratio"] >= CORNER_C).all(dim=1).numpy()
    assert keep.any() and not keep.all()
    np.testing.assert_array_equal(lnl[keep], l_clamp[keep])
    _in_class(lnl, t_init(tp, gram_mode="f64", write_pars=False,
                          device="cpu")[0].loglike_batch(th).numpy())
    # float64 at near-typical points: at prior draws the float64 algebras
    # of either package spread by up to 1e-4 (red-noise log10_A -8.9)
    th = _theta(ts.param_names, seed=5)
    jd = j_init(jp, gram_mode="f64", write_pars=False)[0]
    td = t_init(tp, gram_mode="f64", write_pars=False, device="cpu")[0]
    np.testing.assert_allclose(td.loglike_batch(th).numpy(),
                               np.asarray(jd.loglike_batch(th)),
                               rtol=F64_RTOL)


# a prior draw of gwb_array.dat (J0042-0000 efac 0.0064, log10 equad
# -9.33) where the reference's split Schur path lies 3.9e10 above float64:
# J0042-0000's stage-1 solve on the split Gram leaves its timing-model
# Schur complement indefinite, and the relative eigenvalue clamp turns it
# into a huge quadratic form. A PT chain on the card locked on such
# corners (ROADMAP.md Queue 3). The port does that pair again in float64
# (parallel/pta.py, CORNER_C).
GWB_CORNER = [9.550267261985898, 9.864879953879617, 0.21294984471825207,
              7.983805557016662, -7.573009349530989, -9.090666556223736,
              -5.3159387846797745, -8.518091457654648, -15.409271725939389,
              9.74767137573976, -14.455641670495108, 9.643583519953092,
              0.006367229449742995, -9.329792781673513, -12.034782490427611,
              5.720836340350981]


def test_gwb_corner_shared_with_reference(gwb_array):
    """The port's departure at ``GWB_CORNER``: the reference still gives
    3.885e10 there, and so does the reference's algebra in the port (the
    split Gram and the clamp); the port's likelihood (the float64 Gram,
    J0042-0000's pair flagged and redone in float64) lies within the
    class of the JAX package's dense float64 oracle and of the port's."""
    jp, tp = gwb_array
    row = np.asarray([GWB_CORNER])
    ref = float(t_init(tp, gram_mode="f64", write_pars=False,
                       device="cpu")[0].loglike_batch(row)[0])
    jval = float(np.asarray(j_init(jp, write_pars=False)[0]
                            .loglike_batch(row))[0])
    j64 = float(np.asarray(j_init(jp, gram_mode="f64", write_pars=False)[0]
                           .loglike_batch(row))[0])
    like = t_init(tp, write_pars=False, device="cpu")[0]
    tval = float(like.loglike_batch(row)[0])
    assert np.isfinite(ref) and jval == pytest.approx(3.885e10, rel=1e-3)
    # the port's likelihood there: within the class of the JAX package's
    # dense float64 oracle, where the reference's lies 3.9e10 above it
    _in_class(tval, j64)
    assert jval > j64 + 1e9
    # the reference's algebra in the port reproduces the reference's
    # value, corner and all, with J0042-0000's complement indefinite
    st = like._stages
    th = like.as_theta(row)
    com = st["common"](th, gram="split")
    ref_st = st["stage12"](com[0], com[1], com[5], corner_c=None)
    _in_class(float(st["stage3"](th, ref_st, *com[2:5])[0]), jval)
    assert ref_st["ev_ratio"][0, 1] < 0
    # on the port's Gram one pair (J0042-0000's) is flagged there
    com = st["common"](th)
    clamp = st["stage12"](com[0], com[1], com[5], corner_c=None)
    flagged = (clamp["ev_ratio"][0] < CORNER_C).tolist()
    assert flagged == [False, True]
    # and within the class of the port's own float64 oracle
    _in_class(tval, ref)
    # and the float64 Schur algebra is right there
    tl = t_build(tp.psrs, _termlists(tp), gram_mode="f64",
                 joint_mode="schur", device="cpu")
    _in_class(float(tl.loglike_batch(row)[0]), ref)


def test_unflagged_pairs_bit_for_bit(gwb_array):
    """Pairs the repair does not flag keep the clamp path's stage-1/2
    values and the walker its lnL, bit for bit, at near-typical points
    (none flagged there) and beside a flagged walker in one batch."""
    _, tp = gwb_array
    like = t_init(tp, write_pars=False, device="cpu")[0]
    st = like._stages
    th = _theta(like.param_names, nwalk=W, seed=9)
    th[3] = GWB_CORNER
    t = like.as_theta(th)
    com = st["common"](t)
    clamp = st["stage12"](com[0], com[1], com[5], corner_c=None)
    fixed = st["stage12"](com[0], com[1], com[5])
    flag = ~(clamp["ev_ratio"] >= CORNER_C)
    assert flag.sum() == 1 and flag[3, 1]
    for k, v in clamp.items():
        assert torch.equal(v[~flag], fixed[k][~flag]), k
        assert not torch.equal(v[flag], fixed[k][flag]), k
    l_clamp = st["stage3"](t, clamp, *com[2:5])
    lnl = like.loglike_batch(th)
    keep = torch.ones(W, dtype=torch.bool)
    keep[3] = False
    assert torch.equal(lnl[keep], l_clamp[keep])


def test_corner_scan_on_prior_draws(gwb_array):
    """``chip_smoke.py:corner_scan``, the scan the card runs, on the CPU
    at 400 prior draws of ``gwb_array.dat`` (seed 0): the reference's
    algebra in the port agrees with the JAX package's split Schur path in
    its class wherever both are finite and lies outside the class of
    float64 at most draws, many far above; the port's likelihood at none
    far above and at few outside, against the port's dense float64
    oracle and the JAX package's alike; the two oracles within 1e-4 of
    each other (at prior draws the float64 algebras of either package
    spread by up to 4.7e-5 relative, 0.069 absolute)."""
    import sys
    sys.path.insert(0, REPO)
    from chip_smoke import CORNER_FAR, corner_scan
    jp, tp = gwb_array
    like = t_init(tp, write_pars=False, device="cpu")[0]
    oracle = t_init(tp, gram_mode="f64", write_pars=False, device="cpu")[0]
    theta = like.sample_prior(np.random.default_rng(0), 400)
    summary, arr = corner_scan(like, oracle, theta, chunk=100)
    print(json.dumps(summary))
    fin = np.isfinite(arr["lnl_f64"])
    assert summary["finite_f64"] == fin.sum() >= 390
    ref, rep = summary["reference"], summary["repaired"]
    assert ref["out_of_class"] >= 200 and ref["far_above"] >= 40
    assert rep["far_above"] == 0 and rep["out_of_class"] <= 10
    assert summary["every_pair_f64"]["far_above"] == 0
    np.testing.assert_array_equal(arr["lnl"][fin],
                                  like.loglike_batch(theta[fin]).numpy())
    j64 = np.asarray(j_init(jp, gram_mode="f64", write_pars=False)[0]
                     .loglike_batch(theta[fin]))
    np.testing.assert_allclose(arr["lnl_f64"][fin], j64, rtol=1e-4)
    gap = arr["lnl"][fin] - j64
    assert np.all(gap <= CORNER_FAR)
    assert np.sum(np.abs(gap) > VAL_ATOL + VAL_RTOL * np.abs(j64)) <= 10
    jref = np.asarray(j_init(jp, write_pars=False)[0].loglike_batch(theta))
    both = fin & np.isfinite(jref) & (np.abs(jref) < 1e12)
    gap = np.abs(arr["lnl_reference"][both] - jref[both])
    assert np.mean(gap <= VAL_ATOL + VAL_RTOL * np.abs(jref[both])) >= 0.95


def _termlists(params):
    from enterprise_warp_tpu_torch.models.assemble import \
        build_terms_for_model
    return build_terms_for_model(params.models[0], params.psrs,
                                 params.noise_model_obj)


def test_tm_sampled_with_correlated_common_refused(gwb_array):
    _, tp = gwb_array
    tp.models[0].tm = "sampled"
    try:
        with pytest.raises(NotImplementedError, match="per-pulsar"):
            t_init(tp, write_pars=False, device="cpu")
    finally:
        tp.models[0].tm = "default"


def test_multi_pulsar_likelihood_matches_jax():
    from enterprise_warp_tpu.models.assemble import \
        MultiPulsarLikelihood as JMulti
    jp, tp = _pta(j_fake, 3), _pta(t_fake, 3)
    jl = JMulti([jb.build_pulsar_likelihood(p, tl, gram_mode="f64")
                 for p, tl in zip(jp, _terms(JSM, JTL, jp, None))])
    tl = MultiPulsarLikelihood([
        tb.build_pulsar_likelihood(p, t, gram_mode="f64", device="cpu")
        for p, t in zip(tp, _terms(TSM, TTL, tp, None))])
    assert tl.param_names == jl.param_names
    assert tl.param_names.count("gw_log10_A") == 1
    assert tl.noise_pairs == jl.noise_pairs
    th = _theta(tl.param_names, seed=6)
    np.testing.assert_allclose(tl.loglike_batch(th).numpy(),
                               np.asarray(jl.loglike_batch(th)),
                               rtol=F64_RTOL)


# ---- cli.py and results/ on the array run ----------------------------- #

def _files(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs)


def test_cli_and_results_on_gwb_array(tmp_path):
    prfile = _paramfile(tmp_path, 40, "gwb_array.dat")
    assert cli.main(["--prfile", prfile, "--num", "0"], device="cpu") == 0
    run = os.path.join(tmp_path, "out", "gwb_gwb_array")
    chain = np.loadtxt(os.path.join(run, "chain_1.txt"))
    assert chain.shape == (40 // 10 * 8, 16 + 4)
    assert np.isfinite(chain).all()
    # the reference's pars.txt and nfreqs files for the same paramfile
    ref = tmp_path / "ref"
    jp = JParams(prfile, opts=_opts())
    jp.output_dir = str(ref)
    os.makedirs(ref)
    j_init(jp, write_pars=True)
    for f in _files(ref):
        assert open(os.path.join(run, f)).read() == \
            open(os.path.join(ref, f)).read(), f
    # both results CLIs on copies of the run: the same files, equal noise
    outs = {}
    for key, cls in (("port", TResult), ("jax", JResult)):
        dst = str(tmp_path / key)
        shutil.copytree(run, dst)
        r = cls(opts_for(dst, noisefiles=1, credlevels=1, covm=1))
        r.main_pipeline()
        outs[key] = dst
    assert _files(outs["port"]) == _files(outs["jax"])
    noise = "noisefiles/J1234-5678_noise.json"
    a, b = (json.load(open(os.path.join(outs[k], noise)))
            for k in ("port", "jax"))
    assert sorted(a) == sorted(b) == sorted(
        open(os.path.join(run, "pars.txt")).read().split())
    np.testing.assert_allclose([a[k] for k in sorted(a)],
                               [b[k] for k in sorted(a)], rtol=1e-12)


@pytest.mark.parametrize("corner", [False, True], ids=["typical", "corner"])
def test_cli_warns_on_a_chain_locked_on_a_corner(tmp_path, caplog, corner):
    """``cli.check_joint_chain`` re-scores a joint chain's largest lnL in
    float64 and warns where the float32 Schur path lies outside the
    reference's class there (a chain locked on ``GWB_CORNER``, as a run
    with the reference's algebra locks), and only there."""
    prfile = _paramfile(tmp_path, 40, "gwb_array.dat")
    tp = TParams(prfile, opts=_opts())
    like = t_init(tp, write_pars=False, device="cpu")[0]
    th = _theta(like.param_names, nwalk=2, seed=7)
    if corner:
        th[1] = GWB_CORNER
    lnl = like.loglike_batch(th).numpy()
    if corner:
        # the chain of a run locked on the corner holds the value the
        # reference's algebra gives there
        lnl[1] = np.asarray(j_init(JParams(prfile, opts=_opts()),
                                   write_pars=False)[0]
                            .loglike_batch(th[1:2]))[0]
    os.makedirs(tp.output_dir, exist_ok=True)
    np.savetxt(os.path.join(tp.output_dir, "chain_1.txt"),
               np.column_stack([th, lnl, lnl, np.ones((2, 2))]))
    with caplog.at_level("WARNING", logger="enterprise_warp_tpu_torch.cli"):
        top, ref = cli.check_joint_chain(tp, like, "cpu")
    assert top == lnl.max()
    locked = [r for r in caplog.records if "locked the chain" in r.message]
    assert len(locked) == int(corner)
    assert (abs(top - ref) > VAL_ATOL + VAL_RTOL * abs(ref)) == corner
