"""The port's evaluation cache (``samplers/evalproto.py`` and the joint
likelihood's ``_cache_*`` functions) against the JAX package's.

The fixture is the reference's own (``tests/test_evalcache.py::
TestJointUpdateMask``): 3 fake pulsars of 80 TOAs, efac by backend,
spin noise of 3 modes and a Hellings-Downs ``gwb`` of 3 modes, in
``joint_mode='schur'``, built by both packages from the same seeded
pulsars:

- ``param_blocks`` equal to the JAX package's, element by element;
- a randomized sequence of site, common, full and rejected updates
  tracks a full recompute of the port at the same theta within the
  reference's tolerances (float64 1e-8, split 1e-6), and the JAX
  package's cached value too (float64 1e-8; split, where the port forms
  its Grams in float64, the Schur class 5e-2 + 1e-7 |lnL|);
- ``derive_update_mask`` gives the reference's mask on the same
  transitions;
- a stale mask raises ``ValueError`` and leaves the held state alone;
- ``reject`` restores theta, the cache (the same tensors) and lnL;
- ``EWT_UPDATE_MASK=0`` installs nothing.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (float64 on: the reference's package import)

from enterprise_warp_tpu.models import StandardModels as JSM
from enterprise_warp_tpu.models import TermList as JTL
from enterprise_warp_tpu.parallel import build_pta_likelihood as j_build
from enterprise_warp_tpu.samplers.evalproto import \
    CachedEvaluator as JCached
from enterprise_warp_tpu.samplers.evalproto import \
    derive_update_mask as j_derive
from enterprise_warp_tpu.sim.noise import make_fake_pta as j_fake
from enterprise_warp_tpu_torch.models import StandardModels as TSM
from enterprise_warp_tpu_torch.models import TermList as TTL
from enterprise_warp_tpu_torch.parallel import build_pta_likelihood as t_build
from enterprise_warp_tpu_torch.samplers.evalproto import (BLOCK_COMMON,
                                                          CachedEvaluator,
                                                          derive_update_mask)
from enterprise_warp_tpu_torch.sim import make_fake_pta as t_fake

torch.set_num_threads(2)
# the reference's tolerances for a cached value against a full recompute
# (tests/test_evalcache.py): float64 and split Gram modes
TOL = {"f64": 1e-8, "split": 1e-6}
# the port's cached value against the reference's: the same in float64;
# in split mode the port forms its Grams in float64 (parallel/pta.py,
# CORNER_C), so the Schur class, 5e-2 + 1e-7 |lnL|
CROSS = {"f64": (1e-8, 0.0), "split": (5e-2, 1e-7)}


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    """The route decisions read ``EWT_PALLAS``/``EWT_PALLAS_MEGA`` and the
    protocol's install reads ``EWT_UPDATE_MASK``; an in-process setting
    elsewhere in the suite may have left one set, so each test here
    starts without them."""
    for key in ("EWT_PALLAS", "EWT_PALLAS_MEGA", "EWT_UPDATE_MASK"):
        monkeypatch.delenv(key, raising=False)


def _psrs(fake, npsr=3, seed=3):
    psrs = fake(npsr=npsr, ntoa=80, seed=seed)
    rng = np.random.default_rng(seed)
    for p in psrs:
        p.residuals = p.toaerrs * rng.standard_normal(len(p))
    return psrs


def _terms(SM, TL, psrs):
    out = []
    for p in psrs:
        m = SM(psr=p)
        out.append(TL(p, [m.efac("by_backend"),
                          m.spin_noise("powerlaw_3_nfreqs"),
                          m.gwb("hd_vary_gamma_3_nfreqs")]))
    return out


def joint_like(gram_mode):
    psrs = _psrs(t_fake)
    return t_build(psrs, _terms(TSM, TTL, psrs), gram_mode=gram_mode,
                   joint_mode="schur", device="cpu")


def jax_like(gram_mode):
    psrs = _psrs(j_fake)
    return j_build(psrs, _terms(JSM, JTL, psrs), gram_mode=gram_mode,
                   joint_mode="schur")


def moderate_theta(like):
    return np.array([1.05 if n.endswith("efac") else
                     -13.5 if n.endswith("log10_A") else 3.5
                     for n in like.param_names])


def full(like, th):
    return float(like.loglike_batch(np.asarray(th)[None])[0])


def test_param_blocks_equal_the_reference():
    tl, jl = joint_like("split"), jax_like("split")
    assert tl.param_names == jl.param_names
    np.testing.assert_array_equal(tl.param_blocks, jl.param_blocks)
    for name, blk in zip(tl.param_names, tl.param_blocks):
        if name.startswith("gw_"):
            assert blk == BLOCK_COMMON
        else:
            assert blk >= 0 and name.startswith(tl.psrs[blk].name)


@pytest.mark.parametrize("gram_mode", ["f64", "split"])
def test_randomized_masked_sequence(gram_mode):
    """Site, common, full and rejected updates in a seeded order track a
    full recompute at every step, and the reference's cache too."""
    tol = TOL[gram_mode]
    like, jl = joint_like(gram_mode), jax_like(gram_mode)
    pb = np.asarray(like.param_blocks)
    npsr = int(pb.max()) + 1
    rng = np.random.default_rng(11)
    th = moderate_theta(like)
    ev, jev = CachedEvaluator(like, th), JCached(jl, th)
    assert ev.lnl == pytest.approx(full(like, th), abs=tol)
    kinds = rng.permutation(np.repeat(np.arange(4), 4))
    for step, kind in enumerate(kinds):
        nxt = th.copy()
        if kind in (0, 3):                     # one pulsar's block
            a = int(rng.integers(0, npsr))
            idx = np.nonzero(pb == a)[0]
            nxt[rng.choice(idx, size=rng.integers(1, len(idx) + 1),
                           replace=False)] += 0.01 * rng.standard_normal()
            mask = ("psr", a)
        elif kind == 1:                        # the common GW block
            idx = np.nonzero(pb == BLOCK_COMMON)[0]
            nxt[idx] += 0.01 * rng.standard_normal(len(idx))
            mask = ("common",)
        else:                                  # across blocks: full
            nxt += 0.002 * rng.standard_normal(like.ndim)
            mask = None
        lnl, jlnl = ev.update(nxt, mask), jev.update(nxt, mask)
        assert lnl == pytest.approx(full(like, nxt), abs=tol), (step, kind)
        atol, rtol = CROSS[gram_mode]
        assert lnl == pytest.approx(jlnl, abs=atol, rel=rtol), (step, kind)
        if kind == 3:                          # rejected: back to th
            assert ev.reject() == pytest.approx(jev.reject(), abs=atol,
                                                rel=rtol)
            assert ev.lnl == pytest.approx(full(like, th), abs=tol)
        else:
            th = nxt
    assert ev.counters == {k: v for k, v in jev.counters.items()}
    assert 0.0 < ev.cache_hit_rate == jev.cache_hit_rate <= 1.0


def test_derive_update_mask_agrees_with_the_reference():
    like = joint_like("split")
    pb = np.asarray(like.param_blocks)
    th = moderate_theta(like)
    site_i = np.nonzero(pb == 0)[0][0]
    gw_i = np.nonzero(pb == BLOCK_COMMON)[0][0]
    other_i = np.nonzero(pb == 2)[0][-1]
    moves = [[site_i], [gw_i], [site_i, gw_i], [other_i], [site_i, other_i],
             []]
    want = [("psr", 0), ("common",), None, ("psr", 2), None, None]
    ev = CachedEvaluator(like, th)
    for idx, expect in zip(moves, want):
        nxt = th.copy()
        nxt[idx] += 0.01
        got = derive_update_mask(pb, th, nxt)
        assert got == j_derive(pb, th, nxt) == expect
        # "auto" dispatches through the derivation and stays correct
        assert ev.update(nxt, "auto") == pytest.approx(full(like, nxt),
                                                       abs=1e-6)
        ev.reset(th)


def test_stale_mask_raises():
    like = joint_like("split")
    pb = np.asarray(like.param_blocks)
    th = moderate_theta(like)
    ev = CachedEvaluator(like, th)
    held = (ev.theta.copy(), ev.lnl, ev._cache)
    for blk, mask in ((1, ("psr", 0)), (BLOCK_COMMON, ("psr", 0)),
                      (0, ("common",))):
        bad = th.copy()
        bad[np.nonzero(pb == blk)[0][0]] += 0.1
        with pytest.raises(ValueError, match="stale update_mask"):
            ev.update(bad, mask)
    # the failed updates left the held state alone
    np.testing.assert_array_equal(ev.theta, held[0])
    assert ev.lnl == held[1] and ev._cache is held[2]
    assert ev.update(th.copy(), "auto") == pytest.approx(full(like, th),
                                                         abs=1e-6)


def test_reject_restores_theta_cache_and_lnl():
    like = joint_like("split")
    pb = np.asarray(like.param_blocks)
    th = moderate_theta(like)
    ev = CachedEvaluator(like, th)
    lnl0, cache0 = ev.lnl, ev._cache
    snap = {k: v.clone() for k, v in cache0.items()}
    prop = th.copy()
    prop[np.nonzero(pb == 0)[0][0]] += 0.05
    ev.update(prop, ("psr", 0))
    assert ev._cache is not cache0
    assert ev.reject() == lnl0
    np.testing.assert_array_equal(ev.theta, th)
    # the same tensors, and no update wrote into them
    assert ev._cache is cache0
    for k, v in snap.items():
        assert torch.equal(cache0[k], v), k
    with pytest.raises(RuntimeError, match="no update to revert"):
        ev.reject()
    nxt = th.copy()
    nxt[np.nonzero(pb == 1)[0][0]] += 0.02
    assert ev.update(nxt, ("psr", 1)) == pytest.approx(full(like, nxt),
                                                       abs=1e-6)
    assert ev.counters["rejected"] == 1


def test_update_mask_off_installs_nothing(monkeypatch):
    monkeypatch.setenv("EWT_UPDATE_MASK", "0")
    like = joint_like("split")
    assert not hasattr(like, "param_blocks")
    assert not hasattr(like, "_cache_init")
    with pytest.raises(TypeError, match="update_mask contract"):
        CachedEvaluator(like, moderate_theta(like))
    # the dense oracle never installs it
    monkeypatch.delenv("EWT_UPDATE_MASK")
    psrs = _psrs(t_fake)
    dense = t_build(psrs, _terms(TSM, TTL, psrs), gram_mode="f64",
                    device="cpu")
    assert dense.joint_mode == "dense" and not hasattr(dense,
                                                       "param_blocks")
