"""The port's GP noise reconstruction (``results/reconstruct.py``, the
tempo2 ``general2`` bridge) against the JAX package's.

The five cases of the reference's ``tests/test_reconstruct.py``, on the
same injected pulsar (250 TOAs at three radio frequencies, white, red and
DM noise; built from the same seeds by each package's ``sim``, bit for
bit equal): every realization of the port within 1e-9 of the largest
|realization| (``RTOL``) of the JAX package's at the same draw, both in
float64 on the CPU, and the reference test's own checks on the port:

- recovery of the injected red and DM processes by the conditional mean;
- the batched band over 16 draws (the port's chunked batch against the
  reference's ``vmap``, also across a chunk edge);
- the ``general2`` column contract of ``get_tempo2_prediction`` on files
  the port wrote, all five columns;
- partial noisefile defaults;
- the sampled-ephemeris delay (``bayes_ephem: sampled``): ``D c`` exactly,
  and the GP conditioned on the delay-subtracted residuals;
- a sampled chromatic index (``chromred("vary_30_nfreqs")``): the
  realizations at the truth with the index at 2 and over 16 draws with
  the index spread over its prior, each within ``RTOL`` of the JAX
  package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, 64-bit)

from enterprise_warp_tpu.models import StandardModels as JSM
from enterprise_warp_tpu.models import TermList as JTL
from enterprise_warp_tpu.results import reconstruct as jrec
from enterprise_warp_tpu.sim import noise as jnoise
from enterprise_warp_tpu_torch.io import save_pulsar_pair
from enterprise_warp_tpu_torch.models import StandardModels as TSM
from enterprise_warp_tpu_torch.models import TermList as TTL
from enterprise_warp_tpu_torch.results import reconstruct as trec
from enterprise_warp_tpu_torch.sim import noise as tnoise

torch.set_num_threads(2)
LG_A, GAMMA = -12.8, 4.0
RTOL = 1e-9


def _injected(mod):
    psr = mod.make_fake_pulsar(name="J0613-0200", ntoa=250,
                               cadence_days=14.0, toaerr_us=0.5,
                               backends=("SIMA",),
                               freqs_mhz=(700.0, 1400.0, 3100.0), seed=8)
    mod.inject_white(psr, efac=1.0, rng=np.random.default_rng(9))
    red = mod.inject_basis_process(psr, LG_A, GAMMA, components=30,
                                   rng=np.random.default_rng(10))
    dm = mod.inject_basis_process(psr, -13.1, 3.0, components=30,
                                  chromatic_idx=2.0,
                                  rng=np.random.default_rng(11))
    return psr, red, dm


@pytest.fixture(scope="module")
def injected():
    (jp, jred, jdm), (tp, tred, tdm) = _injected(jnoise), _injected(tnoise)
    np.testing.assert_array_equal(jp.residuals, tp.residuals)
    return jp, tp, tred, tdm


def _terms(SM, TL, psr, ephem=False, chrom=False):
    m = SM(psr=psr)
    terms = [m.efac("by_backend"), m.spin_noise("powerlaw_30_nfreqs"),
             m.dm_noise("powerlaw_30_nfreqs")]
    if ephem:
        terms.append(m.bayes_ephem("sampled"))
    if chrom:
        terms.append(m.chromred("vary_30_nfreqs"))
    return TL(psr, terms), m


def _truth(name):
    return {f"{name}_SIMA_efac": 1.0,
            f"{name}_red_noise_log10_A": LG_A,
            f"{name}_red_noise_gamma": GAMMA,
            f"{name}_dm_gp_log10_A": -13.1,
            f"{name}_dm_gp_gamma": 3.0}


def _assert_close(port, ref):
    assert sorted(port) == sorted(ref)
    for k in ref:
        r = np.asarray(ref[k])
        assert port[k].shape == r.shape, k
        scale = max(np.max(np.abs(r)), 1e-300)
        np.testing.assert_allclose(port[k], r, rtol=0, atol=RTOL * scale,
                                   err_msg=k)


@pytest.fixture(scope="module")
def recs(injected):
    jp, tp = injected[:2]
    return (jrec.NoiseReconstructor(jp, _terms(JSM, JTL, jp)[0]),
            trec.NoiseReconstructor(tp, _terms(TSM, TTL, tp)[0],
                                    device="cpu"))


def test_conditional_mean_recovers_injected(injected, recs):
    _, psr, red, dm = injected
    jr, tr = recs
    assert tr.param_names == jr.param_names
    real = tr.realizations(_truth(psr.name))
    _assert_close(real, jr.realizations(_truth(psr.name)))
    # the conditional mean is defined up to the timing-model fit the
    # injected signal partly absorbs: compare with M projected out
    M = psr.Mmat
    proj = lambda x: x - M @ np.linalg.lstsq(M, x, rcond=None)[0]
    r_t, r_g = proj(red), proj(real["red_noise"])
    assert np.corrcoef(r_t, r_g)[0, 1] > 0.95
    assert np.std(r_t - r_g) < 0.5 * np.std(r_t)
    d_t, d_g = proj(dm), proj(real["dm_gp"])
    assert np.corrcoef(d_t, d_g)[0, 1] > 0.9


@pytest.mark.parametrize("ndraw", [16, trec.RECON_CHUNK + 3])
def test_batched_draws_band(injected, recs, ndraw):
    psr = injected[1]
    jr, tr = recs
    base = tr.theta_from_dict(_truth(psr.name))
    draws = base[None, :] + 0.05 * np.random.default_rng(1) \
        .standard_normal((ndraw, len(base)))
    bands = tr.realizations_batch(draws)
    assert bands["red_noise"].shape == (ndraw, len(psr))
    _assert_close(bands, jr.realizations_batch(draws))
    spread = np.std(bands["red_noise"], axis=0)
    assert np.all(np.isfinite(spread)) and spread.max() > 0


def test_general2_column_contract(tmp_path, injected):
    psr = injected[1]
    parfile, timfile = save_pulsar_pair(psr, str(tmp_path))
    out = tmp_path / "pred.txt"
    cols, path = trec.get_tempo2_prediction(parfile, timfile,
                                            _truth(psr.name),
                                            output=str(out), device="cpu")
    jcols, _ = jrec.get_tempo2_prediction(parfile, timfile,
                                          _truth(psr.name))
    assert cols.shape == jcols.shape == (len(psr), 5)
    for j in range(5):
        np.testing.assert_allclose(cols[:, j], jcols[:, j], rtol=0,
                                   atol=RTOL * np.max(np.abs(jcols[:, j])))
    bat, post, posttn, tndm, tnrn = cols.T
    np.testing.assert_allclose(bat, psr.toas / 86400.0, atol=1e-6)
    np.testing.assert_allclose(posttn, post - tndm - tnrn, atol=1e-15)
    assert np.std(posttn) < 0.5 * np.std(post)
    assert path == str(out) and np.loadtxt(out).shape == cols.shape


def test_partial_noisefile_defaults(tmp_path, injected):
    psr = injected[1]
    parfile, timfile = save_pulsar_pair(psr, str(tmp_path))
    noise = {f"{psr.name}_SIMA_efac": 1.0}
    cols, _ = trec.get_tempo2_prediction(parfile, timfile, noise,
                                         device="cpu")
    jcols, _ = jrec.get_tempo2_prediction(parfile, timfile, noise)
    assert np.all(np.isfinite(cols))
    for j in range(5):
        np.testing.assert_allclose(
            cols[:, j], jcols[:, j], rtol=0,
            atol=RTOL * max(np.max(np.abs(jcols[:, j])), 1e-300))


def test_sampled_ephemeris_delay_realization(injected):
    jp, psr, red, _ = injected
    tl, m = _terms(TSM, TTL, psr, ephem=True)
    rec = trec.NoiseReconstructor(psr, tl, device="cpu")
    jrc = jrec.NoiseReconstructor(jp, _terms(JSM, JTL, jp, ephem=True)[0])
    assert rec.param_names == jrc.param_names
    assert sum("jup_orb_elements" in n for n in rec.param_names) == 6
    c = np.random.default_rng(12).uniform(-1, 1, 13) * np.concatenate(
        [np.full(3, 1e-9), np.full(4, 1e-11), np.full(6, 0.01)])
    theta = {}
    for n in rec.param_names:
        if n.endswith("efac"):
            theta[n] = 1.0
        elif "dm_gp" in n:
            theta[n] = -13.1 if n.endswith("log10_A") else 3.0
        elif n.endswith("log10_A"):
            theta[n] = LG_A
        elif n.endswith("gamma"):
            theta[n] = GAMMA
        else:
            theta[n] = 0.0
    for p, v in zip([n for n in rec.param_names
                     if "efac" not in n and "log10_A" not in n
                     and "gamma" not in n], c):
        theta[p] = float(v)
    out = rec.realizations(theta)
    _assert_close(out, jrc.realizations(theta))
    D, _ = m._ephem_columns()
    np.testing.assert_allclose(out["bayes_ephem"], D @ c, rtol=1e-10,
                               atol=1e-15)
    theta0 = dict(theta)
    for n in rec.param_names:
        if "frame_drift" in n or "_mass" in n or "jup_orb_elements" in n:
            theta0[n] = 0.0
    out0 = rec.realizations(theta0)
    _assert_close(out0, jrc.realizations(theta0))
    np.testing.assert_allclose(out0["bayes_ephem"], 0.0, atol=1e-20)
    assert np.corrcoef(out0["red_noise"], red)[0, 1] > 0.95


def test_sampled_chromatic_index_realizations(injected):
    jp, psr = injected[:2]
    rec = trec.NoiseReconstructor(psr, _terms(TSM, TTL, psr, chrom=True)[0],
                                  device="cpu")
    jrc = jrec.NoiseReconstructor(jp, _terms(JSM, JTL, jp, chrom=True)[0])
    assert rec.param_names == jrc.param_names
    idx = f"{psr.name}_chromatic_gp_idx"
    assert rec.param_names[-1] == idx
    truth = dict(_truth(psr.name), **{
        f"{psr.name}_chromatic_gp_log10_A": -13.5,
        f"{psr.name}_chromatic_gp_gamma": 3.0, idx: 2.0})
    out = rec.realizations(truth)
    _assert_close(out, jrc.realizations(truth))
    assert np.abs(out["chromatic_gp"]).max() > 0
    base = rec.theta_from_dict(truth)
    draws = base[None, :] + 0.05 * np.random.default_rng(3) \
        .standard_normal((16, len(base)))
    draws[:, -1] = np.linspace(0.0, 6.0, 16)
    _assert_close(rec.realizations_batch(draws),
                  jrc.realizations_batch(draws))
