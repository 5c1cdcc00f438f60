"""The port's fake-dataset generation and noise injection against the
JAX package's.

``enterprise_warp_tpu_torch/sim/noise.py`` is a numpy copy of
``enterprise_warp_tpu/sim/noise.py``, built on the port's own ``Pulsar``,
``ParFile`` and ``fourier_design``. For the same seed every array must be
bit for bit the reference's: the TOAs, errors, radio frequencies,
backends, sky positions, design matrices and every injected residual,
``add_noise``'s from a PAL2 noise dict included (no tolerance: the same
numpy operations in the same order). The PSD formulas agree within rtol
1e-12 and keep the reference's limits (``tests/test_sim_psd.py``); the
PSD plot draws the reference's curves.
"""

import numpy as np
import pytest

from enterprise_warp_tpu.sim import noise as jnoise
from enterprise_warp_tpu_torch.sim import noise as tnoise

ARRAYS = ("toas", "toas_rel", "residuals", "toaerrs", "freqs", "pos", "Mmat",
          "backend_flags")


def _assert_same_pulsar(a, b):
    assert a.name == b.name
    for key in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a, key)),
                                      np.asarray(getattr(b, key)), key)
    assert a.Mmat_labels == b.Mmat_labels
    assert (a.raj, a.decj) == (b.raj, b.decj)
    assert sorted(a.flags) == sorted(b.flags)
    for f in a.flags:
        np.testing.assert_array_equal(a.flags[f], b.flags[f])
    assert (a.par.name, a.par.raj, a.par.decj, a.par.f0, a.par.pepoch) == \
        (b.par.name, b.par.raj, b.par.decj, b.par.f0, b.par.pepoch)


@pytest.mark.parametrize("npsr,ntoa,seed", [(4, 100, 3), (45, 60, 45)])
def test_make_fake_pta_bit_equal(npsr, ntoa, seed):
    jp = jnoise.make_fake_pta(npsr=npsr, ntoa=ntoa, seed=seed)
    tp = tnoise.make_fake_pta(npsr=npsr, ntoa=ntoa, seed=seed)
    assert len(jp) == len(tp) == npsr
    for a, b in zip(jp, tp):
        _assert_same_pulsar(a, b)


def test_make_fake_pulsar_options_bit_equal():
    kw = dict(name="J1111-2222", ntoa=57, cadence_days=7.0, toaerr_us=0.5,
              freqs_mhz=(700.0, 1400.0, 3100.0), backends=("A", "B", "C"),
              raj=2.0, decj=0.3, seed=11)
    _assert_same_pulsar(jnoise.make_fake_pulsar(**kw),
                        tnoise.make_fake_pulsar(**kw))


def test_injections_bit_equal():
    a = jnoise.make_fake_pulsar(ntoa=80, backends=("A", "B"), seed=5,
                                freqs_mhz=(800.0, 1400.0))
    b = tnoise.make_fake_pulsar(ntoa=80, backends=("A", "B"), seed=5,
                                freqs_mhz=(800.0, 1400.0))
    for mod, p in ((jnoise, a), (tnoise, b)):
        rng = np.random.default_rng(7)
        mod.inject_white(p, efac={"A": 1.1, "B": 0.9},
                         equad_log10={"A": -6.5, "B": -7.0}, rng=rng)
        mod.inject_white(p, efac=1.2, equad_log10=-7.5, rng=rng)
        mod.inject_basis_process(p, -13.3, 3.8, components=10, rng=rng)
        mod.inject_basis_process(p, -13.6, 2.9, components=8,
                                 chromatic_idx=2.0, rng=rng,
                                 Tspan=2.0 * p.Tspan)
    np.testing.assert_array_equal(a.residuals, b.residuals)
    rng_j, rng_t = np.random.default_rng(1), np.random.default_rng(1)
    sj, cj = jnoise.inject_basis_process(a, -14.0, 4.33, components=5,
                                         rng=rng_j, return_coeffs=True)
    st, ct = tnoise.inject_basis_process(b, -14.0, 4.33, components=5,
                                         rng=rng_t, return_coeffs=True)
    np.testing.assert_array_equal(sj, st)
    np.testing.assert_array_equal(cj, ct)
    f = np.linspace(1e-9, 1e-7, 13)
    np.testing.assert_array_equal(jnoise.red_psd(f, -13.0, 3.2),
                                  tnoise.red_psd(f, -13.0, 3.2))


F_GRID = np.logspace(-9, -7, 20)


@pytest.mark.parametrize("name,args", [
    ("red_psd", (-13.5, 4.0)), ("dm_psd", (-13.1, 3.0)),
    ("red_v1_psd", (-13.5, 4.0, 1e-9)), ("red_v1_psd", (-13.5, 4.0, 0.0)),
    ("lorenzian_red_psd", (3.0, 1e-8, 4.0))])
def test_psds_match_jax(name, args):
    np.testing.assert_allclose(getattr(tnoise, name)(F_GRID, *args),
                               getattr(jnoise, name)(F_GRID, *args),
                               rtol=1e-12)


def test_psd_limits():
    f = F_GRID
    np.testing.assert_allclose(tnoise.red_v1_psd(f, -13.5, 4.0, 0.0),
                               tnoise.red_psd(f, -13.5, 4.0), rtol=1e-12)
    with_fc = tnoise.red_v1_psd(f, -13.5, 4.0, 1e-9)
    assert with_fc[0] < tnoise.red_psd(f, -13.5, 4.0)[0]
    fc, P, alpha = 1e-8, 3.0, 4.0
    np.testing.assert_allclose(tnoise.lorenzian_red_psd(1e-11, P, fc, alpha),
                               P, rtol=1e-4)
    hi = tnoise.lorenzian_red_psd(np.array([1e-6, 2e-6]), P, fc, alpha)
    np.testing.assert_allclose(hi[0] / hi[1], 2.0 ** alpha, rtol=1e-3)


def test_added_noise_psd_to_vector_matches_jax():
    params = {"CASPSR": {"efac": 1.1, "equad": -7.0},
              "DFB": {"efac": 0.9},
              "red": {"A": 1e-14, "gamma": 4.0}}
    for param in ("efac", "equad", "gamma"):
        assert tnoise.added_noise_psd_to_vector(params, param) == \
            jnoise.added_noise_psd_to_vector(params, param)


def test_plot_noise_psd_from_dict_matches_jax():
    import matplotlib
    matplotlib.use("Agg")
    psr = tnoise.make_fake_pulsar(ntoa=50, backends=("X",),
                                  freqs_mhz=(1400.0, 3100.0), seed=0)
    ff = np.logspace(-9, -7, 30)
    for red in ({"A": 1e-14, "gamma": 4.0},
                {"P": 1e-20, "fc": 1e-8, "alpha": 4.0}):
        psd = {"X": {"rms_toaerr": 1.0}, "red": red,
               "dm": {"A": 1e-14, "gamma": 3.0}}
        ax = tnoise.plot_noise_psd_from_dict(psr, psd, ["X"], ff)
        jax_ = jnoise.plot_noise_psd_from_dict(psr, psd, ["X"], ff)
        assert len(ax.lines) == len(jax_.lines) == 3
        for a, b in zip(ax.lines, jax_.lines):
            assert a.get_label() == b.get_label()
            np.testing.assert_array_equal(a.get_ydata(), b.get_ydata())


def test_plot_noise_psd_needs_matplotlib(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    psr = tnoise.make_fake_pulsar(ntoa=10, seed=0)
    with pytest.raises(ImportError, match="needs matplotlib"):
        tnoise.plot_noise_psd_from_dict(psr, {}, [], F_GRID)


NOISE = {"J1234-5678_CPSR2_20CM_efac": 1.1,
         "J1234-5678_PDFB_10CM_efac": 1.05,
         "J1234-5678_CPSR2_20CM_log10_equad": -6.6,
         "J1234-5678_PDFB_10CM_log10_equad": -7.0,
         "J1234-5678_red_noise_log10_A": -13.3,
         "J1234-5678_red_noise_gamma": 3.8,
         "J1234-5678_dm_gp_log10_A": -13.6,
         "J1234-5678_dm_gp_gamma": 2.9}


def _two_backend(mod, flag):
    p = mod.make_fake_pulsar(name="J1234-5678", ntoa=90,
                             backends=("CPSR2_20CM", "PDFB_10CM"),
                             freqs_mhz=(1369.0, 3100.0), seed=21)
    # the backends under one flag convention only
    p.flags = {flag: p.backend_flags.copy()}
    return p


@pytest.mark.parametrize("flag,kw", [
    ("f", {}), ("group", {}), ("sys", dict(components=12, seed=4)),
    ("f", dict(inc_equad=False, inc_dm=False)),
    ("f", dict(inc_efac=False, inc_red=False))])
def test_add_noise_bit_equal(flag, kw):
    a, b = _two_backend(jnoise, flag), _two_backend(tnoise, flag)
    assert tnoise._detect_flag_convention(b, NOISE) == \
        jnoise._detect_flag_convention(a, NOISE)
    assert tnoise._detect_flag_convention(b, NOISE)[0] == flag
    jnoise.add_noise(a, NOISE, **kw)
    assert tnoise.add_noise(b, NOISE, **kw) is b
    np.testing.assert_array_equal(a.residuals, b.residuals)
    assert np.any(b.residuals != 0)


def test_add_noise_without_backend_entries_bit_equal():
    """No flag value in the dict: unit efac, then red and DM noise."""
    noise = {k: v for k, v in NOISE.items() if "CM_" not in k}
    a, b = _two_backend(jnoise, "f"), _two_backend(tnoise, "f")
    assert tnoise._detect_flag_convention(b, noise) == (None, [])
    jnoise.add_noise(a, noise, seed=9)
    tnoise.add_noise(b, noise, seed=9)
    np.testing.assert_array_equal(a.residuals, b.residuals)
