"""The port's fake-dataset generation against the JAX package's.

``enterprise_warp_tpu_torch/sim/noise.py`` is a numpy copy of the part of
``enterprise_warp_tpu/sim/noise.py`` the array fixtures need, built on
the port's own ``Pulsar``, ``ParFile`` and ``fourier_design``. For the
same seed every array must be bit for bit the reference's: the TOAs,
errors, radio frequencies, backends, sky positions, design matrices and
every injected residual (no tolerance: the same numpy operations in the
same order).
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
