"""The port's optimal statistic (``results/optstat.py``) against the JAX
package's.

- ``make_os_fn`` on the reference's own fixture (``tests/test_results.py::
  TestOptimalStatistic``: 6 fake pulsars of 120 TOAs, efac by backend and
  ``gwb`` ``hd_vary_gamma_5_nfreqs``), built by both packages from the
  same seeded pulsars: the same pairs and separations; rho and sig at the
  reference test's point and at seeded draws (the port's one batch
  against the reference's point-by-point calls) within rtol 1e-8, both
  in float64 on the CPU;
- ``combine_os`` for ``hd``, ``dipole`` and ``monopole``, ``bin_crosscorr``
  and ``hd_curve``: equal to the reference's within rtol 1e-12 on the same
  numbers;
- ``python -m enterprise_warp_tpu_torch.results --optimal_statistic 1``
  on a ``gwb_array.dat`` chain written by the port's CLI (40 steps on the
  CPU) writes ``optimal_statistic.pkl`` with the reference's payload: the
  same ORFs and keys and separations; at the median point rho, sig, A^2,
  its error and S/N within rtol 1e-8 of the reference's
  ``OptimalStatisticWarp`` on the same chain; over the same 20 draws, S/N
  within 1e-5 absolute and A^2 within 1e-5 of the draw's A^2 error, NaN
  at the same draws (``MARG_SNR_ATOL``);
- against a long-double witness (``chip_smoke.py:os_longdouble``) at
  seeded ill-conditioned draws (see its docstring).
"""

import os
import pickle
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from enterprise_warp_tpu.models import StandardModels as JSM
from enterprise_warp_tpu.models import TermList as JTL
from enterprise_warp_tpu.results import optstat as jos
from enterprise_warp_tpu.results.core import \
    parse_commandline as j_parse
from enterprise_warp_tpu.sim.noise import make_fake_pta as j_fake
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.models import StandardModels as TSM
from enterprise_warp_tpu_torch.models import TermList as TTL
from enterprise_warp_tpu_torch.results import optstat as tos
from enterprise_warp_tpu_torch.results.__main__ import main as t_main
from enterprise_warp_tpu_torch.sim import make_fake_pta as t_fake

from test_torch_cli import _paramfile

torch.set_num_threads(2)
RTOL = 1e-8
# the noise-marginalized draws of a 40-step chain are prior-like points
# (timing-model columns at prior variance 1e30, S/N down to 5e-7) where
# the packages' float64 algebras agree on S/N to 3.0e-6 and on A^2 to
# 3.0e-6 of the draw's A^2 error, not on A^2's relative digits (up to 13%
# apart where S/N is 1e-5)
MARG_SNR_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    """The route decisions read ``EWT_PALLAS``/``EWT_PALLAS_MEGA``; an
    in-process setting elsewhere in the suite may have left one set."""
    monkeypatch.delenv("EWT_PALLAS", raising=False)
    monkeypatch.delenv("EWT_PALLAS_MEGA", raising=False)


def _setup(fake, SM, TL):
    psrs = fake(npsr=6, ntoa=120, seed=9)
    rng = np.random.default_rng(9)
    for p in psrs:
        p.residuals = p.toaerrs * rng.standard_normal(len(p))
    tls = []
    for p in psrs:
        m = SM(psr=p)
        tls.append(TL(p, [m.efac("by_backend"),
                          m.gwb("hd_vary_gamma_5_nfreqs")]))
    return psrs, tls


@pytest.fixture(scope="module")
def os_fns():
    jp, jt = _setup(j_fake, JSM, JTL)
    tp, tt = _setup(t_fake, TSM, TTL)
    return (jos.make_os_fn(jp, jt),
            tos.make_os_fn(tp, tt, device="cpu"), tp)


def test_make_os_fn_matches_jax(os_fns):
    (jfn, jpairs, jxi, jsampled), (tfn, tpairs, txi, tsampled), psrs = \
        os_fns
    assert tpairs == jpairs and len(tpairs) == 15
    np.testing.assert_allclose(txi, jxi, rtol=1e-14)
    names = [p.name for p in tsampled]
    assert names == [p.name for p in jsampled]
    theta = np.array([1.0 if n.endswith("efac") else
                      (-14.0 if "log10_A" in n else 4.33) for n in names])
    rng = np.random.default_rng(3)
    draws = theta + np.where([n.endswith("efac") for n in names], 0.1,
                             0.5) * rng.standard_normal((5, len(names)))
    rho, sig = tfn(theta)
    assert rho.shape == sig.shape == (15,)
    jr, js = (np.asarray(v) for v in jfn(jnp.asarray(theta)))
    np.testing.assert_allclose(rho, jr, rtol=RTOL)
    np.testing.assert_allclose(sig, js, rtol=RTOL)
    rho_b, sig_b = tfn(draws)
    assert rho_b.shape == (5, 15)
    for k in range(5):
        jr, js = (np.asarray(v) for v in jfn(jnp.asarray(draws[k])))
        np.testing.assert_allclose(rho_b[k], jr, rtol=RTOL)
        np.testing.assert_allclose(sig_b[k], js, rtol=RTOL)


@pytest.mark.parametrize("orf", ["hd", "dipole", "monopole"])
def test_combine_os_matches_jax(os_fns, orf):
    psrs = os_fns[2]
    rng = np.random.default_rng(5)
    rho = rng.standard_normal(15) * 1e-30
    sig = np.abs(rng.standard_normal(15)) * 1e-30 + 1e-31
    xi = os_fns[1][2]
    pos = np.stack([p.pos for p in psrs])
    np.testing.assert_allclose(tos.combine_os(rho, sig, xi, orf, pos),
                               jos.combine_os(rho, sig, xi, orf, pos),
                               rtol=1e-12)
    for a, b in zip(tos.bin_crosscorr(xi, rho, sig, 4),
                    jos.bin_crosscorr(xi, rho, sig, 4)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    np.testing.assert_allclose(tos.hd_curve(xi), jos.hd_curve(xi),
                               rtol=1e-12)


def test_optimal_statistic_cli_on_gwb_array(tmp_path):
    prfile = _paramfile(tmp_path, 40, "gwb_array.dat")
    assert cli.main(["--prfile", prfile, "--num", "0"], device="cpu") == 0
    run = os.path.join(tmp_path, "out", "gwb_gwb_array")
    argv = ["--result", prfile, "--optimal_statistic", "1", "-N", "20"]
    assert t_main(argv, device="cpu") == 0
    pkl = os.path.join(run, "optimal_statistic.pkl")
    port = pickle.load(open(pkl, "rb"))
    os.remove(pkl)
    opts = j_parse(argv)
    jos.OptimalStatisticWarp(opts).main_pipeline()
    ref = pickle.load(open(pkl, "rb"))
    assert list(port) == list(ref) == ["hd", "dipole", "monopole"]
    for orf in ref:
        assert sorted(port[orf]) == sorted(ref[orf])
        np.testing.assert_allclose(port[orf]["xi"], ref[orf]["xi"],
                                   rtol=1e-14)
        for key in ("rho", "sig", "a2", "a2_err", "snr"):
            np.testing.assert_allclose(port[orf][key], ref[orf][key],
                                       rtol=RTOL, err_msg=f"{orf} {key}")
        # the draws: S/N within MARG_SNR_ATOL and A^2 within MARG_SNR_ATOL
        # of the draw's own A^2 error (A^2 / S/N); NaN at the same draws
        (a2, snr), (ja2, jsnr) = port[orf]["marginalized"], \
            ref[orf]["marginalized"]
        assert a2.shape == snr.shape == ja2.shape == jsnr.shape == (20,)
        np.testing.assert_array_equal(np.isnan(snr), np.isnan(jsnr))
        np.testing.assert_allclose(snr, jsnr, rtol=0, atol=MARG_SNR_ATOL)
        ok = ~np.isnan(jsnr)
        assert np.all(np.abs(a2 - ja2)[ok] <= MARG_SNR_ATOL
                      * np.abs(ja2 / jsnr)[ok])
    assert os.path.exists(os.path.join(run, "os_orf.png"))


def test_optimal_statistic_needs_a_paramfile(tmp_path):
    with pytest.raises(ValueError, match="needs a paramfile"):
        tos.OptimalStatisticWarp(types.SimpleNamespace(result=str(tmp_path)),
                                 device="cpu")


def _witness_array(fake, SM, TL):
    """6 fake pulsars of 120 TOAs at one radio frequency with BASELINE
    config 3's terms at fewer modes: efac and equad, spin noise (10
    modes), DM noise (10; at one frequency its columns are the spin
    columns', only the priors separate them) and a ``gwb``."""
    psrs = fake(npsr=6, ntoa=120, seed=9)
    rng = np.random.default_rng(9)
    tls = []
    for p in psrs:
        p.residuals = p.toaerrs * rng.standard_normal(len(p))
        m = SM(psr=p)
        tls.append(TL(p, [m.efac("by_backend"), m.equad("by_backend"),
                          m.spin_noise("powerlaw_10_nfreqs"),
                          m.dm_noise("powerlaw_10_nfreqs"),
                          m.gwb("hd_vary_gamma_5_nfreqs")]))
    return psrs, tls


def test_os_against_long_double_witness():
    """The port's optimal statistic and the JAX package's, both float64 on
    the CPU, against the reference's algebra in long double
    (``chip_smoke.py:os_longdouble``), at 40 seeded draws spread about
    typical noise values (efac sigma 0.3, log10 amplitudes and gammas
    sigma 1) of an array with collinear spin and DM columns: the
    equilibrated Sigma's condition number reaches 4.7e7 there. Each
    result's ``max(|d rho|, |d sig|)`` from the witness, over its sig,
    must lie within the repair's limit of ``chip_smoke.py``: max(2 x the
    JAX package's distance, 1e-6).

    No CPU draw separates the algebras. On 150 seeded prior draws of this
    array (condition numbers up to 1e15) the reference's algebra, its
    form on the equilibrated factor and the form without the
    cancellation all lie 1e-3 to 1 sig from the witness, and the
    reference's algebra in the two packages' float64 (torch's and XLA's
    LAPACK calls) already differs by more than 2x at a quarter of them;
    the card, where the factor's rounding differs from the CPU's, is
    where ``chip_smoke.py:os_witness`` measures them."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import (OS_WITNESS_FACTOR, OS_WITNESS_FLOOR,
                            os_longdouble)
    jp, jt = _witness_array(j_fake, JSM, JTL)
    tp, tt = _witness_array(t_fake, TSM, TTL)
    jfn = jos.make_os_fn(jp, jt)[0]
    tfn, _, _, sampled = tos.make_os_fn(tp, tt, device="cpu")
    inputs = tos.os_inputs(tp, tt, device="cpu")
    names = [p.name for p in sampled]
    base = np.array([1.0 if n.endswith("efac") else -7.0 if "equad" in n
                     else -13.0 if n.endswith("log10_A") else 3.5
                     for n in names])
    spread = np.where([n.endswith("efac") for n in names], 0.3, 1.0)
    draws = base + spread * np.random.default_rng(1).standard_normal(
        (40, len(names)))
    rho, sig = tfn(draws)
    kappas = []
    for k, th in enumerate(draws):
        rl, sl, kappa = os_longdouble(inputs, th)
        rl, sl = rl.astype(float), sl.astype(float)
        kappas.append(kappa)
        jr, js = (np.asarray(v) for v in jfn(jnp.asarray(th)))

        def dist(r, s):
            return np.max(np.maximum(np.abs(r - rl), np.abs(s - sl)) / sl)
        dj = dist(jr, js)
        assert dist(rho[k], sig[k]) <= max(OS_WITNESS_FACTOR * dj,
                                           OS_WITNESS_FLOOR), k
        assert dj <= OS_WITNESS_FLOOR, k
    assert max(kappas) > 1e7
