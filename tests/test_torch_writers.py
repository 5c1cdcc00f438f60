"""The port's ``.par``/``.tim`` writers (``io/writers.py``) against the
JAX package's, and the array workflow from files the port wrote.

- ``save_pulsar_pair`` on the same simulated pulsar (built from the same
  seeds by each package's ``sim``): byte-equal ``.par`` and ``.tim``;
  ``write_par``/``write_tim`` of the parsed example pulsars: byte-equal,
  and lossless on re-parsing; ``pulsar_to_timfile`` without a par: the
  same arrays;
- the reference's round trip (``tests/test_writers.py:29-73``) on the
  port: ``load_pulsar`` recovers the injected residuals within 1e-7 s
  after projecting out the written par's fitted columns, and keeps the
  flags, errors and radio frequencies;
- ``atomic_write_text``: the text lands, no tmp file is left;
- the array route at a small size: 3 fake pulsars of 100 TOAs written by
  the port, read back with their residuals (within the reference's 1e-7
  s), a paramfile through the
  port's CLI (20 PT steps on the CPU), then the results CLI's
  ``--optimal_statistic``: at the chain's median, against the JAX
  package's ``OptimalStatisticWarp`` on the same chain, rho within 1e-6
  of sig, sig and A^2's error within rtol 1e-6, A^2 within 1e-6 of its
  error and S/N within 1e-6 (``OS_RTOL``).
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, 64-bit)

from enterprise_warp_tpu.io import parse_par as j_parse_par
from enterprise_warp_tpu.io import parse_tim as j_parse_tim
from enterprise_warp_tpu.io import writers as jw
from enterprise_warp_tpu.results import optstat as jos
from enterprise_warp_tpu.results.core import parse_commandline as j_parse
from enterprise_warp_tpu.sim import noise as jnoise
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.io import (load_pulsar, parse_par, parse_tim,
                                          save_pulsar_pair, write_par,
                                          write_tim)
from enterprise_warp_tpu_torch.io import writers as tw
from enterprise_warp_tpu_torch.results.__main__ import main as t_main
from enterprise_warp_tpu_torch.sim import noise as tnoise

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "examples", "data")
# the optimal statistic at the short chain's median (equilibrated
# cond(Sigma) 2.5e10): the port's and the JAX package's float64 results,
# the same algebra on two LAPACK call sequences, lie about 1e-7 of sig
# from a long-double witness (chip_smoke.py:os_longdouble) and 4e-8 apart
# in rho's relative digits, so they are held within chip_smoke.py's
# OS_RTOL of sig of each other
OS_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    """The route decisions read ``EWT_PALLAS``/``EWT_PALLAS_MEGA``; an
    in-process setting elsewhere in the suite may have left one set."""
    monkeypatch.delenv("EWT_PALLAS", raising=False)
    monkeypatch.delenv("EWT_PALLAS_MEGA", raising=False)


def _noisy(mod):
    psr = mod.make_fake_pulsar(name="J0613-0200", ntoa=180, toaerr_us=1.0,
                               backends=("SIMA", "SIMB"),
                               freqs_mhz=(700.0, 1400.0, 3100.0), seed=3)
    mod.inject_white(psr, efac={"SIMA": 1.2, "SIMB": 0.9}, flag="f",
                     rng=np.random.default_rng(5))
    mod.inject_basis_process(psr, -13.0, 4.0, components=20,
                             rng=np.random.default_rng(6))
    return psr


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_save_pulsar_pair_byte_equal(tmp_path):
    jp, tp = _noisy(jnoise), _noisy(tnoise)
    jfiles = jw.save_pulsar_pair(jp, str(tmp_path / "jax"))
    tfiles = save_pulsar_pair(tp, str(tmp_path / "port"))
    assert [os.path.basename(f) for f in tfiles] == \
        [os.path.basename(f) for f in jfiles] == \
        ["J0613-0200.par", "J0613-0200.tim"]
    for a, b in zip(tfiles, jfiles):
        assert _read(a) == _read(b)
    # the caller's ParFile is never mutated
    assert tp.par.fit_flags == jp.par.fit_flags


@pytest.mark.parametrize("stem", ["J1234-5678", "fake_psr_0"])
def test_write_parsed_files_byte_equal(tmp_path, stem):
    par = parse_par(os.path.join(DATA, f"{stem}.par"))
    tim = parse_tim(os.path.join(DATA, f"{stem}.tim"))
    write_par(par, str(tmp_path / "x.par"))
    write_tim(tim, str(tmp_path / "x.tim"))
    jw.write_par(j_parse_par(os.path.join(DATA, f"{stem}.par")),
                 str(tmp_path / "j.par"))
    jw.write_tim(j_parse_tim(os.path.join(DATA, f"{stem}.tim")),
                 str(tmp_path / "j.tim"))
    assert _read(tmp_path / "x.par") == _read(tmp_path / "j.par")
    assert _read(tmp_path / "x.tim") == _read(tmp_path / "j.tim")
    par2 = parse_par(str(tmp_path / "x.par"))
    tim2 = parse_tim(str(tmp_path / "x.tim"))
    assert par2.name == par.name
    assert par2.raj == pytest.approx(par.raj, abs=1e-12)
    assert par2.f0 == pytest.approx(par.f0)
    assert len(par2.jumps) == len(par.jumps)
    assert len(tim2) == len(tim)
    np.testing.assert_array_equal(tim2.mjd_int, tim.mjd_int)
    np.testing.assert_allclose(tim2.sec, tim.sec, atol=1e-7)
    np.testing.assert_allclose(tim2.errs, tim.errs, atol=1e-4)
    for k in tim.flags:
        assert list(tim2.flags[k]) == list(tim.flags[k])


def test_pulsar_to_timfile_matches_jax():
    jp, tp = _noisy(jnoise), _noisy(tnoise)
    for kw in (dict(), dict(apply_residuals=False)):
        a, b = tw.pulsar_to_timfile(tp, **kw), jw.pulsar_to_timfile(jp, **kw)
        for key in ("names", "freqs", "mjd_int", "sec", "errs", "sites"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
        assert sorted(a.flags) == sorted(b.flags)


def test_roundtrip_recovers_residuals(tmp_path):
    psr = _noisy(tnoise)
    loaded = load_pulsar(*save_pulsar_pair(psr, str(tmp_path)))
    assert loaded.phase_connected
    assert len(loaded) == len(psr)
    M = loaded.Mmat
    proj = lambda r: r - M @ np.linalg.lstsq(M, r, rcond=None)[0]
    assert np.max(np.abs(proj(loaded.residuals) - proj(psr.residuals))) \
        < 1e-7


def test_roundtrip_preserves_flags_errs_freqs(tmp_path):
    psr = _noisy(tnoise)
    loaded = load_pulsar(*save_pulsar_pair(psr, str(tmp_path)))
    np.testing.assert_allclose(loaded.toaerrs, psr.toaerrs, rtol=1e-4)
    np.testing.assert_allclose(loaded.freqs, psr.freqs, rtol=1e-6)
    assert list(loaded.flags["f"]) == list(psr.flags["f"])
    assert set(loaded.backend_masks()) == {"SIMA", "SIMB"}


def test_atomic_write_text(tmp_path):
    path = str(tmp_path / "x.txt")
    assert tw.atomic_write_text(path, "one\n") == path
    tw.atomic_write_text(path, "two\n")
    assert open(path).read() == "two\n"
    assert os.listdir(tmp_path) == ["x.txt"]


def _array_paramfile(tmp_path, nsamp):
    """3 fake pulsars of 100 TOAs (per-pulsar white residuals, as BASELINE
    config 3 makes them) written by the port, a noise-model JSON with
    config 3's terms at fewer modes, and a paramfile."""
    psrs = tnoise.make_fake_pta(npsr=3, ntoa=100, seed=45)
    rng = np.random.default_rng(45)
    for p in psrs:
        p.residuals = p.toaerrs * rng.standard_normal(len(p))
        save_pulsar_pair(p, str(tmp_path / "data"))
    model = {"model_name": "pta3",
             "common_signals": {"gwb": "hd_vary_gamma_5_nfreqs"},
             "universal": {"white_noise": "by_backend",
                           "spin_noise": "powerlaw_5_nfreqs",
                           "dm_noise": "powerlaw_5_nfreqs"}}
    (tmp_path / "nm.json").write_text(json.dumps(model))
    path = tmp_path / "pta3.dat"
    path.write_text("\n".join([
        f"datadir: {tmp_path / 'data'}", f"out: {tmp_path / 'out'}",
        "overwrite: True", "array_analysis: True",
        "sampler: ptmcmcsampler", f"nsamp: {nsamp}", "{0}",
        f"noise_model_file: {tmp_path / 'nm.json'}"]) + "\n")
    return psrs, str(path)


def test_array_cli_from_written_files(tmp_path):
    psrs, prfile = _array_paramfile(tmp_path, 20)
    for p in psrs:
        loaded = load_pulsar(str(tmp_path / "data" / f"{p.name}.par"),
                             str(tmp_path / "data" / f"{p.name}.tim"))
        # the written par fits the same quadratic spin-down the in-memory
        # design matrix spans; its unit-normalized columns condition the
        # projection better than the loaded (OFFSET, F0, F1) columns
        M = p.Mmat
        proj = lambda r: r - M @ np.linalg.lstsq(M, r, rcond=None)[0]
        assert np.max(np.abs(proj(loaded.residuals) - proj(p.residuals))) \
            < 1e-7
    assert cli.main(["--prfile", prfile, "--num", "0"], device="cpu") == 0
    run = os.path.join(tmp_path, "out", "pta3_pta3")
    pars = open(os.path.join(run, "pars.txt")).read().split()
    # efac, equad, spin (2) and DM (2) per pulsar, then the GW pair
    assert len(pars) == 3 * 6 + 2
    chain = np.loadtxt(os.path.join(run, "chain_1.txt"))
    assert chain.shape[1] == len(pars) + 4 and np.isfinite(chain).all()
    argv = ["--result", prfile, "--optimal_statistic", "1", "-N", "8"]
    assert t_main(argv, device="cpu") == 0
    pkl = os.path.join(run, "optimal_statistic.pkl")
    port = pickle.load(open(pkl, "rb"))
    os.remove(pkl)
    jos.OptimalStatisticWarp(j_parse(argv)).main_pipeline()
    ref = pickle.load(open(pkl, "rb"))
    assert list(port) == list(ref) == ["hd", "dipole", "monopole"]
    for orf in ref:
        p, r = port[orf], ref[orf]
        # rho crosses zero and lies far below sig at a short chain's
        # prior-like median: both in units of sig, as chip_smoke.py:
        # os_check holds them; A^2 in units of its error
        sig = r["sig"]
        assert np.all(np.abs(p["rho"] - r["rho"]) <= OS_RTOL * sig), orf
        np.testing.assert_allclose(p["sig"], sig, rtol=OS_RTOL)
        np.testing.assert_allclose(p["a2_err"], r["a2_err"], rtol=OS_RTOL)
        assert abs(p["a2"] - r["a2"]) <= OS_RTOL * r["a2_err"], orf
        assert abs(p["snr"] - r["snr"]) <= OS_RTOL, orf
