"""The port's results layer against the JAX package's, on the same runs.

Each run directory is copied twice and post-processed by both packages'
``EnterpriseWarpResult`` with noise files, credible levels, logBF,
``covm`` and diagnostics on: ``tests/test_results.py``'s synthetic runs
(with and without an ``nmodel`` column) and a port CPU run of
``examples/example_params/default_hypermodel.dat --num 0``. Both sides
are numpy on the same chain files, so the noise JSON, the credible-level
JSON, the diagnostics JSON and the logBF visit counts must be equal
within rtol 1e-12 (summation order is the only freedom) and
``covm_all.csv`` must be the same text. ``utils/diagnostics.py``'s
``summarize_chains`` is held against the JAX package's likewise.
``python -m enterprise_warp_tpu_torch.results`` runs as a program
(``--optimal_statistic``: ``tests/test_torch_optstat.py``); without
pandas the covariance collection still writes its CSV and skips the
pickle.
"""

import json
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from enterprise_warp_tpu.results import \
    EnterpriseWarpResult as JResult
from enterprise_warp_tpu.utils.diagnostics import \
    summarize_chains as j_summarize
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.results import EnterpriseWarpResult as TResult
from enterprise_warp_tpu_torch.utils.diagnostics import \
    summarize_chains as t_summarize

from test_results import opts_for, write_fake_run
from test_torch_cli import _paramfile

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTS = dict(noisefiles=1, credlevels=1, logbf=1, covm=1, diagnostics=1)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port CPU run of the hypermodel paramfile (80 steps, 8 walkers);
    returns its output directory (the parent of ``0_J1234-5678``)."""
    tmp = tmp_path_factory.mktemp("port_run")
    prfile = _paramfile(tmp, 80, "default_hypermodel.dat")
    assert cli.main(["--prfile", prfile, "--num", "0"], device="cpu") == 0
    runs = [r for r, ds, _ in os.walk(tmp / "out") if "0_J1234-5678" in ds]
    assert len(runs) == 1
    return runs[0]


def _source(kind, tmp_path, port_run):
    if kind == "port_run":
        return port_run
    src = str(tmp_path / "src")
    write_fake_run(src, nsamp=800, nmodel=kind == "synthetic_nmodel")
    d = os.path.join(src, "0_J0000+0000")
    # a 4-chain PT checkpoint, so the diagnostics split the chain
    np.savez(os.path.join(d, "state.npz"), x=np.zeros((8, 3)),
             ladder=np.array([1.0, 1.7]))
    return src


def _run(cls, src, dst, caplog):
    shutil.copytree(src, dst)
    caplog.clear()
    r = cls(opts_for(dst, **PRODUCTS))
    with caplog.at_level(logging.INFO, logger="ewt.results"):
        r.main_pipeline()
    logbf = [m for m in caplog.messages
             if m.startswith("logBF") or "no nmodel column" in m]
    counts = {}
    for psr_dir in r.psr_dirs:
        chain, _, pars = r.load_chains(psr_dir)
        counts[psr_dir] = r._print_logbf(psr_dir, chain, pars)
    return logbf, counts


def _json_close(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _json_close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _json_close(x, y)
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["synthetic", "synthetic_nmodel",
                                  "port_run"])
def test_products_equal(tmp_path, port_run, caplog, kind):
    src = _source(kind, tmp_path, port_run)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_logbf, j_counts = _run(JResult, src, jdir, caplog)
    t_logbf, t_counts = _run(TResult, src, tdir, caplog)
    assert t_logbf == j_logbf and t_counts == j_counts
    if kind != "synthetic":
        assert any(m.startswith("logBF") for m in t_logbf) or \
            len(next(iter(t_counts.values()))) == 1
    for sub in ("noisefiles", "credlevels", "diagnostics"):
        names = sorted(os.listdir(os.path.join(jdir, sub)))
        assert names and sorted(os.listdir(os.path.join(tdir, sub))) == names
        for n in names:
            with open(os.path.join(jdir, sub, n)) as fh:
                want = json.load(fh)
            with open(os.path.join(tdir, sub, n)) as fh:
                got = json.load(fh)
            _json_close(got, want)
    with open(os.path.join(jdir, "covm_all.csv")) as fh:
        want = fh.read()
    with open(os.path.join(tdir, "covm_all.csv")) as fh:
        assert fh.read() == want


def test_summarize_chains_equal():
    rng = np.random.default_rng(7)
    chains = rng.standard_normal((4, 300, 3)).cumsum(axis=1) * 0.1
    names = ["a", "b", "c"]
    _json_close(t_summarize(chains, names), j_summarize(chains, names))


def test_results_program(tmp_path, port_run):
    out = str(tmp_path / "run")
    shutil.copytree(port_run, out)
    proc = subprocess.run(
        [sys.executable, "-m", "enterprise_warp_tpu_torch.results",
         "--result", out, "--info", "1", "--noisefiles", "1",
         "--credlevels", "1", "--logbf", "1", "--covm", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert os.path.exists(os.path.join(out, "noisefiles",
                                       "J1234-5678_noise.json"))
    assert "logBF" in proc.stderr or "only model" in proc.stderr


def test_covm_without_pandas(tmp_path, monkeypatch):
    out = str(tmp_path)
    write_fake_run(out)
    monkeypatch.setitem(sys.modules, "pandas", None)
    TResult(opts_for(out, covm=1)).main_pipeline()
    text = open(os.path.join(out, "covm_all.csv")).read().splitlines()
    assert text[0] == (",J0000+0000_efac,J0000+0000_red_noise_log10_A,"
                       "J0000+0000_red_noise_gamma")
    assert text[1] == "J0000+0000_efac,0.01,0.0,0.0"
    assert not os.path.exists(os.path.join(out, "covm_all.pkl"))
