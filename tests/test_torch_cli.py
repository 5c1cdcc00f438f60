"""The port's CLI end to end on the CPU, and the port's import boundary.

- ``enterprise_warp_tpu_torch.cli.main`` runs a copy of
  ``examples/example_params/system_noise.dat`` (40 steps) for both pulsars
  on the CPU and leaves finite chain rows in the reference layout;
- it runs ``fixed_white_noise.dat --num 0`` (white noise fixed from the
  noisefile, Grams folded at build time) with no likelihood-kernel
  route;
- it runs the nested branch (``sampler: dynesty``) on a copy of
  ``default_model_nested.dat`` at 60 live points, with the paramfile's
  knobs forwarded, and the ``emcee``/``ptemcee`` branch on
  ``system_noise.dat --num 1``;
- it runs the ``hmc`` branch on a copy of ``hmc_single_psr.dat``
  (``--num 1``, 20 steps of 8 chains, 4 leapfrog steps, no ADVI warm
  start) and leaves ``nsamp * nchains`` finite rows of ``ndim + 4``
  columns;
- a fresh interpreter imports every module of the port and must end with
  none of ``jax``, ``optax`` or any ``enterprise_warp_tpu`` module loaded;
- an AST scan of the package (and of ``chip_smoke.py``) finds no import of
  them.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.config.paramfile import IMPLEMENTED_SAMPLERS
from enterprise_warp_tpu_torch.ops import routes as troutes

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _kernels_not_opted_out(monkeypatch):
    """The route decisions read ``EWT_PALLAS``/``EWT_PALLAS_MEGA``; an
    in-process demotion elsewhere in the suite may have left the opt-out
    set, so each test here starts without it."""
    monkeypatch.delenv("EWT_PALLAS", raising=False)
    monkeypatch.delenv("EWT_PALLAS_MEGA", raising=False)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "enterprise_warp_tpu_torch")
EXAMPLES = os.path.join(REPO, "examples")


def _paramfile(tmp_path, nsamp, name="system_noise.dat", **keys):
    """``examples/example_params/<name>`` with absolute input paths, the
    output under ``tmp_path``, ``nsamp`` steps and the sampler ``keys``
    set (added before the model section where the file lacks them)."""
    keys = dict(keys, nsamp=nsamp)
    lines = []
    with open(os.path.join(EXAMPLES, "example_params", name)) as fh:
        for line in fh.read().splitlines():
            key, _, val = line.partition(":")
            key = key.strip()
            if key == "datadir":
                line = f"datadir: {os.path.join(EXAMPLES, 'data')}"
            elif key == "out":
                line = f"out: {tmp_path / 'out'}"
            elif key in keys:
                line = f"{key}: {keys.pop(key)}"
            elif key in ("noise_model_file", "noisefiles"):
                line = f"{key}: " + os.path.join(EXAMPLES, val.strip())
            elif line.strip() == "{0}":
                lines += [f"{k}: {v}" for k, v in keys.items()]
                keys = {}
            lines.append(line)
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("num,psr,ndim", [(0, "J1234-5678", 14),
                                          (1, "J0042-0000", 6)])
def test_cli_runs_the_paramfile_on_cpu(tmp_path, num, psr, ndim):
    prfile = _paramfile(tmp_path, 40)
    rc = cli.main(["--prfile", prfile, "--num", str(num)], device="cpu")
    assert rc == 0
    runs = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "out")
            for d in ds if d == f"{num}_{psr}"]
    assert len(runs) == 1
    chain = np.loadtxt(os.path.join(runs[0], "chain_1.txt"))
    # the paramfile's sampler defaults: ntemps 1, nchains 8, thin 10
    assert chain.shape == (40 // 10 * 8, ndim + 4)
    assert np.isfinite(chain).all()
    pars = open(os.path.join(runs[0], "pars.txt")).read().split()
    assert len(pars) == ndim and all(p.startswith(psr) for p in pars)


def test_cli_runs_fixed_white_noise_on_cpu(tmp_path):
    # white noise fixed from the noisefile: the Grams are folded at build
    # time, so no evaluation reaches the likelihood-kernel route and each
    # Sigma solve takes the solve kernel's (here: its plain version)
    prfile = _paramfile(tmp_path, 40, "fixed_white_noise.dat")
    troutes.reset_counts()
    rc = cli.main(["--prfile", prfile, "--num", "0"], device="cpu")
    assert rc == 0
    assert troutes.ROUTES[("mega_solve", "plain-cpu")] > 0
    assert not any(k == "mega_like" for k, _ in troutes.ROUTES)
    runs = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "out")
            for d in ds if d == "0_J1234-5678"]
    assert len(runs) == 1
    chain = np.loadtxt(os.path.join(runs[0], "chain_1.txt"))
    assert chain.shape == (40 // 10 * 8, 6 + 4)
    assert np.isfinite(chain).all()
    pars = open(os.path.join(runs[0], "pars.txt")).read().split()
    assert len(pars) == 6 and not any("efac" in p or "equad" in p
                                      for p in pars)


def test_cli_runs_hmc_on_cpu(tmp_path, monkeypatch):
    # run_hmc reads the paramfile key ``advi_init``, but the ``hmc``
    # sampler defaults do not list it (in the reference likewise), so the
    # parser drops the key; registering it reaches that branch and skips
    # the 1500-step warm start, which takes ~40 s on the CPU
    monkeypatch.setitem(IMPLEMENTED_SAMPLERS["hmc"], "advi_init", 1)
    prfile = _paramfile(tmp_path, 20, "hmc_single_psr.dat", warmup=10,
                        nchains=8, n_leapfrog=4, advi_init=0)
    rc = cli.main(["--prfile", prfile, "--num", "1"], device="cpu")
    assert rc == 0
    runs = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "out")
            for d in ds if d == "1_J0042-0000"]
    assert len(runs) == 1
    chain = np.loadtxt(os.path.join(runs[0], "chain_1.txt"))
    # fake_psr_0 under the default noise model: efac, equad, red noise
    assert chain.shape == (20 * 8, 4 + 4)
    assert np.isfinite(chain).all()
    assert 0.0 < chain[-1, -2] <= 1.0
    pars = open(os.path.join(runs[0], "pars.txt")).read().split()
    assert len(pars) == 4 and all(p.startswith("J0042-0000") for p in pars)


def test_cli_refuses_what_is_not_ported(tmp_path, capsys):
    with pytest.raises(NotImplementedError):
        cli.main(["serve"], device="cpu")
    # the chain axis is the PT branch's alone: the nested branch notes
    # chain_shard, as the reference's CLI does, and runs unsharded
    prfile = _nested_paramfile(tmp_path, chain_shard=2)
    assert cli.main(["--prfile", prfile, "--num", "0"], device="cpu") == 0
    assert "note: chain_shard applies to the PT-MCMC branch only; " \
        "sampler 'dynesty' runs unsharded" in capsys.readouterr().out
    # the nested sampler's per-iteration switch (block_iters: 0) is
    # accepted: the blocked walk, one iteration a block
    prfile = _nested_paramfile(tmp_path, block_iters=0)
    assert cli.main(["--prfile", prfile, "--num", "0"], device="cpu") == 0
    res = [os.path.join(r, f) for r, _, fs in os.walk(tmp_path / "out")
           for f in fs if f.endswith("_result.json")]
    with open(res[0]) as fh:
        doc = json.load(fh)
    assert (doc["block_iters"], doc["kernel"]) == (1, "walk")


def _nested_paramfile(tmp_path, **keys):
    """``default_model_nested.dat`` (sampler ``dynesty``) at a CPU size:
    60 live points, 30 replaced an iteration, 4 likelihood calls each
    (one slice update), a loose ``dlogz``, and ``keys`` set."""
    keys = dict(dict(nlive=60, kbatch=30, nsteps=4, dlogz=1.0), **keys)
    lines = []
    with open(os.path.join(EXAMPLES, "example_params",
                           "default_model_nested.dat")) as fh:
        for line in fh.read().splitlines():
            key, _, val = line.partition(":")
            key = key.strip()
            if key == "datadir":
                line = f"datadir: {os.path.join(EXAMPLES, 'data')}"
            elif key == "out":
                line = f"out: {tmp_path / 'out'}"
            elif key in keys:
                line = f"{key}: {keys.pop(key)}"
            elif key == "noise_model_file":
                line = f"{key}: " + os.path.join(EXAMPLES, val.strip())
            elif line.strip() == "{0}":
                lines += [f"{k}: {v}" for k, v in keys.items()]
                keys = {}
            lines.append(line)
    path = tmp_path / "nested.dat"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("keys,kernel,block_iters", [
    ({}, "slice", 16), (dict(kernel="walk", block_iters=8), "walk", 8)])
def test_cli_runs_nested_on_cpu(tmp_path, keys, kernel, block_iters):
    """The CLI's nested branch (``sampler: dynesty``) on J1234-5678 with
    the paramfile's knobs forwarded; the result JSON loads through both
    packages' ``BilbyWarpResult`` with the same posterior, and the port's
    results CLI with ``--bilby 1`` writes the noise file from it."""
    import json

    from enterprise_warp_tpu.results.bilbylike import \
        BilbyWarpResult as JBilby
    from enterprise_warp_tpu_torch.results.__main__ import \
        main as results_main
    from enterprise_warp_tpu_torch.results.bilbylike import \
        BilbyWarpResult as TBilby
    from test_results import opts_for
    prfile = _nested_paramfile(tmp_path, **keys)
    rc = cli.main(["--prfile", prfile, "--num", "0"], device="cpu")
    assert rc == 0
    runs = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "out")
            for d in ds if d == "0_J1234-5678"]
    assert len(runs) == 1
    files = sorted(os.listdir(runs[0]))
    res_json = [f for f in files if f.endswith("_result.json")]
    assert len(res_json) == 1 and any(f.endswith("_nested.npz")
                                      for f in files)
    assert not any(f.endswith("_nested_ckpt.npz") for f in files)
    with open(os.path.join(runs[0], res_json[0])) as fh:
        res = json.load(fh)
    assert res["converged"] and np.isfinite(res["log_evidence"])
    assert res["sampler"] == "enterprise_warp_tpu_torch.nested"
    assert (res["kernel"], res["block_iters"]) == (kernel, block_iters)
    assert res["slide_moves_effective"] is True
    # kbatch 30 and nsteps 4 forwarded: evals = it * 30 * 4 + nlive
    assert res["num_likelihood_evaluations"] == \
        res["num_iterations"] * 30 * 4 + 60
    outdir = os.path.dirname(runs[0])
    loaded = [cls(opts_for(outdir, bilby=1)).load_chains("0_J1234-5678")
              for cls in (JBilby, TBilby)]
    assert loaded[0][2] == loaded[1][2] == res["parameter_labels"]
    np.testing.assert_array_equal(loaded[0][0], loaded[1][0])
    assert np.isfinite(loaded[1][0]).all() and len(loaded[1][0]) >= 100
    assert results_main(["--result", outdir, "--bilby", "1",
                         "--noisefiles", "1"]) == 0
    assert os.path.exists(os.path.join(outdir, "noisefiles",
                                       "J1234-5678_noise.json"))


@pytest.mark.parametrize("keys,knobs", [
    (dict(nlive=500, dlogz=0.1, kbatch=0, nsteps=0, block_iters=-1,
          kernel="slice"), {}),
    (dict(kbatch=160, nsteps=12, block_iters=0, kernel="walk"),
     dict(kbatch=160, nsteps=12, block_iters=0, kernel="walk"))])
def test_nested_knobs_forwarded_as_reference(keys, knobs):
    # the reference's forwarding (enterprise_warp_tpu/cli.py:297-314):
    # 0 = auto for kbatch/nsteps, -1 keeps the default block length, and
    # the default kernel is not forwarded
    assert cli.nested_knobs(keys) == knobs


@pytest.mark.parametrize("sampler,ntemps", [("emcee", 1), ("ptemcee", 2)])
def test_cli_runs_emcee_branch_on_cpu(tmp_path, sampler, ntemps):
    """``emcee``/``ptemcee`` run the PT sampler for ``nsteps`` steps with
    ``nwalkers`` chains and ``ntemps`` temperatures, as the reference's
    CLI does; the chain file holds the cold chains."""
    prfile = _paramfile(tmp_path, 10)
    src = open(prfile).read().replace("sampler: ptmcmcsampler",
                                      f"sampler: {sampler}")
    extra = "nsteps: 20\nnwalkers: 4\n" + (
        f"ntemps: {ntemps}\n" if sampler == "ptemcee" else "")
    src = src.replace("{0}", extra + "{0}")
    (tmp_path / "mc.dat").write_text(src)
    rc = cli.main(["--prfile", str(tmp_path / "mc.dat"), "--num", "1"],
                  device="cpu")
    assert rc == 0
    runs = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "out")
            for d in ds if d == "1_J0042-0000"]
    assert len(runs) == 1
    chain = np.loadtxt(os.path.join(runs[0], "chain_1.txt"))
    state = np.load(os.path.join(runs[0], "state.npz"))
    assert state["x"].shape[0] == 4 * ntemps
    assert chain.shape[1] == 6 + 4 and np.isfinite(chain).all()
    assert chain.shape[0] % 4 == 0 and chain.shape[0] >= 4


def _modules():
    out = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'optax', 'enterprise_warp_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_names_jax_or_the_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "optax", "enterprise_warp_tpu"):
                    bad.append(f"{path}:{node.lineno}: {n}")
    assert len(files) > 30 and not bad, bad
    assert {os.path.join(PKG, "native.py"),
            os.path.join(PKG, "samplers", "convergence.py"),
            os.path.join(PKG, "utils", "devicemetrics.py"),
            os.path.join(PKG, "utils", "metricsexport.py"),
            os.path.join(PKG, "parallel", "distributed.py")} <= set(files)
