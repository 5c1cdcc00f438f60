"""The port's convergence-gated sampling (``samplers/convergence.py``).

- ``chains_from_file`` and ``_robust_loadtxt`` against the JAX package's
  on the same files, clean and with a partial or corrupt line (the JAX
  package's pure-Python path: its native reader is switched off here, so
  the test builds nothing inside the reference);
- ports of ``tests/test_samplers.py``'s ``TestConvergence`` (a Gaussian to
  its gates, the warm start after a kill, the checkpoint rewind when the
  chain file is short, the hot-rung files cut back on resume) and
  ``TestConvergenceGrowth`` (geometric checks, thinned diagnostics);
- the streaming gate: on by default, a check the sampler's streaming
  ledger already fails runs no exact fold, and the run converges on an
  exact check only; ``EWT_STREAMING_DIAG=0`` folds exactly at every
  check; a resume that rewinds the checkpoint cuts the ledger's
  ``diag_*`` keys back (or drops them) as the JAX package's
  ``sample_to_convergence`` does on the same checkpoint, and the resumed ledger folds no step twice.
"""

import math

import numpy as np
import pytest
import torch

import enterprise_warp_tpu.native as j_native
from enterprise_warp_tpu.samplers import convergence as jconv
from enterprise_warp_tpu_torch.models.prior_mixin import PriorMixin
from enterprise_warp_tpu_torch.models.priors import Parameter, Uniform
from enterprise_warp_tpu_torch.samplers import PTSampler
from enterprise_warp_tpu_torch.samplers import convergence as tconv
from enterprise_warp_tpu_torch.samplers.convergence import \
    sample_to_convergence

torch.set_num_threads(2)


class GaussianLike(PriorMixin):
    """Analytic Gaussian in a uniform box (float64 torch)."""

    device = torch.device("cpu")

    def __init__(self, mu, sigma, lo=-10.0, hi=10.0):
        self.mu = torch.tensor(mu, dtype=torch.float64)
        self.sigma = torch.tensor(sigma, dtype=torch.float64)
        self.ndim = len(mu)
        self.params = [Parameter(f"p{i}", Uniform(lo, hi))
                       for i in range(self.ndim)]
        self.param_names = [p.name for p in self.params]

    def loglike_batch(self, theta):
        z = (torch.as_tensor(theta, dtype=torch.float64) - self.mu) \
            / self.sigma
        return (-0.5 * torch.sum(z * z, dim=-1)
                - torch.sum(torch.log(self.sigma))
                - 0.5 * self.ndim * math.log(2 * math.pi))


@pytest.fixture
def jax_python_reader(monkeypatch):
    """The JAX package's chain readers on their pure-Python path."""
    monkeypatch.setattr(j_native, "read_table_native", lambda path: None)


def _table(tmp_path, rows=40, cols=6, seed=0):
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal((rows, cols)) * 10.0 ** rng.integers(
        -8, 8, (rows, cols))
    path = tmp_path / "chain_1.txt"
    np.savetxt(path, arr)
    return path, arr


@pytest.mark.parametrize("tail", ["", "1.2e", "-", "3.0 4.0\n",
                                  "1 2 3 garbage 5 6\n"],
                         ids=["clean", "cut_mantissa", "cut_sign", "ragged",
                              "corrupt"])
def test_robust_loadtxt_matches_jax(tmp_path, jax_python_reader, tail):
    path, arr = _table(tmp_path)
    with open(path, "a") as fh:
        fh.write(tail)
    got, dropped = tconv._robust_loadtxt(path)
    want, jdropped = jconv._robust_loadtxt(path)
    np.testing.assert_array_equal(got, want)
    assert dropped == jdropped == bool(tail)
    np.testing.assert_array_equal(got, arr)


def test_robust_loadtxt_of_garbage(tmp_path, jax_python_reader):
    path = tmp_path / "chain_1.txt"
    path.write_text("x y\nz\n")
    got, dropped = tconv._robust_loadtxt(path)
    want, jdropped = jconv._robust_loadtxt(path)
    assert got.shape == want.shape == (0, 0) and dropped and jdropped


@pytest.mark.parametrize("burn_frac", [0.25, 0.0, 0.5])
def test_chains_from_file_matches_jax(tmp_path, burn_frac):
    nchains, ndim = 4, 3
    path, arr = _table(tmp_path, rows=4 * 25 + 3, cols=ndim + 4, seed=1)
    got = tconv.chains_from_file(path, nchains, ndim, burn_frac)
    want = jconv.chains_from_file(path, nchains, ndim, burn_frac)
    np.testing.assert_array_equal(got, want)
    nkept = int(25 * (1 - burn_frac))
    assert got.shape == (nchains, nkept, ndim)
    # chain c's last kept step is row (24 * nchains + c) of the file
    np.testing.assert_array_equal(got[:, -1], arr[96:100, :ndim])


def test_chains_from_file_corrupt_raises_as_jax(tmp_path):
    path, _ = _table(tmp_path, rows=12, cols=7)
    with open(path, "a") as fh:
        fh.write("1.0 2.0 nope 4 5 6 7\n")
    for mod in (tconv, jconv):
        with pytest.raises(ValueError):
            mod.chains_from_file(path, 4, 3)


def test_chains_from_blocks_matches_jax():
    rng = np.random.default_rng(2)
    blocks = [rng.standard_normal((n, 5, 2)).astype(np.float32)
              for n in (10, 7, 13)]
    np.testing.assert_array_equal(tconv._chains_from_blocks(blocks, 0.25),
                                  jconv._chains_from_blocks(blocks, 0.25))


def test_sample_to_convergence_gaussian(tmp_path):
    like = GaussianLike([0.5, -1.0], [0.4, 0.8])
    s = PTSampler(like, str(tmp_path), ntemps=2, nchains=8, seed=2,
                  cov_update=500)
    checks = []
    rep = sample_to_convergence(
        s, target_ess=400.0, rhat_max=1.02, check_every=1000,
        max_steps=20_000, verbose=False,
        on_check=lambda *a: checks.append(a))
    assert rep.converged
    assert rep.rhat_max <= 1.02 and rep.ess_min >= 400.0
    assert rep.chains.shape == (8, int(rep.steps * 0.75), like.ndim)
    flat = rep.chains.reshape(-1, like.ndim)
    np.testing.assert_allclose(flat.mean(0), [0.5, -1.0], atol=0.15)
    # the in-memory chains are the on-disk contract file's
    chain = np.loadtxt(tmp_path / "chain_1.txt")
    assert len(chain) == rep.steps * 8
    np.testing.assert_allclose(
        tconv.chains_from_file(tmp_path / "chain_1.txt", 8, like.ndim),
        rep.chains, rtol=1e-6)
    assert [c[0] for c in checks] == list(range(1000, rep.steps + 1, 1000))
    assert 0 < rep.steady_wall_s < rep.wall_s


def test_convergence_warm_start(tmp_path):
    """A killed convergence run resumes from the output directory: the
    second driver picks up the chain and the checkpoint, and every step
    before and after the kill is in the assembled chains."""
    like = GaussianLike([0.5, -1.0], [0.4, 0.8])
    s = PTSampler(like, str(tmp_path), ntemps=2, nchains=8, seed=2,
                  cov_update=500)
    rep1 = sample_to_convergence(s, target_ess=1e9, rhat_max=0.0,
                                 check_every=1000, max_steps=2000,
                                 verbose=False, resume=True)
    assert not rep1.converged and rep1.steps == 2000
    s2 = PTSampler(like, str(tmp_path), ntemps=2, nchains=8, seed=2,
                   cov_update=500)
    rep2 = sample_to_convergence(s2, target_ess=400.0, rhat_max=1.02,
                                 check_every=1000, max_steps=20_000,
                                 verbose=False, resume=True)
    assert rep2.converged and rep2.steps > 2000
    chain = np.loadtxt(tmp_path / "chain_1.txt")
    assert len(chain) == rep2.steps * 8
    # the resumed run is the uninterrupted one, step for step
    s3 = PTSampler(like, str(tmp_path / "straight"), ntemps=2, nchains=8,
                   seed=2, cov_update=500)
    s3.sample(rep2.steps, resume=False, verbose=False, block_size=500)
    np.testing.assert_array_equal(
        np.loadtxt(tmp_path / "straight" / "chain_1.txt"), chain)
    flat = rep2.chains.reshape(-1, like.ndim)
    np.testing.assert_allclose(flat.mean(0), [0.5, -1.0], atol=0.15)


def test_resume_rewinds_checkpoint_when_chain_short(tmp_path):
    """Dropped or partial chain lines can leave fewer complete steps on
    disk than the checkpoint counts: resume rewinds the checkpoint to the
    file, so rows == steps * nchains holds afterwards."""
    like = GaussianLike([0.0, 1.0], [0.5, 0.5])
    s = PTSampler(like, str(tmp_path), ntemps=2, nchains=4, seed=3,
                  cov_update=500)
    sample_to_convergence(s, target_ess=1e9, rhat_max=0.0,
                          check_every=500, max_steps=1000, verbose=False,
                          resume=True)
    chain_path = tmp_path / "chain_1.txt"
    rows = chain_path.read_text().splitlines()
    assert len(rows) == 1000 * 4
    chain_path.write_text("\n".join(rows[:-6] + [rows[-6][:20]]) + "\n")
    s2 = PTSampler(like, str(tmp_path), ntemps=2, nchains=4, seed=3,
                   cov_update=500)
    rep = sample_to_convergence(s2, target_ess=1e9, rhat_max=0.0,
                                check_every=500, max_steps=1500,
                                verbose=False, resume=True)
    chain = np.loadtxt(chain_path)
    assert len(chain) == rep.steps * 4 == 1500 * 4
    assert np.load(tmp_path / "state.npz")["step"] == rep.steps
    # the rows kept before the cut are the first run's
    np.testing.assert_array_equal(
        chain[:998 * 4], np.loadtxt(rows[:998 * 4]))
    assert rep.chains.shape == (4, int(1500 * 0.75), 2)


def test_resume_truncates_hot_chains(tmp_path):
    """Hot-rung files are appended in the same blocks as the cold file;
    rows appended past the checkpoint are cut on resume."""
    like = GaussianLike([0.0, 1.0], [0.5, 0.5])
    kw = dict(ntemps=3, nchains=4, seed=4, write_hot_chains=True)
    s = PTSampler(like, str(tmp_path), **kw)
    sample_to_convergence(s, target_ess=1e9, rhat_max=0.0, check_every=400,
                          max_steps=400, verbose=False, resume=True)
    hot = sorted(p for p in tmp_path.glob("chain_*.txt")
                 if p.name != "chain_1.txt")
    assert len(hot) == 2
    with open(hot[0], "a") as fh:
        for _ in range(8):
            fh.write(" ".join(["0.1"] * (like.ndim + 4)) + "\n")
    s2 = PTSampler(like, str(tmp_path), **kw)
    rep = sample_to_convergence(s2, target_ess=1e9, rhat_max=0.0,
                                check_every=400, max_steps=800,
                                verbose=False, resume=True)
    cold = np.loadtxt(tmp_path / "chain_1.txt")
    assert len(cold) == rep.steps * 4
    for hp in hot:
        h = np.loadtxt(hp)
        assert len(h) == len(cold) and not (h[:, 0] == 0.1).all()


def test_geometric_checks_and_thinned_diagnostics(tmp_path):
    """check_growth spaces checks geometrically (block-size aligned) and
    diag_max_kept bounds the per-check cost without changing the verdict
    on an easy target."""
    like = GaussianLike([0.5, -0.5], [1.0, 2.0])
    s = PTSampler(like, str(tmp_path), ntemps=1, nchains=32, seed=0,
                  cg_weight=40, de_weight=30, scam_weight=20,
                  prior_weight=10)
    checks = []
    rep = sample_to_convergence(
        s, target_ess=300.0, rhat_max=1.05, check_every=200,
        max_steps=20000, block_size=100, verbose=False,
        diag_max_kept=150, check_growth=1.5,
        on_check=lambda *a: checks.append(a[0]))
    assert rep.converged
    assert rep.steps % 100 == 0
    assert rep.ess_min >= 300.0
    su = rep.summary
    assert abs(su["p0"]["mean"] - 0.5) < 0.15
    assert abs(su["p1"]["std"] - 2.0) < 0.4
    # the check schedule: max(200, 0.5 steps) rounded up to whole blocks
    want, steps = [], 0
    while steps < rep.steps:
        todo = max(200, int(steps * 0.5))
        steps += -(-todo // 100) * 100
        want.append(steps)
    assert checks == want


# ---- the streaming gate (utils/devicemetrics.py) ------------------------ #

def _check_modes(outdir):
    import json
    return [e["diag_mode"] for e in
            (json.loads(ln) for ln in
             (outdir / "events.jsonl").read_text().splitlines())
            if e.get("phase") == "convergence_check"]


def _count_folds(monkeypatch):
    folds = []
    real = tconv.summarize_chains

    def counted(*a, **k):
        folds.append(1)
        return real(*a, **k)
    monkeypatch.setattr(tconv, "summarize_chains", counted)
    return folds


def test_streaming_gate_skips_exact_folds(tmp_path, monkeypatch):
    """With the gate on (the default), a check the streaming ledger
    already fails runs no exact fold of the chains; the run converges
    only on an exact check, whose figures pass."""
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    monkeypatch.delenv("EWT_STREAMING_DIAG", raising=False)
    monkeypatch.delenv("EWT_DEVICE_DIAG", raising=False)
    folds = _count_folds(monkeypatch)
    s = PTSampler(GaussianLike([0.0, 1.0], [0.5, 0.3]), str(tmp_path),
                  ntemps=1, nchains=8, seed=0)
    rep = sample_to_convergence(s, target_ess=600.0, rhat_max=1.05,
                                check_every=200, max_steps=8000,
                                block_size=100, verbose=False)
    modes = _check_modes(tmp_path)
    assert rep.converged and modes[-1] == "exact"
    assert "stream" in modes
    assert len(folds) == modes.count("exact")
    assert rep.ess_min >= 600.0 and rep.rhat_max <= 1.05
    assert s.diag_ledger.total_steps == rep.steps


def test_streaming_gate_off_checks_exactly(tmp_path, monkeypatch):
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    monkeypatch.setenv("EWT_STREAMING_DIAG", "0")
    folds = _count_folds(monkeypatch)
    s = PTSampler(GaussianLike([0.0, 1.0], [0.5, 0.3]), str(tmp_path),
                  ntemps=1, nchains=8, seed=0)
    rep = sample_to_convergence(s, target_ess=600.0, rhat_max=1.05,
                                check_every=200, max_steps=8000,
                                block_size=100, verbose=False)
    modes = _check_modes(tmp_path)
    assert rep.converged and set(modes) == {"exact"}
    assert len(folds) == len(modes)


@pytest.mark.parametrize("keep", [300, 250], ids=["aligned", "unaligned"])
def test_resume_rewind_of_the_ledger_matches_jax(tmp_path, monkeypatch,
                                                 keep):
    """A chain file shorter than the checkpoint rewinds the checkpoint's
    step counter; the streaming ledger's ``diag_*`` keys are cut back with
    it where the step lands on a block boundary, else dropped, as the JAX
    package's ``sample_to_convergence`` does on the same checkpoint."""
    import shutil
    import types
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    monkeypatch.delenv("EWT_DEVICE_DIAG", raising=False)
    like = GaussianLike([0.0, 1.0], [0.5, 0.3])
    run = tmp_path / "run"
    s = PTSampler(like, str(run), ntemps=1, nchains=4, seed=0)
    s.sample(400, resume=False, verbose=False, block_size=100)
    rows = (run / "chain_1.txt").read_text().splitlines()
    (run / "chain_1.txt").write_text("\n".join(rows[:keep * 4]) + "\n")
    shutil.copytree(run, tmp_path / "jax")
    blocks, steps = tconv._resume_blocks(
        PTSampler(like, str(run), ntemps=1, nchains=4, seed=0), False)
    assert steps == keep
    jsampler = types.SimpleNamespace(
        outdir=str(tmp_path / "jax"), nchains=4, ndim=2, like=like,
        _ckpt_path=str(tmp_path / "jax" / "state.npz"))
    jconv.sample_to_convergence(jsampler, max_steps=keep, resume=True,
                                verbose=False)
    got, want = (dict(np.load(d / "state.npz"))
                 for d in (run, tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["step"]) == keep
    if keep == 300:
        assert list(got["diag_counts"]) == [100] * 3
        s2 = PTSampler(like, str(run), ntemps=1, nchains=4, seed=0)
        rep = sample_to_convergence(s2, target_ess=1e9, rhat_max=0.0,
                                    check_every=100, max_steps=500,
                                    block_size=100, resume=True,
                                    verbose=False)
        # no double fold: the ledger covers exactly the sampled steps
        assert s2.diag_ledger.total_steps == rep.steps == 500
        assert s2.diag_hist.sum() == 200 * 4 * 2
    else:
        assert not any(k.startswith("diag_") for k in got)
