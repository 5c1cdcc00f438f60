"""The port's serving layer against the JAX package's, on the CPU.

- ``pack_requests``/``split_batch`` give the reference's rows, segments,
  fills and job counts; ``bucket_for`` and ``EWT_SERVE_BUCKETS`` its
  edges;
- the AOT cache: hit and miss counters, ``warm``, ``clear``, the
  ``compile`` event of a warm-up, and a non-positive bucket raises;
- ``topology_fingerprint``: shared across rebuilds, different across
  pulsars, changed by ``EWT_PALLAS_MEGA``, per instance without a pulsar
  build;
- ``synthetic_trace`` draws the reference's thetas;
- one seeded trace through both drivers on ``fixed_white_noise.dat
  --num 0`` at serve width 4: the same per-request lnL within the
  tolerance of the single-pulsar lnL parity tests
  (``tests/test_torch_kernel.py``), and the same dispatches, fills and
  jobs per batch;
- packed rows bit-equal to serving each job alone, and the likelihood's
  per-walker sums independent of a row's place in the batch;
- a ``classic`` demotion re-dispatches the batch under
  ``EWT_PALLAS_MEGA=0`` with a fresh executable key, and the last rung
  exits 75 with the queue requeued and checkpointed, then resumes;
- the kernel build directory (``utils/compilecache.py``):
  ``EWT_COMPILE_CACHE`` relocates it and ``ops/cuda_lib.py:build`` finds
  a library already built there, ``EWT_NO_COMPILE_CACHE=1`` builds into
  a fresh directory under ``TMPDIR`` that is removed at exit;
- ``eval_protocol``'s batch and single evaluations;
- split mode at the prior draws of seeded synthetic traces: every lnL
  finite, as in the reference.
"""

import hashlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.models.assemble import \
    init_model_likelihoods as j_init
from enterprise_warp_tpu.serve import ServeDriver as JDriver
from enterprise_warp_tpu.serve import pack_requests as j_pack
from enterprise_warp_tpu.serve import split_batch as j_split
from enterprise_warp_tpu.serve.cli import synthetic_trace as j_trace
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.models import (StandardModels, TermList,
                                              build_pulsar_likelihood)
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init
from enterprise_warp_tpu_torch.models.build import topology_fingerprint
from enterprise_warp_tpu_torch.ops import routes as troutes
from enterprise_warp_tpu_torch.resilience import faults
from enterprise_warp_tpu_torch.resilience.supervisor import (
    BlockSupervisor, PlatformDemotion)
from enterprise_warp_tpu_torch.serve import (DEFAULT_BUCKETS,
                                             AOTExecutableCache,
                                             ServeDriver, batch_buckets,
                                             bucket_for, pack_requests,
                                             split_batch)
from enterprise_warp_tpu_torch.serve.cli import synthetic_trace
from enterprise_warp_tpu_torch.sim import make_fake_pulsar
from enterprise_warp_tpu_torch.samplers.evalproto import eval_protocol
from enterprise_warp_tpu_torch.utils import compilecache, telemetry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
# the single-pulsar lnL parity tests' tolerances (tests/test_torch_kernel.py):
# split mode near typical values, |dlnL| <= 1e-3; float64 at prior draws,
# rtol max(1e-9, 10 kappa eps) with kappa the equilibrated Sigma's
# condition number
SPLIT_ATOL = 1e-3
F64_RTOL = 1e-9


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Start without the route opt-outs (an in-process demotion elsewhere
    may have set them) and without a fault plan."""
    monkeypatch.delenv("EWT_PALLAS", raising=False)
    monkeypatch.delenv("EWT_PALLAS_MEGA", raising=False)
    monkeypatch.delenv("EWT_SERVE_BUCKETS", raising=False)
    yield
    faults.install_plan(None)


def write_paramfile(dest, name="fixed_white_noise.dat"):
    """``examples/example_params/<name>`` with absolute input paths and
    its output under ``dest``'s directory; returns the path."""
    lines = []
    with open(os.path.join(EXAMPLES, "example_params", name)) as fh:
        for line in fh.read().splitlines():
            key = line.partition(":")[0].strip()
            if key == "datadir":
                line = f"datadir: {os.path.join(EXAMPLES, 'data')}"
            elif key == "out":
                line = f"out: {os.path.join(os.path.dirname(dest), 'out')}"
            elif key in ("noise_model_file", "noisefiles"):
                line = f"{key}: " + os.path.join(
                    EXAMPLES, line.partition(":")[2].strip())
            lines.append(line)
    with open(dest, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(dest)


def fwn_likes(prfile, gram_mode):
    """Both packages' likelihoods of ``fixed_white_noise.dat --num 0``."""
    opts = types.SimpleNamespace(num=0, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)
    jl = j_init(JParams(prfile, opts=opts), gram_mode=gram_mode,
                write_pars=False)[0]
    tl = t_init(TParams(prfile, opts=opts), gram_mode=gram_mode,
                write_pars=False, device="cpu")[0]
    return jl, tl


@pytest.fixture(scope="module")
def prfile(tmp_path_factory):
    return write_paramfile(tmp_path_factory.mktemp("serve") / "fwn.dat")


@pytest.fixture(scope="module")
def split_likes(prfile):
    return fwn_likes(prfile, "split")


def small_like(name="A", seed=3):
    """A 96-TOA sampled-white pulsar of the port's own simulator."""
    psr = make_fake_pulsar(name=name, ntoa=96, backends=("X", "Y"),
                           freqs_mhz=(1400.0,), seed=seed)
    psr.residuals = psr.toaerrs * np.random.default_rng(
        seed).standard_normal(96)
    m = StandardModels(psr=psr)
    return build_pulsar_likelihood(
        psr, TermList(psr, [m.efac("by_backend"),
                            m.spin_noise("powerlaw_5_nfreqs")]),
        device="cpu")


def jobs_of(like, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"t{i % 3}", np.asarray(like.sample_prior(rng, n)))
            for i, n in enumerate(sizes)]


def drive(root, like, jobs, width=4, buckets=(1, 4), driver=ServeDriver):
    with driver(str(root), buckets=buckets) as drv:
        drv.register("m0", like, width=width)
        rids = [drv.submit(t, "m0", th) for t, th in jobs]
        summary = drv.run()
    return drv, rids, summary


# ------------------------------------------------------------------ #
#  buckets + packer                                                   #
# ------------------------------------------------------------------ #

class _Req:
    def __init__(self, rid, thetas, model="m"):
        self.rid, self.model = rid, model
        self.thetas = np.asarray(thetas, dtype=np.float64)


@pytest.mark.parametrize("sizes,width", [([3, 2], 8), ([5, 6], 4),
                                         ([1, 1, 1, 9, 2], 4),
                                         ([16], 16), ([7, 1, 3], 2)])
def test_pack_and_split_match_reference(sizes, width):
    rng = np.random.default_rng(sum(sizes) + width)
    reqs = [_Req(f"r{i}", rng.standard_normal((n, 3)))
            for i, n in enumerate(sizes)]

    def shape(batches):
        return [(b.bucket, b.n_real, b.fill, b.n_jobs, b.rows,
                 [(r.rid, a, c, n) for r, a, c, n in b.segments])
                for b in batches]

    def same(x, y):
        assert len(x) == len(y)
        for bx, by in zip(x, y):
            assert bx[:4] == by[:4] and bx[5] == by[5]
            np.testing.assert_array_equal(bx[4], by[4])

    tb, jb = pack_requests(reqs, width), j_pack(reqs, width)
    same(shape(tb), shape(jb))
    # every row once, FIFO; padding replicates the last real row
    got = np.concatenate([b.rows[:b.n_real] for b in tb])
    np.testing.assert_array_equal(got, np.concatenate([r.thetas
                                                       for r in reqs]))
    for b in tb:
        np.testing.assert_array_equal(
            b.rows[b.n_real:], np.repeat(b.rows[b.n_real - 1:b.n_real],
                                         b.bucket - b.n_real, axis=0))
    for b, c in zip(tb, jb):
        if b.n_real >= 2:
            same(shape(split_batch(b)), shape(j_split(c)))
        else:
            with pytest.raises(ValueError, match="bisect"):
                split_batch(b)
    with pytest.raises(ValueError, match="mixed models"):
        pack_requests([_Req("a", np.ones((1, 2)), "m1"),
                       _Req("b", np.ones((1, 2)), "m2")], 4)


@pytest.mark.parametrize("n,edges,want", [(1, (1, 4, 16), 1),
                                          (3, (1, 4, 16), 4),
                                          (16, (1, 4, 16), 16),
                                          (17, (1, 4, 16), None)])
def test_bucket_for(n, edges, want):
    from enterprise_warp_tpu.serve import bucket_for as j_bucket_for
    assert bucket_for(n, edges) == j_bucket_for(n, edges) == want


def test_serve_buckets_env(monkeypatch):
    from enterprise_warp_tpu.serve import batch_buckets as j_buckets
    monkeypatch.setenv("EWT_SERVE_BUCKETS", "8,2,8")
    assert batch_buckets() == j_buckets() == (2, 8)
    monkeypatch.setenv("EWT_SERVE_BUCKETS", "0,4")
    assert batch_buckets() == DEFAULT_BUCKETS
    monkeypatch.delenv("EWT_SERVE_BUCKETS")
    assert batch_buckets() == DEFAULT_BUCKETS == (1, 2, 4, 8, 16, 32, 64)


# ------------------------------------------------------------------ #
#  AOT cache and fingerprints                                         #
# ------------------------------------------------------------------ #

def test_aot_hit_miss_and_warm(tmp_path):
    like = small_like()
    cache = AOTExecutableCache((1, 4))
    snap0 = telemetry.registry().snapshot()["counters"]
    h0 = snap0.get("aot_cache{outcome=hit}", 0)
    m0 = snap0.get("aot_cache{outcome=miss}", 0)
    with telemetry.run_scope(str(tmp_path)):
        e1 = cache.executable(like, 4)
        e2 = cache.executable(like, 4)
        walls = cache.warm(like)
    assert e1 is e2 and e1.theta.shape == (4, like.ndim)
    snap = telemetry.registry().snapshot()["counters"]
    assert snap["aot_cache{outcome=miss}"] == m0 + 1
    assert snap["aot_cache{outcome=hit}"] == h0 + 1
    assert set(walls) == {1, 4} and walls[4] == 0.0 and walls[1] > 0.0
    key = cache.key(like, 4)
    assert key == (topology_fingerprint(like), 4, "cpu")
    # on the CPU nothing is built: no verdict
    assert cache.cache_verdicts[key] is None
    stats = cache.stats()
    assert stats["executables"] == 2
    comp = [json.loads(ln) for ln in open(tmp_path / "events.jsonl")]
    comp = [e for e in comp if e["type"] == "compile"]
    assert [e["fn"] for e in comp] == ["serve.eval_b4", "serve.eval_b1"]
    assert all(e["aot"] and e["cache_hit"] is None
               and e["arg_shapes"][0][1] == like.ndim for e in comp)
    # the executable evaluates what the likelihood does, at its bucket
    th = like.sample_prior(np.random.default_rng(5), 4)
    np.testing.assert_array_equal(e1(th).numpy(),
                                  like.loglike_batch(th).numpy())
    with pytest.raises(ValueError, match="rows"):
        e1(th[:3])
    cache.clear()
    assert not cache._exec and not cache._fp
    with pytest.raises(ValueError, match="positive"):
        cache.executable(like, 0)


def test_fingerprint_rebuild_data_route_and_instance(monkeypatch):
    from enterprise_warp_tpu_torch.models.assemble import \
        MultiPulsarLikelihood
    a, b = small_like(), small_like()
    assert a is not b and a.build_fingerprint == b.build_fingerprint
    assert topology_fingerprint(a) == topology_fingerprint(b)
    assert topology_fingerprint(small_like("B", 9)) != \
        topology_fingerprint(a)
    base = topology_fingerprint(a)
    monkeypatch.setenv("EWT_PALLAS_MEGA", "0")
    assert topology_fingerprint(a) != base
    monkeypatch.delenv("EWT_PALLAS_MEGA")
    assert topology_fingerprint(a) == base
    # no pulsar build: keyed on the instance (or a declared token)
    m1, m2 = MultiPulsarLikelihood([a]), MultiPulsarLikelihood([b])
    assert topology_fingerprint(m1) != topology_fingerprint(m2)
    assert topology_fingerprint(m1) == topology_fingerprint(m1)
    m1.topology_token = m2.topology_token = "same-artifact"
    assert topology_fingerprint(m1) == topology_fingerprint(m2)


def test_synthetic_trace_matches_reference(split_likes):
    jl, tl = split_likes
    jt = j_trace({"0": jl, "1": jl}, 40, tenants=5, max_theta=6, seed=7)
    tt = synthetic_trace({"0": tl, "1": tl}, 40, tenants=5, max_theta=6,
                         seed=7)
    assert [(e["tenant"], e["model"]) for e in tt] == \
        [(e["tenant"], e["model"]) for e in jt]
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a["thetas"], b["thetas"])


# ------------------------------------------------------------------ #
#  the driver against the reference's                                 #
# ------------------------------------------------------------------ #

def _sigma_condition(like, theta):
    """Condition number of each point's equilibrated Sigma (float64)."""
    from enterprise_warp_tpu_torch.ops.kernel import gram_blocks
    st = like.static
    G = gram_blocks(like.eval_nw(theta), st["r_w"], st["M_w"], st["T_w"],
                    gram_mode="f64")[0].numpy()
    S = G + np.stack([np.diag(1.0 / p)
                      for p in like.eval_phi(theta).numpy()])
    d = np.sqrt(np.einsum("wii->wi", S))
    return np.linalg.cond(S / d[:, :, None] / d[:, None, :])


def _near_truth_trace(like, n, seed):
    """Seeded requests of 1-6 points near the injected noise values of
    ``fixed_white_noise.dat``'s pulsar (tests/test_torch_kernel.py)."""
    truth = {"J1234-5678_red_noise_log10_A": -13.5,
             "J1234-5678_red_noise_gamma": 3.5,
             "J1234-5678_dm_gp_log10_A": -13.6,
             "J1234-5678_dm_gp_gamma": 2.9}
    mid = np.asarray([truth.get(p.name, 0.5 * (p.prior.lo + p.prior.hi))
                      for p in like.params])
    rng = np.random.default_rng(seed)
    return [{"tenant": f"tenant{rng.integers(4)}", "model": "0",
             "thetas": mid + 0.05 * rng.standard_normal(
                 (int(1 + rng.integers(6)), like.ndim))}
            for _ in range(n)]


@pytest.mark.parametrize("gram_mode", ["f64", "split"])
def test_driver_matches_reference(prfile, split_likes, gram_mode, tmp_path):
    """One seeded trace through both drivers at serve width 4: the
    per-request lnL of the single-pulsar parity tests' class, and the
    same dispatches, fills, jobs per batch and outcomes. float64 runs the
    CLI's synthetic trace (prior draws); split mode, whose float32 solve
    leaves prior corners outside any lnL class (ROADMAP.md Queue 3), runs
    a seeded trace near the injected noise values."""
    jl, tl = split_likes if gram_mode == "split" else fwn_likes(prfile,
                                                                "f64")
    if gram_mode == "f64":
        trace = synthetic_trace({"0": tl}, 24, tenants=4, max_theta=6,
                                seed=0)
    else:
        trace = _near_truth_trace(tl, 24, seed=0)
    jobs = [(e["tenant"], e["thetas"]) for e in trace]
    out = {}
    for name, D, like in (("t", ServeDriver, tl), ("j", JDriver, jl)):
        drv, rids, s = drive(tmp_path / name, like, jobs, driver=D)
        out[name] = (drv, rids, s)
    (td, trids, ts), (jd, jrids, js) = out["t"], out["j"]
    for key in ("dispatches", "sequential_dispatch_equiv",
                "mean_batch_fill", "real_rows", "pad_rows",
                "requests_done", "rejected_requests", "expired_requests",
                "quarantined_requests", "bisect_dispatches"):
        assert ts[key] == js[key], key
    assert ts["requests_done"] == len(jobs) and ts["accounting"]["balanced"]
    assert [(r["tenant"], r["n"], r["fill"]) for r in td.request_log] == \
        [(r["tenant"], r["n"], r["fill"]) for r in jd.request_log]
    lt = np.concatenate([td.results[r] for r in trids])
    lj = np.concatenate([np.asarray(jd.results[r]) for r in jrids])
    assert np.isfinite(lt).all()
    if gram_mode == "split":
        assert np.max(np.abs(lt - lj)) <= SPLIT_ATOL
    else:
        theta = np.concatenate([th for _, th in jobs])
        kappa = _sigma_condition(tl, theta)
        rtol = np.maximum(F64_RTOL, 10.0 * kappa * np.finfo(np.float64).eps)
        assert np.all(np.abs(lt - lj) <= rtol * np.abs(lj)), \
            (np.abs(lt - lj) / np.abs(lj), kappa)
        assert np.mean(kappa < 1e7) >= 0.5


@pytest.mark.parametrize("n", [1, 3, 122, 250, 334])
def test_row_sum_is_position_independent(n):
    """The likelihood's per-walker sums (``ops/kernel.py:_row_sum``) give
    a row the same bits wherever it sits in the batch and whatever the
    other rows hold, also from a misaligned view, and the plain sum's
    value within rounding."""
    from enterprise_warp_tpu_torch.ops.kernel import _row_sum
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.standard_normal((17, n)) * 1e3)
    ref = _row_sum(x)
    assert np.allclose(ref.numpy(), x.sum(dim=-1).numpy(), rtol=1e-13,
                       atol=1e-10)
    perm = torch.as_tensor(rng.permutation(17))
    np.testing.assert_array_equal(_row_sum(x[perm]).numpy(),
                                  ref[perm].numpy())
    flat = torch.cat([torch.zeros(1, dtype=x.dtype), x.flatten()])
    view = flat[1:].view(17, n)                 # one element off alignment
    np.testing.assert_array_equal(_row_sum(view).numpy(), ref.numpy())
    np.testing.assert_array_equal(
        _row_sum(torch.cat([x[:1], torch.zeros((15, n), dtype=x.dtype)]))[0]
        .numpy(), ref[0].numpy())


def test_packed_bit_equal_to_single_job_path(split_likes, tmp_path):
    """One-job, multi-row and spill cases packed together at width 4:
    every job's rows equal, bit for bit, the same rows served alone, and
    the direct evaluation within the kernel tolerance."""
    tl = split_likes[1]
    jobs = jobs_of(tl, [1, 2, 3, 4, 1, 9])
    drv, rids, s = drive(tmp_path / "pack", tl, jobs)
    assert s["requests_done"] == len(jobs) and s["dispatches"] == 5
    for k, (tenant, th) in enumerate(jobs):
        d2, r2, _ = drive(tmp_path / f"alone{k}", tl, [(tenant, th)])
        assert np.array_equal(d2.results[r2[0]], drv.results[rids[k]]), k
        np.testing.assert_allclose(drv.results[rids[k]],
                                   tl.loglike_batch(th).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_classic_demotion_redispatches_on_a_fresh_key(split_likes,
                                                      tmp_path,
                                                      monkeypatch):
    tl = split_likes[1]
    monkeypatch.setenv("EWT_PALLAS_MEGA", "1")      # restored after
    with ServeDriver(str(tmp_path / "dem"), buckets=(1, 4)) as drv:
        drv.register("m0", tl, width=4)
        drv.warm()
        key0 = drv.cache.key(tl, 4)
        real = drv.sup.call
        state = {"raised": 0}

        def flaky(thunk, **kw):
            if not state["raised"]:
                state["raised"] = 1
                raise PlatformDemotion("mega", "classic", "serve.dispatch")
            return real(thunk, **kw)

        monkeypatch.setattr(drv.sup, "call", flaky)
        jobs = jobs_of(tl, [2, 3])
        rids = [drv.submit(t, "m0", th) for t, th in jobs]
        troutes.reset_counts()
        s = drv.run()
        key1 = drv.cache.key(tl, 4)
    assert state["raised"] and os.environ["EWT_PALLAS_MEGA"] == "0"
    assert key1 != key0 and key1[1:] == key0[1:]
    assert s["requests_done"] == 2 and s["dropped_requests"] == 0
    # after the warm-up, only the classic chain ran: the solve kernel's
    # route disabled, the preconditioner's taken
    assert troutes.ROUTES[("mega_solve", "disabled")] > 0
    assert not troutes.ROUTES.get(("mega_solve", "plain-cpu"))
    assert troutes.ROUTES[("chol_precond", "plain-cpu")] > 0
    for rid, (_, th) in zip(rids, jobs):
        np.testing.assert_allclose(drv.results[rid],
                                   tl.loglike_batch(th).numpy(),
                                   rtol=1e-6, atol=1e-6)
    evs = [json.loads(ln) for ln in open(tmp_path / "dem" / "events.jsonl")]
    disp = [e for e in evs if e["type"] == "serve_stage"
            and e["stage"] == "dispatch"]
    assert disp[0]["demotion"] == "classic" and disp[1]["attempt"] == 1


def test_last_rung_exits_75_requeues_checkpoints_and_resumes(
        prfile, tmp_path, monkeypatch, capsys):
    """The bottom rung through the CLI: the second dispatch demotes past
    the last in-process rung, the unfinished queue (a spilled request
    included) is requeued and checkpointed, the CLI exits 75, and
    ``--resume`` drains the restored queue."""
    real = BlockSupervisor.call
    state = {"n": 0}

    def flaky(self, thunk, **kw):
        state["n"] += 1
        if state["n"] == 2:
            raise PlatformDemotion("classic", None, "serve.dispatch")
        return real(self, thunk, **kw)

    monkeypatch.setattr(BlockSupervisor, "call", flaky)
    root = tmp_path / "root"
    argv = ["serve", "-p", prfile, "-o", str(root), "--synthetic", "6",
            "--tenants", "2", "--buckets", "1,4", "--max-theta", "5",
            "--seed", "2"]
    assert cli.main(argv, device="cpu") == 75
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["demoted"] == "restart" and out["root"] == str(root)
    assert os.path.exists(root / "state.npz")
    with np.load(root / "state.npz") as z:
        n_ckpt = len(z["rids"])
    assert n_ckpt >= 1
    evs = [json.loads(ln) for ln in open(root / "events.jsonl")]
    assert {e["request_id"] for e in evs if e["type"] == "serve_requeue"}
    monkeypatch.setattr(BlockSupervisor, "call", real)
    assert cli.main(argv + ["--resume"], device="cpu") == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["restored_requests"] == n_ckpt == s["requests_done"]
    assert s["accounting"]["balanced"]
    assert not os.path.exists(root / "state.npz")


def test_compile_cache_relocates_the_build(tmp_path, monkeypatch):
    """``EWT_COMPILE_CACHE`` moves the kernel build directory; a library
    already built there is found (cache verdict ``True``, no ``nvcc``);
    ``enable_compilation_cache(dir)`` pins a directory for the process
    and ``arm_env`` hands the choice to child processes."""
    from enterprise_warp_tpu_torch.ops import cuda_lib
    monkeypatch.setattr(compilecache, "_PINNED", [None])
    monkeypatch.delenv("EWT_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("EWT_COMPILE_CACHE", raising=False)
    assert compilecache.build_dir() == compilecache.DEFAULT_DIR
    cache = tmp_path / "cache"
    monkeypatch.setenv("EWT_COMPILE_CACHE", str(cache))
    assert compilecache.build_dir() == cache
    assert compilecache.arm_env() == str(cache)
    src = cuda_lib.CSRC / "megakernel.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        cuda_lib.NVCC_FLAGS).encode()).hexdigest()
    cache.mkdir()
    lib = cache / f"libmegakernel_{digest[:16]}.so"
    lib.write_bytes(b"")
    monkeypatch.setitem(cuda_lib.BUILD_VERDICTS, "megakernel", None)
    assert cuda_lib.build("megakernel") == lib
    assert cuda_lib.BUILD_VERDICTS["megakernel"] is True
    pinned = tmp_path / "pinned"
    assert compilecache.enable_compilation_cache(pinned) == str(pinned)
    assert compilecache.build_dir() == pinned


def test_no_compile_cache_builds_into_a_fresh_directory(tmp_path):
    """``EWT_NO_COMPILE_CACHE=1``: the build directory is a fresh empty
    directory under ``TMPDIR``, the same for the whole process, no
    ``EWT_COMPILE_CACHE`` is armed for children, and the directory is
    gone when the process exits."""
    code = (
        "import os\n"
        "from enterprise_warp_tpu_torch.utils import compilecache as c\n"
        "d = c.build_dir()\n"
        "assert d.is_dir() and not any(d.iterdir()), d\n"
        "assert str(c.enable_compilation_cache()) == str(d)\n"
        "assert c.build_dir() == d\n"
        "assert c.arm_env() is None\n"
        "assert 'EWT_COMPILE_CACHE' not in os.environ\n"
        "print(d)\n")
    env = dict(os.environ, EWT_NO_COMPILE_CACHE="1", TMPDIR=str(tmp_path),
               PYTHONPATH=REPO)
    env.pop("EWT_COMPILE_CACHE", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    fresh = proc.stdout.strip().splitlines()[-1]
    assert os.path.dirname(fresh) == str(tmp_path)
    assert os.path.basename(fresh).startswith("ewt_build_")
    assert not os.path.exists(fresh)


def test_eval_protocol_batch_and_single(split_likes):
    """``eval_protocol`` gives the likelihood's own batch evaluation, a
    single-theta evaluation equal bit for bit to a batch of one and to
    the row of a wider batch within its rounding (tensor or numpy
    input), and the empty consts."""
    _, tl = split_likes
    batch_fn, single_fn, consts = eval_protocol(tl)
    theta = np.asarray(tl.sample_prior(np.random.default_rng(3), 3))
    lnl = batch_fn(torch.as_tensor(theta))
    assert consts == () and lnl.shape == (3,)
    one = float(batch_fn(torch.as_tensor(theta[1:2]))[0])
    assert float(single_fn(theta[1])) == one
    assert float(single_fn(torch.as_tensor(theta[1]))) == one
    assert abs(one - float(lnl[1])) <= 1e-12 * abs(one)


@pytest.mark.parametrize("seed", [0, 2])
def test_split_prior_draws_finite_like_reference(split_likes, seed):
    """The split likelihood at every prior draw of a seeded 24-request
    synthetic trace is finite in both packages (rows 13 and 15 of seed 0
    and 78 of seed 2 were -inf in the port while the factorizations read
    the lower triangle of an asymmetric Schur complement)."""
    jl, tl = split_likes
    trace = synthetic_trace({"0": tl}, 24, tenants=4, max_theta=6,
                            seed=seed)
    theta = np.concatenate([e["thetas"] for e in trace])
    lt = tl.loglike_batch(torch.as_tensor(theta)).numpy()
    lj = np.asarray(jl.loglike_batch(theta))
    assert np.isfinite(lj).all()
    assert np.isfinite(lt).all(), np.nonzero(~np.isfinite(lt))[0]
