"""The pulsar axis across processes: ``parallel/distributed.py``, the joint
likelihood's one-collective sharded path and the single-writer rule,
against the JAX package's (``tests/test_distributed.py``).

- the process group: a single process is a no-op, the contract needs all
  three variables, ``init_process_group`` is called with it, and the
  identity is read from the environment before the group is joined;
- the helpers and the writers: ``primary_only``, ``make_mesh``'s width,
  ``scatter_to_global`` under a sum, and a secondary process's PT, nested
  and ``nfreqs`` writers writing nothing;
- in one process, every shard's body summed by hand (1, 2, 3 and 8
  shards, uneven ones included) against the unsharded port and the
  reference's own 8-way sharded likelihood, health words included, and
  exactly one ``all_reduce`` and no ``all_gather`` per evaluation;
- real gloo processes on the CPU, meeting through a ``file://`` store
  under ``tmp_path``, each killed at its own timeout: the sharded lnL and
  gradient on both ranks with a PT and an HMC run of the joint model
  (rank 0 writes, rank 1 streams only its own events, equal state
  digests), ``sample_to_convergence`` continued and resumed over two
  ranks (equal states at every check), the CLI with ``psr_shard: 1`` on
  ``gwb_array.dat`` and with ``chain_shard: 1`` on ``system_noise.dat``.
"""

import json
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (float64 on: the reference's package import)
import jax.numpy as jnp

from enterprise_warp_tpu.models import StandardModels as JSM
from enterprise_warp_tpu.models import TermList as JTL
from enterprise_warp_tpu.parallel import build_pta_likelihood as j_build
from enterprise_warp_tpu.parallel import make_mesh as j_make_mesh
from enterprise_warp_tpu.sim.noise import make_fake_pta as j_fake
from enterprise_warp_tpu_torch.models import StandardModels as TSM
from enterprise_warp_tpu_torch.models import TermList as TTL
from enterprise_warp_tpu_torch.parallel import build_pta_likelihood as t_build
from enterprise_warp_tpu_torch.parallel import distributed
from enterprise_warp_tpu_torch.parallel.distributed import (COLLECTIVES,
                                                            ShardLayout)
from enterprise_warp_tpu_torch.sim import make_fake_pta as t_fake

from test_torch_cli import _paramfile
from test_torch_pta import _in_class
from test_torch_ptmcmc import GaussianLike

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMODES = 2
CONTRACT = ("EWT_COORDINATOR", "EWT_NUM_PROCESSES", "EWT_PROCESS_ID")


@pytest.fixture(autouse=True)
def _one_process(monkeypatch):
    """No launcher contract and no group, the kernels not opted out."""
    for k in CONTRACT + ("EWT_PALLAS", "EWT_PALLAS_MEGA"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(distributed, "_INITIALIZED", False)
    monkeypatch.setattr(distributed, "_LOCAL_RANK", None)


@pytest.fixture
def as_secondary(monkeypatch):
    """Pretend to be process 1 of 2."""
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)


def _pta(fake, npsr, ntoa=28, seed=3):
    psrs = fake(npsr=npsr, ntoa=ntoa, seed=seed)
    rng = np.random.default_rng(seed)
    for p in psrs:
        p.residuals = p.toaerrs * rng.standard_normal(len(p))
    return psrs


def _terms(SM, TL, psrs):
    out = []
    for p in psrs:
        m = SM(psr=p)
        out.append(TL(p, [m.efac("by_backend"),
                          m.spin_noise(f"powerlaw_{NMODES}_nfreqs"),
                          m.gwb(f"hd_vary_gamma_{NMODES}_nfreqs")]))
    return out


def _theta_for(names):
    return np.array([1.1 if n.endswith("efac") else -13.2 if "log10_A" in n
                     else 3.9 if "gamma" in n else 0.5 for n in names])


def _sharded_sum(like, theta, with_health=False):
    """Every shard's body at ``theta`` summed by hand, then stage 3:
    ``(lnl, health words)``."""
    st = like._stages
    packed = sum(st["shard_packed"](theta, s, with_health)
                 for s in range(st["nshard"]))
    sst, rwr, ldn, lphi, hw, _ = st["unpack"](packed, with_health)
    return st["stage3"](theta, sst, rwr, ldn, lphi), hw


# ------------------------------------------------------------------ #
#  the process group                                                  #
# ------------------------------------------------------------------ #

def test_single_process_is_a_noop():
    assert distributed.init_distributed(device="cpu") == (0, 1)
    assert distributed.is_primary()
    assert distributed.device_stamp() == dict(
        platform="cpu", process_count=1, process_index=0,
        local_device_count=0)


def test_env_contract_requires_all_three(monkeypatch):
    import torch.distributed as dist

    def refuse(**kw):
        raise AssertionError("init_process_group called")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    for present in ((0,), (0, 1), (1, 2)):
        for i, k in enumerate(CONTRACT):
            if i in present:
                monkeypatch.setenv(k, ["host0:1234", "2", "0"][i])
            else:
                monkeypatch.delenv(k, raising=False)
        assert distributed.init_distributed(device="cpu")[1] in (1, 2)
        assert not distributed._INITIALIZED


def _fake_group(monkeypatch, peers, rank=2, world=4):
    """``init_process_group`` and the rendezvous replaced: the store an
    in-memory one holding the other ranks' placement ``peers`` ({rank:
    (host, cards)}). Returns the dict the calls are recorded in."""
    import torch.distributed as dist
    calls = {}
    store = dist.HashStore()
    place = dist.PrefixStore("ewt_placement", store)
    for r, hc in peers.items():
        place.set(str(r), json.dumps(list(hc)))

    def rendezvous(url, rank, world_size, timeout):
        calls["url"] = url
        yield store, rank, world_size

    monkeypatch.setattr(dist, "rendezvous", rendezvous)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.update(kw))
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.update(card=i))
    monkeypatch.setattr(distributed, "_LOCAL_RANK", None)
    return calls


def test_init_process_group_called_with_the_contract(monkeypatch):
    calls = _fake_group(monkeypatch, {0: ("h", 0), 1: ("h", 0),
                                      3: ("h", 0)})
    monkeypatch.setenv("EWT_COORDINATOR", "host0:1234")
    monkeypatch.setenv("EWT_NUM_PROCESSES", "4")
    monkeypatch.setenv("EWT_PROCESS_ID", "2")
    assert distributed.init_distributed(device="cpu") == (2, 4)
    assert calls["url"] == "tcp://host0:1234"
    assert (calls["backend"], calls["world_size"], calls["rank"]) \
        == ("gloo", 4, 2)
    assert calls["store"] is not None and "card" not in calls
    assert not distributed.is_primary()
    # keyword arguments override the environment; a store URL is kept
    monkeypatch.setattr(distributed, "_INITIALIZED", False)
    distributed.init_distributed("file:///x/store", 4, 2, device="cpu")
    assert calls["url"] == "file:///x/store"


def test_identity_from_env_before_the_group(monkeypatch):
    monkeypatch.setenv("EWT_PROCESS_ID", "3")
    monkeypatch.setenv("EWT_NUM_PROCESSES", "4")
    assert (distributed.process_index(), distributed.process_count()) \
        == (3, 4)
    assert not distributed.is_primary()
    monkeypatch.setenv("EWT_PROCESS_ID", "x")
    assert distributed.process_index() == 0


def test_backend_follows_the_placement(monkeypatch):
    place = distributed._placement
    assert place([("a", 0), ("a", 0)], 1) == ("gloo", 1)
    assert place([("a", 1)], 0) == ("nccl", 0)
    # two ranks sharing one card
    assert place([("a", 1), ("a", 1)], 0) == ("gloo", 0)
    assert place([("a", 4)] * 4, 3) == ("nccl", 3)
    # two hosts of four cards, world 8: NCCL, each rank on its host's
    # card by its local index, however the ranks are numbered
    two = [("a", 4), ("b", 4)] * 4
    assert [place(two, r) for r in range(8)] == \
        [("nccl", r // 2) for r in range(8)]
    # one host short of cards: every rank takes gloo, the group forms
    short = [("a", 4)] * 4 + [("b", 2)] * 4
    assert {place(short, r)[0] for r in range(8)} == {"gloo"}
    assert place([("a", 4)] * 3 + [("b", 0)], 0)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed._visible_cards("cuda") == 4
    assert distributed._visible_cards("cpu") == 0


def test_two_host_layout_picks_nccl_and_the_local_card(monkeypatch):
    """Rank 5 of two hosts with four cards each, the ranks numbered
    across the hosts: NCCL, and the card its index on its host."""
    monkeypatch.setattr(socket, "gethostname", lambda: "b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    peers = {r: ("a" if r % 2 == 0 else "b", 4) for r in range(8) if r != 5}
    calls = _fake_group(monkeypatch, peers, rank=5, world=8)
    assert distributed.init_distributed("h0:1", 8, 5) == (5, 8)
    assert calls["backend"] == "nccl" and calls["card"] == 2
    assert distributed._rank_device() == torch.device("cuda:2")


# ------------------------------------------------------------------ #
#  helpers and the single-writer rule                                 #
# ------------------------------------------------------------------ #

def test_primary_only(as_secondary):
    calls = []

    @distributed.primary_only
    def artifact(x):
        calls.append(x)
        return x

    @distributed.primary_only(telemetry_ok=True)
    def stream(x):
        return 2 * x

    assert artifact(1) is None and calls == []
    assert stream(3) == 6


def test_primary_only_passes_through_on_the_primary():
    assert distributed.primary_only(lambda x: x * 2)(3) == 6


def test_make_mesh_clamps_to_the_pulsar_count(monkeypatch):
    monkeypatch.setenv("EWT_NUM_PROCESSES", "4")
    monkeypatch.setenv("EWT_PROCESS_ID", "1")
    assert distributed.make_mesh(3, device="cpu").nshard == 3
    m = distributed.make_mesh(100, device="cpu")
    assert (m.nshard, m.rank, m.axis, m.device.type) == (4, 1, "psr", "cpu")
    assert distributed.make_mesh(100, width=2, device="cpu").nshard == 2
    # contiguous, uneven, no padding
    lay = ShardLayout(2)
    assert lay.ranges(45) == [(0, 23), (23, 45)]
    assert ShardLayout(3).ranges(8) == [(0, 3), (3, 6), (6, 8)]
    assert ShardLayout(8).ranges(3) == [(0, 1), (1, 2), (2, 3)]
    stamp = distributed.device_stamp(m)
    assert stamp["mesh_devices"] == 4 and stamp["mesh_axes"] == {"psr": 4}


def test_chain_slice_and_host_pull():
    from enterprise_warp_tpu_torch.samplers.devicestate import (chain_slice,
                                                                host_pull)
    assert chain_slice(None, 8) is None
    assert chain_slice(ShardLayout(2, rank=1, axis="psr"), 8) is None
    assert chain_slice(ShardLayout(2, rank=1, axis="chain"), 8) \
        == slice(4, 8)
    with pytest.raises(ValueError, match="divisible"):
        chain_slice(ShardLayout(3, axis="chain"), 8)
    t = torch.arange(4.0)
    a = host_pull(t)
    t += 1.0                        # the copy owns its memory
    np.testing.assert_array_equal(a, [0.0, 1.0, 2.0, 3.0])


def test_scatter_to_global_rebuilds_under_a_sum():
    x = torch.arange(2 * 8 * 3, dtype=torch.float64).reshape(2, 8, 3)
    parts = [distributed.scatter_to_global(x[:, lo:hi], 8, lo, dim=1)
             for lo, hi in ShardLayout(3).ranges(8)]
    assert all(p.shape == x.shape for p in parts)
    torch.testing.assert_close(sum(parts), x, rtol=0, atol=0)


def test_pt_secondary_writes_nothing(tmp_path, as_secondary, monkeypatch):
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    from enterprise_warp_tpu_torch.samplers import PTSampler
    s = PTSampler(GaussianLike([0.0], [1.0]), str(tmp_path), ntemps=1,
                  nchains=4, seed=0, cov_update=100)
    st = s.sample(200, resume=False, verbose=False)
    assert st.step == 200
    # the secondary streams its own telemetry, and nothing else
    assert sorted(p.name for p in tmp_path.iterdir()) == ["events.1.jsonl"]


def test_pt_primary_writes(tmp_path):
    from enterprise_warp_tpu_torch.samplers import PTSampler
    s = PTSampler(GaussianLike([0.0], [1.0]), str(tmp_path), ntemps=1,
                  nchains=4, seed=0, cov_update=100)
    s.sample(200, resume=False, verbose=False)
    for f in ("chain_1.txt", "pars.txt", "cov.npy", "state.npz",
              "events.jsonl"):
        assert (tmp_path / f).exists()


def test_nested_secondary_writes_no_artifact(tmp_path, as_secondary,
                                             monkeypatch):
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    from enterprise_warp_tpu_torch.samplers import run_nested
    r = run_nested(GaussianLike([0.0], [0.5]), outdir=str(tmp_path),
                   nlive=60, kbatch=20, nsteps=4, dlogz=0.5, seed=0,
                   verbose=False, label="r")
    assert np.isfinite(r["log_evidence"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["events.1.jsonl"]


def test_nfreqs_and_pars_secondary_writes_nothing(tmp_path, as_secondary):
    from enterprise_warp_tpu_torch.config import Params
    from enterprise_warp_tpu_torch.models.assemble import \
        init_model_likelihoods
    params = Params(_paramfile(tmp_path, 40), init_pulsars=False)
    params.init_pulsars()
    params.clone_all_params_to_models()
    os.makedirs(params.output_dir, exist_ok=True)
    init_model_likelihoods(params, device="cpu")
    assert os.listdir(params.output_dir) == []


# ------------------------------------------------------------------ #
#  the sharded path in one process                                    #
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def arrays():
    """The reference's 8-pulsar fixture in both packages, the unsharded
    port in both Gram modes, the reference's 8-way sharded likelihood,
    and a theta."""
    jp, tp = _pta(j_fake, 8), _pta(t_fake, 8)
    like0 = {gm: t_build(tp, _terms(TSM, TTL, tp), gram_mode=gm,
                         joint_mode="schur", device="cpu")
             for gm in ("f64", "split")}
    likeJ = j_build(jp, _terms(JSM, JTL, jp), mesh=j_make_mesh(8))
    assert likeJ._stages["spmd"] and likeJ._stages["nshard"] == 8
    assert like0["f64"].param_names == likeJ.param_names
    theta = _theta_for(likeJ.param_names)
    lJ, hwJ = jax.jit(likeJ._eval_health)(jnp.asarray(theta), likeJ.consts)
    _, gJ = jax.jit(jax.value_and_grad(
        lambda t: likeJ._eval(t, likeJ.consts)))(jnp.asarray(theta))
    return tp, like0, (float(lJ), np.asarray(hwJ), np.asarray(gJ)), theta


@pytest.mark.parametrize("gram_mode", ["f64", "split"])
@pytest.mark.parametrize("nshard", [1, 2, 3, 8])
def test_shard_bodies_summed_equal_the_unsharded_path(arrays, nshard,
                                                      gram_mode):
    tp, like0, likeJ, theta = arrays
    likeS = t_build(tp, _terms(TSM, TTL, tp), gram_mode=gram_mode,
                    joint_mode="schur", device="cpu",
                    mesh=ShardLayout(nshard))
    assert likeS._stages["spmd"] and likeS._stages["nshard"] == nshard
    assert not hasattr(likeS, "param_blocks")        # no evaluation cache
    rng = np.random.default_rng(1)
    th = torch.as_tensor(np.vstack([theta, likeS.sample_prior(rng, 3)]))
    lS, hwS = _sharded_sum(likeS, th, with_health=True)
    l0, hw0 = like0[gram_mode]._eval_health_batch(th)
    if gram_mode == "f64":
        np.testing.assert_allclose(lS.numpy(), l0.numpy(), rtol=1e-9)
    else:
        _in_class(lS.numpy(), l0.numpy())
    torch.testing.assert_close(hwS, hw0.to(torch.float64), rtol=0,
                               atol=1e-12)
    # against the reference's own 8-way sharded likelihood (its health
    # twin's lnL and flags; its condition lane reads its split Gram)
    lJ, hwJ, _ = likeJ
    _in_class(lS[:1].numpy(), [lJ])
    np.testing.assert_array_equal(hwS[0, :, :2].numpy(), hwJ[:, :2])


@pytest.mark.parametrize("gram_mode", ["f64", "split"])
def test_sharded_gradient_matches_unsharded_and_reference(arrays, gram_mode):
    """The gradient through every shard's body summed by hand (8 shards):
    the unsharded port's within 1e-9 relative in float64 (1e-6 in split
    mode), the reference's 8-way sharded gradient within the gradient
    class, 1e-3 max(1, |g|)."""
    tp, like0, likeJ, theta = arrays
    likeS = t_build(tp, _terms(TSM, TTL, tp), gram_mode=gram_mode,
                    joint_mode="schur", device="cpu", mesh=ShardLayout(8))

    def grad(fn):
        th = torch.as_tensor(theta[None]).requires_grad_(True)
        g, = torch.autograd.grad(fn(th).sum(), th)
        return g[0].numpy()

    gS = grad(lambda th: _sharded_sum(likeS, th)[0])
    g0 = grad(like0[gram_mode].loglike_batch)
    scale = np.maximum(1.0, np.abs(g0))
    assert np.max(np.abs(gS - g0) / scale) \
        <= (1e-9 if gram_mode == "f64" else 1e-6)
    gJ = likeJ[2]
    assert np.max(np.abs(gS - gJ) / np.maximum(1.0, np.abs(gJ))) <= 1e-3


def test_one_collective_per_evaluation_and_lane_totals(arrays):
    tp, like0, _, theta = arrays
    likeS = t_build(tp, _terms(TSM, TTL, tp), gram_mode="f64",
                    joint_mode="schur", device="cpu", mesh=ShardLayout(1))
    th = torch.as_tensor(np.vstack([theta, theta]))
    for fn in (likeS.loglike_batch, likeS._eval_health_batch,
               likeS._eval_mesh_batch):
        COLLECTIVES.clear()
        out = fn(th)
        assert dict(COLLECTIVES) == {"all_reduce": 1}, fn
        lnl = out[0] if isinstance(out, tuple) else out
        np.testing.assert_allclose(lnl.numpy(),
                                   like0["f64"].loglike_batch(th).numpy(),
                                   rtol=1e-9)
    # the attribution lanes of a 3-shard layout: one evaluation per shard
    # and walker, each shard's active TOAs, as the layout says
    likeM = t_build(tp, _terms(TSM, TTL, tp), gram_mode="f64",
                    joint_mode="schur", device="cpu", mesh=ShardLayout(3))
    st, lay = likeM._stages, likeM.mesh_layout
    packed = sum(st["shard_packed"](th, s, True, True) for s in range(3))
    attr = st["unpack"](packed, True, True)[5].sum(dim=0).numpy()
    assert attr.shape == (lay["nshard"], lay["attr_width"]) == (3, 4)
    np.testing.assert_array_equal(attr[:, 0], [2.0] * 3)
    np.testing.assert_array_equal(attr[:, 1], 2.0 * np.asarray(
        lay["shard_toas"], dtype=float))
    assert lay["shard_psrs"] == [3, 3, 2] and sum(lay["shard_toas"]) \
        == sum(len(p) for p in tp)
    assert lay["cost_basis"] == "static_cost_model"
    assert lay["psum_payload_bytes"] == 8 * packed.shape[1]


def test_a_rank_past_the_last_shard_adds_zeros(arrays):
    """``psr_shard: 2`` over three ranks: rank 2 holds no pulsar, adds a
    zero vector to the sum and still joins the gradient's sum."""
    tp, _, _, theta = arrays
    like = t_build(tp, _terms(TSM, TTL, tp), gram_mode="f64",
                   joint_mode="schur", device="cpu",
                   mesh=ShardLayout(2, rank=2))
    st = like._stages
    th = torch.as_tensor(theta[None]).requires_grad_(True)
    COLLECTIVES.clear()
    lnl = like.loglike_batch(th)
    g, = torch.autograd.grad(lnl.sum(), th)
    assert dict(COLLECTIVES) == {"all_reduce": 1, "all_reduce_grad": 1}
    zero = torch.zeros_like(st["shard_packed"](th.detach(), 0))
    sst, rwr, ldn, lphi, _, _ = st["unpack"](zero, False)
    want = st["stage3"](th.detach(), sst, rwr, ldn, lphi)
    torch.testing.assert_close(lnl.detach(), want)
    assert torch.isfinite(g).all()


def test_dynamic_basis_and_dense_mode_stay_unsharded(arrays, capsys,
                                                     caplog):
    tp, *_ = arrays
    with caplog.at_level(logging.INFO, logger="ewt.pta"):
        like = t_build(tp, _terms(TSM, TTL, tp), gram_mode="f64",
                       joint_mode="dense", device="cpu", mesh=ShardLayout(2))
    assert not like._stages["spmd"] and like.mesh is None
    # the note is the library's log record; stdout stays the CLI's
    assert "keeps the unsharded joint likelihood" in caplog.text
    assert "keeps the unsharded" not in capsys.readouterr().out
    # a chain-axis layout is not the likelihood's
    like = t_build(tp, _terms(TSM, TTL, tp), device="cpu",
                   mesh=ShardLayout(2, axis="chain"))
    assert not like._stages["spmd"]


# ------------------------------------------------------------------ #
#  real gloo processes on the CPU                                     #
# ------------------------------------------------------------------ #

def _launch(tmp_path, script, args=(), nproc=2, timeout=180):
    """Run ``script`` in ``nproc`` processes under the EWT_* contract (a
    ``file://`` store under ``tmp_path``); every process is killed at the
    timeout. Returns each rank's stdout."""
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               EWT_COORDINATOR=f"file://{store}",
               EWT_NUM_PROCESSES=str(nproc), EWT_DIST_TIMEOUT_S="150")
    env.pop("EWT_PALLAS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *map(str, args)],
        env=dict(env, EWT_PROCESS_ID=str(i)), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a rank timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _lines(outs, tag):
    """``{rank: json}`` of every rank's ``tag {json}`` line."""
    got = {}
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith(tag + " "):
                rec = json.loads(ln[len(tag) + 1:])
                got[rec["rank"]] = rec
    return got


_PREAMBLE = r'''
import hashlib, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from enterprise_warp_tpu_torch.parallel import distributed
rank, world = distributed.init_distributed(device="cpu")
assert world == 2 and distributed._INITIALIZED


def digest(*arrs):
    h = hashlib.sha256()
    for a in arrs:
        h.update(np.ascontiguousarray(
            torch.as_tensor(a).detach().cpu().numpy()).tobytes())
    return h.hexdigest()
'''

_JOINT = _PREAMBLE + r'''
from enterprise_warp_tpu_torch.models import StandardModels, TermList
from enterprise_warp_tpu_torch.parallel import build_pta_likelihood, make_mesh
from enterprise_warp_tpu_torch.samplers import PTSampler
from enterprise_warp_tpu_torch.samplers.hmc import HMCSampler
from enterprise_warp_tpu_torch.sim import make_fake_pta
psrs = make_fake_pta(npsr=5, ntoa=28, seed=5)
rng = np.random.default_rng(5)
for p in psrs:
    p.residuals = p.toaerrs * rng.standard_normal(len(p))
tls = []
for p in psrs:
    m = StandardModels(psr=p)
    tls.append(TermList(p, [m.efac("by_backend"),
                            m.spin_noise("powerlaw_2_nfreqs"),
                            m.gwb("hd_vary_gamma_2_nfreqs")]))
mesh = make_mesh(len(psrs), device="cpu")
likeS = build_pta_likelihood(psrs, tls, gram_mode="f64", joint_mode="schur",
                             device="cpu", mesh=mesh)
like0 = build_pta_likelihood(psrs, tls, gram_mode="f64", joint_mode="schur",
                             device="cpu")
th0 = torch.as_tensor(like0.sample_prior(np.random.default_rng(1), 4))


def value_grad(like):
    th = th0.clone().requires_grad_(True)
    lnl = like.loglike_batch(th)
    g, = torch.autograd.grad(lnl.sum(), th)
    return lnl.detach(), g


distributed.reset_collectives()
lS, gS = value_grad(likeS)
coll = dict(distributed.COLLECTIVES)
l0, g0 = value_grad(like0)
out = sys.argv[1]
pt = PTSampler(likeS, os.path.join(out, "pt"), ntemps=1, nchains=4, seed=0,
               cov_update=10)
st = pt.sample(20, resume=False, verbose=False)
hmc = HMCSampler(likeS, os.path.join(out, "hmc"), nchains=4, seed=0,
                 warmup=4, n_leapfrog=3)
sh = hmc.sample(8, resume=False, verbose=False, block_size=4)
print("RANK " + json.dumps(dict(
    rank=rank, nshard=likeS._stages["nshard"], coll=coll,
    ldiff=float((lS - l0).abs().max() / l0.abs().max()),
    gdiff=float(((gS - g0).abs() / g0.abs().clamp(min=1.0)).max()),
    lnl=digest(lS), grad=digest(gS), pt=digest(st.x, st.lnl),
    hmc=digest(sh.z), finite=bool(torch.isfinite(sh.z).all()),
    mesh=pt.mesh_stats is not None,
    health=[led.stats() for led in pt.health or []])))
'''


def test_two_ranks_shard_the_joint_likelihood_and_sample(tmp_path):
    outs = _launch(tmp_path, _JOINT, [tmp_path / "out"])
    got = _lines(outs, "RANK")
    assert set(got) == {0, 1}
    for r in got.values():
        assert r["nshard"] == 2
        # the forward evaluation: one all_reduce, no gather; the
        # backward: one sum of theta's gradient
        assert r["coll"] == {"all_reduce": 1, "all_reduce_grad": 1}
        assert r["ldiff"] < 1e-12 and r["gdiff"] < 1e-9
        assert r["finite"] and r["mesh"]
        # the health plane is armed on the CPU: both ranks folded the
        # words the collective brought, one ledger per pulsar
        assert len(r["health"]) == 5 \
            and all(h["n_evals"] > 0 for h in r["health"])
    for key in ("lnl", "grad", "pt", "hmc", "health"):
        assert got[0][key] == got[1][key], key
    pt, hmc = tmp_path / "out" / "pt", tmp_path / "out" / "hmc"
    for d in (pt, hmc):
        names = set(os.listdir(d))
        assert {"chain_1.txt", "pars.txt", "state.npz", "events.jsonl",
                "events.1.jsonl"} <= names
        assert not any(".1." in n and not n.startswith(("events.",
                                                        "mesh_stats."))
                       for n in names)
    assert {"cov.npy", "mesh_stats.json", "mesh_stats.1.json"} \
        <= set(os.listdir(pt))
    ev1 = [json.loads(ln) for ln in open(pt / "events.1.jsonl")]
    assert ev1[0]["type"] == "run_start" and ev1[0]["process_index"] == 1
    ms = [e for e in ev1 if e["type"] == "mesh_stats"]
    assert ms and ms[-1]["nshard"] == 2
    assert json.load(open(pt / "mesh_stats.json"))["shard_evals"] \
        == json.load(open(pt / "mesh_stats.1.json"))["shard_evals"]


_CONVERGE = _PREAMBLE + r'''
from enterprise_warp_tpu_torch.models import StandardModels, TermList
from enterprise_warp_tpu_torch.parallel import build_pta_likelihood, make_mesh
from enterprise_warp_tpu_torch.samplers import PTSampler, ptmcmc
from enterprise_warp_tpu_torch.samplers.convergence import \
    sample_to_convergence
from enterprise_warp_tpu_torch.sim import make_fake_pta
psrs = make_fake_pta(npsr=3, ntoa=28, seed=5)
rng = np.random.default_rng(5)
for p in psrs:
    p.residuals = p.toaerrs * rng.standard_normal(len(p))
tls = []
for p in psrs:
    m = StandardModels(psr=p)
    tls.append(TermList(p, [m.efac("by_backend"),
                            m.spin_noise("powerlaw_2_nfreqs"),
                            m.gwb("hd_vary_gamma_2_nfreqs")]))
likeS = build_pta_likelihood(psrs, tls, gram_mode="f64", joint_mode="schur",
                             device="cpu", mesh=make_mesh(3, device="cpu"))
states = []
sample = ptmcmc.PTSampler.sample


def traced(self, *a, **k):
    st = sample(self, *a, **k)
    states.append(digest(st.x, st.lnl, st.lnp, st.accepted, st.history)
                  + f"@{int(st.step)}")
    return st


ptmcmc.PTSampler.sample = traced
out = sys.argv[1]
distributed.reset_collectives()
pt = PTSampler(likeS, out, ntemps=1, nchains=4, seed=0, cov_update=10)
# three checks: the second and third continue from the checkpoint
r1 = sample_to_convergence(pt, target_ess=1e9, check_every=10,
                           max_steps=30, block_size=10, verbose=False)
# a fresh sampler resumes the run from its files
pt2 = PTSampler(likeS, out, ntemps=1, nchains=4, seed=0, cov_update=10)
r2 = sample_to_convergence(pt2, target_ess=1e9, check_every=10,
                           max_steps=50, block_size=10, verbose=False,
                           resume=True)
print("RANK " + json.dumps(dict(
    rank=rank, states=states, steps=[r1.steps, r2.steps],
    chains=digest(r2.chains), coll=dict(distributed.COLLECTIVES))))
'''


def test_two_ranks_continue_and_resume_to_convergence(tmp_path):
    """``sample_to_convergence`` over a sharded likelihood: every check
    after the first resumes from the checkpoint, and a second call
    resumes the run from its files. The secondary takes each resume from
    the primary (one broadcast), never from a file the primary may be
    writing, so both ranks hold the same state at every check."""
    outs = _launch(tmp_path, _CONVERGE, [tmp_path / "out"])
    got = _lines(outs, "RANK")
    assert set(got) == {0, 1}
    assert got[0]["steps"] == [30, 50]
    assert [s.rsplit("@", 1)[1] for s in got[0]["states"]] \
        == ["10", "20", "30", "40", "50"]
    for key in ("states", "steps", "chains"):
        assert got[0][key] == got[1][key], key
    for r in got.values():
        # the first call's two resumes, the second call's repair
        # and its two resumes
        assert r["coll"]["broadcast"] == 5
    names = set(os.listdir(tmp_path / "out"))
    assert {"state.npz", "chain_1.txt", "events.1.jsonl"} <= names
    assert np.loadtxt(tmp_path / "out" / "chain_1.txt").shape[0] == 50 * 4


_CLI = _PREAMBLE + r'''
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.samplers import ptmcmc
sample = ptmcmc.PTSampler.sample


def traced(self, *a, **k):
    st = sample(self, *a, **k)
    print("RANK " + json.dumps(dict(
        rank=rank, state=digest(st.x, st.lnl, st.lnp), step=int(st.step),
        split=type(self.like).__name__,
        spmd=bool(getattr(self.like, "_stages", {}).get("spmd")))))
    return st


ptmcmc.PTSampler.sample = traced
distributed.reset_collectives()
rc = cli.main(["--prfile", sys.argv[1], "--num", "0"], device="cpu")
print("DONE " + json.dumps(dict(rank=rank, rc=rc,
                                coll=dict(distributed.COLLECTIVES))))
'''


def _run_dir(tmp_path):
    return [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "out")
            for d in ds if any(os.path.isfile(os.path.join(r, d, f))
                               for f in ("events.jsonl",))]


def test_cli_psr_shard_on_gwb_array(tmp_path):
    prfile = _paramfile(tmp_path, 40, "gwb_array.dat", psr_shard=1)
    outs = _launch(tmp_path, _CLI, [prfile])
    assert "distributed: process 1/2, single-writer=no" in outs[1]
    assert "pulsar-axis sharding: joint likelihood over 2 of 2" in outs[0]
    got, done = _lines(outs, "RANK"), _lines(outs, "DONE")
    assert got[0]["spmd"] and got[1]["spmd"]
    assert got[0]["state"] == got[1]["state"] and got[0]["step"] == 40
    for r in done.values():
        assert r["rc"] == 0 and r["coll"]["all_reduce"] > 40
        assert "all_gather" not in r["coll"]
    (run,) = _run_dir(tmp_path)
    names = set(os.listdir(run))
    assert {"chain_1.txt", "pars.txt", "cov.npy", "events.jsonl",
            "events.1.jsonl", "mesh_stats.json", "mesh_stats.1.json"} \
        <= names
    chain = np.loadtxt(os.path.join(run, "chain_1.txt"))
    assert np.isfinite(chain).all()


def test_cli_chain_shard_with_pt(tmp_path):
    prfile = _paramfile(tmp_path, 40, chain_shard=1)
    outs = _launch(tmp_path, _CLI, [prfile])
    assert "chain-axis sharding: walker evaluations over 2 of 2" in outs[0]
    got, done = _lines(outs, "RANK"), _lines(outs, "DONE")
    assert got[0]["split"] == got[1]["split"] == "_ChainSplit"
    assert got[0]["state"] == got[1]["state"]
    for r in done.values():
        # one gather per evaluation: the start and one per step; the
        # resume decision and the checkpoint read taken from the primary
        assert r["rc"] == 0 \
            and r["coll"] == {"all_gather": 41, "broadcast": 2}
    (run,) = _run_dir(tmp_path)
    names = set(os.listdir(run))
    assert {"chain_1.txt", "pars.txt", "state.npz", "events.1.jsonl"} \
        <= names
    assert not any(n.startswith("mesh_stats") for n in names)
