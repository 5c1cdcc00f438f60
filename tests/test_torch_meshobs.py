"""The mesh half of the device diagnostics plane, against the JAX
package's (``tests/test_meshobs.py``): ``MeshStatsLedger``'s folds and
snapshot beside the reference's on the same tables, ``mesh_enabled``'s
switches, ``write_mesh_stats``' per-process paths, a PT run over the
sharded joint likelihood (the ``mesh_stats`` event, sidecar and heartbeat
keys, the chain bit for bit the same with telemetry off, the report's
mesh section), and a secondary process's own event stream.
"""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from enterprise_warp_tpu.utils import devicemetrics as jdm
from enterprise_warp_tpu_torch.models import StandardModels as TSM
from enterprise_warp_tpu_torch.models import TermList as TTL
from enterprise_warp_tpu_torch.parallel import build_pta_likelihood as t_build
from enterprise_warp_tpu_torch.parallel import distributed
from enterprise_warp_tpu_torch.parallel.distributed import ShardLayout
from enterprise_warp_tpu_torch.sim import make_fake_pta as t_fake
from enterprise_warp_tpu_torch.utils import devicemetrics as dm
from enterprise_warp_tpu_torch.utils import telemetry

from test_torch_distributed import _pta, _terms

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ewt_{name}_cli_torch_mesh", str(REPO / "tools" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layout(nshard=4, f12=None, f3=100.0, payload=10, procs=None):
    return {"nshard": nshard, "attr_width": 4,
            "shard_psrs": [2] * nshard, "shard_toas": [50] * nshard,
            "shard_process": procs or [0] * nshard,
            "flops_stage12_per_shard": f12 or [1000.0] * nshard,
            "flops_stage3": f3, "psum_payload_bytes": payload,
            "cost_basis": "static_cost_model"}


# ------------------------------------------------------------------ #
#  MeshStatsLedger                                                    #
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("work", [[1.0] * 4, [3.0, 1.0, 1.0, 1.0],
                                  [0.0] * 4])
def test_skew_math(work):
    w = np.asarray(work)
    assert dm.MeshStatsLedger._skew(w) == jdm.MeshStatsLedger._skew(w)
    assert dm.MeshStatsLedger._skew(w) == {1.0: 1.0, 3.0: 2.0, 0.0: 1.0}[
        work[0]]


def test_model_fractions_and_skew_from_geometry():
    lay = _layout(f12=[800.0, 400.0, 400.0, 400.0], f3=100.0, payload=10)
    led, ref = dm.MeshStatsLedger(lay), jdm.MeshStatsLedger(lay)
    c_coll = 10 * led.coll_flop_per_byte
    crit = 800.0 + 100.0 + c_coll
    assert led.frac_coll == pytest.approx(c_coll / crit)
    assert led.frac_stage3 == pytest.approx(100.0 / crit)
    assert led.frac_local == pytest.approx(800.0 / crit)
    assert led.model_skew == pytest.approx(800.0 / 500.0)
    for k in ("frac_coll", "frac_stage3", "frac_local", "model_skew"):
        assert getattr(led, k) == getattr(ref, k)


def test_coll_flop_per_byte_env_override(monkeypatch):
    monkeypatch.setenv("EWT_MESH_COLL_FPB", "64.0")
    assert dm.MeshStatsLedger(_layout()).coll_flop_per_byte == 64.0
    assert dm.DEFAULT_COLL_FLOP_PER_BYTE == jdm.DEFAULT_COLL_FLOP_PER_BYTE


def test_fold_accumulates_and_tracks_the_straggler():
    lay = _layout(procs=[0, 0, 1, 1])
    led, ref = dm.MeshStatsLedger(lay), jdm.MeshStatsLedger(lay)
    attr = np.zeros((4, 4))
    attr[:, 0] = 10.0
    attr[:, 1] = [100.0, 100.0, 300.0, 100.0]
    g = led.fold(attr, wall_s=2.0)
    assert g == ref.fold(attr, wall_s=2.0)
    assert g["shard_skew"] == pytest.approx(2.0)
    assert (g["straggler_index"], g["straggler_host"]) == (2, 1)
    led.fold(attr, wall_s=1.0)
    ref.fold(attr, wall_s=1.0)
    snap = led.snapshot()
    assert snap == ref.snapshot()
    assert snap["blocks"] == 2 and snap["shard_evals"] == [20.0] * 4
    assert snap["straggler_hits"] == [0, 0, 2, 0]
    assert (snap["collective_wall_ms"] + snap["stage3_wall_ms"]
            + snap["local_wall_ms"]) == pytest.approx(snap["wall_ms"])


def test_mesh_enabled_gating(monkeypatch):
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    monkeypatch.delenv("EWT_MESH_STATS", raising=False)
    assert dm.mesh_enabled()
    monkeypatch.setenv("EWT_MESH_STATS", "0")
    assert not dm.mesh_enabled()
    monkeypatch.delenv("EWT_MESH_STATS")
    monkeypatch.setenv("EWT_TELEMETRY", "0")
    assert not dm.mesh_enabled()


def test_write_mesh_stats_per_process_paths(tmp_path, monkeypatch):
    p = dm.write_mesh_stats(str(tmp_path), {"blocks": 1})
    assert os.path.basename(p) == "mesh_stats.json"
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    p1 = dm.write_mesh_stats(str(tmp_path), {"blocks": 2})
    assert os.path.basename(p1) == "mesh_stats.1.json"
    assert json.load(open(tmp_path / "mesh_stats.json")) == {"blocks": 1}
    assert json.load(open(tmp_path / "mesh_stats.1.json")) == {"blocks": 2}


# ------------------------------------------------------------------ #
#  PT over the sharded joint likelihood                               #
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def pt_mesh_runs(tmp_path_factory):
    """A PT run over a one-shard sharded likelihood with telemetry on
    and one with ``EWT_TELEMETRY=0``."""
    from enterprise_warp_tpu_torch.samplers import PTSampler
    tp = _pta(t_fake, 6)
    like = t_build(tp, _terms(TSM, TTL, tp), device="cpu",
                   mesh=ShardLayout(1))

    def run(outdir, tel):
        old = {k: os.environ.get(k) for k in ("EWT_TELEMETRY",
                                             "EWT_KERNEL_HEALTH")}
        os.environ["EWT_TELEMETRY"] = tel
        os.environ["EWT_KERNEL_HEALTH"] = "0"
        telemetry.registry().reset()
        try:
            s = PTSampler(like, outdir, ntemps=2, nchains=2, seed=7,
                          cov_update=40)
            s.sample(120, resume=False, verbose=False)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            telemetry.registry().reset()
        return s, np.loadtxt(os.path.join(outdir, "chain_1.txt"))

    root = tmp_path_factory.mktemp("pt_mesh")
    s_on, chain_on = run(str(root / "on"), "1")
    s_off, chain_off = run(str(root / "off"), "0")
    return root, s_on, chain_on, s_off, chain_off


def test_plane_leaves_the_chain_bit_equal(pt_mesh_runs):
    _, s_on, chain_on, s_off, chain_off = pt_mesh_runs
    assert s_on.mesh_stats is not None and s_off.mesh_stats is None
    np.testing.assert_array_equal(chain_on, chain_off)


def test_mesh_stats_event_sidecar_and_report(pt_mesh_runs):
    root = pt_mesh_runs[0]
    events = [json.loads(ln) for ln in open(root / "on" / "events.jsonl")]
    ms = [e for e in events if e["type"] == "mesh_stats"]
    assert len(ms) == 3 and ms[-1]["blocks"] == 3
    last = ms[-1]
    assert last["nshard"] == 1 and last["cost_basis"] == "static_cost_model"
    # one evaluation per walker and step, the shard's TOAs each time
    assert last["shard_evals"] == [4.0 * 120]
    assert last["shard_work"] == [4.0 * 120 * 6 * 28]
    hb = [e for e in events if e["type"] == "heartbeat"]
    assert {"shard_skew", "collective_wall_ms", "straggler_index"} \
        <= set(hb[-1])
    side = json.load(open(root / "on" / "mesh_stats.json"))
    assert side["blocks"] == last["blocks"]
    assert not (root / "off" / "events.jsonl").exists()
    assert not (root / "off" / "mesh_stats.json").exists()
    assert telemetry.check_stream(str(root / "on" / "events.jsonl"))[0] == 0
    report = _load_tool("report")
    evs, dropped = report.load_events(str(root / "on" / "events.jsonl"))
    mesh = report.build_report(evs, dropped)["mesh"]
    assert mesh["nshard"] == 1
    assert mesh["cost_basis"] == "static_cost_model"


def test_secondary_writes_its_own_stream_only(tmp_path, monkeypatch):
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    telemetry.registry().reset()
    with telemetry.run_scope(str(tmp_path), sampler="pt"):
        rec = telemetry.active_recorder()
        assert (rec.process_index, rec.process_count) == (1, 2)
        rec.event("mesh_stats", blocks=1)
        rec.heartbeat(step=1)
    telemetry.registry().reset()
    assert sorted(os.listdir(tmp_path)) == ["events.1.jsonl"]
    ev = [json.loads(ln) for ln in open(tmp_path / "events.1.jsonl")]
    start = [e for e in ev if e["type"] == "run_start"]
    assert start and start[0]["process_index"] == 1 \
        and start[0]["process_count"] == 2
    assert [e["process_index"] for e in ev if e["type"] == "heartbeat"] \
        == [1]
    # the report stitches the secondary's stream by its name
    report = _load_tool("report")
    assert report._stream_process_index(
        str(tmp_path / "events.1.jsonl"), []) == 1


def test_identity_never_raises(monkeypatch):
    def broken():
        raise RuntimeError("no group")

    monkeypatch.setattr(distributed, "process_index", broken)
    assert telemetry._host_identity() == (0, 1)
    assert telemetry._is_primary()
