"""The port's kernel-health plane against the JAX package's, on the CPU.

- the health word of ``ops/kernel.py:_mixed_psd_solve_logdet(...,
  with_health=True)`` on seeded fixtures, fused and unfused branches: a
  three-tier fixture whose walkers end on tiers 1, 2 and 3 (and a walker
  of numerically null rows), and a refinement-divergence fixture
  (an eigenvalue just below zero): the jitter and diverge bits equal the
  reference's and ``logcond`` lies within 1e-12 of it; ``Z`` and the
  logdet are unchanged by the instrumentation;
- the fused branch's two jitter rules agree on the three-tier fixture:
  the kernel's per-walker tier (2 or 3; the plain version reports the
  tier it ended on) and the reference's rule (tier 1's factor fails or
  ``U`` is the identity); on the kernel route (a stand-in launch) the bit
  is the tier's;
- ``_eval_health_batch`` of both packages' J1234-5678 likelihoods
  (``system_noise.dat``) near the injection and at prior draws: float64
  Grams, lnL within 1e-8 and ``logcond`` within 1e-12; split Grams, lnL
  within the split class and ``logcond`` within 1e-6 (the two packages
  sum the float32 products in another order); the bits equal;
  and of a 2-pulsar correlated array's Schur path: lnL in the Schur class,
  each pulsar's stage-1 word's bits equal, ``logcond`` within 1e-6 (the
  port's stage-1 Gram is float64, the reference's split);
- ``with_health`` with an explicit megakernel route raises, as the
  reference's;
- ``HealthLedger`` against the reference's class on seeded update
  sequences: the same actions and statistics;
- a planted ``kernel.health`` fault walks ``observe -> reeval -> classic
  -> quarantine`` through the port's CLI with the reference's
  ``kernel_health`` actions, ``psr_quarantined`` event, exit status 76
  and ``quarantined.json``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.ops.kernel import \
    _mixed_psd_solve_logdet as j_mixed
from enterprise_warp_tpu.resilience import integrity as jint
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.ops import cholfuse as tcf
from enterprise_warp_tpu_torch.ops.kernel import \
    _mixed_psd_solve_logdet as t_mixed
from enterprise_warp_tpu_torch.ops.kernel import marginalized_loglike
from enterprise_warp_tpu_torch.resilience import faults
from enterprise_warp_tpu_torch.resilience import integrity as tint

from test_torch_kernel import _likes, near_truth
from test_torch_telemetry import _events, _paramfile

torch.set_num_threads(2)

LOGCOND_ATOL = 1e-12


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("EWT_PALLAS", "EWT_PALLAS_MEGA"):
        monkeypatch.setenv(k, "1")            # restored after the test
        monkeypatch.delenv(k)
    for k in ("EWT_FAULT_PLAN", "EWT_KERNEL_HEALTH", "EWT_FUSED_CHOL",
              "EWT_HEALTH_JITTER_FRAC", "EWT_HEALTH_LOGCOND_MAX"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EWT_TELEMETRY", "1")
    faults.install_plan(None)
    yield
    faults.install_plan(None)


def three_tier(n=16):
    """Walkers ending on tier 1 (PD), tier 2 (an eigenvalue -1.5e-4 that
    the second jitter lifts), tier 3 (unit diagonal, an eigenvalue of
    -6.5: no jitter helps) and a walker of numerically null rows."""
    rng = np.random.default_rng(13)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(0.5, 1.5, n)
    ev[0] = -5e-5
    S_mid = (Q * ev) @ Q.T
    A = np.random.default_rng(2).standard_normal((n, n))
    S0 = A @ A.T / n + 0.5 * np.eye(n)
    d = np.sqrt(np.diag(S0))
    S0 = S0 / d[:, None] / d[None, :]
    S_bad = 1.5 * np.eye(n) - 0.5 * np.ones((n, n))
    S = np.stack([S0, 3.0 * S_mid, 2.0 * S_bad, -2.0 * np.eye(n)])
    return S, rng.standard_normal((4, n, 3))


def diverging(n=24, seed=5):
    """Systems whose equilibrated casts have one eigenvalue at -3e-7,
    -6e-7 or -1.5e-6 (the jittered factor succeeds, tier 2 for the last,
    but the preconditioned iteration's error grows), and one
    well-conditioned system, behind a 1e4 spread of scales."""
    rng = np.random.default_rng(seed)
    out = []
    for low in (-3e-7, -6e-7, -1.5e-6, 0.5):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = np.linspace(0.5, 1.5, n)
        ev[0] = low
        S = (Q * ev) @ Q.T
        d = np.sqrt(np.diag(S))
        S = S / d[:, None] / d[None, :]
        D = np.logspace(-2, 2, n)
        out.append(S * D[:, None] * D[None, :])
    return np.stack(out), rng.standard_normal((len(out), n, 2))


@pytest.mark.parametrize("fixture", [three_tier, diverging])
@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("refine", [2, 3])
def test_health_word_matches_reference(monkeypatch, fixture, fused, refine):
    monkeypatch.setenv("EWT_FUSED_CHOL", fused)
    S, B = fixture()
    j1, j2 = 1e-6, 1e-3
    Zj, ldj, hj = jax.vmap(lambda s, b: j_mixed(
        s, b, j1, j2, refine=refine, delta_mode="split", mega=False,
        with_health=True))(jnp.asarray(S), jnp.asarray(B))
    St, Bt = torch.as_tensor(S), torch.as_tensor(B)
    Zt, ldt, ht = t_mixed(St, Bt, j1, j2, refine=refine,
                          delta_mode="split", with_health=True)
    hj, ht = np.asarray(hj), ht.numpy()
    np.testing.assert_array_equal(ht[:, :2], hj[:, :2])
    np.testing.assert_allclose(ht[:, 2], hj[:, 2], rtol=0,
                               atol=LOGCOND_ATOL)
    # the instrumentation changes neither output of the chain
    Z0, ld0 = t_mixed(St, Bt, j1, j2, refine=refine, delta_mode="split",
                      mega=False)
    assert torch.equal(Z0, Zt) and torch.equal(ld0, ldt)
    if fixture is three_tier:
        # tiers 2 and 3 engaged: the jitter bit on walkers 1 and 2 only
        assert ht[:, 0].tolist() == [0.0, 1.0, 1.0, 0.0]
    else:
        # refinement diverged on the three ill-posed systems only
        assert ht[:, 1].tolist() == [1.0, 1.0, 1.0, 0.0]


def _equilibrated_casts(S):
    St = torch.as_tensor(S)
    d = torch.clamp(torch.diagonal(St, dim1=-2, dim2=-1), min=1e-30)
    s = 1.0 / torch.sqrt(d)
    return (St * s[:, :, None] * s[:, None, :]).to(torch.float32)


def test_tier_rule_equals_reference_rule():
    Sn = _equilibrated_casts(three_tier()[0][:3])
    U, V, E, tier = tcf._fused_torch(Sn, 1e-6, 1e-3, tiers=True)
    assert tier.tolist() == [1, 2, 3]
    np.testing.assert_array_equal((tier >= 2).numpy(),
                                  tcf.jitter_bit_plain(Sn, U, 1e-6).numpy())
    trio = tcf._fused_torch(Sn, 1e-6, 1e-3)
    assert all(torch.equal(a, b) for a, b in zip(trio, (U, V, E)))


def test_kernel_route_passes_the_tier_on(monkeypatch):
    """On the kernel route the jitter bit is the launch's own tier, not a
    replayed factor: a stand-in launch reports tiers that the reference's
    rule would not give, and the bit follows them."""
    Sn = _equilibrated_casts(three_tier()[0][:3])
    plain = tcf._fused_torch(Sn, 1e-6, 1e-3)
    monkeypatch.setattr(tcf, "route", lambda *a: "kernel")
    monkeypatch.setattr(tcf, "_chol_precond_cuda", lambda S, j1, j2: plain
                        + (torch.tensor([3, 1, 2], dtype=torch.int32),))
    *_, bit = tcf.chol_precond_health(Sn, 1e-6, 1e-3)
    assert bit.tolist() == [True, False, True]


def test_health_refuses_the_megakernel_route():
    S, B = three_tier()
    with pytest.raises(ValueError, match="mega"):
        t_mixed(torch.as_tensor(S), torch.as_tensor(B), 1e-6, 1e-3,
                delta_mode="split", mega=True, with_health=True)
    nw = torch.ones(2, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="mega"):
        marginalized_loglike(nw, torch.ones(2, 2, dtype=torch.float64),
                             torch.ones(8, dtype=torch.float64),
                             torch.ones(8, 1, dtype=torch.float64),
                             torch.ones(8, 2, dtype=torch.float64),
                             mega=True, with_health=True)


@pytest.mark.parametrize("gram_mode,logcond_atol,lnl_atol", [
    ("f64", LOGCOND_ATOL, 1e-8),
    # the split Grams' float32 products are summed in another order by
    # the two packages: ~1e-7 relative on Sigma's diagonal
    ("split", 1e-6, 1e-3)])
def test_pulsar_health_twin_matches_reference(gram_mode, logcond_atol,
                                              lnl_atol):
    jl, tl = _likes(0, gram_mode)
    rng = np.random.default_rng(4)
    th = np.concatenate([near_truth(tl, 8, seed=2),
                         tl.sample_prior(rng, 8)])
    lj, hj = jl._eval_health_batch(jnp.asarray(th), jl.consts)
    lt, ht = tl._eval_health_batch(th)
    lj, hj, ht = np.asarray(lj), np.asarray(hj), ht.numpy()
    ok = np.isfinite(lj)
    assert ok[:8].all()
    # near the injection: the split class of tests/test_torch_kernel.py,
    # or float64
    assert np.all(np.abs(lt.numpy()[:8] - lj[:8]) <= lnl_atol)
    np.testing.assert_array_equal(ht[:, :2], hj[:, :2])
    np.testing.assert_allclose(ht[:, 2], hj[:, 2], rtol=0,
                               atol=logcond_atol)
    # the twin's lnL is the plain evaluation's on the CPU (classic route)
    assert torch.equal(lt, tl.loglike_batch(th))
    assert tl.health_psr_names == [tl.psr.name]
    # the float64 twin against the reference's
    np.testing.assert_allclose(
        tl._eval_f64_batch(th[:8]).numpy(),
        np.asarray(jl._eval_f64_batch(jnp.asarray(th[:8]), jl.consts)),
        rtol=1e-9)


def test_pta_health_twin_matches_reference():
    from test_torch_pta import _builds, _in_class, _theta
    jl, tl = _builds(gram_mode="split", npsr=2)
    th = _theta(tl.param_names)
    lj, hj = jl._eval_health_batch(jnp.asarray(th), jl.consts)
    lt, ht = tl._eval_health_batch(th)
    _in_class(lt.numpy(), np.asarray(lj))
    hj, ht = np.asarray(hj), ht.numpy()
    assert ht.shape == hj.shape == (th.shape[0], 2, 3)
    np.testing.assert_array_equal(ht[..., :2], hj[..., :2])
    # the port's stage-1 Gram is float64, the reference's split: ~1e-7
    # relative on the diagonal
    np.testing.assert_allclose(ht[..., 2], hj[..., 2], rtol=0, atol=1e-6)
    assert tl.health_psr_names == jl.health_psr_names


def _sequences():
    rng = np.random.default_rng(7)
    for k in range(6):
        seq = []
        for _ in range(24):
            n = int(rng.integers(0, 500))
            seq.append((n, int(rng.integers(0, max(n, 1) // 2 + 1)),
                        int(rng.random() < 0.15),
                        float(rng.uniform(2.0, 16.0))))
        yield seq


@pytest.mark.parametrize("kw", [{}, dict(jitter_frac=0.1, logcond_max=8.0)])
def test_ledger_matches_reference(kw):
    for seq in _sequences():
        tl, jl = tint.HealthLedger("p", **kw), jint.HealthLedger("p", **kw)
        acts = [(tl.update(*u), jl.update(*u)) for u in seq]
        assert all(a == b for a, b in acts)
        assert any(a is not None for a, _ in acts)
        tl.note_reeval(True, 0.01)
        jl.note_reeval(True, 0.01)
        assert tl.stats() == jl.stats()
        assert tl.reeval_verdicts == jl.reeval_verdicts
    assert tint.LADDER == jint.LADDER


def test_planted_fault_walks_the_ladder(tmp_path, monkeypatch):
    """``kernel.health`` planted on every block of a PT run of
    ``system_noise.dat --num 1`` (the natural condition proxy kept from
    tripping by ``EWT_HEALTH_LOGCOND_MAX``): both packages' CLIs escalate
    one rung a block and exit 76 with the pulsar quarantined."""
    from enterprise_warp_tpu import cli as jcli
    from enterprise_warp_tpu.resilience import faults as jfaults
    monkeypatch.setenv("EWT_HEALTH_LOGCOND_MAX", "1000")
    plan = {"faults": [{"site": "kernel.health", "kind": "nonfinite"}]}
    out = []
    for who, main, fmod in (
            ("port", lambda a: cli.main(a, device="cpu"), faults),
            ("jax", jcli.main, jfaults)):
        fmod.install_plan(plan)
        tmp = tmp_path / who
        tmp.mkdir()
        try:
            rc = main(["--prfile", _paramfile(tmp, "system_noise.dat",
                                              nsamp=400, covUpdate=50),
                       "--num", "1"])
        finally:
            fmod.install_plan(None)
        run = [r for r, _, fs in os.walk(tmp / "out")
               if "events.jsonl" in fs][0]
        events = _events(os.path.join(run, "events.jsonl"))
        with open(os.path.join(run, "quarantined.json")) as fh:
            qrec = json.load(fh)
        out.append(dict(
            rc=rc,
            actions=[e["action"] for e in events
                     if e["type"] == "kernel_health"],
            quarantined=[(e["psr"], e["cause"], e["where"]) for e in events
                         if e["type"] == "psr_quarantined"],
            qrec=(qrec["quarantined_pulsars"],
                  sorted(qrec["reports"]["J0042-0000"]))))
        # the classic rung: the reference turns every kernel off, the
        # port pins the classic chain and keeps its preconditioner kernel
        flag = "EWT_PALLAS_MEGA" if who == "port" else "EWT_PALLAS"
        assert os.environ.get(flag) == "0"
        for k in ("EWT_PALLAS", "EWT_PALLAS_MEGA"):
            monkeypatch.setenv(k, "1")
            monkeypatch.delenv(k)
    assert out[0] == out[1]
    assert out[0]["rc"] == 76
    assert out[0]["actions"] == ["observe", "reeval", "classic",
                                 "quarantine"]
    assert out[0]["quarantined"] == [("J0042-0000", "kernel_health",
                                      "sampler")]
