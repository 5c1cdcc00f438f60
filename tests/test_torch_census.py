"""The dispatch census against the JAX package's
(``enterprise_warp_tpu/ops/megakernel.py:dispatch_ab_counts``,
``dispatch_reduction``; ``utils/telemetry.py:dispatch_stats``).

- ``dispatch_reduction`` against the reference's on the same records,
  missing and zero sides included; a side recorded as None (the port's
  kernel side on CPU tensors) gives None;
- ``census_calls`` draws the reference's fixture bit for bit: ``nw``,
  ``b``, ``Gs`` and ``RHS`` as ``dispatch_ab_counts`` hands them to the
  reference's ``dispatch_stats``;
- ``dispatch_ab_counts`` on the CPU: the reference's four keys, the
  classic records positive and equal across two calls, no kernel launch,
  the kernel side None (a plain version is never counted as a kernel);
- ``dispatch_stats`` on a known function: every ATen op in ``aten_ops``,
  views and allocations left out of ``dispatch_ops``, launches counted
  from ``ops/routes.py:LAUNCHES``;
- on a card (skipped here): the kernel side's records show their
  kernels' launches, and the profiler's GPU kernels include them.
"""

import jax  # noqa: F401  (float64 on: the reference's package import)
import numpy as np
import pytest
import torch

import enterprise_warp_tpu.utils.telemetry as jtel
from enterprise_warp_tpu.ops import megakernel as jmk
from enterprise_warp_tpu_torch.ops import megakernel as tmk
from enterprise_warp_tpu_torch.ops import routes as troutes
from enterprise_warp_tpu_torch.ops.kernel import whiten_inputs
from enterprise_warp_tpu_torch.utils.telemetry import dispatch_stats

torch.set_num_threads(2)

KEYS = ("full_classic", "full_mega", "solve_classic", "solve_mega")


def _arrays(ntoa=96, nb=12, ntm=3, seed=0):
    """Whitened inputs of a small seeded problem, as both packages take
    them (``whiten_inputs``)."""
    rng = np.random.default_rng(seed)
    r_w, M_w, T_w, cs2, _ = whiten_inputs(
        rng.standard_normal(ntoa), 0.5 + rng.random(ntoa),
        rng.standard_normal((ntoa, ntm)), rng.standard_normal((ntoa, nb)))
    return r_w, M_w, T_w, cs2


def _rec(n):
    return {"dispatch_ops": n, "aten_ops": 2 * n}


@pytest.mark.parametrize("counts", [
    {"full_classic": _rec(200), "full_mega": _rec(80)},
    {"full_classic": _rec(7), "full_mega": _rec(3)},
    {"full_classic": _rec(200)},
    {"full_mega": _rec(80)},
    {},
    {"full_classic": _rec(0), "full_mega": _rec(80)},
    {"full_classic": _rec(200), "full_mega": _rec(0)},
    {"full_classic": {"aten_ops": 5}, "full_mega": _rec(80)},
], ids=["both", "rounded", "no_mega", "no_classic", "empty", "zero_classic",
        "zero_mega", "key_missing"])
@pytest.mark.parametrize("key", ["dispatch_ops", "aten_ops"])
def test_dispatch_reduction_matches_reference(counts, key):
    assert tmk.dispatch_reduction(counts, "full", key) == \
        jmk.dispatch_reduction(counts, "full", key)


def test_dispatch_reduction_none_side():
    counts = {"solve_classic": _rec(150), "solve_mega": None}
    assert tmk.dispatch_reduction(counts, "solve") is None
    assert tmk.dispatch_reduction({"solve_classic": None,
                                   "solve_mega": _rec(3)}, "solve") is None
    assert tmk.dispatch_reduction({"solve_classic": _rec(10),
                                   "solve_mega": _rec(3)}, "solve") == 3.33


@pytest.mark.parametrize("batch,seed", [(64, 7), (5, 3)])
def test_census_fixture_is_the_reference_draws(monkeypatch, batch, seed):
    arrays = _arrays()
    seen = {}

    def capture(fn, *args):
        seen.setdefault(len(seen), [np.asarray(a) for a in args])
        return {}

    monkeypatch.setattr(jtel, "dispatch_stats", capture)
    jmk.dispatch_ab_counts(*arrays, batch=batch, seed=seed)
    # the reference counts full_classic, solve_classic, full_mega,
    # solve_mega in that order
    ref = dict(zip(("full_classic", "solve_classic", "full_mega",
                    "solve_mega"), (seen[i] for i in range(4))))
    calls = tmk.census_calls(*arrays, batch=batch, seed=seed, device="cpu")
    for key in ("full_classic", "solve_classic"):
        got = [a.numpy() for a in calls[key][1]]
        assert len(got) == len(ref[key]) == 2
        for a, b in zip(got, ref[key]):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
    # the reference's kernel side counts the same fixture
    for a, b in zip(ref["full_mega"] + ref["solve_mega"],
                    ref["full_classic"] + ref["solve_classic"]):
        np.testing.assert_array_equal(a, b)


def test_dispatch_ab_counts_on_cpu():
    arrays = _arrays()
    troutes.reset_counts()
    first = tmk.dispatch_ab_counts(*arrays, batch=8, device="cpu")
    second = tmk.dispatch_ab_counts(*arrays, batch=8, device="cpu")
    assert tuple(first) == KEYS
    for counts in (first, second):
        assert counts["full_mega"] is None and counts["solve_mega"] is None
    for key in ("full_classic", "solve_classic"):
        rec = first[key]
        assert set(rec) == {"aten_ops", "dispatch_ops", "kernels",
                            "device_kernels"}
        assert 0 < rec["dispatch_ops"] < rec["aten_ops"]
        assert rec["kernels"] == {k: 0 for k in troutes.KERNELS}
        assert rec["device_kernels"] is None
        assert rec == second[key]
    # the full evaluation dispatches more than its Sigma solve alone
    assert first["full_classic"]["aten_ops"] > \
        first["solve_classic"]["aten_ops"]
    assert dict(troutes.LAUNCHES) == {k: 0 for k in troutes.KERNELS}
    assert tmk.dispatch_reduction(first, "full") is None


def test_census_outputs_match_the_classic_chain():
    """The counted calls are the classic chain's evaluation and Sigma
    solve on the fixture: finite, and the solve solves ``Gs``."""
    arrays = _arrays()
    calls = tmk.census_calls(*arrays, batch=4, device="cpu")
    fn, args = calls["full_classic"]
    lnl = fn(*args)
    assert lnl.shape == (4,) and bool(torch.isfinite(lnl).all())
    fn, (Gs, RHS) = calls["solve_classic"]
    Z, ld = fn(Gs, RHS)
    torch.testing.assert_close(Gs @ Z, RHS, rtol=1e-9, atol=1e-9)
    # the logdet: a float32 factor's plus the trace correction
    torch.testing.assert_close(ld, torch.logdet(Gs), rtol=1e-7, atol=0)


def test_dispatch_stats_known_function():
    x = torch.arange(12, dtype=torch.float64).reshape(3, 4)

    def fn(a):
        b = torch.empty(3, dtype=a.dtype)        # an allocation
        b.fill_(1.0)                             # in place: work
        y = (a.t() @ a).sum()                    # t: a view; mm, sum
        z = a.view(12)[0]                        # view, select: views
        return y + z + b.sum()                   # add, sum, add

    rec = dispatch_stats(fn, x)
    assert rec["aten_ops"] == 10
    assert rec["dispatch_ops"] == 6
    assert rec["kernels"] == {k: 0 for k in troutes.KERNELS}
    assert rec["device_kernels"] is None
    assert dispatch_stats(lambda a: a.transpose(0, 1)[None], x) == \
        {"aten_ops": 2, "dispatch_ops": 0,
         "kernels": {k: 0 for k in troutes.KERNELS}, "device_kernels": None}


def test_dispatch_stats_counts_launches(monkeypatch):
    monkeypatch.setattr(troutes, "LAUNCHES", {k: 5 for k in troutes.KERNELS})

    def fn():
        troutes.record_launch("mega_solve")
        troutes.record_launch("chol_precond", "smem")
        troutes.record_launch("mega_solve")

    rec = dispatch_stats(fn)
    assert rec["kernels"] == {"mega_solve": 2, "mega_like": 0,
                              "chol_precond": 1}
    assert rec["aten_ops"] == rec["dispatch_ops"] == 0


# ---- on the card ------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py phase 17 runs the "
                    "census on the card)")
    return torch.device("cuda")


def test_cuda_census_counts_the_kernels(cuda):
    counts = tmk.dispatch_ab_counts(*_arrays(), batch=8, device=cuda)
    assert counts["full_mega"]["kernels"]["mega_like"] == 1
    assert counts["solve_mega"]["kernels"]["mega_solve"] == 1
    for key in KEYS:
        rec = counts[key]
        assert rec["dispatch_ops"] == sum(rec["device_kernels"].values())
    assert tmk.dispatch_reduction(counts, "solve") > 1.0
