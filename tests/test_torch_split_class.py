"""The split Gram's precision class at many TOAs, against the JAX package.

The pulsar and model of ``chip_smoke.py:toa_problem`` (the north star's
J1832-0836-scale pulsar at 4096 and 8192 TOAs over the same span: 12
parameters, nb 80, three timing-model columns), built by each package's
own simulator and ``build_pulsar_likelihood``, at the 8 points of
``chip_smoke.py:toa_points``:

- lnL: the port's split build lies within max(1e-3, 1.5 x the JAX
  package's |split - float64|) of its own float64 build, with the pair
  program off and on (``EWT_PAIR_PROGRAM``);
- the (T, T) Gram ``G``: the port's ``gram_blocks(..., gram_mode="split")``
  and ``pair_program_grams`` lie no farther from float64, relative to
  max|G|, than the reference's ``gram_blocks`` and ``pair_program_grams``
  on the same whitened inputs and weights;
- the skinny ``M``/``r`` side of the split Grams is float64's;
- the Sigma stage on the solve kernel's route (its plain version here,
  a float32 ``Z``) holds the lnL class above.

Before the repair the port's 256-row float32 partials (a BLAS GEMM sums
them in one sequential pass) put ``G`` 2.6x farther from float64 than the
reference's and lnL up to 9x (``PERF.md``, the split class).
"""

import os

import jax  # noqa: F401  (float64 on: the reference's package import)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import toa_points, toa_problem
from enterprise_warp_tpu.models import StandardModels as JSM
from enterprise_warp_tpu.models import TermList as JTL
from enterprise_warp_tpu.models import build_pulsar_likelihood as j_build
from enterprise_warp_tpu.ops import kernel as jk
from enterprise_warp_tpu.sim.noise import (inject_basis_process,
                                           inject_white, make_fake_pulsar)
from enterprise_warp_tpu_torch.ops import kernel as tk

torch.set_num_threads(2)

NTOAS = (4096, 8192)
#: the lnL hold: max(LNL_FLOOR, LNL_FACTOR x the reference's own gap)
LNL_FLOOR, LNL_FACTOR = 1e-3, 1.5


def _jax_problem(ntoa, gram_mode):
    """``chip_smoke.py:toa_problem`` built by the JAX package."""
    psr = make_fake_pulsar(name="J1832-0836", ntoa=ntoa,
                           cadence_days=14.0 * 334 / ntoa,
                           backends=("CPSR2m", "CPSR2n", "CASPSR", "DFB"),
                           freqs_mhz=(700.0, 1400.0, 3100.0), seed=11)
    psr.residuals = 0.0 * psr.toaerrs
    inject_white(psr, efac=1.2, equad_log10=-6.5,
                 rng=np.random.default_rng(1))
    inject_basis_process(psr, log10_A=-13.0, gamma=3.5, components=20,
                         rng=np.random.default_rng(2))
    m = JSM(psr=psr)
    terms = JTL(psr, [m.efac("by_backend"), m.equad("by_backend"),
                      m.spin_noise("powerlaw_20_nfreqs"),
                      m.dm_noise("powerlaw_20_nfreqs")])
    return j_build(psr, terms, gram_mode=gram_mode)


def _with_pair(pair, build):
    """``build()`` with ``EWT_PAIR_PROGRAM`` set to ``pair`` (read at build
    time by both packages)."""
    old = os.environ.get("EWT_PAIR_PROGRAM")
    os.environ["EWT_PAIR_PROGRAM"] = pair
    try:
        return build()
    finally:
        if old is None:
            os.environ.pop("EWT_PAIR_PROGRAM")
        else:
            os.environ["EWT_PAIR_PROGRAM"] = old


def _measure(ntoa):
    """Both packages' lnL gaps from their own float64 builds (pair program
    off and on), the Sigma stage's on the solve kernel's route, and the
    port's whitened inputs and weights."""
    t64 = toa_problem("cpu", gram_mode="f64", ntoa=ntoa)
    pts = toa_points(t64)
    th = torch.as_tensor(pts)
    l64 = t64.loglike_batch(th).numpy()
    j64 = np.asarray(_jax_problem(ntoa, "f64").loglike_batch(
        jnp.asarray(pts)))
    gaps = {}
    for pair in ("0", "1"):
        t = _with_pair(pair, lambda: toa_problem("cpu", ntoa=ntoa))
        j = _with_pair(pair, lambda: _jax_problem(ntoa, "split"))
        assert t.pair_program == (pair == "1")
        gaps[pair] = (
            float(np.abs(t.loglike_batch(th).numpy() - l64).max()),
            float(np.abs(np.asarray(j.loglike_batch(jnp.asarray(pts)))
                         - j64).max()))
    st = t64.static
    nw = t64.eval_nw(pts)
    # the Sigma stage on the solve kernel's route: on the CPU its plain
    # version, which hands back a float32 Z as the kernel does
    grams = tk.gram_blocks(nw, st["r_w"], st["M_w"], st["T_w"])
    ldn = tk._row_sum(torch.log(nw))
    kernel_gap = float(np.abs(tk.sigma_stage(
        grams, t64.eval_phi(pts), ldn, solve_mega=True).numpy()
        - l64).max())
    return dict(ntoa=ntoa, gaps=gaps, f64_gap=float(np.abs(l64 - j64).max()),
                kernel_gap=kernel_gap, nw=nw, r=st["r_w"], M=st["M_w"],
                T=st["T_w"])


@pytest.fixture(scope="module", params=NTOAS, ids=lambda n: f"ntoa{n}")
def problem(request):
    return _measure(request.param)


def test_float64_builds_agree(problem):
    """The two packages' float64 builds give the same lnL: the inputs of
    the split comparisons are the same."""
    assert problem["f64_gap"] <= 1e-7


@pytest.mark.parametrize("pair", ["0", "1"], ids=["pair_off", "pair_on"])
def test_split_lnl_in_reference_class(problem, pair):
    port, ref = problem["gaps"][pair]
    assert port <= max(LNL_FLOOR, LNL_FACTOR * ref), (problem["ntoa"], pair,
                                                      port, ref)


def test_solve_kernel_route_in_reference_class(problem):
    """The Sigma stage through the solve kernel's route (float32 ``Z``)
    holds the same class: its quadratic forms are variational
    (``ops/kernel.py:_quad_forms``), so ``Z``'s rounding does not reach
    lnL at first order (1.6e-2 at 8192 TOAs with ``X^T Z``)."""
    ref = problem["gaps"]["0"][1]
    assert problem["kernel_gap"] <= max(LNL_FLOOR, LNL_FACTOR * ref), \
        (problem["ntoa"], problem["kernel_gap"], ref)


def _g_err(G, G64):
    scale = G64.abs().amax(dim=(-2, -1))
    return float(((G - G64).abs().amax(dim=(-2, -1)) / scale).max())


def _gram_errors(problem, path):
    """The port's and the reference's split ``G`` against float64,
    relative to max|G|, on the same whitened inputs and weights."""
    nw, r, M, T = (problem[k] for k in ("nw", "r", "M", "T"))
    G64 = tk.gram_blocks(nw, r, M, T, gram_mode="f64")[0]
    rj, Mj, Tj = (jnp.asarray(a.numpy()) for a in (r, M, T))
    if path == "gram_blocks":
        Gt = tk.gram_blocks(nw, r, M, T, gram_mode="split")[0]
        Gj = jax.vmap(lambda n: jk.gram_blocks(n, rj, Mj, Tj,
                                               gram_mode="split")[0])(
            jnp.asarray(nw.numpy()))
    else:
        w = 1.0 / nw
        Gt = tk.pair_program_grams(w, tk.build_pair_program(
            r.numpy(), M.numpy(), T.numpy(), device="cpu"))[0]
        prog = jk.build_pair_program(r.numpy(), M.numpy(), T.numpy())
        Gj = jax.vmap(lambda x: jk.pair_program_grams(x, prog)[0])(
            jnp.asarray(w.numpy()))
    return _g_err(Gt, G64), _g_err(torch.as_tensor(np.array(Gj)), G64)


@pytest.mark.parametrize("path", ["gram_blocks", "pair_program"])
def test_split_gram_no_worse_than_reference(problem, path):
    port, ref = _gram_errors(problem, path)
    assert port <= ref, (problem["ntoa"], path, port, ref)


@pytest.mark.parametrize("pair", [False, True], ids=["pair_off", "pair_on"])
def test_split_skinny_side_is_float64(problem, pair):
    """``H``, ``P``, ``X``, ``q`` and ``rwr`` of the split Grams are the
    float64 ones up to float64 rounding: only the (T, T) block is split."""
    nw, r, M, T = (problem[k] for k in ("nw", "r", "M", "T"))
    prog = tk.build_pair_program(r.numpy(), M.numpy(), T.numpy(),
                                 device="cpu") if pair else None
    split = tk.gram_blocks(nw, r, M, T, pair_program=prog)
    f64 = tk.gram_blocks(nw, r, M, T, gram_mode="f64")
    for a, b in zip(split[1:], f64[1:]):
        torch.testing.assert_close(a, b, rtol=1e-11, atol=1e-11 * float(
            b.abs().max()))


def test_partial_length_follows_the_toa_count():
    """A pulsar of more than ``_SUB_ABOVE`` TOAs takes 32-row hi*hi
    partials in both Gram paths; a shorter one keeps the reference's 256,
    and so the reference's partials."""
    assert tk._gram_rows(tk._SUB_ABOVE) == tk._CHUNK == 256
    assert tk._gram_rows(tk._SUB_ABOVE + 1) == tk._SUB == 32
    rng = np.random.default_rng(0)
    for ntoa, rows in ((334, 256), (2047, 32)):
        T = rng.standard_normal((ntoa, 6))
        prog = tk.build_pair_program(rng.standard_normal(ntoa),
                                     rng.standard_normal((ntoa, 2)), T,
                                     device="cpu")
        assert prog["rows"] == rows


def test_chunked_gram_partials_sum_in_float64():
    """``_chunked_f32_gram`` at any partial length that divides the chunk
    is the float64 sum of its float32 partials: exact on integer data."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-8, 9, (3, 512, 5), generator=g).to(torch.float32)
    y = torch.randint(-8, 9, (3, 512, 4), generator=g).to(torch.float32)
    want = x.double().transpose(-1, -2) @ y.double()
    for rows in (tk._SUB, 64, tk._CHUNK):
        got = tk._chunked_f32_gram(x, y, rows)
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def main(argv):
    """Print the split-class table, one JSON line a TOA count in ``argv``
    (default 4096, 8192 and 32768), from the repository root::

        JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.',
        'tests']; import conftest, test_torch_split_class as t; t.main([])"

    (``conftest`` puts the JAX package in float64 on the CPU, as the
    tests run it)."""
    import json
    for ntoa in [int(a) for a in argv] or [4096, 8192, 32768]:
        p = _measure(ntoa)
        row = dict(ntoa=ntoa, f64_gap=p["f64_gap"],
                   kernel_route_gap=p["kernel_gap"])
        for pair, name in (("0", "pair_off"), ("1", "pair_on")):
            row[f"lnl_{name}"] = dict(zip(("port", "jax"), p["gaps"][pair]))
        for path in ("gram_blocks", "pair_program"):
            row[f"G_{path}"] = dict(zip(("port", "jax"),
                                        _gram_errors(p, path)))
        print(json.dumps(row), flush=True)
