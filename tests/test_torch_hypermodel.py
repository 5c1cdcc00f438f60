"""The product-space hypermodel in the torch port, against the JAX package.

``examples/example_params/default_hypermodel.dat`` (white noise only
against white plus spin noise) and ``custom_hypermodel.dat`` (spin noise
against spin noise plus the plugin's DM dip; the port's
``enterprise_warp_tpu_torch/examples/custom_models.py`` against
``examples/custom_models.py``), ``--num 0`` (J1234-5678), both built in
float64 through both packages and wrapped in each package's
``HyperModelLikelihood``:

- the union parameter names are equal, ``nmodel`` last;
- ``loglike_batch`` agrees within rtol 1e-9 at points in every bin, at
  ``nmodel`` exactly 0.5 and 1.5 (both packages round half to even),
  outside [-0.5, n - 0.5] (clipped to the end members) and for a batch
  that sits entirely in one bin, where the other member is not called;
- the members' white-noise pairs (the sampler's ``ns`` metadata) are
  remapped into the union and name-deduplicated, as the reference does;
- a short CPU run of the port's CLI leaves a chain whose ``pars.txt``
  ends in ``nmodel``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.models.assemble import \
    init_model_likelihoods as j_init
from enterprise_warp_tpu.samplers import \
    HyperModelLikelihood as JHyperModel
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init
from enterprise_warp_tpu_torch.models.priors import Parameter, Uniform
from enterprise_warp_tpu_torch.samplers import \
    HyperModelLikelihood as THyperModel

from test_torch_cli import _paramfile
from test_torch_models import _opts

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "examples", "example_params")
PLUGINS = {"jax": os.path.join(REPO, "examples", "custom_models.py"),
           "torch": os.path.join(REPO, "enterprise_warp_tpu_torch",
                                 "examples", "custom_models.py")}
PSR = "J1234-5678"


def _custom_args(name, pkg):
    if name != "custom_hypermodel.dat":
        return []
    return ["--custom_models_py", PLUGINS[pkg], "--custom_models",
            "CustomModels"]


def _plugin(name, pkg):
    args = _custom_args(name, pkg)
    return cli.import_custom_models(args[1], args[3]) if args else None


@pytest.fixture(scope="module",
                params=["default_hypermodel.dat", "custom_hypermodel.dat"])
def hyper(request):
    name = request.param
    prfile = os.path.join(PARAMS, name)
    jl = j_init(JParams(prfile, opts=_opts(0),
                        custom_models_obj=_plugin(name, "jax")),
                gram_mode="f64", write_pars=False)
    tl = t_init(TParams(prfile, opts=_opts(0),
                        custom_models_obj=_plugin(name, "torch")),
                gram_mode="f64", write_pars=False, device="cpu")
    return name, JHyperModel(jl), THyperModel(tl)


def typical(like, n, seed, nmodel):
    """Typical noise values (efac 1, log10 equad -7, log10_A -13.5,
    gamma 3.5, spread 0.05), other parameters near their prior middles
    (spread 2% of the width), and the given ``nmodel`` column."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, like.ndim))
    for i, p in enumerate(like.params[:-1]):
        z = rng.standard_normal(n)
        base = (1.0 if p.name.endswith("efac") else
                -7.0 if "equad" in p.name else
                -13.5 if p.name.endswith("log10_A") else
                3.5 if p.name.endswith("gamma") else None)
        if base is not None:
            out[:, i] = base + 0.05 * z
        else:
            lo, hi = p.prior.lo, p.prior.hi
            out[:, i] = 0.5 * (lo + hi) + 0.02 * (hi - lo) * z
    out[:, -1] = nmodel
    return out


def test_union_names_equal(hyper):
    _, jh, th = hyper
    assert th.param_names == jh.param_names
    assert th.param_names[-1] == "nmodel"
    assert th.params[-1].prior.lo == -0.5 and th.params[-1].prior.hi == 1.5
    assert th.ndim == jh.ndim
    for like in th.likes.values():
        assert set(like.param_names) <= set(th.param_names[:-1])


NMODEL = {
    "every_bin": [-0.4, 0.2, 0.49, 0.51, 0.9, 1.3, -0.2, 1.1],
    "halves": [0.5, 1.5, 0.5, 1.5, -0.5, 0.5, 1.5, -0.5],
    "outside": [-3.0, 2.7, -0.51, 1.51, 40.0, -40.0, 0.0, 1.0],
    "one_bin": [0.8, 1.2, 1.45, 0.6, 1.0, 0.55, 1.3, 0.9],
}


@pytest.mark.parametrize("case", sorted(NMODEL))
def test_loglike_batch_equal(hyper, case):
    _, jh, th = hyper
    theta = typical(th, 8, 6, NMODEL[case])
    calls = {m: 0 for m in th.likes}
    for m, like in th.likes.items():
        orig = like.loglike_batch

        def counted(t, m=m, orig=orig):
            calls[m] += len(t)
            return orig(t)
        like.loglike_batch = counted
    try:
        lnl_t = th.loglike_batch(theta).numpy()
    finally:
        for like in th.likes.values():
            del like.loglike_batch
    lnl_j = np.asarray(jh.loglike_batch(jnp.asarray(theta)))
    assert np.isfinite(lnl_t).all()
    np.testing.assert_allclose(lnl_t, lnl_j, rtol=1e-9, atol=0)
    # each member evaluated only on the walkers that select it
    k = np.clip(np.round(theta[:, -1]), 0, 1).astype(int)
    assert calls == {m: int(np.sum(k == m)) for m in th.likes}
    if case == "one_bin":
        assert calls[0] == 0
    if case == "halves":
        # round half to even: 0.5 -> 0, 1.5 -> 2 -> clipped to 1
        assert k.tolist() == [0, 1, 0, 1, 0, 0, 1, 0]


@pytest.mark.parametrize("name", ["default_hypermodel.dat",
                                  "custom_hypermodel.dat"])
def test_cli_runs_on_cpu(tmp_path, name):
    prfile = _paramfile(tmp_path, 40, name)
    rc = cli.main(["--prfile", prfile, "--num", "0"]
                  + _custom_args(name, "torch"), device="cpu")
    assert rc == 0
    runs = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "out")
            for d in ds if d == f"0_{PSR}"]
    assert len(runs) == 1
    pars = open(os.path.join(runs[0], "pars.txt")).read().split()
    assert pars[-1] == "nmodel" and len(pars) == len(set(pars))
    chain = np.loadtxt(os.path.join(runs[0], "chain_1.txt"))
    assert chain.shape == (40 // 10 * 8, len(pars) + 4)
    assert np.isfinite(chain).all()
    nmodel = chain[:, len(pars) - 1]
    assert nmodel.min() >= -0.5 and nmodel.max() <= 1.5


def test_noise_pairs_equal_reference(hyper):
    """The members' slide triples remapped into the union, against the
    reference's ``HyperModelLikelihood.noise_pairs`` (indices exactly,
    the mean toaerr^2 within 1e-15 relative)."""
    _, jh, th = hyper
    assert [p[:2] for p in th.noise_pairs] == \
        [p[:2] for p in jh.noise_pairs]
    np.testing.assert_allclose([p[2] for p in th.noise_pairs],
                               [p[2] for p in jh.noise_pairs], rtol=1e-15)


class _Member:
    """A stand-in member: parameter names and white-noise pairs only."""
    device = torch.device("cpu")

    def __init__(self, names, pairs):
        self.params = [Parameter(n, Uniform(0.0, 1.0)) for n in names]
        self.param_names = names
        self.noise_pairs = pairs


def test_noise_pairs_remapped():
    a = _Member(["x_efac", "x_log10_equad", "red"], [(0, 1, 2.0)])
    b = _Member(["red", "x_efac", "x_log10_equad", "y_efac",
                 "y_log10_equad"], [(1, 2, 2.0), (3, 4, 5.0)])
    h = THyperModel({1: b, 0: a})
    assert h.param_names == ["x_efac", "x_log10_equad", "red", "y_efac",
                             "y_log10_equad", "nmodel"]
    assert h.noise_pairs == [(0, 1, 2.0), (3, 4, 5.0)]


# a prior corner of default_hypermodel.dat's member 1 that a 2000-step
# PT chain on the card reached before the kernel route rejected such
# walkers (CASPSR efac 7.8e-4, red-noise log10_A -6.89): the last row of
# that chain, whose lnL there was 6.2e18
CORNER = [0.0007849382887030049, 8.404088323451239, 4.915462071268632,
          9.132290993384434, -9.255658796563068, -7.779135706917557,
          -5.462763583946961, -8.434894532696779, -6.888397086499135,
          5.466953296230443]


def test_kernel_route_corner_shared_with_reference(monkeypatch):
    """The corner is the reference's own, and the port's kernel route now
    departs from it there. At CORNER the equilibrated Sigma is far beyond
    float32 and the timing-model Schur complement comes out indefinite.
    The reference's
    likelihood-kernel route (its Pallas kernel in interpret mode) returns
    a finite lnL more than 1e9 above the float64 value there; the port's
    kernel route (its plain version on CPU tensors) rejects the walker
    (``ops.megakernel.schur_reject``): NaN before the likelihood's mapping,
    -inf after it, as both classic split chains give. The departure from
    the reference is deliberate (ROADMAP.md Queue 3). At 64 seeded points
    near typical noise values of the same model the rejection leaves the
    port's lnL bit for bit as it was without it."""
    import enterprise_warp_tpu_torch.models.build as tbuild
    import enterprise_warp_tpu_torch.ops.megakernel as tmk
    from enterprise_warp_tpu.ops.kernel import \
        marginalized_loglike as j_marginalized_loglike
    prfile = os.path.join(PARAMS, "default_hypermodel.dat")
    split = t_init(TParams(prfile, opts=_opts(0)), gram_mode="split",
                   write_pars=False, device="cpu")[1]
    exact = t_init(TParams(prfile, opts=_opts(0)), gram_mode="f64",
                   write_pars=False, device="cpu")[1]
    theta = np.asarray([CORNER])
    ref = float(exact.loglike_batch(theta)[0])
    captured = {}
    orig = tbuild.marginalized_loglike

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return orig(*args, **kw)
    monkeypatch.setattr(tbuild, "marginalized_loglike", capture)
    classic = float(split.loglike_batch(theta)[0])
    args, kw = captured["args"], dict(captured["kw"], mega=True)
    port_kernel_route = float(orig(*args, **kw)[0])
    nw, b, r_w, M_w, T_w = (np.asarray(a.numpy()) for a in args[:5])
    ref_kernel_route = float(j_marginalized_loglike(
        jnp.asarray(nw[0]), jnp.asarray(b[0]), jnp.asarray(r_w),
        jnp.asarray(M_w), jnp.asarray(T_w), mega="interpret"))
    ref_classic = float(j_marginalized_loglike(
        jnp.asarray(nw[0]), jnp.asarray(b[0]), jnp.asarray(r_w),
        jnp.asarray(M_w), jnp.asarray(T_w), mega=False))
    assert np.isfinite(ref) and ref < -1e6
    assert not np.isfinite(classic) and not np.isfinite(ref_classic)
    assert np.isnan(port_kernel_route)
    assert np.isfinite(ref_kernel_route) and ref_kernel_route > ref + 1e9

    # the likelihood on the kernel route: -inf at CORNER; near typical
    # values bit for bit what it gives with the rejection switched off
    monkeypatch.setattr(tbuild, "marginalized_loglike",
                        lambda *a, **k: orig(*a, **dict(k, mega=True)))
    assert float(split.loglike_batch(theta)[0]) == -np.inf
    rng = np.random.default_rng(64)
    base = [1.0 if p.name.endswith("efac") else
            -7.0 if "equad" in p.name else
            -13.5 if p.name.endswith("log10_A") else 3.5
            for p in split.params]
    typical = np.asarray(base) + 0.05 * rng.standard_normal((64, len(base)))
    kept = split.loglike_batch(typical)
    monkeypatch.setattr(tmk, "schur_reject",
                        lambda evA, quad: torch.zeros_like(
                            quad, dtype=torch.bool))
    unrepaired = split.loglike_batch(typical)
    assert torch.isfinite(kept).all()
    assert torch.equal(kept, unrepaired)
