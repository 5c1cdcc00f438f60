"""Parity of the torch port's model layer with the JAX package.

``examples/example_params/system_noise.dat`` with ``--num 0``
(J1234-5678) and ``--num 1`` (fake_psr_0) must give the same parameter
names, the same whitened static arrays, and the same white-noise
variances, prior variances and log-prior at prior draws made from shared
numpy uniforms through each package's ``from_unit`` (rtol 1e-12: both are
float64 evaluations of the same formulas; the tolerance only absorbs
``pow``/``log`` last-digit differences between XLA and PyTorch).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.models import build as jb
from enterprise_warp_tpu.models.assemble import (build_terms_for_model,
                                                 init_model_likelihoods
                                                 as j_init)
from enterprise_warp_tpu.ops.kernel import whiten_inputs
from enterprise_warp_tpu.samplers.evalproto import eval_protocol
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRFILE = os.path.join(REPO, "examples", "example_params", "system_noise.dat")
RTOL = 1e-12


def _opts(num):
    return types.SimpleNamespace(num=num, drop=0, mpi_regime=2,
                                 wipe_old_output=0, extra_model_terms=None)


@pytest.fixture(scope="module", params=[0, 1], ids=["num0", "num1"])
def pair(request):
    num = request.param
    jp = JParams(PRFILE, opts=_opts(num))
    tp = TParams(PRFILE, opts=_opts(num))
    jl = j_init(jp, write_pars=False)[0]
    tl = t_init(tp, write_pars=False, device="cpu")[0]
    return jp, jl, tl


def _jax_nw_phi(jp, theta):
    """nw and phi of the JAX build, through its own lowering helpers."""
    psr = jp.psrs[0]
    tl = build_terms_for_model(jp.models[0], jp.psrs, jp.noise_model_obj)[0]
    wbk, bbk, T_all = jb.lower_terms(psr, tl)
    _, _, T_w, cs2, _ = whiten_inputs(psr.residuals, psr.toaerrs, psr.Mmat,
                                      T_all)
    _, mapping = jb._resolve_params(jb.collect_params(wbk, bbk), None)
    wbs, bbs = jb.white_static(wbk, mapping), jb.basis_static(bbk, mapping)
    s2 = jnp.asarray(np.asarray(psr.toaerrs) ** 2)
    th = jnp.asarray(theta)
    nw = jax.vmap(lambda t: jb.eval_nw(t, wbs, len(psr), s2))(th)
    phi = jax.vmap(lambda t: jb.eval_phi_T(t, bbs, jnp.asarray(T_w),
                                           jnp.asarray(cs2))[0])(th)
    return np.asarray(nw), np.asarray(phi)


def test_param_names_equal(pair):
    _, jl, tl = pair
    assert jl.param_names == tl.param_names
    assert [type(p.prior).__name__ for p in jl.params] == \
        [type(p.prior).__name__ for p in tl.params]


def test_static_arrays_equal(pair):
    _, jl, tl = pair
    consts = eval_protocol(jl)[2]
    for jk, tk in (("r", "r_w"), ("M", "M_w"), ("T", "T_w"),
                   ("s2", "sigma2")):
        np.testing.assert_allclose(tl.static[tk].numpy(),
                                   np.asarray(consts[jk]), rtol=RTOL,
                                   atol=0, err_msg=jk)


def test_nw_phi_log_prior_at_prior_draws(pair):
    jp, jl, tl = pair
    u = np.random.default_rng(5).uniform(size=(8, tl.ndim))
    th_j = np.asarray(jl.from_unit(jnp.asarray(u)))
    th_t = tl.from_unit(torch.as_tensor(u, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(th_t, th_j, rtol=RTOL)
    nw_j, phi_j = _jax_nw_phi(jp, th_j)
    np.testing.assert_allclose(tl.eval_nw(th_j).numpy(), nw_j, rtol=RTOL)
    np.testing.assert_allclose(tl.eval_phi(th_j).numpy(), phi_j, rtol=RTOL)
    lp_j = np.asarray(jl.log_prior(jnp.asarray(th_j)))
    lp_t = tl.log_prior(torch.tensor(th_j)).numpy()
    np.testing.assert_allclose(lp_t, lp_j, rtol=RTOL)
    # outside the prior box both give -inf, per walker
    out = th_j.copy()
    out[::2, 0] = 1e3
    np.testing.assert_allclose(tl.log_prior(torch.as_tensor(out)).numpy(),
                               np.asarray(jl.log_prior(jnp.asarray(out))),
                               rtol=RTOL)


def test_build_choices_match(pair):
    _, jl, tl = pair
    assert tl.const_grams == jl.const_grams
    assert tl.pair_program


@pytest.mark.parametrize("name", ["default_model_nested.dat",
                                  "system_noise.dat"])
def test_noise_pairs_and_params_fingerprint_equal(name):
    """J1234-5678 under ``default_noise_example_1.json`` (the nested
    example's model) and under ``system_noise.dat``'s model: the same
    (efac, equad, mean toaerr^2) slide triples (indices exactly, the
    variance within 1e-15 relative: the same numpy mean of the same
    parsed errors) and the same model-identity string, so a nested
    checkpoint is recognised by either package."""
    from enterprise_warp_tpu.models.build import \
        params_fingerprint as j_fingerprint
    from enterprise_warp_tpu_torch.models.build import \
        params_fingerprint as t_fingerprint
    prfile = os.path.join(os.path.dirname(PRFILE), name)
    jl = j_init(JParams(prfile, opts=_opts(0)), write_pars=False)[0]
    tl = t_init(TParams(prfile, opts=_opts(0)), write_pars=False,
                device="cpu")[0]
    assert len(jl.noise_pairs) == 4
    assert [p[:2] for p in tl.noise_pairs] == \
        [p[:2] for p in jl.noise_pairs]
    np.testing.assert_allclose([p[2] for p in tl.noise_pairs],
                               [p[2] for p in jl.noise_pairs], rtol=1e-15)
    assert t_fingerprint(tl) == j_fingerprint(jl)
