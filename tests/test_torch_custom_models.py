"""The custom-models contract in the torch port, against the JAX package.

``examples/example_params/custom_hypermodel.dat --num 0`` (J1234-5678,
two models: standard spin noise, and spin noise plus the DM exponential
dip of the plugin) is built twice: through the port with its own plugin
(``enterprise_warp_tpu_torch/examples/custom_models.py``) and through the
JAX package with ``examples/custom_models.py``. Both models must give the
same parameter names, the same whitened static arrays (rtol 1e-12, as
``tests/test_torch_models.py``) and the same float64 lnL at shared prior
draws (rtol 1e-9 or the conditioning limit, as
``tests/test_torch_kernel.py::test_f64_lnl_at_prior_draws``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enterprise_warp_tpu.config import Params as JParams
from enterprise_warp_tpu.models.assemble import \
    init_model_likelihoods as j_init
from enterprise_warp_tpu.samplers.evalproto import eval_protocol
from enterprise_warp_tpu_torch import cli
from enterprise_warp_tpu_torch.config import Params as TParams
from enterprise_warp_tpu_torch.models.assemble import \
    init_model_likelihoods as t_init

from test_torch_kernel import _sigma_condition
from test_torch_models import RTOL, _opts

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRFILE = os.path.join(REPO, "examples", "example_params",
                      "custom_hypermodel.dat")
J_PLUGIN = os.path.join(REPO, "examples", "custom_models.py")
T_PLUGIN = os.path.join(REPO, "enterprise_warp_tpu_torch", "examples",
                        "custom_models.py")


@pytest.fixture(scope="module")
def models():
    jc = cli.import_custom_models(J_PLUGIN, "CustomModels")
    tc = cli.import_custom_models(T_PLUGIN, "CustomModels")
    jl = j_init(JParams(PRFILE, opts=_opts(0), custom_models_obj=jc),
                gram_mode="f64", write_pars=False)
    tl = t_init(TParams(PRFILE, opts=_opts(0), custom_models_obj=tc),
                gram_mode="f64", write_pars=False, device="cpu")
    return jl, tl


def test_both_models_built(models):
    jl, tl = models
    assert sorted(tl) == sorted(jl) == [0, 1]
    # model 1 carries the plugin's DM dip on top of model 0
    assert tl[1].static["T_w"].shape[1] == tl[0].static["T_w"].shape[1] + 1


@pytest.mark.parametrize("model", [0, 1])
def test_custom_param_names_equal(models, model):
    jl, tl = models
    assert tl[model].param_names == jl[model].param_names


@pytest.mark.parametrize("model", [0, 1])
def test_custom_static_arrays_equal(models, model):
    jl, tl = models
    consts = eval_protocol(jl[model])[2]
    for jk, tk in (("r", "r_w"), ("M", "M_w"), ("T", "T_w"),
                   ("s2", "sigma2")):
        np.testing.assert_allclose(tl[model].static[tk].numpy(),
                                   np.asarray(consts[jk]), rtol=RTOL,
                                   atol=0, err_msg=jk)


@pytest.mark.parametrize("model", [0, 1])
def test_custom_f64_lnl_at_prior_draws(models, model):
    jl, tl = models[0][model], models[1][model]
    theta = jl.sample_prior(np.random.default_rng(7), 6)
    lnl_j = np.asarray(jl.loglike_batch(jnp.asarray(theta)))
    lnl_t = tl.loglike_batch(theta).numpy()
    assert np.isfinite(lnl_t).all()
    kappa = _sigma_condition(tl, theta)
    rtol = np.maximum(1e-9, 10.0 * kappa * np.finfo(np.float64).eps)
    assert np.all(np.abs(lnl_t - lnl_j) <= rtol * np.abs(lnl_j)), \
        (lnl_t - lnl_j, kappa)

