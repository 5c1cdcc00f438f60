"""The port's dense float64 oracle against the JAX package's.

``enterprise_warp_tpu_torch/ops/oracle.py`` is a numpy copy of
``enterprise_warp_tpu/ops/oracle.py``: on the same synthetic inputs (made
from a seed with numpy, as ``tests/test_kernel.py`` makes them) both
``oracle_loglike`` and ``kernel_constant_offset`` must agree exactly,
with a marginalized timing model and with none (``M`` of shape
(ntoa, 0), the sampled-timing-model case).
"""

import numpy as np
import pytest

from enterprise_warp_tpu.ops import oracle as j_oracle
from enterprise_warp_tpu_torch.ops import oracle as t_oracle


def _inputs(seed, ntoa=120, ntm=4, nb=20):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 1.0, ntoa))
    sigma = 10 ** rng.uniform(-6.5, -5.5, ntoa)
    r = sigma * rng.standard_normal(ntoa)
    M = t[:, None] ** np.arange(ntm)[None, :]
    f = np.arange(1, nb // 2 + 1)
    T = np.concatenate([np.sin(2 * np.pi * np.outer(t, f)),
                        np.cos(2 * np.pi * np.outer(t, f))], axis=1)
    ndiag = sigma ** 2 * rng.uniform(0.8, 1.5, ntoa)
    b = 10 ** rng.uniform(-14, -12, nb)
    return r, sigma, ndiag, M, T, b


@pytest.mark.parametrize("ntm", [4, 0], ids=["marginalized", "no_tm"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_equal(seed, ntm):
    r, sigma, ndiag, M, T, b = _inputs(seed, ntm=ntm)
    want = j_oracle.oracle_loglike(r, sigma, ndiag, M, T, b)
    got = t_oracle.oracle_loglike(r, sigma, ndiag, M, T, b)
    assert np.isfinite(got) and got == want
    assert t_oracle.kernel_constant_offset(sigma, M) == \
        j_oracle.kernel_constant_offset(sigma, M)
