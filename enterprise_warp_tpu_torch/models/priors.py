"""Prior distributions and named sampling parameters.

Counterpart of ``enterprise_warp_tpu/models/priors.py``: plain frozen
dataclasses whose ``logpdf`` / ``from_unit`` act elementwise on float64
tensors, and whose ``sample`` draws from a numpy ``Generator`` (the
reference draws its initial ensembles with numpy too, so the two packages
start from the same points for the same seed).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Uniform:
    lo: float
    hi: float

    def logpdf(self, x):
        inside = (x >= self.lo) & (x <= self.hi)
        return torch.where(inside,
                           torch.full_like(x, -math.log(self.hi - self.lo)),
                           torch.full_like(x, -math.inf))

    def from_unit(self, u):
        """Unit-cube transform."""
        return self.lo + (self.hi - self.lo) * u

    def sample(self, rng):
        return rng.uniform(self.lo, self.hi)


@dataclass(frozen=True)
class Normal:
    mu: float
    sigma: float

    def logpdf(self, x):
        z = (x - self.mu) / self.sigma
        return -0.5 * z * z - math.log(self.sigma) \
            - 0.5 * math.log(2 * math.pi)

    def from_unit(self, u):
        return self.mu + self.sigma * math.sqrt(2.0) * torch.erfinv(2 * u - 1)

    def sample(self, rng):
        return rng.normal(self.mu, self.sigma)


@dataclass(frozen=True)
class LinearExp:
    """log10-space parameter whose implied amplitude prior is uniform
    (Enterprise's LinearExp, ``gwb_lgA_prior: linexp``)."""
    lo: float
    hi: float

    def logpdf(self, x):
        inside = (x >= self.lo) & (x <= self.hi)
        norm = math.log(math.log(10.0)) - \
            math.log(10.0 ** self.hi - 10.0 ** self.lo)
        return torch.where(inside, norm + x * math.log(10.0),
                           torch.full_like(x, -math.inf))

    def from_unit(self, u):
        lo10, hi10 = 10.0 ** self.lo, 10.0 ** self.hi
        return torch.log10(lo10 + u * (hi10 - lo10))

    def sample(self, rng):
        return float(np.log10(10.0 ** self.lo + rng.uniform()
                              * (10.0 ** self.hi - 10.0 ** self.lo)))


@dataclass(frozen=True)
class Constant:
    """Fixed parameter: not sampled; its value is injected at model build
    (scalar-prior / noisefile-fixing convention)."""
    value: float


@dataclass(frozen=True)
class Parameter:
    """A named model parameter bound to a prior."""
    name: str
    prior: object

    @property
    def fixed(self) -> bool:
        return isinstance(self.prior, Constant)


def interpret_white_noise_prior(spec):
    """A scalar means Constant (value filled from noisefiles later); a
    pair means Uniform bounds."""
    if np.isscalar(spec):
        return Constant(float(spec))
    return Uniform(float(spec[0]), float(spec[1]))
