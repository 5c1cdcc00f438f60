# ewt: allow-precision module — the product-space walkers and their lnL are
# float64 sampler state
"""Product-space hypermodel: Bayesian model selection in one chain.

Counterpart of ``enterprise_warp_tpu/samplers/hypermodel.py``: the
sampler explores the union of all models' parameters plus a continuous
model index ``nmodel``; rounding ``nmodel`` selects which model's
likelihood is active, and the posterior mass per index bin yields Bayes
factors (the results layer's ``--logbf``).

The reference evaluates every member for every walker under a vmapped
``lax.switch`` and keeps the selected one. Here each member runs only on
the walkers whose index selects it (gathered, evaluated, scattered
back), and a member that no walker selects is not called at all: the
lnL per walker is the same, and the card does each member's work once.
"""

from __future__ import annotations

import torch

from .. import F64
from ..models.build import PulsarLikelihood
from ..models.prior_mixin import PriorMixin
from ..models.priors import Parameter, Uniform


class HyperModelLikelihood(PriorMixin):
    """Union-parameter product-space likelihood over ``{model_id: like}``.

    The parameter vector is the deduplicated union of all models'
    parameters in model order (shared names collapse), with ``nmodel``
    appended last (uniform on [-0.5, nmodels - 0.5]). Every member must
    live on the same device.
    """

    # ewt: allow-host-sync — build time: each member's parameter index goes to
    # the device once
    def __init__(self, likes: dict):
        self.likes = dict(sorted(likes.items()))
        self.nmodels = len(self.likes)
        devices = {torch.device(like.device) for like in self.likes.values()}
        if len(devices) != 1:
            raise ValueError(f"hypermodel members on several devices: "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()

        self.params = []
        seen = {}
        for like in self.likes.values():
            for p in like.params:
                if p.name not in seen:
                    seen[p.name] = len(self.params)
                    self.params.append(p)
        self.params.append(Parameter("nmodel",
                                     Uniform(-0.5, self.nmodels - 0.5)))
        self.param_names = [p.name for p in self.params]
        self.ndim = len(self.params)

        # union of the members' white-noise pair metadata (the sampler's
        # ns family), remapped and name-deduplicated
        pair_seen = set()
        self.noise_pairs = []
        for like in self.likes.values():
            for (i, j, s2) in (getattr(like, "noise_pairs", None) or []):
                key = like.param_names[i]
                if key not in pair_seen:
                    pair_seen.add(key)
                    self.noise_pairs.append(
                        (seen[key], seen[like.param_names[j]], s2))

        self._index = [torch.tensor([seen[p.name] for p in like.params],
                                    dtype=torch.long, device=self.device)
                       for like in self.likes.values()]

    as_theta = PulsarLikelihood.as_theta

    def loglike_batch(self, theta):
        """lnL at ``(W, ndim)`` points -> ``(W,)`` float64: each member on
        the walkers it is selected by, the active member of a walker being
        ``clip(round(nmodel), 0, nmodels - 1)`` (round half to even, as
        ``jnp.round``)."""
        theta = self.as_theta(theta)
        k = torch.clamp(torch.round(theta[:, -1]), 0,
                        self.nmodels - 1).to(torch.long)
        out = torch.zeros(theta.shape[0], dtype=F64, device=self.device)
        # the members' kernel-route rejections, walker by walker
        rej = torch.zeros(theta.shape[0], dtype=torch.bool,
                          device=self.device)
        for m, (like, idx) in enumerate(zip(self.likes.values(),
                                            self._index)):
            # ewt: allow-host-sync — each member evaluates only the walkers
            # that select it: the row count is data-dependent, one read per
            # member a call
            rows = torch.nonzero(k == m).flatten()
            if rows.numel() == 0:
                continue
            sub = theta.index_select(0, rows).index_select(1, idx)
            out = out.index_copy(0, rows, like.loglike_batch(sub))
            if getattr(like, "last_reject", None) is not None:
                rej = rej.index_copy(0, rows, like.last_reject)
        self.last_reject = rej
        return out
