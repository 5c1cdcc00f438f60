"""Trained-flow artifact and the serve-facing model wrapper.

Counterpart of ``enterprise_warp_tpu/flows/model.py``.
:class:`FlowPosterior` is the durable product of
:func:`~.train.fit_flow`: the architecture spec, the weights, the
parameter names it models, and the digests (weights and training corpus)
that pin its identity. It saves and loads as one ``.npz`` through the
digest-verified ``checkpoint_replace`` path, with the reference's keys
(``meta``, the JSON of spec, names, digests and meta; ``p{i}``, the
weights in :func:`~.coupling.leaves` order), so an artifact written by
either package loads in the other.

:class:`FlowServeModel` adapts a posterior to the ``ServeDriver`` model
contract in one of two modes:

- ``sample``: a request row is a base draw ``u`` (standard normal, width
  ``ndim``); the result row is ``[T(u), log q(T(u))]``, so
  ``serve_out_dim = ndim + 1`` rides the driver's vector-result lane;
- ``log_prob``: a request row is a parameter vector; the result is its
  flow log-density.

The reference installs the evaluation with ``install_protocol``; here the
wrapper has its own ``loglike_batch`` (``samplers/evalproto.
eval_protocol`` takes any object with one). Both modes carry
``params = []`` (a flow row is not box-bounded: admission keeps its width
and finiteness gates and skips the prior box), ``sample_prior`` (request
rows for synthetic traces) and a ``topology_token`` (architecture,
weights, corpus and mode), so ``models/build.py:topology_fingerprint``
keys the AOT cache on the artifact: reloading the same artifact reuses
the warmed executables, retraining keys fresh ones.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from .. import F64, resolve_device
from ..io.writers import checkpoint_replace, resolve_checkpoint
from .coupling import (FlowSpec, _unflatten, base_logpdf, cuda_graphed,
                       flow_forward, flow_log_prob, flow_sample_logq, leaves,
                       params_from_numpy, params_to, spec_from_json,
                       spec_to_json)

__all__ = ["FlowPosterior", "FlowServeModel", "weights_digest"]


def weights_digest(params) -> str:
    """Order-stable digest of a flow's weights (the reference's: each
    leaf's shape and float64 bytes in ``tree_leaves`` order)."""
    h = hashlib.sha256()
    for leaf in leaves(params):
        arr = np.ascontiguousarray(
            leaf.detach().cpu().numpy().astype(np.float64)
            if torch.is_tensor(leaf) else np.asarray(leaf, dtype=np.float64))
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


class FlowPosterior:
    """A trained normalizing-flow posterior surrogate.

    Parameters
    ----------
    spec : :class:`~.coupling.FlowSpec` (static architecture).
    params : the weights, the port's dict of tensors or the reference's
        pytree of arrays; copied onto ``device``.
    param_names : names of the modelled dimensions, in order.
    data_digest : digest of the training corpus (from ``fit_flow``).
    device : where the flow evaluates (the card unless the caller asks
        for the CPU).
    """

    def __init__(self, spec: FlowSpec, params, param_names=None,
                 data_digest: str = "", meta: dict | None = None,
                 device=None):
        self.spec = spec
        self.device = resolve_device(device or "cuda")
        if all(torch.is_tensor(x) for x in leaves(params)):
            self.params = params_to(params, self.device)
        else:
            self.params = params_from_numpy(params, self.device)
        self.param_names = list(param_names or
                                [f"x{i}" for i in range(spec.ndim)])
        if len(self.param_names) != spec.ndim:
            raise ValueError("param_names length "
                             f"{len(self.param_names)} != ndim {spec.ndim}")
        self.data_digest = str(data_digest)
        self.meta = dict(meta or {})
        self._wd = None

    @property
    def ndim(self) -> int:
        return self.spec.ndim

    @property
    def weights_digest(self) -> str:
        if self._wd is None:
            self._wd = weights_digest(self.params)
        return self._wd

    @property
    def topology_token(self) -> str:
        """Identity for the serve AOT cache: architecture + weights +
        training corpus."""
        return (f"{self.spec.arch_token};w={self.weights_digest};"
                f"d={self.data_digest}")

    def to(self, device):
        """This posterior on ``device`` (itself where it already is)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return FlowPosterior(self.spec, self.params, self.param_names,
                             self.data_digest, self.meta, device=device)

    def sample(self, n, generator=None, context=None):
        """Draw ``n`` posterior samples from base draws of ``generator``
        (on the flow's device); returns ``(thetas, logq)``."""
        if context is not None:
            raise NotImplementedError(
                "context-conditioned batch sampling: call "
                "flow_sample_logq with a per-row context")
        u = torch.randn((int(n), self.ndim), generator=generator,
                        dtype=F64, device=self.device)
        with torch.no_grad():
            return flow_sample_logq(self.spec, self.params, u)

    def log_prob(self, thetas, context=None):
        """Exact flow log-density of each row of ``thetas``."""
        if context is not None:
            raise NotImplementedError(
                "context-conditioned log_prob: call flow_log_prob")
        thetas = torch.atleast_2d(torch.as_tensor(
            thetas, dtype=F64, device=self.device))
        with torch.no_grad():
            return flow_log_prob(self.spec, self.params, thetas)

    # ------------------------------------------------------- persistence

    def save(self, path: str) -> str:
        """Atomically persist the artifact; returns the content digest."""
        meta = {"spec": json.loads(spec_to_json(self.spec)),
                "param_names": self.param_names,
                "data_digest": self.data_digest,
                "meta": self.meta}
        payload = {"meta": np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)}
        for i, leaf in enumerate(leaves(self.params)):
            payload[f"p{i}"] = leaf.detach().cpu().numpy()
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **payload)
        return checkpoint_replace(tmp, path)

    @classmethod
    def load(cls, path: str, device=None) -> "FlowPosterior":
        usable = resolve_checkpoint(path, "flow posterior artifact")
        if usable is None:
            raise FileNotFoundError(f"no usable flow artifact at {path}")
        with np.load(usable) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            spec = spec_from_json(json.dumps(meta["spec"]))
            flat = [np.asarray(z[f"p{i}"])
                    for i in range(6 * spec.n_layers + 2)]
        return cls(spec, _unflatten(spec.n_layers, flat),
                   param_names=meta["param_names"],
                   data_digest=meta["data_digest"], meta=meta["meta"],
                   device=device)

    # ------------------------------------------------------------- serve

    def serve_view(self, mode: str = "sample",
                   name: str | None = None) -> "FlowServeModel":
        """A ``ServeDriver``-registrable model for this flow."""
        return FlowServeModel(self, mode=mode, name=name)


class FlowServeModel:
    """``ServeDriver`` adapter for a trained flow (module docstring)."""

    def __init__(self, flow: FlowPosterior, mode: str = "sample",
                 name: str | None = None):
        if mode not in ("sample", "log_prob"):
            raise ValueError(f"mode must be 'sample' or 'log_prob', "
                             f"got {mode!r}")
        self.flow = flow
        self.mode = mode
        self.name = name or f"flow_{mode}"
        self.ndim = flow.ndim
        self.param_names = list(flow.param_names)
        self.device = flow.device
        # no prior box: admission skips the bounds gate but keeps the
        # width/finiteness gates (a base draw is unbounded by design)
        self.params = []
        self.serve_out_dim = flow.ndim + 1 if mode == "sample" else 1
        self._graphs = {}

    @property
    def topology_token(self) -> str:
        return f"{self.flow.topology_token};mode={self.mode}"

    def loglike_batch(self, rows):
        """The served evaluation of rows ``(B, ndim)``: ``(B, ndim + 1)``
        draws and their log q in ``sample`` mode, ``(B,)`` log-densities
        in ``log_prob`` mode. On the card one CUDA graph per batch shape,
        captured at its first call (the serving layer's warm-up); the
        result is a copy, so a batch in flight keeps it."""
        rows = torch.as_tensor(rows, dtype=F64, device=self.device)
        if rows.device.type != "cuda":
            return self._evaluate(rows)
        key = tuple(rows.shape)
        if key not in self._graphs:
            self._graphs[key] = cuda_graphed(self._evaluate, rows)
        return self._graphs[key](rows).clone()

    def _evaluate(self, rows):
        fl = self.flow
        with torch.no_grad():
            if self.mode == "log_prob":
                return flow_log_prob(fl.spec, fl.params, rows)
            x, ld = flow_forward(fl.spec, fl.params, rows)
            return torch.cat([x, (base_logpdf(rows) - ld)[:, None]], dim=1)

    def sample_prior(self, rng, n=1):
        """Request rows for synthetic traces: base draws in sample mode
        (the natural input), standard-normal probes otherwise."""
        return rng.standard_normal((int(n), self.ndim))
