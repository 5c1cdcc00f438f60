"""Conditional coupling flows (RealNVP affine + RQ-spline) in torch.

Counterpart of ``enterprise_warp_tpu/flows/coupling.py``. A stack of
coupling layers with fixed permutations maps a standard-normal latent
``u`` to parameter space ``x = T(u)``; every transform is a function of
an explicit weight set, so one code path serves training
(:mod:`.train`), serving (:mod:`.model` behind ``ServeDriver``) and the
MH-corrected ``flow`` family of ``samplers/ptmcmc.py``.

Two coupling kinds, as the reference's:

- ``affine``: RealNVP shift-and-scale with a tanh-bounded log-scale
  (``s = s_cap * tanh(raw / s_cap)``);
- ``rqs``: monotonic rational-quadratic splines (Durkan et al.,
  arXiv:1906.04032) on ``[-tail_bound, tail_bound]`` with identity tails,
  analytic forward and inverse.

Conditioners are small tanh MLPs whose last layer starts at zero, so an
untrained flow is the standardization affine layer alone. An optional
context vector is concatenated onto the conditioner input.

Where the reference maps one parameter vector and batches with
``jax.vmap``, every function here takes a batch of rows ``(B, ndim)``
(and an optional ``(B, context_dim)`` context); the spline's bin lookup
is one ``torch.searchsorted(..., right=True)`` over the batch. The unused
branch of each ``where`` is computed on clipped values, as the
reference's, so no NaN reaches a gradient.

**The weights** are a dict of float64 tensors laid out as the reference's
pytree::

    {"layers": [{"b1", "b2", "b3", "w1", "w2", "w3"}, ...],
     "loc": (ndim,), "log_scale": (ndim,)}

with ``w1`` ``(d1 + context_dim, hidden)``, ``w2`` ``(hidden, hidden)``,
``w3`` ``(hidden, out)``. :func:`leaves` lists them in the order of
``jax.tree_util.tree_leaves`` of the reference's dict (``layers`` first,
each layer's ``b1, b2, b3, w1, w2, w3``, then ``loc``, ``log_scale``):
that order fixes ``weights_digest`` and the ``.npz`` layout of
:mod:`.model`. :func:`params_from_numpy` and :func:`params_to_numpy`
carry a weight set across packages.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from .. import F64, resolve_device
from ..ops.kernel import _row_sum

__all__ = [
    "FlowSpec", "init_flow", "set_standardization",
    "flow_forward", "flow_inverse", "flow_log_prob", "flow_sample_logq",
    "spec_to_json", "spec_from_json", "base_logpdf",
    "leaves", "params_from_numpy", "params_to_numpy", "params_to",
    "cuda_graphed",
]

# softplus(raw + _DERIV_SHIFT) == 1 at raw == 0: zero-initialized
# conditioners yield unit interior derivatives, i.e. an identity spline
_DERIV_SHIFT = float(np.log(np.e - 1.0))
_MIN_BIN = 1e-3
_MIN_DERIV = 1e-4
_LAYER_KEYS = ("b1", "b2", "b3", "w1", "w2", "w3")
_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class FlowSpec:
    """Static architecture of a coupling flow (hashable, JSON round trip);
    ``perms`` holds one fixed permutation per layer as a tuple of ints."""

    ndim: int
    n_layers: int
    hidden: int
    kind: str = "affine"          # "affine" | "rqs"
    context_dim: int = 0
    n_bins: int = 8
    tail_bound: float = 5.0
    s_cap: float = 4.0
    perms: tuple = ()

    @property
    def d1(self) -> int:
        return self.ndim // 2

    @property
    def d2(self) -> int:
        return self.ndim - self.d1

    @property
    def arch_token(self) -> str:
        """Stable architecture digest input (the reference's string)."""
        return ("cflow-v1;ndim=%d;layers=%d;hidden=%d;kind=%s;ctx=%d;"
                "bins=%d;tail=%g;scap=%g;perms=%s"
                % (self.ndim, self.n_layers, self.hidden, self.kind,
                   self.context_dim, self.n_bins, self.tail_bound,
                   self.s_cap, self.perms))


def spec_to_json(spec: FlowSpec) -> str:
    return json.dumps(dataclasses.asdict(spec))


def spec_from_json(text: str) -> FlowSpec:
    d = json.loads(text)
    d["perms"] = tuple(tuple(int(i) for i in p) for p in d["perms"])
    return FlowSpec(**d)


def _conditioner_out_dim(spec: FlowSpec) -> int:
    if spec.kind == "affine":
        return 2 * spec.d2
    if spec.kind == "rqs":
        return spec.d2 * (3 * spec.n_bins - 1)
    raise ValueError(f"unknown coupling kind {spec.kind!r}")


# ---------------------------------------------------------------- weights

def leaves(params):
    """The weight tensors in the reference's ``tree_leaves`` order."""
    out = [lp[k] for lp in params["layers"] for k in _LAYER_KEYS]
    return out + [params["loc"], params["log_scale"]]


def _unflatten(n_layers, flat):
    """The weight dict of :func:`leaves`' order ``flat``."""
    layers = [dict(zip(_LAYER_KEYS, flat[6 * i:6 * i + 6]))
              for i in range(n_layers)]
    return {"layers": layers, "loc": flat[6 * n_layers],
            "log_scale": flat[6 * n_layers + 1]}


def params_from_numpy(tree, device="cuda"):
    """The port's weight dict from the reference's pytree (numpy or any
    array the dict holds), as float64 tensors on ``device``."""
    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=F64,
                               device=device)
    return {"layers": [{k: t(lp[k]) for k in _LAYER_KEYS}
                       for lp in tree["layers"]],
            "loc": t(tree["loc"]), "log_scale": t(tree["log_scale"])}


def params_to_numpy(params):
    """The reference's pytree layout (``layers`` a tuple of dicts) with
    float64 numpy leaves."""
    def a(x):
        return x.detach().cpu().numpy().astype(np.float64)
    return {"layers": tuple({k: a(lp[k]) for k in _LAYER_KEYS}
                            for lp in params["layers"]),
            "loc": a(params["loc"]), "log_scale": a(params["log_scale"])}


def params_to(params, device):
    """The weight dict on ``device`` (the same tensors where they already
    lie there)."""
    return _unflatten(len(params["layers"]),
                      [x.to(device=device, dtype=F64)
                       for x in leaves(params)])


def init_flow(seed, ndim, n_layers=6, hidden=64, context_dim=0,
              kind="affine", n_bins=8, tail_bound=5.0, s_cap=4.0,
              device=None):
    """Build a flow: returns ``(spec, params)``, the weights on ``device``
    (the card unless the caller asks for the CPU).

    ``seed`` is the integer the reference draws from its key
    (``int(jax.random.randint(key, (), 0, int32 max))``): the permutations
    and the weights come from ``np.random.default_rng(seed)`` in the
    reference's order, so the same integer gives the same flow."""
    dev = resolve_device(device or "cuda")
    ndim = int(ndim)
    if ndim < 2:
        raise ValueError("coupling flows need ndim >= 2 "
                         f"(got {ndim}); use a KDE/analytic surrogate "
                         "for 1-D posteriors")
    rng = np.random.default_rng(int(seed))
    perms = []
    for i in range(n_layers):
        if i % 2 == 0:
            perms.append(tuple(range(ndim - 1, -1, -1)))   # reversal
        else:
            perms.append(tuple(int(v) for v in rng.permutation(ndim)))
    spec = FlowSpec(ndim=ndim, n_layers=int(n_layers), hidden=int(hidden),
                    kind=str(kind), context_dim=int(context_dim),
                    n_bins=int(n_bins), tail_bound=float(tail_bound),
                    s_cap=float(s_cap), perms=tuple(perms))
    out_dim = _conditioner_out_dim(spec)
    in_dim = spec.d1 + spec.context_dim
    layers = []
    for _ in range(n_layers):
        # He-ish init for the tanh trunk; zero final layer => identity
        w1 = rng.standard_normal((in_dim, hidden)) / np.sqrt(max(in_dim, 1))
        w2 = rng.standard_normal((hidden, hidden)) / np.sqrt(hidden)
        layers.append({"b1": np.zeros(hidden), "b2": np.zeros(hidden),
                       "b3": np.zeros(out_dim), "w1": w1, "w2": w2,
                       "w3": np.zeros((hidden, out_dim))})
    tree = {"layers": layers, "loc": np.zeros(ndim),
            "log_scale": np.zeros(ndim)}
    return spec, params_from_numpy(tree, dev)


def set_standardization(params, mean, std):
    """Fold data moments into the outermost affine layer
    (``x = loc + exp(log_scale) * y``), so a fresh flow maps N(0, I) onto
    the corpus' per-dimension moments."""
    std = np.maximum(np.asarray(std, dtype=np.float64), 1e-12)
    dev = params["loc"].device
    return dict(params,
                loc=torch.as_tensor(np.asarray(mean, dtype=np.float64),
                                    dtype=F64, device=dev).clone(),
                log_scale=torch.as_tensor(np.log(std), dtype=F64,
                                          device=dev).clone())


# ------------------------------------------------------------ conditioner

# (perms, device) -> per layer (perm, inverse perm) index tensors, made
# once: an index copied to the card inside a sampler step would be a
# host synchronisation
_PERM_INDEX: dict = {}


def _perm_index(spec, device):
    key = (spec.perms, str(device))
    idx = _PERM_INDEX.get(key)
    if idx is None:
        idx = [(torch.as_tensor(p, dtype=torch.long, device=device),
                torch.as_tensor(np.argsort(np.asarray(p)), dtype=torch.long,
                                device=device)) for p in spec.perms]
        _PERM_INDEX[key] = idx
    return idx


def _mlp(lp, inp):
    h = torch.tanh(inp @ lp["w1"] + lp["b1"])
    h = torch.tanh(h @ lp["w2"] + lp["b2"])
    return h @ lp["w3"] + lp["b3"]


def _cond_input(spec, va, context):
    if spec.context_dim:
        if context is None:
            raise ValueError("flow was built with context_dim="
                             f"{spec.context_dim} but no context given")
        return torch.cat([va, context], dim=-1)
    return va


def _affine_split(spec, raw):
    raw_s, t = raw[:, :spec.d2], raw[:, spec.d2:]
    return spec.s_cap * torch.tanh(raw_s / spec.s_cap), t


# ------------------------------------------------------------ RQ splines

def _rqs_knots(spec, raw):
    """Per-row, per-dim spline knots from raw conditioner output
    ``(B, d2 (3K - 1))``: ``xk``, ``yk``, ``dk`` ``(B, d2, K + 1)``, the
    boundary derivatives pinned to 1 (C1 with the identity tails)."""
    k, b = spec.n_bins, spec.tail_bound
    raw = raw.reshape(raw.shape[0], spec.d2, 3 * k - 1)
    rw, rh, rd = raw[..., :k], raw[..., k:2 * k], raw[..., 2 * k:]
    w = _MIN_BIN + (1.0 - _MIN_BIN * k) * torch.softmax(rw, dim=-1)
    h = _MIN_BIN + (1.0 - _MIN_BIN * k) * torch.softmax(rh, dim=-1)
    zero = torch.zeros(raw.shape[:2] + (1,), dtype=raw.dtype,
                       device=raw.device)
    xk = -b + 2.0 * b * torch.cat([zero, torch.cumsum(w, dim=-1)], dim=-1)
    yk = -b + 2.0 * b * torch.cat([zero, torch.cumsum(h, dim=-1)], dim=-1)
    d_int = _MIN_DERIV + torch.nn.functional.softplus(rd + _DERIV_SHIFT)
    ones = zero + 1.0
    return xk, yk, torch.cat([ones, d_int, ones], dim=-1)


def _gather_bin(xk, yk, dk, k):
    """The edges of bin ``k`` (B, d2, 1) in ``xk``, ``yk`` and ``dk``."""
    def at(t, i):
        return torch.gather(t, -1, i)[..., 0]
    return (at(xk, k), at(xk, k + 1), at(yk, k), at(yk, k + 1), at(dk, k),
            at(dk, k + 1))


def _rqs_fwd(x, xk, yk, dk, b):
    """Monotone RQ spline y(x) and log dy/dx, element by element."""
    inside = (x > -b) & (x < b)
    xc = torch.clamp(x, -b, b)
    k = torch.searchsorted(xk.contiguous(), xc[..., None].contiguous(),
                           right=True) - 1
    k = k.clamp(0, xk.shape[-1] - 2)
    x0, x1, y0, y1, d0, d1 = _gather_bin(xk, yk, dk, k)
    wid = x1 - x0
    hei = y1 - y0
    sk = hei / wid
    xi = (xc - x0) / wid
    om = 1.0 - xi
    den = sk + (d1 + d0 - 2.0 * sk) * xi * om
    y = y0 + hei * (sk * xi * xi + d0 * xi * om) / den
    ld = (2.0 * torch.log(sk)
          + torch.log(d1 * xi * xi + 2.0 * sk * xi * om + d0 * om * om)
          - 2.0 * torch.log(den))
    return torch.where(inside, y, x), torch.where(inside, ld, 0.0)


def _rqs_inv(y, xk, yk, dk, b):
    """Analytic spline inverse x(y) and log dx/dy (Durkan et al. eq.
    6-8), element by element."""
    inside = (y > -b) & (y < b)
    yc = torch.clamp(y, -b, b)
    k = torch.searchsorted(yk.contiguous(), yc[..., None].contiguous(),
                           right=True) - 1
    k = k.clamp(0, yk.shape[-1] - 2)
    x0, x1, y0, y1, d0, d1 = _gather_bin(xk, yk, dk, k)
    wid = x1 - x0
    hei = y1 - y0
    sk = hei / wid
    dy = yc - y0
    a = hei * (sk - d0) + dy * (d1 + d0 - 2.0 * sk)
    bq = hei * d0 - dy * (d1 + d0 - 2.0 * sk)
    c = -sk * dy
    disc = torch.clamp(bq * bq - 4.0 * a * c, min=0.0)
    xi = torch.clamp(2.0 * c / (-bq - torch.sqrt(disc)), 0.0, 1.0)
    om = 1.0 - xi
    x = x0 + xi * wid
    den = sk + (d1 + d0 - 2.0 * sk) * xi * om
    # log dx/dy = -log dy/dx evaluated at the recovered xi
    ld = -(2.0 * torch.log(sk)
           + torch.log(d1 * xi * xi + 2.0 * sk * xi * om + d0 * om * om)
           - 2.0 * torch.log(den))
    return torch.where(inside, x, y), torch.where(inside, ld, 0.0)


# ------------------------------------------------------------- transforms

def _layer(spec, lp, idx, v, context, inverse):
    perm, inv_perm = idx
    vp = v[:, perm]
    va, vb = vp[:, :spec.d1], vp[:, spec.d1:]
    raw = _mlp(lp, _cond_input(spec, va, context))
    if spec.kind == "affine":
        s, t = _affine_split(spec, raw)
        if inverse:
            ub, ld = (vb - t) * torch.exp(-s), -_row_sum(s)
        else:
            ub, ld = vb * torch.exp(s) + t, _row_sum(s)
    else:
        xk, yk, dk = _rqs_knots(spec, raw)
        spline = _rqs_inv if inverse else _rqs_fwd
        ub, lds = spline(vb, xk, yk, dk, spec.tail_bound)
        ld = _row_sum(lds)
    return torch.cat([va, ub], dim=-1)[:, inv_perm], ld


def flow_forward(spec, params, u, context=None):
    """Latent -> data on rows ``u`` (B, ndim): ``(x, log|det dT/du|)``."""
    idx = _perm_index(spec, u.device)
    v = u
    logdet = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    for lp, pi in zip(params["layers"], idx):
        v, ld = _layer(spec, lp, pi, v, context, inverse=False)
        logdet = logdet + ld
    x = params["loc"] + torch.exp(params["log_scale"]) * v
    return x, logdet + torch.sum(params["log_scale"])


def flow_inverse(spec, params, x, context=None):
    """Data -> latent on rows ``x``: ``(u, log|det dT^-1/dx|)``."""
    idx = _perm_index(spec, x.device)
    v = (x - params["loc"]) * torch.exp(-params["log_scale"])
    logdet = -torch.sum(params["log_scale"])
    for lp, pi in zip(reversed(params["layers"]), reversed(idx)):
        v, ld = _layer(spec, lp, pi, v, context, inverse=True)
        logdet = logdet + ld
    return v, logdet


def base_logpdf(u):
    """Standard-normal log-density of each latent row."""
    return -0.5 * _row_sum(u * u) - 0.5 * u.shape[-1] * _LOG_2PI


def flow_log_prob(spec, params, x, context=None):
    """Exact flow log-density ``log q(x)`` of each row of ``x``."""
    u, ld = flow_inverse(spec, params, x, context)
    return base_logpdf(u) + ld


def flow_sample_logq(spec, params, u, context=None):
    """Push base draws through the flow: ``(x, log q(x))`` with
    ``log q(x) = log N(u; 0, I) - log|det dT/du|``."""
    x, ld = flow_forward(spec, params, u, context)
    return x, base_logpdf(u) - ld


def cuda_graphed(fn, *examples, warmup=3):
    """``fn`` of tensors shaped as ``examples`` (CUDA tensors), captured
    once as a CUDA graph: the returned callable copies its arguments into
    the graph's input buffers, replays the graph and returns ``fn``'s
    outputs, which the next call overwrites. One replay stands in for the
    hundreds of small launches of a flow pass (the reference's jit fuses
    them), with the same kernels on the same shapes. ``fn`` must draw no
    random numbers and read nothing back to the host; ``warmup`` eager
    calls on a side stream come first (what capturing autograd needs)."""
    dev = examples[0].device
    static = [e.detach().clone() for e in examples]
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(*static)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)

    def run(*args):
        for buf, a in zip(static, args):
            buf.copy_(a)
        graph.replay()
        return out
    run.graph = graph
    return run

