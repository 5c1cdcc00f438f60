"""Maximum-likelihood flow training: hand-rolled Adam, blocked.

Counterpart of ``enterprise_warp_tpu/flows/train.py``. Trains a
:mod:`.coupling` flow on posterior draws from the samplers (PT, HMC and
nested chains are the corpus) with the reference's Adam (no optimizer
library; one ``torch._foreach`` pass over the weights a step). The
reference scans ``block`` steps in one jitted call; here the steps run
on the device in a Python loop, each step's loss is kept there, and the
host reads the block's mean loss once: one host synchronisation a block,
as the reference's dispatch.

On the card one step's minibatch gather, loss and gradient are one CUDA
graph (``coupling.cuda_graphed``, captured at the fit's start), replayed
a step after the minibatch's indices are drawn, and the Adam pass runs
after it. Minibatch indices come from a ``torch.Generator`` on the device
seeded with ``seed``; the flow's permutations and initial weights from
``init_flow(seed, ...)`` (the reference derives both from a threefry key,
so the two packages' fits differ draw by draw and agree in outcome).

Telemetry, as the reference's: a ``flow_train`` event opens and closes
the fit, a heartbeat per block carries ``phase="flow_train"`` and the
running loss, and the fit runs in a ``flow.fit`` span. The training state
(weights, both Adam moments, the generator's state and the step)
checkpoints through ``io/writers.checkpoint_replace`` and resumes through
``resolve_checkpoint``, with the spec and the corpus digest checked.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import F64, resolve_device
from ..io.writers import checkpoint_replace, resolve_checkpoint
from ..utils import telemetry
from ..utils.logging import get_logger
from ..utils.profiling import span
from .coupling import (_unflatten, cuda_graphed, flow_log_prob, init_flow,
                       leaves, set_standardization, spec_to_json)

__all__ = ["fit_flow", "data_digest", "flow_nll"]

_log = get_logger("ewt.flows.train")

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def data_digest(samples) -> str:
    """Stable digest of a training corpus (shape + float64 bytes)."""
    arr = np.ascontiguousarray(np.asarray(samples, dtype=np.float64))
    h = hashlib.sha256()
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()[:16]


def flow_nll(spec, params, xb, cb=None):
    """The training loss: minus the mean flow log-density of the rows
    ``xb`` (with their contexts ``cb``)."""
    return -torch.mean(flow_log_prob(spec, params, xb, cb))


def _adam_step(p, m, v, g, t, lr):
    """One Adam update of the weight lists ``p``, ``m``, ``v`` from the
    gradients ``g``, in place; ``t`` is the 1-based step count. The
    reference's arithmetic: ``p - lr (m / c1) / (sqrt(v / c2) + eps)``."""
    torch._foreach_mul_(m, _B1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - _B1))
    torch._foreach_mul_(v, _B2)
    torch._foreach_add_(v, torch._foreach_mul(
        torch._foreach_mul(g, 1.0 - _B2), g))
    c1 = 1.0 - _B1 ** t
    c2 = 1.0 - _B2 ** t
    den = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, _EPS)
    step = torch._foreach_mul(torch._foreach_div(m, c1), lr)
    torch._foreach_sub_(p, torch._foreach_div(step, den))


def _save_state(path, spec, p, m, v, gen, step, dd):
    payload = {"gen_state": gen.get_state().numpy(),
               "step": np.asarray(step),
               "spec": np.frombuffer(spec_to_json(spec).encode(),
                                     dtype=np.uint8),
               "data_digest": np.frombuffer(dd.encode(), dtype=np.uint8)}
    for tag, ls in (("p", p), ("m", m), ("v", v)):
        for i, leaf in enumerate(ls):
            payload[f"{tag}{i}"] = leaf.detach().cpu().numpy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    return checkpoint_replace(tmp, path)


def _load_state(path, spec, n_leaves, dd, dev):
    usable = resolve_checkpoint(path, "flow training state")
    if usable is None:
        return None
    with np.load(usable) as z:
        saved_spec = bytes(z["spec"]).decode()
        saved_dd = bytes(z["data_digest"]).decode()
        if saved_spec != spec_to_json(spec) or saved_dd != dd \
                or "gen_state" not in z:
            _log.warning("flow checkpoint %s is for a different "
                         "architecture or corpus; restarting", usable)
            return None

        def flat(tag):
            return [torch.as_tensor(z[f"{tag}{i}"], dtype=F64, device=dev)
                    for i in range(n_leaves)]
        return (flat("p"), flat("m"), flat("v"),
                torch.from_numpy(np.array(z["gen_state"], dtype=np.uint8)),
                int(z["step"]))


def fit_flow(samples, *, context=None, n_layers=6, hidden=64,
             kind="affine", n_bins=8, tail_bound=5.0, s_cap=4.0,
             steps=2000, batch=256, lr=1e-3, seed=0, block=100,
             checkpoint_path=None, ckpt_every_blocks=5, resume=True,
             device=None):
    """Fit a flow to posterior draws by maximum likelihood.

    Parameters
    ----------
    samples : (n, ndim) array of posterior draws (chain rows).
    context : optional (n, context_dim) per-row conditioning vectors.
    steps/batch/lr : the Adam schedule; the host reads the loss once per
        ``block`` steps.
    checkpoint_path : optional ``.npz`` path; the training state rotates
        through ``checkpoint_replace`` every ``ckpt_every_blocks`` blocks
        and at the end, and a fit resumes from it when ``resume`` and the
        spec and corpus digest match.
    device : where the fit runs (the card unless the caller asks for the
        CPU).

    Returns ``(spec, params, info)``: the weights as tensors on
    ``device`` and ``info`` with the reference's keys (``steps``,
    ``final_loss``, ``loss_curve``, ``data_digest``, ``n_samples``,
    ``resumed_at``).
    """
    dev = resolve_device(device or "cuda")
    host = np.asarray(samples, dtype=np.float64)
    data = torch.as_tensor(host, dtype=F64, device=dev)
    n, ndim = data.shape
    ctx = None
    context_dim = 0
    if context is not None:
        ctx = torch.as_tensor(np.asarray(context, dtype=np.float64),
                              dtype=F64, device=dev)
        context_dim = int(ctx.shape[1])
    dd = data_digest(host)

    spec, params = init_flow(seed, ndim, n_layers=n_layers, hidden=hidden,
                             context_dim=context_dim, kind=kind,
                             n_bins=n_bins, tail_bound=tail_bound,
                             s_cap=s_cap, device=dev)
    params = set_standardization(params, host.mean(0), host.std(0))
    p = leaves(params)
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    step0 = 0
    if checkpoint_path and resume:
        state = _load_state(checkpoint_path, spec, len(p), dd, dev)
        if state is not None:
            p, m, v, gen_state, step0 = state
            gen.set_state(gen_state)
            _log.info("flow training resumed at step %d from %s",
                      step0, checkpoint_path)
    for x in p:
        x.requires_grad_(True)

    def loss_grad(idx):
        loss = flow_nll(spec, _unflatten(spec.n_layers, p), data[idx],
                        None if ctx is None else ctx[idx])
        return (loss, *torch.autograd.grad(loss, p))
    if dev.type == "cuda":
        loss_grad = cuda_graphed(loss_grad, torch.zeros(
            batch, dtype=torch.long, device=dev))

    rec = telemetry.active_recorder()
    if rec:
        rec.event("flow_train", phase="start", ndim=int(ndim),
                  n_samples=int(n), kind=spec.kind,
                  n_layers=spec.n_layers, hidden=spec.hidden,
                  steps=int(steps), batch=int(batch), lr=float(lr),
                  resumed_at=int(step0), data_digest=dd)

    n_blocks = max((steps - step0) + block - 1, 0) // block
    loss_curve = []
    with span("flow.fit", steps=steps, blocks=n_blocks) as sp:
        done = step0
        for bi in range(n_blocks):
            losses = []
            for i in range(block):
                idx = torch.randint(0, n, (batch,), generator=gen,
                                    device=dev)
                loss, *g = loss_grad(idx)
                losses.append(loss.detach().clone())
                with torch.no_grad():
                    _adam_step(p, m, v, g, float(done + i + 1), lr)
            done += block
            # the block's one host read: its mean loss (heartbeat, curve)
            bl = float(torch.stack(losses).mean())
            loss_curve.append(bl)
            if rec:
                rec.heartbeat(phase="flow_train", step=int(done),
                              steps=int(steps), loss=round(bl, 4))
            if (checkpoint_path
                    and ((bi + 1) % max(ckpt_every_blocks, 1) == 0
                         or bi == n_blocks - 1)):
                _save_state(checkpoint_path, spec, p, m, v, gen, done, dd)
        sp.attrs = dict(getattr(sp, "attrs", None) or {}, final_loss=(
            loss_curve[-1] if loss_curve else None))

    params = _unflatten(spec.n_layers, [x.detach() for x in p])
    info = {
        "steps": int(done if n_blocks else step0),
        "final_loss": loss_curve[-1] if loss_curve else None,
        "loss_curve": loss_curve,
        "data_digest": dd,
        "n_samples": int(n),
        "resumed_at": int(step0),
    }
    if rec:
        rec.event("flow_train", phase="end", **{
            k: info[k] for k in ("steps", "final_loss", "data_digest",
                                 "n_samples")})
    return spec, params, info
