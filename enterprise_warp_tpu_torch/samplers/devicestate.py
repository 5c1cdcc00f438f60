# ewt: allow-precision module — host snapshots move sampler state through one
# float64 buffer (integers up to 2^53 round-trip exactly)
"""Device-resident sampler state: the block-commit snapshot and the
double-buffered host pipeline.

Counterpart of ``host_snapshot`` and ``HostPipeline`` in
``enterprise_warp_tpu/samplers/devicestate.py``. A sampler keeps its
state on the card between blocks and reads it once per block:

- :func:`host_snapshot` packs a block's outputs into one float64 buffer
  on the device, brings it back in ONE non-blocking device-to-host copy
  into pinned memory and waits for it with one stream sync;
- :class:`HostPipeline` parks a block's host work (checkpoint write, log
  line) and runs it after the next block has been enqueued, so the card
  computes block ``k+1`` while the host finishes block ``k``.

The chain axis: :func:`chain_slice` is the rank's walker slice, the
port's stand-in for the reference's ``chain_sharding`` (an evaluation
split, ``samplers/ptmcmc.py``), and :func:`host_pull` the one-leaf
sibling of :func:`host_snapshot`.

Placement: :func:`resolve_placement` is the device a likelihood's
resident state lives on (the likelihood's own; every rank's tensors live
on its own device, so the reference's replicated-over-a-mesh placement
has no counterpart), and :func:`place_resident` puts one state leaf
there: a tensor already resident passes through, host numpy is copied,
never aliased.
"""

from __future__ import annotations

import numpy as np
import torch


# ewt: allow-host-sync — the sanctioned block-boundary snapshot: one non-
# blocking copy into pinned memory and one stream sync
def host_snapshot(tree):
    """Host copy of a dict of tensors, all on one device: one float64
    buffer on the device, one non-blocking copy into pinned host memory,
    one sync of the current stream. Returns numpy arrays of the leaves'
    shapes and dtypes (integers up to 2^53 round-trip exactly)."""
    leaves = list(tree.values())
    flat = torch.cat([v.detach().reshape(-1).to(torch.float64)
                      for v in leaves])
    if flat.device.type == "cuda":
        host = torch.empty(flat.shape, dtype=torch.float64,
                           pin_memory=True)
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
    else:
        host = flat
    buf = host.numpy()
    out, at = {}, 0
    for k, v in zip(tree, leaves):
        n = v.numel()
        dtype = torch.empty((), dtype=v.dtype).numpy().dtype
        out[k] = buf[at:at + n].reshape(tuple(v.shape)).astype(dtype)
        at += n
    return out


# ewt: allow-host-sync — the one-leaf host snapshot: a device->host copy by
# design
def host_pull(v):
    """Host copy of ONE tensor (the one-leaf :func:`host_snapshot`): a
    numpy array that owns its memory, never a view of a device buffer a
    later launch may overwrite."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True).numpy()
    return np.array(v)


def resolve_placement(like):
    """The device a likelihood's resident state lives on: its own
    ``device`` (the CPU for an object without one). Resolve once per
    model."""
    return torch.device(getattr(like, "device", None) or "cpu")


# ewt: allow-host-sync — places host state on the device once (a resume, a
# fresh start)
def place_resident(v, placement):
    """One state leaf as a float64 tensor on ``placement``: a tensor
    already there passes through, anything else is copied (a REAL copy:
    a caller may reuse or free its host rows while the device reads
    them)."""
    if isinstance(v, torch.Tensor) and v.device == placement \
            and v.dtype == torch.float64:
        return v
    if isinstance(v, torch.Tensor):
        return v.to(device=placement, dtype=torch.float64, copy=True)
    return torch.tensor(np.asarray(v, dtype=np.float64),
                        dtype=torch.float64, device=placement)


def chain_slice(mesh, W):
    """This rank's contiguous walker slice of a ``W``-walker batch under
    a ``chain`` layout (``parallel.ShardLayout``), or None without one
    (None, another axis, or one shard). ``W`` must divide by the
    layout's width."""
    if mesh is None or getattr(mesh, "axis", None) != "chain" \
            or mesh.nshard < 2:
        return None
    if W % mesh.nshard:
        raise ValueError(
            f"chain-axis sharding needs ntemps*nchains divisible by the "
            f"layout's width: W={W} over {mesh.nshard} ranks")
    n = W // mesh.nshard
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


class HostPipeline:
    """One-deep deferred host-work queue, the double buffer.

    ``defer(fn)`` parks one block's host work; ``run_pending()`` is called
    right after the next block is enqueued, so ``fn`` runs while the card
    computes; ``flush()`` drains it (end of run). Work runs in defer
    order, exactly once."""

    def __init__(self):
        self._pending = None

    def defer(self, fn):
        self.run_pending()          # strict ordering: one in flight
        self._pending = fn

    def run_pending(self):
        fn, self._pending = self._pending, None
        if fn is not None:
            fn()

    def flush(self):
        self.run_pending()
