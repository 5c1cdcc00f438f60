"""Processes across cards: ``torch.distributed`` and the single-writer rule.

Counterpart of ``enterprise_warp_tpu/parallel/distributed.py``. The
reference joins hosts with ``jax.distributed`` and shards over a device
``Mesh``; the port joins processes with ``torch.distributed`` and shards
over ranks, one rank per process:

- **process group**: :func:`init_distributed` joins this process to a
  group when the launcher set the environment contract below, and is a
  no-op for the ordinary one-process run. The backend follows from the
  placement, which the ranks exchange through the rendezvous store
  before the group forms (each rank's host name and visible card count):
  NCCL where every rank computes on a card and no host holds more ranks
  than cards, gloo on the CPU and where the ranks on a host outnumber its
  cards (two ranks sharing ``cuda:0``). Every rank reads the same table,
  so every rank picks the same backend; each rank's card is its index
  among the ranks of its host. A group that cannot form raises; nothing
  carries on unsharded.
- **no staging protocol**: every rank builds the same likelihood from the
  same paramfile and runs the same sampler step stream (same seeds,
  replicated walker state; the collectives keep the likelihood values
  identical). The one thing a rank takes from another is what the
  primary read from the run's files: a resume's checkpoint and chain
  rows, and the decision whether there is one (:func:`from_primary`, one
  broadcast), so no secondary reads a file the primary may be writing.
- **single-writer rule**: only process 0 writes the output contract
  (``chain_1.txt``, ``pars.txt``, ``cov.npy``, ``state.npz``,
  ``*_nfreqs.txt``, result JSONs). Writers ask :func:`is_primary`, which
  is always True in a one-process run. Telemetry is the one exception:
  each rank writes its own ``events.<i>.jsonl`` and ``mesh_stats.<i>.json``
  (:func:`primary_only` with ``telemetry_ok=True``).
- **pulsar axis**: :func:`make_mesh` returns a :class:`ShardLayout`: the
  group, ``nshard = min(world, npsr)`` and each rank's contiguous range of
  pulsars (uneven where ``npsr`` does not divide; no padded pulsars). The
  joint likelihood (``parallel/pta.py``) runs stages 1-2 on its own
  pulsars and sums every cross-pulsar quantity in ONE packed
  :func:`all_reduce_sum` per evaluation (:func:`scatter_to_global` builds
  the sum-ready global buffers).
- **TOA axis**: ``parallel.make_toa_mesh`` is a layout of ``axis="toa"``
  and width the group size; ``models/build.py:build_pulsar_likelihood``
  gives each rank a block of one pulsar's TOA rows and sums its Gram
  partials in ONE :func:`all_reduce_sum` per evaluation.

Environment contract (set by the launcher, one process per rank)::

    EWT_COORDINATOR   = "host0:port"   rendezvous address (tcp://), or a
                                       file:// store path
    EWT_NUM_PROCESSES = "<N>"
    EWT_PROCESS_ID    = "<i>"

The CLI calls :func:`init_distributed` before building likelihoods;
keyword arguments override the environment. ``EWT_DIST_TIMEOUT_S``
(default 600) bounds the rendezvous and every collective.

Every collective of the port goes through this module's wrappers, which
count each call in ``COLLECTIVES`` (``all_reduce``, ``all_gather``,
``all_reduce_grad`` for the backward of a sharded gradient, and
``broadcast`` for :func:`from_primary`). Gloo stages
through host memory: a CUDA tensor on a gloo group is copied to the host
and back explicitly.

Left out: the reference's ``emulated_host_count`` reads ``XLA_FLAGS``
(emulated host-platform devices), which has no torch counterpart.
"""

from __future__ import annotations

import collections
import datetime
import functools
import json
import os
import socket

import torch

_INITIALIZED = False
#: calls of the port's collective wrappers, by kind
COLLECTIVES = collections.Counter()


def reset_collectives():
    """Zero :data:`COLLECTIVES` (a run reads it after)."""
    COLLECTIVES.clear()


def _placement(table, rank):
    """``(backend, local_rank)`` of ``rank`` from every rank's ``(host,
    cards)``, where ``cards`` is the number of cards the rank computes on
    (0 on the CPU): NCCL where every rank has cards and no host holds
    more ranks than cards, gloo otherwise. ``local_rank`` is the rank's
    index among the ranks of its host, and picks its card."""
    per_host = collections.Counter(h for h, _ in table)
    nccl = all(c >= per_host[h] > 0 for h, c in table)
    host = table[rank][0]
    local = [r for r, (h, _) in enumerate(table) if h == host].index(rank)
    return ("nccl" if nccl else "gloo"), local


def _visible_cards(device=None):
    """The cards this process may compute on: 0 when the caller asks for
    the CPU or there is no CUDA."""
    if device is not None and torch.device(device).type == "cpu":
        return 0
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


#: this rank's index among the ranks of its host (set by init_distributed)
_LOCAL_RANK = None


def init_distributed(coordinator=None, num_processes=None,
                     process_id=None, device=None):
    """Join the process group when the contract is present.

    Returns ``(process_index, process_count)``. A run without all three
    of ``EWT_COORDINATOR``, ``EWT_NUM_PROCESSES`` and ``EWT_PROCESS_ID``
    (nor their arguments) returns ``(0, 1)`` and touches nothing.
    ``device`` is where this process computes (the CUDA card unless the
    caller asks for the CPU). The ranks meet at the coordinator's store,
    write their host name and card count there, and each picks the
    backend and its card from the whole table (:func:`_placement`)."""
    global _INITIALIZED, _LOCAL_RANK
    coord = coordinator or os.environ.get("EWT_COORDINATOR")
    npro = (num_processes if num_processes is not None
            else os.environ.get("EWT_NUM_PROCESSES"))
    pid = (process_id if process_id is not None
           else os.environ.get("EWT_PROCESS_ID"))
    if not _INITIALIZED and coord and npro is not None and pid is not None:
        import torch.distributed as dist
        n, i = int(npro), int(pid)
        url = coord if "://" in coord else f"tcp://{coord}"
        timeout = datetime.timedelta(seconds=float(
            os.environ.get("EWT_DIST_TIMEOUT_S", "600")))
        store, _, _ = next(dist.rendezvous(url, rank=i, world_size=n,
                                           timeout=timeout))
        store.set_timeout(timeout)
        place = dist.PrefixStore("ewt_placement", store)
        place.set(str(i), json.dumps([socket.gethostname(),
                                      _visible_cards(device)]))
        table = [tuple(json.loads(place.get(str(r)))) for r in range(n)]
        backend, _LOCAL_RANK = _placement(table, i)
        if backend == "nccl":
            torch.cuda.set_device(_LOCAL_RANK)
        dist.init_process_group(backend=backend, store=store, world_size=n,
                                rank=i, timeout=timeout)
        _INITIALIZED = True
    return process_index(), process_count()


def process_index() -> int:
    """This process's rank. Before the group is joined the launcher's
    environment is the identity (0 without it), so the single-writer
    guard works in a process between launch and
    :func:`init_distributed`, and never raises."""
    if not _INITIALIZED:
        pid = os.environ.get("EWT_PROCESS_ID")
        if pid is None:
            return 0
        try:
            return int(pid)
        except ValueError:
            return 0
    import torch.distributed as dist
    return int(dist.get_rank())


def process_count() -> int:
    """The number of ranks (the launcher's count before the group is
    joined, 1 without it)."""
    if not _INITIALIZED:
        npro = os.environ.get("EWT_NUM_PROCESSES")
        if npro is None:
            return 1
        try:
            return max(1, int(npro))
        except ValueError:
            return 1
    import torch.distributed as dist
    return int(dist.get_world_size())


def is_primary() -> bool:
    """True on the one process allowed to write run outputs."""
    return process_index() == 0


def primary_only(fn=None, *, telemetry_ok=False):
    """Decorator of an artifact writer: on a secondary process the call is
    a no-op returning None. ``telemetry_ok=True`` lets every process run
    the writer: it writes telemetry to a path that carries its process
    index, so writers never race on one path. Chains, checkpoints and
    result files never pass it."""
    def deco(f):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            if not telemetry_ok and not is_primary():
                return None
            return f(*args, **kwargs)
        return wrapped
    return deco if fn is None else deco(fn)


def device_stamp(mesh=None) -> dict:
    """Provenance of a measurement: platform, process index and count,
    the cards this process sees, and the layout's width."""
    ncuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    stamp = dict(platform="gpu" if ncuda else "cpu",
                 process_count=process_count(),
                 process_index=process_index(),
                 local_device_count=ncuda)
    if mesh is not None:
        stamp["mesh_devices"] = int(mesh.nshard)
        stamp["mesh_axes"] = {mesh.axis: int(mesh.nshard)}
    return stamp


class ShardLayout:
    """The port's counterpart of a 1-D device mesh: ``nshard`` shards
    over the ranks ``0 .. nshard-1`` of ``group`` along ``axis``
    (``"psr"``, ``"toa"`` or ``"chain"``), this process being ``rank``. A rank at or
    above ``nshard`` holds no shard and adds zeros to each sum.

    ``group`` None is a layout without a process group (one process); the
    collectives are then the identity. ``device`` is this rank's device.
    """

    def __init__(self, nshard, rank=0, axis="psr", group=None,
                 device="cpu"):
        self.nshard = max(1, int(nshard))
        self.rank = int(rank)
        self.axis = axis
        self.group = group
        self.device = torch.device(device)

    def ranges(self, n):
        """Contiguous ``[(lo, hi), ...]`` of ``n`` rows over the shards
        (the first ``n % nshard`` one row longer), ``min(nshard, n)``
        of them."""
        k = max(1, min(self.nshard, int(n)))
        base, extra = divmod(int(n), k)
        out, lo = [], 0
        for s in range(k):
            hi = lo + base + (1 if s < extra else 0)
            out.append((lo, hi))
            lo = hi
        return out

    def __repr__(self):
        return (f"ShardLayout(axis={self.axis!r}, nshard={self.nshard}, "
                f"rank={self.rank}, device={self.device})")


def _rank_device(device=None):
    """This rank's device: the CPU where asked or without CUDA, else its
    card, by its index among the ranks of its host (the global rank
    before the group is joined)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if device is None and not torch.cuda.is_available():
        return torch.device("cpu")
    local = process_index() if _LOCAL_RANK is None else _LOCAL_RANK
    return torch.device(f"cuda:{local % max(torch.cuda.device_count(), 1)}")


def make_mesh(npsr, axis="psr", device=None, width=None):
    """The shard layout of ``npsr`` rows over the process group: ``nshard
    = min(world, npsr)`` (or ``min(width, world, npsr)``), this process's
    rank, and its device (:func:`_rank_device`)."""
    import torch.distributed as dist
    world = process_count()
    if width is not None and int(width) > 0:
        world = min(world, int(width))
    group = dist.group.WORLD if _INITIALIZED else None
    return ShardLayout(max(1, min(world, int(npsr))), rank=process_index(),
                       axis=axis, group=group, device=_rank_device(device))


def scatter_to_global(local, global_rows, offset, dim=0):
    """Place this shard's rows (along ``dim``) into a zero buffer of
    ``global_rows`` rows at ``offset``. Summing the shards' buffers (one
    :func:`all_reduce_sum`) rebuilds the whole array. Differentiable."""
    n = local.shape[dim]
    before = list(local.shape)
    before[dim] = offset
    after = list(local.shape)
    after[dim] = int(global_rows) - offset - n
    z = functools.partial(torch.zeros, dtype=local.dtype,
                          device=local.device)
    return torch.cat([z(before), local, z(after)], dim=dim)


def _group_backend(group):
    import torch.distributed as dist
    return dist.get_backend(group)


def _raw_all_reduce(t, group):
    """Sum of ``t`` over ``group`` as a new tensor (the identity without
    a group); a CUDA tensor on a gloo group goes through host memory."""
    if group is None:
        return t.clone()
    import torch.distributed as dist
    if t.is_cuda and _group_backend(group) == "gloo":
        # ewt: allow-host-sync — gloo reduces host memory: a CUDA tensor is
        # staged through the host on a gloo group
        h = t.detach().to("cpu", copy=True)
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the identity (every rank
    holds the same replicated cotangent of the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        return _raw_all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradAllReduce(torch.autograd.Function):
    """Forward: the identity. Backward: the sum of the gradient over the
    group, so a replicated input collects every shard's contribution."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["all_reduce_grad"] += 1
        return _raw_all_reduce(g.contiguous(), ctx.group), None


def all_reduce_sum(t, group=None):
    """The sum of ``t`` over ``group``: one counted collective, the
    identity in the backward."""
    COLLECTIVES["all_reduce"] += 1
    return _AllReduceSum.apply(t, group)


def grad_all_reduce(t, group=None):
    """``t`` unchanged; in the backward, its gradient summed over
    ``group`` (counted as ``all_reduce_grad``)."""
    return _GradAllReduce.apply(t, group)


def all_gather_rows(t, group=None):
    """The ranks' ``t`` (equal shapes) concatenated along dim 0, in rank
    order: one counted collective (no gradient)."""
    COLLECTIVES["all_gather"] += 1
    if group is None:
        return t.clone()
    import torch.distributed as dist
    world = dist.get_world_size(group)
    src = t.detach().contiguous()
    if src.is_cuda and _group_backend(group) == "gloo":
        # ewt: allow-host-sync — gloo gathers host memory: a CUDA tensor is
        # staged through the host on a gloo group
        src = src.to("cpu")
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=0).to(t.device)


def from_primary(fn):
    """``fn()`` as the primary computes it, on every rank: the primary
    calls ``fn`` and one broadcast (counted as ``broadcast``) carries its
    picklable value to the others, which never call it. An exception in
    ``fn`` is raised on every rank. Without a group of more than one
    process, every process calls ``fn`` itself. Used for what the primary
    reads from the run's files (a resume), so every rank starts from the
    same state and takes the same decision."""
    if not _INITIALIZED or process_count() == 1:
        return fn()
    import torch.distributed as dist
    COLLECTIVES["broadcast"] += 1
    box = [None]
    err = None
    if is_primary():
        try:
            box = [(True, fn())]
        except Exception as e:  # noqa: BLE001 - re-raised below
            err, box = e, [(False, f"{type(e).__name__}: {e}")]
    dist.broadcast_object_list(box, src=0)
    if err is not None:
        raise err
    ok, val = box[0]
    if not ok:
        raise RuntimeError(f"the primary process failed: {val}")
    return val
