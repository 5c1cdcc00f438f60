"""AOT executable cache: warm once per (topology, bucket, device).

Counterpart of ``enterprise_warp_tpu/serve/aot.py``. A serving replica
answers many small jobs against a handful of model topologies. The
reference lowers and compiles the batched likelihood ahead of time; the
port has no jit, so its "executable" is a :class:`ServeExecutable`, keyed
on

    (topology fingerprint, batch bucket, device)

- the **topology fingerprint** (``models/build.py:topology_fingerprint``)
  is stable across rebuilds of the same pulsar and model and distinct for
  anything that changes the evaluation (data, fixed parameters, route
  pins — a demotion that sets ``EWT_PALLAS_MEGA=0`` keys fresh
  executables);
- the **batch bucket** is the padded walker-batch row count. Each model
  serves at ONE sticky bucket (its serve width — see ``packer.py``); the
  configured bucket SET is what a replica pre-warms;
- the **device** is ``str(like.device)`` (the reference's backend).

A :class:`ServeExecutable` holds the likelihood's batch evaluation
(``samplers/evalproto.py:eval_protocol``), a preallocated ``(bucket,
ndim)`` float64 theta buffer on the likelihood's device and, on the
card, two pinned host staging buffers used in turn: batch ``k+1``'s rows
are staged while batch ``k``'s non-blocking upload may still be reading
the other buffer, and a buffer is written again only after its last
upload completed. The upload is a real copy; the caller keeps each
batch's host rows for a retry or a demotion's re-dispatch (the port's
form of the reference's donated theta buffer).

"Compiling" a key builds that object and runs one evaluation at the
bucket on a valid prior draw: the first one loads the kernel library
(``ops/cuda_lib.py``, built into ``utils/compilecache.py``'s directory),
the CUDA modules and the library handles. ``compile_walls[key]`` is that
evaluation's wall; ``cache_verdicts[key]`` is True when the kernel
library was found built (or was already loaded), False when this warm-up
ran ``nvcc``, None on the CPU. The warm-up emits the reference's
``compile`` event (``fn=serve.eval_b<bucket>``, ``aot=True``).

No CUDA graph is captured: the kernel wrappers make host-side decisions
between launches (the preconditioner's tier-2 branch, the routes' cap
checks), which a graph would freeze.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["DEFAULT_BUCKETS", "batch_buckets", "bucket_for",
           "ServeExecutable", "AOTExecutableCache"]

#: default batch-bucket edges (padded rows per dispatch). Powers of
#: two: few enough that a replica warms them all in seconds per
#: topology, dense enough that padding waste stays under 2x.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def batch_buckets():
    """The configured bucket edges (``EWT_SERVE_BUCKETS=1,8,64``
    overrides; always sorted, deduplicated)."""
    env = os.environ.get("EWT_SERVE_BUCKETS")
    if env:
        edges = sorted({int(x) for x in env.split(",") if x.strip()})
        if edges and all(e > 0 for e in edges):
            return tuple(edges)
    return DEFAULT_BUCKETS


def bucket_for(n, buckets):
    """Smallest bucket edge >= ``n``, or None when ``n`` exceeds the
    largest edge (the packer spills such loads across several
    capacity-sized dispatches instead)."""
    for b in buckets:
        if b >= n:
            return b
    return None


class ServeExecutable:
    """The batch-``bucket`` evaluation of one likelihood (module
    docstring). ``exe(rows)`` uploads ``rows`` — host ``(bucket, ndim)``
    float64, or a tensor, which passes through when it already lies on
    the device — into the theta buffer and returns the ``(bucket,)``
    lnL tensor on the device, not waited for."""

    def __init__(self, like, bucket, batch_fn):
        from ..samplers.devicestate import resolve_placement
        self.bucket = int(bucket)
        self.ndim = int(like.ndim)
        self.device = resolve_placement(like)
        self.batch_fn = batch_fn
        self.theta = torch.empty((self.bucket, self.ndim),
                                 dtype=torch.float64, device=self.device)
        self._stage = None
        if self.device.type == "cuda":
            self._stage = [torch.empty((self.bucket, self.ndim),
                                       dtype=torch.float64, pin_memory=True)
                           for _ in range(2)]
        self._uploaded = [None, None]   # each staging buffer's copy event
        self._turn = 0

    def upload(self, rows):
        """``rows`` on the device: the theta buffer, filled by a real
        copy (host rows), or the tensor itself (already resident)."""
        from ..samplers.devicestate import place_resident
        if torch.is_tensor(rows):
            return place_resident(rows, self.device)
        rows = np.asarray(rows, dtype=np.float64)
        if rows.shape != (self.bucket, self.ndim):
            raise ValueError(f"serve executable takes ({self.bucket}, "
                             f"{self.ndim}) rows, got {rows.shape}")
        if self._stage is None:
            self.theta.copy_(torch.from_numpy(rows))
            return self.theta
        k, self._turn = self._turn, self._turn ^ 1
        if self._uploaded[k] is not None:
            # the last upload from this buffer must have read it
            self._uploaded[k].synchronize()
        self._stage[k].numpy()[...] = rows
        stream = torch.cuda.current_stream(self.device)
        self.theta.copy_(self._stage[k], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
        self._uploaded[k] = ev
        return self.theta

    def __call__(self, rows):
        return self.batch_fn(self.upload(rows))


class AOTExecutableCache:
    """In-process executable cache for batched likelihood evaluation
    (see module docstring).

    ``executable(like, bucket)`` returns the batch-``bucket`` executable
    — warming it on first use, a dict hit afterwards. ``warm(like)``
    warms the whole configured bucket set.
    """

    def __init__(self, buckets=None):
        self.buckets = tuple(sorted(buckets or batch_buckets()))
        self._exec: dict = {}           # key -> ServeExecutable
        self._fp: dict = {}             # id(like) -> fingerprint memo
        self.compile_walls: dict = {}   # key -> first evaluation's wall
        self.cache_verdicts: dict = {}  # key -> kernel library found built

    @property
    def capacity(self) -> int:
        """Largest bucket: the most rows one dispatch can carry."""
        return self.buckets[-1]

    def fingerprint(self, like) -> str:
        """Memoized topology fingerprint of ``like`` (the data digest
        is hashed once per registered model, not per request). The
        memo holds a strong reference to ``like`` — an id()-only key
        could be reused by a NEW object after the old one is freed
        and silently serve the wrong topology's executable."""
        slot = self._fp.get(id(like))
        if slot is not None and slot[0] is like:
            return slot[1]
        from ..models.build import topology_fingerprint

        fp = topology_fingerprint(like)
        self._fp[id(like)] = (like, fp)
        return fp

    def key(self, like, bucket):
        from ..samplers.devicestate import resolve_placement
        return (self.fingerprint(like), int(bucket),
                str(resolve_placement(like)))

    def executable(self, like, bucket):
        """The batch-``bucket`` executable for ``like`` (warm-on-miss;
        see class docstring)."""
        bucket = int(bucket)
        if bucket <= 0:
            raise ValueError(f"bucket must be positive, got {bucket}")
        key = self.key(like, bucket)
        exe = self._exec.get(key)
        from ..utils import telemetry

        if exe is not None:
            telemetry.registry().counter("aot_cache",
                                         outcome="hit").inc()
            return exe
        telemetry.registry().counter("aot_cache", outcome="miss").inc()
        return self._compile(like, bucket, key)

    def _compile(self, like, bucket, key):
        from ..ops import cuda_lib
        from ..samplers.devicestate import host_pull
        from ..samplers.evalproto import eval_protocol
        from ..utils import profiling, telemetry

        batch_fn, _, _ = eval_protocol(like)
        label = f"serve.eval_b{bucket}"
        exe = ServeExecutable(like, bucket, batch_fn)
        rows = np.asarray(like.sample_prior(np.random.default_rng(0),
                                            bucket), dtype=np.float64)
        cuda = exe.device.type == "cuda"
        fresh = not cuda_lib.loaded()
        t0 = profiling.monotonic()
        host_pull(exe(rows))
        wall = profiling.monotonic() - t0
        verdict = None
        if cuda:
            verdict = not (fresh and cuda_lib.loaded()
                           and cuda_lib.BUILD_VERDICTS.get("megakernel")
                           is False)
        self._exec[key] = exe
        self.compile_walls[key] = wall
        self.cache_verdicts[key] = verdict
        rec = telemetry.active_recorder()
        if rec is not None:
            rec.event("compile", fn=label, wall_s=round(wall, 4),
                      arg_shapes=[[bucket, int(like.ndim)]],
                      cache_hit=verdict, aot=True)
        return exe

    def warm(self, like, buckets=None):
        """Warm the executable set for ``like`` across ``buckets``
        (default: every configured edge) — the fresh-replica warm start.
        Returns ``{bucket: warm_wall_s}`` (0.0 where already warm)."""
        walls = {}
        for b in (buckets or self.buckets):
            key = self.key(like, b)
            if key in self._exec:
                walls[b] = 0.0
                continue
            self._compile(like, b, key)
            walls[b] = self.compile_walls[key]
        return walls

    def clear(self):
        """Drop every executable AND fingerprint memo — required
        after a demotion (route pins changed, so the memoed
        fingerprints are stale alongside the executables)."""
        self._exec.clear()
        self._fp.clear()

    def stats(self):
        from ..utils.telemetry import registry

        snap = {k: v for k, v in
                registry().snapshot()["counters"].items()
                if k.startswith("aot_cache")}
        return {
            "executables": len(self._exec),
            "counters": snap,
            "compile_walls_s": {str(k): round(v, 4)
                                for k, v in self.compile_walls.items()},
            "persistent_cache_verdicts": {
                str(k): v for k, v in self.cache_verdicts.items()},
        }
