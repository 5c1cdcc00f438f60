"""Multi-tenant serving layer: AOT executable cache + shape-bucketed
batched dispatch.

Counterpart of ``enterprise_warp_tpu/serve``, the entry point for many
small repeat jobs (per-pulsar noise-posterior evaluations against a
handful of model topologies): the warm-up is paid once per topology and
the dispatch once per batch.

- :mod:`aot` — warmed batch-evaluation executables keyed on ``(model
  topology fingerprint, batch bucket, device)``; the kernel build
  directory (``utils/compilecache.py``) is what a fresh replica reuses
  across processes;
- :mod:`packer` — the request queue's shape-bucketing packer: many
  small jobs padded into ONE batched dispatch at a bucket edge, padding
  rows masked out at harvest (bit-equal to the single-job path);
- :mod:`driver` — :class:`~driver.ServeDriver`: the queue + dispatch
  loop, double-buffered result harvest (``samplers/devicestate.py``),
  per-batch supervision (``resilience/supervisor.py``), and per-tenant
  ``events.jsonl`` streams;
- :mod:`admission` — typed :class:`~admission.Rejection` at submit,
  bounded queue, per-tenant quotas and weighted tenant fair-share drain
  ordering;
- :mod:`slo` — the per-tenant SLO engine (:class:`~slo.SLOEngine`);
- :mod:`cli` — the ``serve`` subcommand of
  ``enterprise_warp_tpu_torch.cli``.
"""

from .admission import (Rejection, UnknownModel, fair_share_order,
                        parse_serve_config, validate_thetas)
from .aot import (DEFAULT_BUCKETS, AOTExecutableCache, batch_buckets,
                  bucket_for)
from .driver import Request, ServeDriver
from .packer import PackedBatch, pack_requests, split_batch
from .slo import SLOEngine

__all__ = ["AOTExecutableCache", "DEFAULT_BUCKETS", "batch_buckets",
           "bucket_for", "ServeDriver", "Request", "PackedBatch",
           "pack_requests", "split_batch", "Rejection",
           "UnknownModel", "validate_thetas", "fair_share_order",
           "parse_serve_config", "SLOEngine"]
